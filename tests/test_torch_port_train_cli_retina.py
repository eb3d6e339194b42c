"""The two packages' train and detect CLIs on RetinaNet, each on the other's
checkpoints: ``tpu_models/train.py`` and the port's train CLI (``--device
cpu``) with the same arguments (VOC's 20 classes + background, 64 px,
batch 2 over 2 images, 2 epochs, --ema), the port's net carried from the
JAX package's seed-0 init. Then the detect CLIs at their 640 px: the port's
serves the JAX package's checkpoint (its EMA: nonzero tower biases, moved
frozen statistics) and ``tpu_models/detect.py`` serves the port's, each
with the detections of the other package's detect CLI on it.
``test_torch_port_train_cli_frcnn.py`` runs the same for Faster R-CNN,
with the JAX package's sampling draws injected into the port's CLI.

Tolerances: each step's loss 1e-5 relative (2.2e-7 and 8.2e-8 measured);
the checkpoints' files, payload keys and tree structures equal; detections
as ``test_torch_port_train_cli_cross.py`` compares them (rows paired one to
one by class, conf within 1e-3 and box within 1 px; at most 5% unpaired,
paired conf within 1e-4 and boxes within 0.1 px; 600 rows, none unpaired,
conf 1.3e-6 and boxes 4.2e-5 px measured).
"""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

from edgeml_tpu_torch.cli import detect as tdetect
from edgeml_tpu_torch.cli import train as ttrain_cli
from edgeml_tpu_torch.models import engine as tengine
from test_torch_port_train_cli import write_dataset
from test_torch_port_train_cli_cross import _load_cli, _pair

torch.set_num_threads(1)

IMG, N_IMG, BATCH, EPOCHS = 64, 2, 2, 2
DETECT_CONF = 0.05
LOSS_TOL = 1e-5
CONF_TOL, BOX_TOL_PX, UNPAIRED_TOL = 1e-4, 0.1, 0.05


def train_argv(model, img_dir, lab_dir, save_dir, epochs=EPOCHS):
    return [img_dir, str(save_dir), "--label-dir", lab_dir, "--model", model,
            "-b", str(BATCH), "--img-size", str(IMG), "--max-targets", "8",
            "--epochs", str(epochs), "--ema", "--print-freq", "100"]


def run_both(root, model, port_draws=None, resume=None):
    """Both train CLIs on the same dataset: (JAX result, port result, image
    directory). ``port_draws()`` makes the port step's ``draw_fn``;
    ``resume``: (the JAX package's checkpoint, the port's) of the same
    weights at epoch 0, which the CLIs resume for EPOCHS more epochs, else
    both start from the JAX package's seed-0 init."""
    img_dir, lab_dir = write_dataset(root, n=N_IMG)
    extra = [[], []] if resume is None else [
        ["--resume", str(path)] for path in resume]
    epochs = EPOCHS if resume is None else EPOCHS + 1
    sys_argv = sys.argv
    sys.argv = ["train.py"] + train_argv(model, img_dir, lab_dir,
                                         root / "jax", epochs) + extra[0]
    try:
        jcli = _load_cli("train")
        jres = jcli.main(jcli.getargs())
    finally:
        sys.argv = sys_argv
    make = tengine.make_detector
    make_step = tengine.make_family_train_step
    with pytest.MonkeyPatch.context() as m:
        if resume is None:
            init = jax.tree_util.tree_map(
                np.asarray, jres["state"][0].init(jax.random.PRNGKey(0)))
            m.setattr(tengine, "make_detector",
                      lambda *a, **k: make(*a, **k).from_jax_params(init))
        if port_draws is not None:
            def with_draws(*a, **k):
                opt, step = make_step(*a, **k)
                step.draw_fn = port_draws()
                return opt, step

            m.setattr(tengine, "make_family_train_step", with_draws)
        tres = ttrain_cli.main(ttrain_cli.getargs(
            train_argv(model, img_dir, lab_dir, root / "port", epochs)
            + extra[1] + ["--device", "cpu"]))
    return jres, tres, img_dir


def _payload(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def check_losses(tag, runs):
    jres, tres, _ = runs
    errs = [abs(t - j) / j for t, j in zip(tres["epoch_loss"],
                                            jres["epoch_loss"])]
    print(f"{tag}: JAX losses {jres['epoch_loss']}, port "
          f"{tres['epoch_loss']}, relative {errs}")
    assert len(errs) == EPOCHS and max(errs) <= LOSS_TOL


def check_files(root, names=("checkpoint.pth", "model_0.pth")):
    assert sorted(os.listdir(root / "jax")) \
        == sorted(os.listdir(root / "port")) == list(names)
    for name in names:
        j, p = _payload(root / "jax" / name), _payload(root / "port" / name)
        assert set(j) == set(p) == {"model", "optimizer", "lr_scheduler",
                                    "args", "epoch", "ema"}
        assert j["args"] == p["args"] and j["epoch"] == p["epoch"]
        assert p["model"]["stats"] is None is j["model"]["stats"]
        assert set(j["ema"]) == set(p["ema"]) == {"params", "n_updates"}
        for jt, pt in ((j["model"]["params"], p["model"]["params"]),
                       (j["ema"]["params"], p["ema"]["params"])):
            assert jax.tree_util.tree_structure(jt) == \
                jax.tree_util.tree_structure(pt)
            for a, b in zip(jax.tree_util.tree_leaves(jt),
                            jax.tree_util.tree_leaves(pt)):
                assert np.asarray(a).shape == b.shape
                assert b.dtype == np.float32
        assert int(j["ema"]["n_updates"]) == int(p["ema"]["n_updates"])


def detect_both(root, which, model, img_dir, capsys, conf=DETECT_CONF):
    """Both detect CLIs on ``which``'s checkpoint over the first image: the
    same detection files."""
    ckpt = str(root / which / "checkpoint.pth")
    one = root / "detect_images"
    if not one.exists():
        one.mkdir()
        first = sorted(os.listdir(img_dir))[0]
        shutil.copy(os.path.join(img_dir, first), one / first)
    img_dir = str(one)
    argv = [img_dir, None, "--model", model, "--dataset", "voc",
            "--model-path", ckpt, "--batch-size", "1", "--conf-thres",
            str(conf)]
    out_t, out_j = root / f"{which}_by_port", root / f"{which}_by_jax"
    argv[1] = str(out_t)
    tdetect.main(tdetect.getargs(argv + ["--device", "cpu"]))
    assert "loading native checkpoint (EMA weights" in capsys.readouterr().out
    jdetect = _load_cli("detect")
    argv[1] = str(out_j)
    sys_argv = sys.argv
    sys.argv = ["detect.py"] + argv
    try:
        jdetect.main(jdetect.getargs())
    finally:
        sys.argv = sys_argv
    assert "EMA weights" in capsys.readouterr().out
    rows = unpaired = 0
    ce = be = 0.0
    names = sorted(os.listdir(img_dir))
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == names
    for n in names:
        a, b = np.load(out_t / n), np.load(out_j / n)
        pairs, c, e = _pair(a, b, (IMG, IMG))
        rows += max(len(a), len(b))
        unpaired += max(len(a), len(b)) - pairs
        ce, be = max(ce, c), max(be, e)
    share = unpaired / max(rows, 1)
    print(f"{model} {which}: rows {rows} unpaired {share:.4f} conf {ce:.2e} "
          f"box {be:.2e} px")
    assert rows > 0
    assert share <= UNPAIRED_TOL and ce <= CONF_TOL and be <= BOX_TOL_PX


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("retina_cli")
    return root, run_both(root, "retinanet")


def test_losses_match_jax_cli(runs):
    check_losses("retinanet", runs[1])


def test_same_files_and_trees(runs):
    root, _ = runs
    check_files(root)
    ema = _payload(root / "jax" / "checkpoint.pth")["ema"]["params"]
    # the JAX package trains the tower biases and the frozen statistics
    # (zero biases and means, unit variances at its init)
    stem = ema["backbone"]["stem"]
    assert np.abs(ema["cls_tower"][1]["b"]).max() > 0
    assert np.abs(stem["m"]).max() > 0 and np.abs(stem["v"] - 1).max() > 0


def test_port_detect_serves_jax_checkpoint(runs, capsys):
    root, (_, _, img_dir) = runs
    detect_both(root, "jax", "retinanet", img_dir, capsys)


def test_jax_detect_serves_port_checkpoint(runs, capsys):
    root, (_, _, img_dir) = runs
    detect_both(root, "port", "retinanet", img_dir, capsys)
