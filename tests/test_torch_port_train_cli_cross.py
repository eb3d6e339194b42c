"""The two packages' train and detect CLIs on each other's checkpoints, on
8 images of 64 px: ``tpu_models/train.py`` and the port's train CLI
(``--device cpu``) with the same arguments (YOLOv5n, --preset yolo
--augment yolo --ema, one epoch) write the same files with the same payload
keys and model trees; the port's detect CLI serves the JAX package's
checkpoint (its EMA weights) with the detections of ``tpu_models/detect.py``
on it, and ``tpu_models/detect.py`` serves the port's with the port's
detections.

Detections are compared as ``chip_smoke.py`` compares the card's files with
the CPU's (PERF.md section 6's file tolerance): rows paired one to one by
class, conf within 1e-3 and box within 1 px; at most 5% of rows unpaired,
the paired rows' conf within 1e-4 and boxes within 0.1 px. The two
packages' convolutions sum in different orders, so near-equal confidences
may swap places or cross the threshold.
"""

import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax

from edgeml_tpu_torch.cli import detect as tdetect
from edgeml_tpu_torch.cli import train as ttrain_cli
from test_torch_port_train_cli import IMG, N_IMG, write_dataset

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_MODELS = os.path.join(REPO, "tpu_models")
PAIR_CONF, PAIR_PX = 1e-3, 1.0
CONF_TOL, BOX_TOL_PX, UNPAIRED_TOL = 1e-4, 0.1, 0.05


def _load_cli(name):
    if TPU_MODELS not in sys.path:
        sys.path.insert(0, TPU_MODELS)
    spec = importlib.util.spec_from_file_location(
        f"tpu_models_{name}", os.path.join(TPU_MODELS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train_args(img_dir, lab_dir, save_dir):
    return ttrain_cli.getargs(
        [img_dir, str(save_dir), "--label-dir", lab_dir, "--model",
         "yolov5n", "-b", "4", "--img-size", str(IMG), "--max-targets",
         "16", "--epochs", "1", "--preset", "yolo", "--augment", "yolo",
         "--ema", "--device", "cpu"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cross")
    img_dir, lab_dir = write_dataset(root)
    _load_cli("train").main(_train_args(img_dir, lab_dir, root / "jax"))
    ttrain_cli.main(_train_args(img_dir, lab_dir, root / "port"))
    return root, img_dir


def _payload(path):
    with open(path, "rb") as f:
        return pickle.load(f)  # the JAX package's needs optax: it is here


def test_same_files_and_keys(runs):
    root, _ = runs
    assert sorted(os.listdir(root / "jax")) == sorted(
        os.listdir(root / "port")) == ["checkpoint.pth", "model_0.pth"]
    for name in ("checkpoint.pth", "model_0.pth"):
        j, p = _payload(root / "jax" / name), _payload(root / "port" / name)
        assert set(j) == set(p) == {"model", "optimizer", "lr_scheduler",
                                    "args", "epoch", "ema"}
        assert j["epoch"] == p["epoch"] == 0
        assert j["args"] == p["args"]
        assert j["lr_scheduler"] == p["lr_scheduler"]
        for key in ("model", "ema"):
            assert set(j[key]) == set(p[key])
            for part in ("params", "stats"):
                jt, pt = j[key][part], p[key][part]
                assert jax.tree_util.tree_structure(jt) == \
                    jax.tree_util.tree_structure(pt)
                for a, b in zip(jax.tree_util.tree_leaves(jt),
                                jax.tree_util.tree_leaves(pt)):
                    assert np.asarray(a).shape == b.shape
                    assert b.dtype == np.float32
        assert int(j["ema"]["n_updates"]) == int(p["ema"]["n_updates"]) \
            == N_IMG // 4


def _pair(a, b, hw):
    """Pair rows (cls, x, y, w, h, conf) one to one: (pairs, conf error,
    box error in pixels)."""
    scale = np.array([hw[1], hw[0], hw[1], hw[0]], np.float64)
    free = np.ones(len(b), bool)
    pairs, ce, be = 0, 0.0, 0.0
    for row in a:
        cand = np.nonzero(free & (b[:, 0] == row[0])
                          & (np.abs(b[:, 5] - row[5]) <= PAIR_CONF))[0]
        if cand.size == 0:
            continue
        px = (np.abs(b[cand, 1:5] - row[1:5]) * scale).max(axis=1)
        k = int(np.argmin(px))
        if px[k] > PAIR_PX:
            continue
        free[cand[k]] = False
        pairs += 1
        ce = max(ce, float(abs(b[cand[k], 5] - row[5])))
        be = max(be, float(px[k]))
    return pairs, ce, be


def _detect_both(runs, which, capsys):
    root, img_dir = runs
    ckpt = str(root / which / "checkpoint.pth")
    argv = [img_dir, None, "--model", "yolov5n", "--dataset", "voc",
            "--model-path", ckpt, "--batch-size", "4", "--conf-thres",
            "0.01"]
    out_t, out_j = root / f"{which}_by_port", root / f"{which}_by_jax"
    argv[1] = str(out_t)
    tdetect.main(tdetect.getargs(argv + ["--device", "cpu"]))
    assert "loading native checkpoint (EMA weights, epoch 0)" in \
        capsys.readouterr().out
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
    print(f"{which}: rows {rows} unpaired {share:.4f} conf {ce:.2e} "
          f"box {be:.2e} px")
    assert rows > 0
    assert share <= UNPAIRED_TOL and ce <= CONF_TOL and be <= BOX_TOL_PX


def test_port_detect_serves_jax_checkpoint(runs, capsys):
    _detect_both(runs, "jax", capsys)


def test_jax_detect_serves_port_checkpoint(runs, capsys):
    _detect_both(runs, "port", capsys)


def test_port_reads_jax_checkpoint_without_jax(runs):
    """The port's reader opens a JAX-written checkpoint in an interpreter
    where optax and jax cannot be imported: its optimizer state (optax
    tuples) loads as opaque tuples, model and ema as arrays."""
    import subprocess

    root, _ = runs
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'optax', 'chex', 'flax'):\n"
        "    sys.modules[m] = None\n"
        "from edgeml_tpu_torch.models.train import load_checkpoint\n"
        f"p, s, opt, payload = load_checkpoint({str(root / 'jax' / 'checkpoint.pth')!r})\n"
        "assert p['l0']['w'].shape == (6, 6, 3, 16)\n"
        "assert payload['ema']['stats']['l0']['m'].dtype.name == 'float32'\n"
        "assert isinstance(opt, tuple)\n"
        "print('ok', type(opt).__name__)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
