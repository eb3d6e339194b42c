"""``--data-parallel`` serving: ``run_detection(data_parallel=True)`` on two
gloo ranks on the CPU against the one-process run and the JAX package's
mesh run, int8 too, and the detect CLI with ``--data-parallel`` with and
without a process group.

One spawn of two ranks (``torch_mp_worker.py detect``) serves 9 images at a
global batch of 8 (4 a rank; the tail batch's one image falls to rank 0,
rank 1 has none) with carried weights, which rank 1 perturbs before the
call: ``replicate`` must hand it rank 0's.

Tolerances and why:
  * two ranks against one process, f32 and int8: 1e-5 on every column. A
    rank runs the same ops on 4 rows that one process runs on 8; each
    image's rows depend on that image alone.
  * two ranks against JAX's mesh run: classes exact, conf 1e-5, xywh 1e-4
    (normalised), the port-against-JAX file limits of
    ``test_torch_port_detect.py`` (the trunks agree to ~2e-6 in scores and
    ~2e-3 px in boxes), on its separation-checked workload, so no decision
    flips.
  * the CLI: two ranks against one process 1e-5; ``--data-parallel``
    without a group against no flag: the same path, bit for bit.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax

from edgeml_tpu.models.common import letterbox_batch as jax_letterbox
from edgeml_tpu.models.infer import run_detection as jax_run_detection
from edgeml_tpu.parallel.mesh import make_mesh
from edgeml_tpu_torch.cli import detect as detect_cli
from edgeml_tpu_torch.models.infer import run_detection

from test_torch_port_detect import _assert_separated, ragged_images
from test_torch_port_yolov5 import carried
from torch_mp_worker import DETECT_KW as KW, spawn

torch.set_num_threads(1)

N_IMAGES = 9
CLI_IMAGES = 3


def _write(img_dir, imgs):
    img_dir.mkdir(parents=True)
    for i, im in enumerate(imgs):
        np.save(img_dir / f"im{i}.npy", im)


def _cli_argv(img_dir, out_dir):
    return [str(img_dir), str(out_dir), "--model", "yolov5n", "--dataset",
            "voc", "--batch-size", "2", "--conf-thres", "1e-6", "--device",
            "cpu"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The two-rank spawn and the one-process runs it is held against."""
    root = tmp_path_factory.mktemp("dp_detect")
    imgs = (ragged_images(3) + ragged_images(10))[:N_IMAGES]
    _write(root / "images", imgs)
    _write(root / "cli_images", imgs[:CLI_IMAGES])
    lb, _ = jax_letterbox(imgs, 64)
    jnet, params, stats, net = carried(9, lb)
    n_cand = _assert_separated(jnet, params, stats, lb, KW["conf_thres"],
                               KW["iou_thres"], 2e-5)
    assert n_cand > 50
    torch.save(net.state_dict(), root / "yolo.pt")
    with open(root / "cli_args.pkl", "wb") as f:
        pickle.dump(_cli_argv(root / "cli_images", root / "cli_dp"), f)
    outs = spawn("detect", root)
    for dtype in (None, "int8"):
        run_detection(net, str(root / "images"), str(root / f"one_{dtype}"),
                      dtype=dtype, device="cpu", **KW)
    jax_run_detection(jnet, params, stats, str(root / "images"),
                      str(root / "jax_mesh"), mesh=make_mesh(("dp",)), **KW)
    detect_cli.main(detect_cli.getargs(
        _cli_argv(root / "cli_images", root / "cli_one")))
    return root, outs


def _rows(d, i):
    return np.load(d / f"im{i}.npy")


def test_backend_printed_once(served):
    _, outs = served
    assert sum(o.count("[distributed] backend=gloo world_size=2") for o in
               outs) == 1


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_two_ranks_match_one_process(served, dtype):
    root, _ = served
    rows = 0
    for i in range(N_IMAGES):
        got, want = _rows(root / f"dp_{dtype}", i), _rows(
            root / f"one_{dtype}", i)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        rows += len(got)
    assert rows > 10


def test_two_ranks_match_jax_mesh(served):
    root, _ = served
    assert len(jax.devices()) == 8
    for i in range(N_IMAGES):
        got, want = _rows(root / "dp_None", i), _rows(root / "jax_mesh", i)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 5], want[:, 5], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[:, 1:5], want[:, 1:5], atol=1e-4,
                                   rtol=0)


def test_cli_two_ranks_match_one_process(served):
    root, _ = served
    names = sorted(os.listdir(root / "cli_one"))
    assert names == sorted(os.listdir(root / "cli_dp"))
    assert len(names) == CLI_IMAGES
    assert sum(len(np.load(root / "cli_one" / n)) for n in names) > 0
    for n in names:
        np.testing.assert_allclose(np.load(root / "cli_dp" / n),
                                   np.load(root / "cli_one" / n), atol=1e-5,
                                   rtol=0)


def test_data_parallel_without_group_is_the_one_process_path(tmp_path):
    """No process group: ``--data-parallel`` writes the files the CLI
    writes without it (the JAX CLI runs the flag on one device so)."""
    imgs = ragged_images(5)[:2]
    _write(tmp_path / "imgs", imgs)
    for name, extra in (("plain", []), ("dp", ["--data-parallel"])):
        detect_cli.main(detect_cli.getargs(
            _cli_argv(tmp_path / "imgs", tmp_path / name) + extra))
    for i in range(len(imgs)):
        want = _rows(tmp_path / "plain", i)
        assert len(want) > 0
        np.testing.assert_array_equal(_rows(tmp_path / "dp", i), want)


def test_batch_must_split_over_ranks(tmp_path, monkeypatch):
    from edgeml_tpu_torch.models import infer
    from edgeml_tpu_torch.models.yolov5 import YoloV5

    monkeypatch.setattr(infer, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="not divisible"):
        run_detection(YoloV5(variant="n", num_classes=2, img_size=64),
                      str(tmp_path), str(tmp_path / "o"), batch_size=3,
                      device="cpu", data_parallel=True)
