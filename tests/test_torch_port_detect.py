"""The port's serving slice against the JAX package: letterbox, the NMS +
unmap tail, run_detection end to end, and the detect CLI.

Tolerances and why:
  * letterbox: 2e-6 — the port evaluates the reference's resampling weights
    in NumPy, the reference through its native C++ path in another summation
    order; tests/test_loader.py pins the same 2e-6 between the two.
  * the tail (_nms_unmap) on identical trunk outputs: none, bit for bit.
  * run_detection end to end: the same row count per file, the same classes,
    conf within 1e-5 and xywh within 1e-4 (normalised). The trunks agree to
    ~2e-6 in scores and ~2e-3 px in boxes (tests/test_torch_port_yolov5.py),
    and the seed is chosen so that candidate scores, the confidence gate and
    same-class IoUs at the NMS threshold are separated by more than that —
    the test checks the separation, so no decision can flip.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models.common import letterbox_batch as jax_letterbox
from edgeml_tpu.models.infer import _nms_unmap as jax_nms_unmap
from edgeml_tpu.models.infer import run_detection as jax_run_detection
from edgeml_tpu_torch.models.common import letterbox_batch
from edgeml_tpu_torch.models.infer import _nms_unmap, run_detection

from test_torch_port_yolov5 import carried

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(50, 70), (64, 40), (33, 90), (64, 64), (120, 96)]


def ragged_images(seed):
    rng = np.random.default_rng(seed)
    return [rng.random(s + (3,)).astype(np.float32) for s in SHAPES]


def test_letterbox_matches_jax():
    imgs = ragged_images(0) + [
        np.random.default_rng(1).random((480, 640, 3)).astype(np.float32)]
    for size in (64, 640):
        want, wmeta = jax_letterbox(imgs, size)
        got, meta = letterbox_batch(imgs, size)
        np.testing.assert_array_equal(meta, wmeta)
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() < 2e-6


@pytest.mark.parametrize("bf16", [False, True])
def test_nms_unmap_tail_bit_identical(bf16):
    """JAX predict outputs through both tails: rows and valid identical."""
    imgs = ragged_images(2)
    lb, meta = jax_letterbox(imgs, 64)
    hw = np.array([im.shape[:2] for im in imgs], np.float32)
    jnet, params, stats, _ = carried(4, lb)
    dtype = jnp.bfloat16 if bf16 else None
    pred = jnet.predict(params, stats, jnp.asarray(lb), dtype=dtype)
    kw = dict(conf_thres=1e-3, iou_thres=0.5, max_det=300, multi_label=True)
    d_ref, v_ref = jax_nms_unmap(pred, jnp.asarray(meta), jnp.asarray(hw),
                                 **kw)
    obj, xywh, cls = (np.array(a.astype(jnp.float32)) for a in pred)
    sdt = torch.bfloat16 if bf16 else torch.float32  # exact: bf16 -> f32 -> bf16
    tpred = (torch.from_numpy(obj).to(sdt), torch.from_numpy(xywh),
             torch.from_numpy(cls).to(sdt))
    d, v = _nms_unmap(tpred, torch.from_numpy(meta), torch.from_numpy(hw),
                      **kw)
    assert int(np.asarray(v_ref).sum()) > 20
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))


def test_detect_batch_uint8_equals_float_input():
    """uint8 pixels are normalised on the device as f32 / 255, the same
    values as a host-normalised float batch: identical dets."""
    from edgeml_tpu_torch.models.infer import detect_batch
    from edgeml_tpu_torch.models.yolov5 import YoloV5

    net = YoloV5(num_classes=8, img_size=64,
                 generator=torch.Generator().manual_seed(1))
    px = torch.from_numpy(
        (np.random.default_rng(3).random((2, 64, 64, 3)) * 255)
        .astype(np.uint8))
    meta = torch.tensor([[1.0, 0.0, 0.0]] * 2)
    hw = torch.tensor([[64.0, 64.0]] * 2)
    a = detect_batch(net, px, meta, hw, 1e-6, 0.6)
    b = detect_batch(net, px.to(torch.float32) / 255.0, meta, hw, 1e-6, 0.6)
    assert int(a[1].sum()) > 0
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _assert_separated(jnet, params, stats, lb, conf, iou_thres, margin):
    """No candidate decision of this workload lies within ``margin`` of a
    flip: pair scores above the gate are distinct by more than margin, none
    sits within margin of the gate, and no same-class IoU sits within margin
    of the NMS threshold."""
    obj, xywh, cls = (np.asarray(a) for a in
                      jnet.predict(params, stats, jnp.asarray(lb)))
    total = 0
    for o, x, c in zip(obj, xywh, cls):
        pair = c * o[:, None]
        assert np.abs(pair - conf).min() > margin
        box, col = np.nonzero(pair > conf)
        if box.size < 2:
            total += box.size
            continue
        assert np.diff(np.sort(pair[box, col])).min() > margin
        xyxy = np.concatenate([x[box, :2] - x[box, 2:] / 2,
                               x[box, :2] + x[box, 2:] / 2], 1)
        lo = np.maximum(xyxy[:, None, :2], xyxy[None, :, :2])
        hi = np.minimum(xyxy[:, None, 2:], xyxy[None, :, 2:])
        inter = np.prod(np.clip(hi - lo, 0, None), -1)
        area = np.prod(xyxy[:, 2:] - xyxy[:, :2], -1)
        iou = inter / (area[:, None] + area[None, :] - inter)
        same = col[:, None] == col[None, :]
        assert np.abs(iou[same] - iou_thres).min() > margin
        total += box.size
    return total


def test_run_detection_matches_jax(tmp_path):
    """The slice end to end: JAX run_detection and the port's
    run_detection(device="cpu") on 5 ragged images with carried weights."""
    imgs = ragged_images(3)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, im in enumerate(imgs):
        np.save(img_dir / f"im{i}.npy", im)
    lb, _ = jax_letterbox(imgs, 64)
    jnet, params, stats, net = carried(9, lb)
    conf, iou = 0.2, 0.5
    n_cand = _assert_separated(jnet, params, stats, lb, conf, iou, 2e-5)
    assert n_cand > 50
    kw = dict(batch_size=2, conf_thres=conf, iou_thres=iou, img_size=64)
    jax_run_detection(jnet, params, stats, str(img_dir),
                      str(tmp_path / "jax"), **kw)
    run_detection(net, str(img_dir), str(tmp_path / "port"), device="cpu",
                  **kw)
    rows = 0
    for i in range(len(imgs)):
        want = np.load(tmp_path / "jax" / f"im{i}.npy")
        got = np.load(tmp_path / "port" / f"im{i}.npy")
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 5], want[:, 5], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[:, 1:5], want[:, 1:5], atol=1e-4,
                                   rtol=0)
        rows += got.shape[0]
    assert rows > 10


def test_detect_cli_writes_files(tmp_path):
    """python -m edgeml_tpu_torch.cli.detect --device cpu on 2 small images
    writes one .npy and one .txt per image."""
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(7)
    np.save(img_dir / "a.npy", (rng.random((48, 64, 3)) * 255).astype(np.uint8))
    np.save(img_dir / "b.npy", rng.random((80, 40, 3)).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    base = [sys.executable, "-m", "edgeml_tpu_torch.cli.detect",
            str(img_dir)]
    for fmt in ("npy", "txt"):
        out = tmp_path / fmt
        subprocess.run(
            base + [str(out), "--model", "yolov5n", "--device", "cpu",
                    "--batch-size", "2", "--conf-thres", "1e-6",
                    "--format", fmt],
            check=True, cwd=REPO, env=env, timeout=300)
        assert sorted(os.listdir(out)) == [f"a.{fmt}", f"b.{fmt}"]
    rows = np.load(tmp_path / "npy" / "a.npy")
    assert rows.ndim == 2 and rows.shape[1] == 6 and rows.shape[0] > 0
    assert np.all((rows[:, 1:5] >= 0) & (rows[:, 1:5] <= 1))
    assert np.all(np.diff(rows[:, 5]) <= 0)  # conf descending
    lines = (tmp_path / "txt" / "a.txt").read_text().splitlines()
    assert len(lines) == rows.shape[0]
    first = lines[0].split()
    assert int(first[0]) == int(rows[0, 0])
    assert first[5] == f"{rows[0, 5]:.6f}"


def test_detect_cli_refuses_unported_family(tmp_path):
    """A detector family the port does not have exits with a message (all
    of the reference's families are ported; this one is not among them)."""
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    res = subprocess.run(
        [sys.executable, "-m", "edgeml_tpu_torch.cli.detect", str(img_dir),
         str(tmp_path / "out"), "--model", "yolov8n", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert res.returncode != 0
    assert "not yet ported" in res.stderr


@pytest.mark.parametrize("model", ["ssd", "retinanet", "faster_rcnn"])
def test_detect_cli_torchvision_families_write_files(tmp_path, model):
    """python -m edgeml_tpu_torch.cli.detect --model ssd|retinanet|
    faster_rcnn --device cpu (random weights, full width) writes one file
    per image of rows in
    the compact 80-class space (the COCO 91 -> 80 map applied)."""
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(8)
    np.save(img_dir / "a.npy", (rng.random((48, 64, 3)) * 255).astype(np.uint8))
    np.save(img_dir / "b.npy", rng.random((80, 40, 3)).astype(np.float32))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = tmp_path / "out"
    subprocess.run(
        [sys.executable, "-m", "edgeml_tpu_torch.cli.detect", str(img_dir),
         str(out), "--model", model, "--device", "cpu", "--batch-size", "2"],
        check=True, cwd=REPO, env=env, timeout=300)
    assert sorted(os.listdir(out)) == ["a.npy", "b.npy"]
    for name in ("a.npy", "b.npy"):
        rows = np.load(out / name)
        assert rows.ndim == 2 and rows.shape[1] == 6 and rows.shape[0] > 0
        assert np.all((rows[:, 0] >= 0) & (rows[:, 0] < 80))
        assert np.all(rows[:, 0] == np.round(rows[:, 0]))
        assert np.all((rows[:, 1:5] >= 0) & (rows[:, 1:5] <= 1))
        assert np.all(np.diff(rows[:, 5]) <= 0)  # conf descending
