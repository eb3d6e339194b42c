"""The detect CLI's ``--int8`` (and ``--int8 --bf16``) on the CPU, the
families that refuse int8 as the JAX package refuses them, and the YOLOv5
float paths unchanged by the shared graph walk (``YoloV5.walk``) and the
shared anchor decode (``YoloV5.decode_level_split``) that int8 serving
brought.

Tolerances: none. The CLI runs check the files' contract; the refusals
check the error; the float paths are compared bit for bit with the code
they replaced, copied here.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edgeml_tpu.models.faster_rcnn import FasterRCNN as JaxFasterRCNN
from edgeml_tpu.models.infer import run_detection as jax_run_detection
from edgeml_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from edgeml_tpu_torch.models.faster_rcnn import FasterRCNN
from edgeml_tpu_torch.models.infer import run_detection
from edgeml_tpu_torch.models.retinanet import RetinaNet
from edgeml_tpu_torch.models.yolov5 import HEAD_STAGES, STRIDES, YoloV5

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(root):
    img_dir = root / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(7)
    np.save(img_dir / "a.npy", (rng.random((48, 64, 3)) * 255)
            .astype(np.uint8))
    np.save(img_dir / "b.npy", rng.random((80, 40, 3)).astype(np.float32))
    return img_dir


def _cli(img_dir, out, *flags, check=True):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "edgeml_tpu_torch.cli.detect", str(img_dir),
         str(out), "--device", "cpu", "--batch-size", "2", *flags],
        check=check, cwd=REPO, env=env, timeout=300, capture_output=True,
        text=True)


@pytest.mark.parametrize("flags", [
    ("--model", "yolov5n", "--int8", "--conf-thres", "1e-6"),
    ("--model", "yolov5n", "--int8", "--bf16", "--conf-thres", "1e-6"),
    ("--model", "ssd", "--int8"),
], ids=["yolov5n-int8", "yolov5n-int8-bf16", "ssd-int8"])
def test_detect_cli_int8_writes_files(tmp_path, flags):
    """Full width, random weights: one .npy per image stem (the JAX CLI's
    file set), rows of 6 in the compact 80-class space, conf descending in
    (0, 1], boxes normalised."""
    img_dir = _images(tmp_path)
    out = tmp_path / "out"
    _cli(img_dir, out, *flags)
    assert sorted(os.listdir(out)) == ["a.npy", "b.npy"]
    total = 0
    for name in ("a.npy", "b.npy"):
        rows = np.load(out / name)
        assert rows.ndim == 2 and rows.shape[1] == 6
        assert rows.dtype == np.float32 and np.isfinite(rows).all()
        assert np.all((rows[:, 0] >= 0) & (rows[:, 0] < 80))
        assert np.all(rows[:, 0] == np.round(rows[:, 0]))
        assert np.all((rows[:, 1:5] >= 0) & (rows[:, 1:5] <= 1))
        assert np.all((rows[:, 5] > 0) & (rows[:, 5] <= 1))
        assert np.all(np.diff(rows[:, 5]) <= 0)
        total += len(rows)
    assert total > 0


@pytest.mark.parametrize("family", ["retinanet", "faster_rcnn"])
def test_int8_refused_as_in_jax(tmp_path, family):
    """RetinaNet and Faster R-CNN have no int8 path: run_detection raises
    the JAX package's ValueError (tests/test_quant.py
    test_int8_rejected_for_unsupported_family) before anything runs, and
    the CLI's --int8 exits with it."""
    jnet, net = {"retinanet": (JaxRetinaNet, RetinaNet),
                 "faster_rcnn": (JaxFasterRCNN, FasterRCNN)}[family]
    with pytest.raises(ValueError, match="int8") as want:
        jax_run_detection(jnet(num_classes=7, image_size=256), {}, {},
                          str(tmp_path), str(tmp_path / "jax"), dtype="int8")
    for dtype in ("int8", "int8-bf16"):
        with pytest.raises(ValueError, match="int8") as got:
            run_detection(net(num_classes=7, image_size=64), str(tmp_path),
                          str(tmp_path / "port"), dtype=dtype, device="cpu")
        assert str(got.value) == str(want.value)
    assert not (tmp_path / "port").exists()
    res = _cli(_images(tmp_path), tmp_path / "out", "--model", family,
               "--int8", check=False)
    assert res.returncode != 0
    assert str(want.value) in res.stderr
    assert not (tmp_path / "out").exists()


# ---- the float paths before the shared walk and decode, copied ----------

def _old_walk(net, x):
    from edgeml_tpu_torch.models.common import upsample2x

    outputs = {}
    y = x
    for idx, kind, src, _ in net.layers():
        if kind in ("conv", "c3", "sppf"):
            y = net.model[idx](y)
        elif kind == "up":
            y = upsample2x(y)
        elif kind == "concat":
            y = torch.cat([y, outputs[src[1]]], 1)
        outputs[idx] = y
    return outputs


@torch.no_grad()
def _old_predict(net, x, dtype=None):
    hdtype = torch.float32 if dtype is None else dtype
    x = x.permute(0, 3, 1, 2).to(hdtype)
    outputs = _old_walk(net, x)
    feats = [outputs[i] for i in HEAD_STAGES]
    det = net.model[24]
    params = det._cast.get(
        [t for conv in det.m for t in (conv.weight, conv.bias)], hdtype)
    na, no, nc = net.na, net.no, net.num_classes
    f32 = torch.float32
    objs, xywhs, clss = [], [], []
    for li, (f, stride, anchors) in enumerate(
            zip(feats, STRIDES, net.anchors)):
        w, bias = params[2 * li], params[2 * li + 1].reshape(na, no)
        h = F.conv2d(f, w)
        b, _, hh, ww = h.shape
        h = h.reshape(b, na, no, hh, ww).permute(0, 3, 4, 1, 2)
        h_xy = h[..., 0:2].to(f32) + bias[:, 0:2].to(f32)
        h_wh = h[..., 2:4].to(f32) + bias[:, 2:4].to(f32)
        h_obj = h[..., 4] + bias[:, 4]
        h_cls = h[..., 5:] + bias[:, 5:]
        gy, gx = torch.meshgrid(
            torch.arange(hh, dtype=f32, device=h.device),
            torch.arange(ww, dtype=f32, device=h.device), indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)
        anc = torch.tensor(anchors, dtype=f32, device=h.device)
        xy = (torch.sigmoid(h_xy) * 2.0 - 0.5 + grid[:, :, None, :]) \
            * stride
        wh = (torch.sigmoid(h_wh) * 2.0) ** 2 * anc[None, None, :, :]
        xywhs.append(torch.cat([xy, wh], -1).reshape(b, -1, 4))
        objs.append(torch.sigmoid(h_obj).reshape(b, -1))
        clss.append(torch.sigmoid(h_cls).reshape(b, -1, nc))
    return torch.cat(objs, 1), torch.cat(xywhs, 1), torch.cat(clss, 1)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_predict_and_walk_unchanged(dtype):
    """predict (trunk, head, decode) and every stage of _walk, bit for bit
    against the code before the refactor, on a seeded YOLOv5n with spread
    head biases."""
    g = torch.Generator().manual_seed(3)
    net = YoloV5(num_classes=8, img_size=64, generator=g)
    with torch.no_grad():
        for conv in net.model[24].m:
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=g))
    x = torch.from_numpy(np.random.default_rng(4).random((2, 64, 64, 3))
                         .astype(np.float32))
    for got, want in zip(net.predict(x, dtype=dtype),
                         _old_predict(net, x, dtype=dtype)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    xt = x.permute(0, 3, 1, 2).to(dtype or torch.float32)
    with torch.no_grad():
        new, old = net._walk(xt), _old_walk(net, xt)
    assert sorted(new) == sorted(old) == list(range(24))
    for idx in old:
        assert torch.equal(new[idx], old[idx]), idx
