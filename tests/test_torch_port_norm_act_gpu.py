"""The eval-norm and activation kernel (``csrc/norm_act.cu``) on a CUDA
device: against its plain version (``ops/norm_act.py norm_act_plain``, the
op sequence) for every activation in f32 and bf16, at YOLOv5n's plane sizes,
Faster R-CNN's box head (2,000 RoIs x 256 x 7 x 7), C = 1, H x W = 1 and
odd planes, contiguous and channels-last; and on the main paths: one YOLOv5n
frame through ``detect_batch`` launches it once for each of the 57 conv
blocks and serves the rows the plain sequence serves, one Faster R-CNN batch
launches it 12 times (8 FPN and 4 box-head blocks).

Marked ``gpu``; the ``cuda`` fixture skips every test where no CUDA device is
present (decided when the test runs, never at import). Run on the card with

    python -m pytest tests/test_torch_port_norm_act_gpu.py -m gpu -q

Tolerance: none. Values are compared bit for bit, NaN by position.
"""

import numpy as np
import pytest
import torch

from edgeml_tpu_torch.models import common
from edgeml_tpu_torch.ops.norm_act import (
    norm_act, norm_act_cuda, norm_act_plain,
)

pytestmark = pytest.mark.gpu

ACTS = [None, "relu", "relu6", "hardswish", "silu"]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SHAPES = {
    "yolo_320": (1, 16, 320, 320),
    "yolo_160": (1, 32, 160, 160),
    "yolo_80": (1, 64, 80, 80),
    "yolo_40": (1, 128, 40, 40),
    "yolo_20": (1, 256, 20, 20),
    "box_head": (2000, 256, 7, 7),
    "c1": (2, 1, 64, 64),
    "hw1": (4, 8, 1, 1),
    "odd": (3, 5, 7, 9),
    "hw144": (2, 8, 12, 12),
    "c12": (2, 12, 9, 9),  # 16-byte rows in f32, not in bf16
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def case(shape, dtype, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    y = torch.randn(shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed)) * 4
    flat = y.view(-1)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"),
                             -3.0, 3.0, 0.0, -0.0, 1e-30, -1e-30, 88.0,
                             -88.0, 6.0])
    flat[:min(flat.numel(), specials.numel())] = \
        specials[:flat.numel()].to(dev)
    m = torch.randn(c, generator=gen)
    v = torch.rand(c, generator=gen) * 2 + 1e-3
    g = torch.randn(c, generator=gen)
    b = torch.randn(c, generator=gen)
    return [t.to(dev, dtype) for t in (y, m, v, g, b)]


def assert_same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    it = torch.int32 if got.dtype == torch.float32 else torch.int16
    differ = torch.where(nan, False, got.view(it) != want.view(it))
    if differ.any():
        gap = torch.where(differ, (got.float() - want.float()).abs(), 0.0)
        raise AssertionError(f"{int(differ.sum())} of {differ.numel()} "
                             f"values differ, the largest by "
                             f"{float(gap.max())}")


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ACTS)
def test_kernel_equals_plain(cuda, act, dtype, shape, layout):
    """Both layouts: the port's convs return channels-last maps on the card
    (its inputs are permuted NHWC), so the serving paths take that one."""
    y, m, v, g, b = case(SHAPES[shape], DTYPES[dtype], cuda)
    if layout == "channels_last":
        y = y.to(memory_format=torch.channels_last)
    eps = 1e-5 if shape == "box_head" else 1e-3
    want = norm_act_plain(y, m, v, g, b, eps, act)
    before = norm_act_cuda.launches
    out = y.clone()
    got = norm_act(out, m, v, g, b, eps, act)
    torch.cuda.synchronize()
    assert norm_act_cuda.launches == before + 1
    assert got.data_ptr() == out.data_ptr()  # in place
    assert_same(got, want)


def test_kernel_refuses_mixed_devices(cuda):
    y, m, v, g, b = case((1, 4, 8, 8), torch.float32, cuda)
    with pytest.raises(ValueError, match="per-channel"):
        norm_act_cuda(y, m.cpu(), v, g, b, 1e-3, "relu")
    with pytest.raises(ValueError, match="contiguous"):
        norm_act_cuda(y.transpose(2, 3), m, v, g, b, 1e-3, "relu")


def _plain_blocks(monkeypatch):
    """Serve with the plain op sequence in place of the kernel."""
    monkeypatch.setattr(common, "norm_act", norm_act_plain)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_yolov5n_frame_launches_once_per_block(cuda, dtype, monkeypatch):
    from edgeml_tpu_torch.models.infer import detect_batch
    from edgeml_tpu_torch.models.yolov5 import YoloV5, calibrate_bn

    net = YoloV5("n", num_classes=80, img_size=640,
                 generator=torch.Generator().manual_seed(0)).to(cuda)
    rng = np.random.default_rng(1)
    calib = torch.from_numpy(rng.random((2, 640, 640, 3), np.float32)).to(
        cuda)
    calibrate_bn(net, lambda i: calib, iters=1)
    frame = torch.from_numpy(rng.random((1, 640, 640, 3), np.float32)).to(
        cuda)
    meta = torch.tensor([[1.0, 0.0, 0.0]], device=cuda)
    hw = torch.tensor([[640.0, 640.0]], device=cuda)
    blocks = sum(isinstance(m, common.ConvBN) for m in net.modules())
    assert blocks == 57
    before = norm_act_cuda.launches
    dets, valid = detect_batch(net, frame, meta, hw, 1e-3, 0.6, dtype=dtype)
    torch.cuda.synchronize()
    assert norm_act_cuda.launches == before + blocks
    _plain_blocks(monkeypatch)
    p_dets, p_valid = detect_batch(net, frame, meta, hw, 1e-3, 0.6,
                                   dtype=dtype)
    assert norm_act_cuda.launches == before + blocks
    assert int(valid.sum()) > 0
    assert torch.equal(valid, p_valid) and torch.equal(dets, p_dets)


def test_faster_rcnn_batch_launches_12(cuda, monkeypatch):
    from edgeml_tpu_torch.models import faster_rcnn as tfr

    net = tfr.FasterRCNN(num_classes=91, image_size=640,
                         generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 640, 640, 3)).astype(np.float32)).to(cuda)
    before = norm_act_cuda.launches
    with torch.no_grad():
        dets, valid = net.detect(x, 0.001, 0.5)
    torch.cuda.synchronize()
    assert norm_act_cuda.launches == before + 12
    _plain_blocks(monkeypatch)
    with torch.no_grad():
        p_dets, p_valid = net.detect(x, 0.001, 0.5)
    assert norm_act_cuda.launches == before + 12
    assert torch.equal(valid, p_valid) and torch.equal(dets, p_dets)
