"""The port on a CUDA device: the suppressor kernels (monolithic, K <= 1024;
blocked, K <= 2048) against their plain versions, and the serving slices
(YOLOv5, SSDLite) through them.

Marked ``gpu``; the ``cuda`` fixture skips every test where no CUDA device is
present (decided when the test runs, never at import). Run on the card with

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q

Tolerance: none — kernel and plain masks and the dets of the kernel and plain
tails are compared bit for bit.
"""

import numpy as np
import pytest
import torch

from edgeml_tpu_torch.ops import nms as tnms
from edgeml_tpu_torch.ops.nms_fused import (
    greedy_keep_mask_blocked_cuda, greedy_keep_mask_blocked_plain,
    greedy_keep_mask_cuda, greedy_keep_mask_fused, greedy_keep_mask_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def fuzz(seed, b, k, spread, ncls):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(20, 20 + spread, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(30, 150, (b, k, 2)).astype(np.float32)
    scores = np.sort(rng.random((b, k)).astype(np.float32),
                     axis=-1)[:, ::-1].copy()
    scores[scores < 0.05] = 0.0
    cls = rng.integers(0, ncls, (b, k)).astype(np.float32)
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], axis=-1)
    off = (boxes + cls[..., None] * np.float32(tnms.MAX_WH)).astype(np.float32)
    return torch.from_numpy(off), torch.from_numpy(scores)


@pytest.mark.parametrize("k", [1024, 1000, 256, 33])
@pytest.mark.parametrize("thr", [0.6, 0.45])
@pytest.mark.parametrize("seed,spread,ncls",
                         [(0, 80.0, 1), (1, 300.0, 4), (2, 2000.0, 80)])
def test_kernel_equals_plain(cuda, seed, spread, ncls, thr, k):
    boxes, scores = fuzz(seed, 8, k, spread, ncls)
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    before = greedy_keep_mask_cuda.launches
    got = greedy_keep_mask_fused(boxes, scores, thr)
    torch.cuda.synchronize()
    assert greedy_keep_mask_cuda.launches == before + 1
    want = greedy_keep_mask_plain(boxes, scores, thr)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), greedy_keep_mask_plain(
        boxes.cpu(), scores.cpu(), thr))


@pytest.mark.parametrize("k", [2048, 1536, 1280, 1025])
@pytest.mark.parametrize("thr", [0.6, 0.45])
@pytest.mark.parametrize("seed,spread,ncls",
                         [(0, 80.0, 1), (1, 300.0, 4), (2, 2000.0, 80)])
def test_blocked_kernel_equals_plain(cuda, seed, spread, ncls, thr, k):
    """K in (1024, 2048] goes to the blocked kernel, equal to the blocked
    and the global plain versions."""
    boxes, scores = fuzz(seed, 8, k, spread, ncls)
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    before = (greedy_keep_mask_cuda.launches,
              greedy_keep_mask_blocked_cuda.launches)
    got = greedy_keep_mask_fused(boxes, scores, thr)
    torch.cuda.synchronize()
    assert (greedy_keep_mask_cuda.launches,
            greedy_keep_mask_blocked_cuda.launches) == (before[0],
                                                        before[1] + 1)
    assert torch.equal(got, greedy_keep_mask_blocked_plain(boxes, scores, thr))
    assert torch.equal(got, greedy_keep_mask_plain(boxes, scores, thr))


@pytest.mark.parametrize("k", [1, 33, 256, 1024])
def test_blocked_kernel_small_k(cuda, k):
    """The blocked kernel takes any K <= 2048 (a partial last band)."""
    boxes, scores = fuzz(3, 4, k, 300.0, 4)
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    got = greedy_keep_mask_blocked_cuda(boxes.contiguous(),
                                        (scores > 0).contiguous(), 0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, greedy_keep_mask_plain(boxes, scores, 0.5))


def test_kernel_rejects_large_k(cuda):
    """K > 2048 raises on CUDA (no kernel takes it, and nothing falls back);
    K = 1025 rides the blocked kernel."""
    boxes, scores = fuzz(0, 1, 2049, 300.0, 4)
    with pytest.raises(ValueError, match="2049"):
        greedy_keep_mask_fused(boxes.to(cuda), scores.to(cuda), 0.6)
    boxes, scores = fuzz(0, 1, 1025, 300.0, 4)
    before = greedy_keep_mask_blocked_cuda.launches
    greedy_keep_mask_fused(boxes.to(cuda), scores.to(cuda), 0.6)
    assert greedy_keep_mask_blocked_cuda.launches == before + 1


def test_serving_tail_kernel_equals_plain(cuda):
    rng = np.random.default_rng(5)
    b, n, nc = 4, 4000, 80
    obj = torch.from_numpy(rng.random((b, n)).astype(np.float32)).to(cuda)
    xywh = torch.from_numpy(np.stack(
        [rng.uniform(50, 600, (b, n)), rng.uniform(50, 600, (b, n)),
         rng.uniform(5, 120, (b, n)), rng.uniform(5, 120, (b, n))],
        -1).astype(np.float32)).to(cuda)
    cls = torch.from_numpy(
        (rng.random((b, n, nc)) ** 4).astype(np.float32)).to(cuda)
    d, v = tnms.nms_split_batch(obj, xywh, cls, 1e-3, 0.6)
    cand, top, ci = tnms.candidates(obj, xywh, cls, 1e-3, 1024)
    kept = greedy_keep_mask_plain(cand + ci[..., None] * tnms.MAX_WH, top,
                                  0.6)
    d_plain, v_plain = tnms._compact(cand, top, ci, kept, 300)
    assert torch.equal(v, v_plain) and torch.equal(d, d_plain)
    # and the CPU path gives the same rows
    d_cpu, v_cpu = tnms.nms_split_batch(obj.cpu(), xywh.cpu(), cls.cpu(),
                                        1e-3, 0.6)
    assert torch.equal(v.cpu(), v_cpu) and torch.equal(d.cpu(), d_cpu)


def test_run_detection_on_cuda(cuda, tmp_path):
    from edgeml_tpu_torch.models.infer import run_detection
    from edgeml_tpu_torch.models.yolov5 import YoloV5

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        np.save(img_dir / f"im{i}.npy",
                (rng.random((120, 90 + 10 * i, 3)) * 255).astype(np.uint8))
    net = YoloV5(num_classes=8, img_size=128,
                 generator=torch.Generator().manual_seed(0))
    before = greedy_keep_mask_cuda.launches
    run_detection(net, str(img_dir), str(tmp_path / "out"), batch_size=2,
                  conf_thres=1e-6, img_size=128)
    assert greedy_keep_mask_cuda.launches == before + 3  # one per batch
    for i in range(5):
        a = np.load(tmp_path / "out" / f"im{i}.npy")
        assert a.shape[1] == 6 and a.shape[0] > 0
        assert np.all((a[:, 1:5] >= 0) & (a[:, 1:5] <= 1))


def test_ssd_tail_kernel_equals_plain(cuda):
    """max_cand = 2048 (the SSDLite/RetinaNet tail) on the card: the
    blocked kernel's dets equal the plain tail's and the CPU's."""
    rng = np.random.default_rng(6)
    b, n, nc = 4, 3234, 20
    obj = torch.ones(b, n, device=cuda)
    xywh = torch.from_numpy(np.stack(
        [rng.uniform(20, 300, (b, n)), rng.uniform(20, 300, (b, n)),
         rng.uniform(5, 90, (b, n)), rng.uniform(5, 90, (b, n))],
        -1).astype(np.float32)).to(cuda)
    cls = torch.from_numpy(rng.dirichlet(np.ones(nc), (b, n)).astype(
        np.float32)).to(cuda)
    before = greedy_keep_mask_blocked_cuda.launches
    d, v = tnms.nms_split_batch(obj, xywh, cls, 1e-3, 0.55, max_cand=2048)
    assert greedy_keep_mask_blocked_cuda.launches == before + 1
    cand, top, ci = tnms.candidates(obj, xywh, cls, 1e-3, 2048)
    assert top.shape == (b, 2048)
    kept = greedy_keep_mask_blocked_plain(
        cand + ci[..., None] * tnms.MAX_WH, top, 0.55)
    d_plain, v_plain = tnms._compact(cand, top, ci, kept, 300)
    assert torch.equal(v, v_plain) and torch.equal(d, d_plain)
    d_cpu, v_cpu = tnms.nms_split_batch(obj.cpu(), xywh.cpu(), cls.cpu(),
                                        1e-3, 0.55, max_cand=2048)
    assert torch.equal(v.cpu(), v_cpu) and torch.equal(d.cpu(), d_cpu)


def test_ssdlite_run_detection_on_cuda(cuda, tmp_path):
    """SSDLite serving on the card goes through the blocked kernel, one
    launch per batch (K = 2048), and writes every file."""
    from edgeml_tpu_torch.models.infer import run_detection
    from edgeml_tpu_torch.models.ssdlite import SSDLite

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(1)
    for i in range(5):
        np.save(img_dir / f"im{i}.npy",
                (rng.random((120, 90 + 10 * i, 3)) * 255).astype(np.uint8))
    net = SSDLite(num_classes=5, image_size=160,
                  generator=torch.Generator().manual_seed(0))
    before = greedy_keep_mask_blocked_cuda.launches
    run_detection(net, str(img_dir), str(tmp_path / "out"), batch_size=2,
                  conf_thres=1e-6, class_map={1: 0, 2: 1, 3: 2, 4: 3})
    assert greedy_keep_mask_blocked_cuda.launches == before + 3
    for i in range(5):
        a = np.load(tmp_path / "out" / f"im{i}.npy")
        assert a.shape[1] == 6 and a.shape[0] > 0
        assert np.all((a[:, 1:5] >= 0) & (a[:, 1:5] <= 1))
        assert np.all((a[:, 0] >= 0) & (a[:, 0] < 4))
