"""The port on a CUDA device: the suppressor kernel against its plain
version, and the serving slice through the kernel.

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
    scores = np.ascontiguousarray(
        np.sort(rng.random((b, k)).astype(np.float32), axis=-1)[:, ::-1])
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


def test_kernel_rejects_large_k(cuda):
    boxes, scores = fuzz(0, 1, 1025, 300.0, 4)
    with pytest.raises(ValueError, match="1025"):
        greedy_keep_mask_fused(boxes.to(cuda), scores.to(cuda), 0.6)


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
