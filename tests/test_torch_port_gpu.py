"""The port on a CUDA device: the suppressor kernels (monolithic, K <= 1024;
blocked, K <= 2048; sequential, per segment K <= 1024) and the row-gather
kernel against their plain versions, and the serving slices (YOLOv5,
SSDLite, Faster R-CNN) through them.

Marked ``gpu``; the ``cuda`` fixture skips every test where no CUDA device is
present (decided when the test runs, never at import). Run on the card with

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q

Tolerance: none — kernel and plain masks and the dets of the kernel and plain
tails are compared bit for bit.
"""

import numpy as np
import pytest
import torch

from edgeml_tpu_torch.models import faster_rcnn as tfr
from edgeml_tpu_torch.ops import nms as tnms
from edgeml_tpu_torch.ops.gather import (
    gather_rows, gather_rows_cuda, gather_rows_plain, vector_path,
)
from edgeml_tpu_torch.ops.nms_fused import (
    greedy_keep_mask_blocked_cuda, greedy_keep_mask_blocked_plain,
    greedy_keep_mask_cuda, greedy_keep_mask_fused, greedy_keep_mask_plain,
)
from edgeml_tpu_torch.ops.nms_seq import (
    suppress_mask_seq, suppress_mask_seq_cuda, suppress_mask_seq_plain,
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


@pytest.mark.parametrize("k", [1024, 1000, 300, 257, 256, 33, 1])
@pytest.mark.parametrize("thr", [0.6, 0.45])
@pytest.mark.parametrize("seed,spread,ncls",
                         [(0, 80.0, 1), (1, 300.0, 4), (2, 2000.0, 80)])
def test_kernel_equals_plain(cuda, seed, spread, ncls, thr, k):
    """K <= 1024 goes to the monolithic kernel (a cluster of 4 bands of
    256, partial bands and words at ragged K), equal to the global plain
    version on the card and on the CPU."""
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


@pytest.mark.parametrize("b", [1, 16, 64, 80, 200])
@pytest.mark.parametrize("case", ["fuzz", "holes", "thr0", "thr_negative",
                                  "thr1", "ties"])
def test_kernel_edge_cases(cuda, case, b):
    """The monolithic kernel at K = 1024 (the YOLOv5 tail's shape at B =
    64) on one image, 16, 64, 80 and more images than the card holds
    clusters at once: an all-invalid image, invalid holes (one across a
    band's edge), whole leading bands invalid, thr = 0 (any overlap
    suppresses), thr < 0 (disjoint pairs too), thr = 1 (nothing does) and
    exact IoU ties at the threshold. Equal to the blocked and the global
    plain versions."""
    k, thr = 1024, {"thr0": 0.0, "thr_negative": -0.5, "thr1": 1.0}.get(
        case, 0.6)
    boxes, scores = fuzz(b + len(case), b, k, 300.0, 4)
    if case == "holes":
        scores[0, 100:300] = 0.0
        scores[-1, 5] = 0.0
        scores[-1, 700:800] = 0.0
        if b > 2:
            scores[1] = 0.0
            scores[2, :600] = 0.0
    elif case == "ties":
        thr = float(np.float32(1) / np.float32(3))
        boxes, scores = tie_boxes(b, b, k)
        boxes[0, 0] = torch.tensor([0.0, 0.0, 3.0, 7.0])
        boxes[0, 1] = torch.tensor([0.0, 0.0, 1.0, 7.0])
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    before = greedy_keep_mask_cuda.launches
    got = greedy_keep_mask_fused(boxes, scores, thr)
    torch.cuda.synchronize()
    assert greedy_keep_mask_cuda.launches == before + 1
    assert torch.equal(got, greedy_keep_mask_blocked_plain(boxes, scores, thr))
    assert torch.equal(got, greedy_keep_mask_plain(boxes, scores, thr))
    if case == "thr1":
        assert torch.equal(got, scores > 0)
    elif case == "holes" and b > 2:
        assert not got[1].any()


@pytest.mark.parametrize("b", [8, 24])
@pytest.mark.parametrize("k", [2048, 2047, 1537, 1536, 1280, 1025])
@pytest.mark.parametrize("thr", [0.6, 0.45])
@pytest.mark.parametrize("seed,spread,ncls",
                         [(0, 80.0, 1), (1, 300.0, 4), (2, 2000.0, 80)])
def test_blocked_kernel_equals_plain(cuda, seed, spread, ncls, thr, k, b):
    """K in (1024, 2048] goes to the blocked kernel, equal to the blocked
    and the global plain versions."""
    boxes, scores = fuzz(seed, b, k, spread, ncls)
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


@pytest.mark.parametrize("b", [1, 16, 64, 200])
def test_blocked_kernel_batch_sizes(cuda, b):
    """One image, the RetinaNet / Faster R-CNN and SSDLite batches, and more
    images than the card holds clusters at once."""
    boxes, scores = fuzz(b, b, 2048, 300.0, 4)
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    got = greedy_keep_mask_fused(boxes, scores, 0.6)
    torch.cuda.synchronize()
    assert torch.equal(got, greedy_keep_mask_blocked_plain(boxes, scores, 0.6))
    assert 0 < int(got.sum()) < int((scores > 0).sum())


@pytest.mark.parametrize("b", [6, 40])
@pytest.mark.parametrize("k", [2048, 2047, 1025, 300])
@pytest.mark.parametrize("thr", [0.6, 0.0, -0.5])
def test_blocked_kernel_invalid_candidates(cuda, k, thr, b):
    """An all-invalid image, invalid holes inside the valid prefix (one
    across a band's edge), whole leading bands invalid and a single valid
    candidate; at thr = 0 any overlap suppresses, below 0 disjoint pairs do
    too (the kernel's disjoint-pair shortcut must not apply there)."""
    boxes, scores = fuzz(7 + k, b, k, 300.0, 4)
    scores[0] = 0.0
    scores[1, 100:300] = 0.0
    scores[2, 5] = 0.0
    scores[2, k // 2:k // 2 + 100] = 0.0
    scores[3, :min(600, k - 20)] = 0.0
    scores[4, 1:] = 0.0
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    got = greedy_keep_mask_blocked_cuda(boxes, (scores > 0).contiguous(), thr)
    torch.cuda.synchronize()
    assert torch.equal(got, greedy_keep_mask_blocked_plain(boxes, scores, thr))
    assert torch.equal(got, greedy_keep_mask_plain(boxes, scores, thr))
    assert not got[0].any() and got[4].tolist() == [True] + [False] * (k - 1)


def tie_boxes(seed, b, k):
    """Integer-cornered boxes of one class on a small grid: intersections and
    unions are small integers, so many pairs share an IoU exactly and a
    threshold set to one such f32 quotient has compares on it and on either
    side of it."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 24, (b, k, 2))
    wh = rng.integers(1, 13, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = np.sort(rng.random((b, k)).astype(np.float32),
                     axis=-1)[:, ::-1].copy()
    return torch.from_numpy(boxes), torch.from_numpy(scores)


@pytest.mark.parametrize("b", [4, 20])
@pytest.mark.parametrize("k", [1100, 2048])
@pytest.mark.parametrize("num,den", [(6, 10), (1, 3), (1, 2), (2, 3), (1, 4),
                                     (5, 7), (9, 11)])
def test_blocked_kernel_exact_ties(cuda, num, den, k, b):
    """IoU exactly at the threshold does not suppress (strict compare on the
    rounded quotient); the kernel decides most compares without the division
    and must take it here."""
    thr = float(np.float32(num) / np.float32(den))
    boxes, scores = tie_boxes(num * 100 + den, b, k)
    b0, b1 = boxes[0, 0], boxes[0, 1]  # a pair at the threshold, by hand
    b0[:] = torch.tensor([0.0, 0.0, float(den), 7.0])
    b1[:] = torch.tensor([0.0, 0.0, float(num), 7.0])
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    got = greedy_keep_mask_blocked_cuda(boxes, (scores > 0).contiguous(), thr)
    torch.cuda.synchronize()
    assert torch.equal(got, greedy_keep_mask_blocked_plain(boxes, scores, thr))
    assert torch.equal(got, greedy_keep_mask_plain(boxes, scores, thr))
    assert 0 < int(got.sum()) < got.numel()


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


def seq_candidates(seed, s, k, regime):
    """Unsorted candidates of positive area over s segments: dense
    RPN-like overlap, sparse, or tie clusters of saturated 1.0 scores."""
    rng = np.random.default_rng(seed)
    spread = {"dense": 120.0, "sparse": 2000.0, "ties": 300.0}[regime]
    c = rng.uniform(0, spread, (s, k, 2))
    wh = rng.uniform(8, 150, (s, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if regime == "ties":
        logits = rng.choice([30.0, 30.0, 2.0, 0.5, -3.0], (s, k))
        scores = (1 / (1 + np.exp(-logits))).astype(np.float32)
    else:
        scores = rng.random((s, k)).astype(np.float32)
    scores[rng.random((s, k)) < 0.2] = 0.0
    return torch.from_numpy(boxes), torch.from_numpy(scores)


@pytest.mark.parametrize("k", [1024, 1000, 300, 257, 256, 33, 1])
@pytest.mark.parametrize("regime", ["dense", "sparse", "ties"])
@pytest.mark.parametrize("thr", [0.7, 0.5])
def test_seq_kernel_equals_plain(cuda, k, regime, thr):
    """The sequential kernel's kept masks and picks equal the plain loop's
    on the card and on the CPU, at max_keep 8 and K (partial bands and
    words at ragged K)."""
    boxes, scores = seq_candidates(k, 16, k, regime)
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    for max_keep in (8, k):
        before = suppress_mask_seq_cuda.launches
        kept, picks = suppress_mask_seq(boxes, scores, thr, max_keep)
        torch.cuda.synchronize()
        assert suppress_mask_seq_cuda.launches == before + 1
        want_kept, want_picks = suppress_mask_seq_plain(boxes, scores, thr,
                                                        max_keep)
        assert torch.equal(kept, want_kept)
        assert torch.equal(picks, want_picks)
        cpu_kept, cpu_picks = suppress_mask_seq_plain(
            boxes.cpu(), scores.cpu(), thr, max_keep)
        assert torch.equal(kept.cpu(), cpu_kept)
        assert torch.equal(picks.cpu(), cpu_picks)
        if max_keep == k:
            assert torch.equal(kept, tnms.suppress_mask(boxes, scores, thr,
                                                        k))


def seq_edge(case, s, k=1000):
    """(boxes, scores, thr, max_keeps) of one regime the kernel's sorted
    form must get exactly right, over s segments of k candidates."""
    boxes, scores = seq_candidates(k + s + len(case), s, k,
                                   "ties" if case in ("ties", "presorted")
                                   else "dense")
    bx, sc = boxes.numpy(), scores.numpy()
    thr = {"thr1": 1.0, "thr0": 0.0, "thr_negative": -0.5,
           "nan": float("nan")}.get(case, 0.7)
    max_keeps = (k,)
    if case == "sticky":
        rng = np.random.default_rng(s)
        for seg in range(s):
            hit = rng.choice(k, 12, replace=False)
            bx[seg, hit[:4], 2] = bx[seg, hit[:4], 0]  # zero width
            bx[seg, hit[4:8], 3] = bx[seg, hit[4:8], 1]  # zero height
            bx[seg, hit[8:], 0], bx[seg, hit[8:], 2] = \
                bx[seg, hit[8:], 2], bx[seg, hit[8:], 0].copy()  # x2 < x1
            sc[seg, hit[::3]] = np.float32(0.999)  # picked early
        max_keeps = (k, 50)
    elif case == "caps":
        max_keeps = (0, 1, 7)
    elif case == "dead":
        sc[0] = 0.0
        sc[-1, ::2] = 0.0
    elif case == "presorted":
        # a top-k's order: scores descending in index order (saturated ties
        # in index order), dead candidates in between; the kernel takes
        # this order as it is
        live = sc > 0
        sc[:] = -np.sort(-sc, axis=1)
        sc[~live] = 0.0
    return boxes, scores, thr, max_keeps


@pytest.mark.parametrize("s", [1, 16, 64, 80, 200])
@pytest.mark.parametrize("case", ["sticky", "thr1", "thr0", "thr_negative",
                                  "nan", "caps", "dead", "ties",
                                  "presorted"])
def test_seq_kernel_edge_cases(cuda, case, s):
    """The sequential kernel at K = 1000 (the RPN's segment; 80 segments is
    a batch of 16) on 1 to 200 segments (more than the card holds clusters
    at once): sticky picks (zero width, zero height, x2 < x1: the pick is
    never removed, picked at every remaining step), thr = 1 (every box
    sticky), thr = 0, thr < 0, a NaN thr (every pair suppresses, a box
    itself too), caps of 0, 1 and 7, dead segments, saturated 1.0 ties, and
    candidates already in key order (as the RPN's top-k gives them). kept
    and picks equal the plain loop's on the card and on the CPU."""
    boxes, scores, thr, max_keeps = seq_edge(case, s)
    cb, cs = boxes.to(cuda), scores.to(cuda)
    for max_keep in max_keeps:
        before = suppress_mask_seq_cuda.launches
        kept, picks = suppress_mask_seq(cb, cs, thr, max_keep)
        torch.cuda.synchronize()
        assert suppress_mask_seq_cuda.launches == before + 1
        want_kept, want_picks = suppress_mask_seq_plain(cb, cs, thr, max_keep)
        assert torch.equal(kept, want_kept)
        assert torch.equal(picks, want_picks)
        cpu_kept, cpu_picks = suppress_mask_seq_plain(boxes, scores, thr,
                                                      max_keep)
        assert torch.equal(kept.cpu(), cpu_kept)
        assert torch.equal(picks.cpu(), cpu_picks)
        if case in ("sticky", "thr1") and max_keep > 0:
            assert bool((picks[:, -1] >= 0).all())  # a pick repeats
        if case == "dead":
            assert not kept[0].any() and bool((picks[0] == -1).all())


def test_seq_kernel_rejects_large_k(cuda):
    boxes, scores = seq_candidates(0, 2, 1025, "sparse")
    before = suppress_mask_seq_cuda.launches
    with pytest.raises(ValueError, match="1025"):
        suppress_mask_seq(boxes.to(cuda), scores.to(cuda), 0.7, 10)
    assert suppress_mask_seq_cuda.launches == before


@pytest.mark.parametrize("src_dt,scale_dt", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("c", [1, 3, 4, 8, 80, 91])
@pytest.mark.parametrize("idx_dt", [torch.int32, torch.int64])
def test_gather_kernel_equals_plain(cuda, src_dt, scale_dt, c, idx_dt):
    rng = np.random.default_rng(c)
    b, n, k = 3, 5000, 700
    src = torch.from_numpy(rng.normal(0, 1, (b, n, c)).astype(
        np.float32)).to(cuda, src_dt)
    idx = torch.from_numpy(rng.integers(0, n, (b, k))).to(cuda, idx_dt)
    scale = None if scale_dt is None else torch.from_numpy(
        rng.random((b, n)).astype(np.float32)).to(cuda, scale_dt)
    before = gather_rows_cuda.launches
    got = gather_rows(src, idx, scale)
    torch.cuda.synchronize()
    assert gather_rows_cuda.launches == before + 1
    want = gather_rows_plain(src, idx, scale)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(got.cpu(), gather_rows_plain(
        src.cpu(), idx.cpu(), None if scale is None else scale.cpu()))


def _vector(src, scale=None):
    """The path the wrapper takes for this source (the output of
    ``torch.empty`` is aligned)."""
    return vector_path(src.dtype, None if scale is None else scale.dtype,
                       src.shape[2], src.stride(0), src.stride(1),
                       src.data_ptr(), 0)


def test_gather_kernel_strided_sources(cuda):
    """An expanded source (image stride 0), a channel slice (row stride > C,
    rows off the 16-byte grid), a misaligned base, a row-strided aligned
    view, a non-contiguous index and K = 1 are read in place, on the path
    their alignment allows."""
    rng = np.random.default_rng(9)
    anc = torch.from_numpy(rng.random((900, 4)).astype(np.float32)).to(cuda)
    wide = torch.from_numpy(rng.random((3, 900, 91)).astype(
        np.float32)).to(cuda)
    wide96 = torch.from_numpy(rng.random((3, 900, 96)).astype(
        np.float32)).to(cuda)
    flat = torch.from_numpy(rng.random(3 * 900 * 4 + 1).astype(
        np.float32)).to(cuda)
    half = torch.from_numpy(rng.random((3, 900, 88)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, 900, (3, 256))).to(cuda)
    idx_t = torch.from_numpy(rng.integers(0, 900, (256, 3))).to(cuda).t()
    assert not idx_t.is_contiguous()
    cases = [(anc.expand(3, -1, -1), True), (wide[..., 1:], False),
             (flat[1:].view(3, 900, 4), False), (flat[:-1].view(3, 900, 4),
                                                 True),
             (wide96[..., 4:12], True), (wide96[..., 3:11], False),
             (anc[:1].expand(3, 900, 4), True), (half[..., 8:88], True),
             (half[..., 4:84], False)]
    for src, vec in cases:
        assert _vector(src) == vec
        for ix in (idx, idx_t, idx[:, :1]):
            assert torch.equal(gather_rows(src, ix),
                               gather_rows_plain(src, ix))
    scale = torch.from_numpy(rng.random((3, 900)).astype(np.float32)).to(cuda)
    for src, _ in cases[:6]:
        assert torch.equal(gather_rows(src, idx_t, scale.t().contiguous().t()),
                           gather_rows_plain(src, idx_t, scale))


class _Plain:
    """Route the Faster R-CNN path's kernel calls to the plain versions (on
    whatever device the tensors are), so the two can be compared."""

    def __init__(self, monkeypatch):
        def fused_plain(boxes, scores, iou_thres):
            if boxes.shape[1] <= 1024:
                return greedy_keep_mask_plain(boxes, scores, iou_thres)
            return greedy_keep_mask_blocked_plain(boxes, scores, iou_thres)

        monkeypatch.setattr(tfr, "gather_rows", gather_rows_plain)
        monkeypatch.setattr(tfr, "suppress_mask_seq", suppress_mask_seq_plain)
        monkeypatch.setattr(tnms, "gather_rows", gather_rows_plain)
        monkeypatch.setattr(tnms, "greedy_keep_mask_fused", fused_plain)


def _counts():
    return (suppress_mask_seq_cuda.launches,
            greedy_keep_mask_blocked_cuda.launches,
            greedy_keep_mask_cuda.launches, gather_rows_cuda.launches)


def test_faster_rcnn_tails_kernel_equals_plain(cuda, monkeypatch):
    """Proposals (sequential kernel, gathers) and the final tail (blocked
    kernel at K = 2048, gathers) equal their plain reruns on the same head
    outputs; one launch of each suppressor per batch."""
    net = tfr.FasterRCNN(num_classes=6, image_size=128,
                         generator=torch.Generator().manual_seed(0)).to(cuda)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, 128, 128, 3)).astype(np.float32)).to(cuda)
    with torch.no_grad():
        feats = net.features(x)
        objs, regs = net.run_rpn(feats)
        before = _counts()
        boxes, valid = net.proposals(objs, regs)
        pooled = net.roi_align(feats[:4], boxes)
        cls, reg = net.box_head(pooled)
        cls, reg = cls.view(2, 1000, -1), reg.view(2, 1000, -1, 4)
        dets, dvalid = net.postprocess(cls, reg, boxes, valid, 0.001, 0.5)
        torch.cuda.synchronize()
        after = _counts()
        assert (after[0] - before[0], after[1] - before[1],
                after[2] - before[2], after[3] - before[3]) == (1, 1, 0, 5)
        _Plain(monkeypatch)
        p_boxes, p_valid = net.proposals(objs, regs)
        p_dets, p_dvalid = net.postprocess(cls, reg, boxes, valid, 0.001,
                                           0.5)
        assert _counts() == after
    assert torch.equal(boxes, p_boxes) and torch.equal(valid, p_valid)
    assert torch.equal(dets, p_dets) and torch.equal(dvalid, p_dvalid)
    assert int(valid.sum()) > 100 and int(dvalid.sum()) > 0


def test_faster_rcnn_run_detection_on_cuda(cuda, tmp_path):
    """Faster R-CNN serving on the card: the sequential and blocked kernels
    once per batch each, every file written."""
    from edgeml_tpu_torch.models.infer import run_detection

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(2)
    for i in range(5):
        np.save(img_dir / f"im{i}.npy",
                (rng.random((120, 90 + 10 * i, 3)) * 255).astype(np.uint8))
    net = tfr.FasterRCNN(num_classes=6, image_size=128,
                         generator=torch.Generator().manual_seed(0))
    before = _counts()
    run_detection(net, str(img_dir), str(tmp_path / "out"), batch_size=2,
                  conf_thres=1e-3, iou_thres=0.5,
                  class_map={c: c - 1 for c in range(1, 6)})
    after = _counts()
    assert (after[0] - before[0], after[1] - before[1]) == (3, 3)
    for i in range(5):
        a = np.load(tmp_path / "out" / f"im{i}.npy")
        assert a.shape[1] == 6 and a.shape[0] > 0
        assert np.all((a[:, 1:5] >= 0) & (a[:, 1:5] <= 1))
        assert np.all((a[:, 0] >= 0) & (a[:, 0] < 5))
