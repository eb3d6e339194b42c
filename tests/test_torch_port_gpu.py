"""The port on a CUDA device: the suppressor kernels (monolithic, K <= 1024;
blocked, K <= 2048; sequential, the cluster kernel up to K = 1024 and the
literal loop above) and the row-gather kernel against their plain versions,
the batched suppressor's K > 2048 route, the serving slices (YOLOv5,
SSDLite, Faster R-CNN) through them, every family's heads and files (and
Faster R-CNN's RoIAlign and box head) against the CPU's, the reward path
(the mAP core, ORIE rewards, the reward and test CLIs) against the CPU's, and
the estimator path: the SGD scan kernel against its plain loop, the trees
and DCSB (exactly) and the linear families (1e-5) against the CPU's, and the
new CLIs on the card against ``--device cpu``.

Marked ``gpu``; the ``cuda`` fixture skips every test where no CUDA device is
present (decided when the test runs, never at import). Run on the card with

    python -m pytest tests/test_torch_port_gpu.py -m gpu -q

Tolerance: none for the detection kernels — kernel and plain masks and the dets of the
kernel and plain tails are compared bit for bit. Card against CPU: heads 1e-4
of each output's largest value (Faster R-CNN's RPN 3e-4), files as
``chip_smoke.py`` pairs them, each mAP 3e-5, ORIE 6e-5 (E + 1). The SGD
kernel and its plain loop differ in each dot's summation order: 1e-5 of the
largest |w|.
"""

import os

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
    suppress_mask_seq_wide_cuda,
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
    """K = 1025, above the cluster kernel's 1024: the entry point launches
    the literal-loop kernel instead (the cluster kernel's wrapper still
    refuses it), and its kept and picks equal the plain loop's."""
    boxes, scores = seq_candidates(0, 2, 1025, "sparse")
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    before = suppress_mask_seq_cuda.launches
    before_wide = suppress_mask_seq_wide_cuda.launches
    kept, picks = suppress_mask_seq(boxes, scores, 0.7, 10)
    torch.cuda.synchronize()
    assert suppress_mask_seq_cuda.launches == before
    assert suppress_mask_seq_wide_cuda.launches == before_wide + 1
    want_kept, want_picks = suppress_mask_seq_plain(boxes, scores, 0.7, 10)
    assert torch.equal(kept, want_kept) and torch.equal(picks, want_picks)
    with pytest.raises(ValueError, match="1025"):
        suppress_mask_seq_cuda(boxes, scores, 0.7, 10)


@pytest.mark.parametrize("k,segs", [(1025, 16), (2000, 8), (4096, 4),
                                    (11000, 2)])
@pytest.mark.parametrize("regime", ["dense", "sparse", "ties"])
@pytest.mark.parametrize("thr,max_keep", [(0.7, None), (0.5, 64),
                                          (float("nan"), 5), (1.0, 20)])
def test_seq_wide_kernel_equals_plain(cuda, k, segs, regime, thr, max_keep):
    """K > 1024 through the literal-loop kernel (boxes in shared memory up
    to 10,240 candidates, in global memory above), bit-equal to the plain
    loop on the card and on the CPU."""
    boxes, scores = seq_candidates(k + segs, segs, k, regime)
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    mk = k if max_keep is None else max_keep
    before = suppress_mask_seq_wide_cuda.launches
    kept, picks = suppress_mask_seq(boxes, scores, thr, mk)
    torch.cuda.synchronize()
    assert suppress_mask_seq_wide_cuda.launches == before + 1
    want_kept, want_picks = suppress_mask_seq_plain(boxes, scores, thr, mk)
    assert torch.equal(kept, want_kept) and torch.equal(picks, want_picks)
    cpu_kept, cpu_picks = suppress_mask_seq_plain(boxes.cpu(), scores.cpu(),
                                                  thr, mk)
    assert torch.equal(kept.cpu(), cpu_kept)
    assert torch.equal(picks.cpu(), cpu_picks)


@pytest.mark.parametrize("call", ["split", "rows"])
def test_large_max_cand_route_on_cuda(cuda, call):
    """max_cand 4096: the dispatcher takes the global fixpoint on the card
    (chosen by K), no suppressor kernel launches, and the dets equal the
    CPU's."""
    rng = np.random.default_rng(4096)
    b, n = 2, 5000
    if call == "split":
        obj = torch.from_numpy(rng.random((b, n)).astype(np.float32))
        xywh = torch.from_numpy(np.stack(
            [rng.uniform(50, 600, (b, n)), rng.uniform(50, 600, (b, n)),
             rng.uniform(5, 80, (b, n)), rng.uniform(5, 80, (b, n))],
            -1).astype(np.float32))
        cls = torch.from_numpy((rng.random((b, n, 4)) ** 4).astype(
            np.float32))
        args = (obj, xywh, cls)

        def fn(*a):
            return tnms.nms_split_batch(*a, conf_thres=1e-3, iou_thres=0.6,
                                        max_cand=4096)
    else:
        c = rng.uniform(20, 500, (b, n, 2))
        wh = rng.uniform(10, 120, (b, n, 2))
        boxes = torch.from_numpy(np.concatenate(
            [c - wh / 2, c + wh / 2], -1).astype(np.float32))
        scores = torch.from_numpy(rng.random((b, n)).astype(np.float32))
        ids = torch.from_numpy(rng.integers(0, 6, (b, n)).astype(np.float32))
        args = (boxes, scores, ids)

        def fn(*a):
            return tnms.nms_rows(*a, iou_thres=0.5, max_cand=4096)
    before = (_counts(), tnms.greedy_keep_mask_global.launches)
    d, v = fn(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert _counts()[:3] == before[0][:3]
    assert tnms.greedy_keep_mask_global.launches == before[1] + 1
    d_cpu, v_cpu = fn(*args)
    assert torch.equal(d.cpu(), d_cpu) and torch.equal(v.cpu(), v_cpu)
    assert int(v.sum()) > 50
    with pytest.raises(ValueError, match="4096"):
        greedy_keep_mask_fused(torch.zeros(1, 4096, 4, device=cuda),
                               torch.ones(1, 4096, device=cuda), 0.6)


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


def _reward_dataset(seed, n_img, t=1, n_cls=12):
    """set_data-format triples with matching-consistent TP flags."""
    rng = np.random.default_rng(seed)
    weak, strong, labels = [], [], []
    for _ in range(n_img):
        lab = rng.integers(0, n_cls, int(rng.integers(0, 6)))
        labels.append(lab)
        for out, skill in ((weak, 0.35), (strong, 0.6)):
            n = int(rng.integers(0, 12))
            cls = rng.integers(0, n_cls, n)
            tp = np.zeros((n, t), bool)
            for c in np.unique(cls):
                rows = np.nonzero(cls == c)[0]
                cap = int((lab == c).sum())
                for ti in range(t):
                    hot = rows[rng.random(rows.size) < skill]
                    tp[hot[:cap], ti] = True
            out.append((tp, rng.random(n), cls))
    return weak, strong, labels


@pytest.mark.parametrize("t", [1, 10])
def test_map_core_card_equals_cpu(cuda, t):
    """map_from_masks, orie_map_pair and dataset_map on the card within
    3e-5 of the CPU path on the same masks; a draw's value does not depend
    on its batch."""
    from edgeml_tpu_torch.ops import map_kernel as tmk

    weak, strong, labels = _reward_dataset(t, 300, t)
    n = len(labels)
    gpool = tmk.build_pool(weak, strong, labels, device=cuda)
    cpool = tmk.build_pool(weak, strong, labels)
    rng = np.random.default_rng(t)
    w, s = (torch.from_numpy(rng.random((40, n)) < 0.5) for _ in range(2))
    lab = w | s
    got = tmk.map_from_masks(gpool, w.to(cuda), s.to(cuda), lab.to(cuda))
    want = tmk.map_from_masks(cpool, w, s, lab)
    assert float((got.cpu() - want).abs().max()) <= 3e-5
    target = torch.arange(40)
    gw, gs = tmk.orie_map_pair(gpool, w.to(cuda), target.to(cuda))
    cw, cs_ = tmk.orie_map_pair(cpool, w, target)
    assert float((gw.cpu() - cw).abs().max()) <= 3e-5
    assert float((gs.cpu() - cs_).abs().max()) <= 3e-5
    hw, hs = tmk.orie_map_pair(gpool, w[7:9].to(cuda), target[7:9].to(cuda))
    assert torch.equal(hw, gw[7:9]) and torch.equal(hs, gs[7:9])
    off = torch.from_numpy(rng.random((11, n)) < 0.5)
    assert float((tmk.dataset_map(gpool, off.to(cuda)).cpu()
                  - tmk.dataset_map(cpool, off)).abs().max()) <= 3e-5


@pytest.mark.parametrize("e", ["all", "some"])
def test_orie_rewards_card_equals_cpu(cuda, e):
    """E = N - 1 rewards (the draw does not matter) on the card within
    6e-5 N of the CPU's; at E = 50 the same draws on both devices give
    rewards within 6e-5 (E + 1); batch-independent on the card."""
    from edgeml_tpu_torch.reward import orie as torie

    weak, strong, labels = _reward_dataset(9, 200)
    n = len(labels)
    ens = n - 1 if e == "all" else 50
    got = torie.orie_rewards(weak, strong, labels, ens, seed=5, device=cuda)
    want = torie.orie_rewards(weak, strong, labels, ens, seed=5,
                              device="cpu")
    assert got.dtype == np.float32 and np.any(got != 0)
    np.testing.assert_allclose(got, want, atol=6e-5 * (ens + 1), rtol=0)
    np.testing.assert_array_equal(got, torie.orie_rewards(
        weak, strong, labels, ens, seed=5, batch=17, device=cuda))
    m = torie.ensemble_masks(5, torch.arange(n, device=cuda), n, ens)
    assert bool((m.sum(dim=1) == ens).all()) and not bool(m.diag().any())
    assert torch.equal(m.cpu(), torie.ensemble_masks(5, torch.arange(n), n,
                                                     ens))


def test_reward_and_test_clis_on_cuda(cuda, tmp_path):
    """The reward CLI (orie, dcsb) and the test CLI on the card by default:
    the JAX CLIs' files, dcsb equal to a --device cpu run, ORIE within
    tolerance of it, test_map.npy of shape (n, 11)."""
    from edgeml_tpu_torch.cli import reward as cli_reward
    from edgeml_tpu_torch.cli import test as cli_test

    rng = np.random.default_rng(3)
    dirs = [str(tmp_path / d) for d in ("weak", "strong", "labels")]
    for d in dirs:
        (tmp_path / os.path.basename(d)).mkdir()
    n_img = 60
    for i in range(n_img):
        lab = np.concatenate([rng.integers(0, 5, (3, 1)),
                              rng.uniform(0.2, 0.8, (3, 2)),
                              rng.uniform(0.05, 0.3, (3, 2))], 1)
        with open(os.path.join(dirs[2], f"im{i:03d}.txt"), "w") as f:
            f.writelines(f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} "
                         f"{r[4]:.6f}\n" for r in lab)
        for d in dirs[:2]:
            rows = lab[rng.integers(0, 3, 5)].copy()
            rows[:, 1:] += rng.normal(0, 0.02, (5, 4))
            conf = rng.uniform(0.1, 1.0, 5)
            with open(os.path.join(d, f"im{i:03d}.txt"), "w") as f:
                f.writelines(f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} "
                             f"{r[4]:.6f} {c:.6f}\n" for r, c in zip(rows,
                                                                     conf))
    out, out_cpu = str(tmp_path / "out"), str(tmp_path / "out_cpu")
    for method in ("orie", "dcsb"):
        for o, extra in ((out, []), (out_cpu, ["--device", "cpu"])):
            cli_reward.main(cli_reward.getargs(
                [*dirs, o, "--method", method, "--num-ensemble", "20",
                 *extra]))
    for name, dt in (("orie20.npz", np.float32), ("dcsb.npz", np.int64)):
        got = np.load(os.path.join(out, name))
        want = np.load(os.path.join(out_cpu, name))
        assert sorted(got.files) == ["reward", "time"]
        assert got["reward"].dtype == dt and got["reward"].shape == (n_img,)
        if dt == np.int64:
            np.testing.assert_array_equal(got["reward"], want["reward"])
        else:
            np.testing.assert_allclose(got["reward"], want["reward"],
                                       atol=6e-5 * 21, rtol=0)
    fold = rng.permutation(np.arange(n_img) % 3)
    split = np.stack([fold == f for f in range(3)])
    np.save(tmp_path / "split.npy", split)
    est = tmp_path / "est"
    est.mkdir()
    for k, val in enumerate(split):
        np.savez(est / f"estimate{k + 1}.npz",
                 train_est=rng.normal(0, 1, int((~val).sum())),
                 val_est=rng.normal(0, 1, int(val.sum())))
    for o, extra in ((out, []), (out_cpu, ["--device", "cpu"])):
        cli_test.main(cli_test.getargs([*dirs, str(tmp_path / "split.npy"),
                                        o, "--estimates", str(est), *extra]))
    got = np.load(os.path.join(out, "test_map.npy"))
    assert got.shape == (1, 11)
    np.testing.assert_allclose(got, np.load(os.path.join(out_cpu,
                                                         "test_map.npy")),
                               atol=3e-5, rtol=0)


def _heads_rel_err(got, ref):
    """The largest error of each output over its largest value."""
    return max(float((a.float().cpu() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(got, ref))


def _family(name):
    from edgeml_tpu_torch.models.retinanet import RetinaNet
    from edgeml_tpu_torch.models.yolov5 import YoloV5

    g = torch.Generator().manual_seed(0)
    if name == "yolov5":
        net = YoloV5(num_classes=8, img_size=128, generator=g)
        return net, 128, (lambda m, x: m.predict(x)), {}
    if name == "ssd":
        # full width, BatchNorm statistics and spread class biases from
        # chip_smoke.py's seeded construction: a small random SSDLite gives
        # thousands of near-equal scores, whose max_det cut no
        # rounding-level check can hold
        import chip_smoke as cs
        from edgeml_tpu_torch.data.coco_labelmap import coco_to_yolov5

        calib = torch.from_numpy(np.random.default_rng(2).normal(
            0, 1, (4, 320, 320, 3)).astype(np.float32))
        net = cs.seeded_ssdlite(3, calib, torch.device("cpu"))
        return net, 320, (lambda m, x: m(x)), {"class_map": coco_to_yolov5}
    if name == "retinanet":
        net = RetinaNet(num_classes=6, image_size=128, generator=g)
        return net, 128, (lambda m, x: m(x)), {
            "class_map": {c: c - 1 for c in range(1, 6)}}
    net = tfr.FasterRCNN(num_classes=6, image_size=128, generator=g)
    return net, 128, (lambda m, x: [t for lv in m.run_rpn(m.features(x))
                                    for t in lv]), {
        "class_map": {c: c - 1 for c in range(1, 6)}}


@pytest.mark.parametrize("name", ["yolov5", "ssd", "retinanet",
                                  "faster_rcnn"])
def test_heads_and_files_card_equal_cpu(cuda, tmp_path, name):
    """The f32 heads on the card within 1e-4 of each output's largest value
    of the CPU's (Faster R-CNN's RPN: the card's 3e-4); run_detection's
    files on the card paired row for row with the CPU's within
    chip_smoke.py's file tolerances (conf 1e-4, boxes 0.1 px, at most 5% of
    rows unpaired)."""
    import copy

    import chip_smoke as cs
    from edgeml_tpu_torch.models.infer import run_detection

    net, size, fwd, kw = _family(name)
    net = net.eval()
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (2, size, size, 3)).astype(np.float32))
    cpu_net = copy.deepcopy(net)
    with torch.no_grad():
        ref = fwd(cpu_net, x)
        got = fwd(net.to(cuda), x.to(cuda))
    tol = cs.FRCNN_RPN_CARD_TOL if name == "faster_rcnn" \
        else cs.CPU_SUITE_TOL
    assert _heads_rel_err(got, ref) < tol
    img_dir = tmp_path / "imgs"
    if name == "ssd":  # chip_smoke.py's images: smooth content
        shapes = cs.make_images(str(img_dir), seed=5, n=3)
    else:
        img_dir.mkdir()
        rng = np.random.default_rng(5)
        shapes = []
        for i in range(3):
            h, w = 120, 90 + 10 * i
            np.save(img_dir / f"img{i:04d}.npy",
                    (rng.random((h, w, 3)) * 255).astype(np.uint8))
            shapes.append((h, w))
    args = dict(batch_size=2, conf_thres=1e-3, iou_thres=0.5, **kw)
    if name == "yolov5":
        args["img_size"] = 128
    run_detection(net, str(img_dir), str(tmp_path / "card"), **args)
    run_detection(cpu_net, str(img_dir), str(tmp_path / "cpu"),
                  device="cpu", **args)
    rows = unpaired = 0
    for i, hw in enumerate(shapes):
        a = np.load(tmp_path / "card" / f"img{i:04d}.npy")
        b = np.load(tmp_path / "cpu" / f"img{i:04d}.npy")
        pairs, conf_err, box_err = cs.pair_rows(a, b, hw)
        assert conf_err <= cs.FILE_CONF_TOL and box_err <= cs.FILE_BOX_TOL_PX
        rows += max(len(a), len(b))
        unpaired += max(len(a), len(b)) - pairs
    assert rows > 0 and unpaired <= cs.FILE_UNPAIRED_TOL * rows


def test_faster_rcnn_second_stage_card_equals_cpu(cuda):
    """RoIAlign (strict f32 within 1e-4 of its largest value; the bf16
    pyramid within bf16 rounding, 4e-2) and the box head (1e-4) on the card
    against the CPU on the same features and proposals."""
    import copy

    net = tfr.FasterRCNN(num_classes=6, image_size=128,
                         generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 128, 128, 3)).astype(np.float32))
    with torch.no_grad():
        feats = net.features(x)
        boxes, _ = net.proposals(*net.run_rpn(feats))
        pooled = net.roi_align(feats[:4], boxes)
        head = net.box_head(pooled)
        card = copy.deepcopy(net).to(cuda)
        feats_g = [f.to(cuda) for f in feats[:4]]
        assert _heads_rel_err([card.roi_align(feats_g, boxes.to(cuda))],
                              [pooled]) < 1e-4
        p16 = card.roi_align(feats_g, boxes.to(cuda), tfr.ROI_PYR)
        assert float((p16.float().cpu() - net.roi_align(
            feats[:4], boxes, tfr.ROI_PYR).float()).abs().max()) <= 4e-2
        assert _heads_rel_err(card.box_head(pooled.to(cuda)), head) < 1e-4


# ---- the estimator path: the SGD kernel, the trees and the CLIs ----------

def _sgd_inputs(n, f, epochs, seed):
    from edgeml_tpu_torch.ops import sgd as tsgd

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x @ rng.normal(size=f) / np.sqrt(f) + 0.3).astype(np.float32)
    order = tsgd.sgd_orders(seed, n, epochs).reshape(-1)
    eta = tsgd.sgd_eta(0.01, 0.25, order.size)
    return x, y, order, eta


@pytest.mark.parametrize("f", [1, 31, 33, 64, 145, 205, 1024])
def test_sgd_kernel_equals_plain(cuda, f):
    """One launch per fit; w and b within 1e-5 of the largest |w| of the
    plain loop on the card (the two differ in each dot's summation
    order)."""
    from edgeml_tpu_torch.ops import sgd as tsgd

    x, y, order, eta = (torch.from_numpy(a).to(cuda)
                        for a in _sgd_inputs(150, f, 3, f))
    before = tsgd.sgd_fit_cuda.launches
    wk, bk = tsgd.sgd_fit_cuda(x, y, order, eta, 0.001)
    torch.cuda.synchronize()
    assert tsgd.sgd_fit_cuda.launches == before + 1
    wp, bp = tsgd.sgd_fit_plain(x, y, order, eta, 0.001)
    scale = float(wp.abs().max())
    assert float((wk - wp).abs().max()) <= 1e-5 * scale
    assert abs(float(bk) - float(bp)) <= 1e-5 * max(scale, abs(float(bp)))


def test_sgd_kernel_edges(cuda):
    """No steps leaves w = 0, b = 0; F > 1024 and CPU tensors are refused
    without a launch; sgd_fit dispatches CUDA tensors to the kernel."""
    from edgeml_tpu_torch.ops import sgd as tsgd

    x, y, order, eta = (torch.from_numpy(a).to(cuda)
                        for a in _sgd_inputs(20, 8, 2, 1))
    w, b = tsgd.sgd_fit_cuda(x, y, order[:0], eta[:0], 0.001)
    assert not w.any() and float(b) == 0.0
    before = tsgd.sgd_fit_cuda.launches
    with pytest.raises(ValueError, match="outside"):
        tsgd.sgd_fit_cuda(torch.zeros(4, 1025, device=cuda),
                          torch.zeros(4, device=cuda), order[:4] % 4,
                          eta[:4], 0.001)
    assert tsgd.sgd_fit_cuda.launches == before
    w, b = tsgd.sgd_fit(x, y, order.cpu().numpy().reshape(2, 20), 0.001,
                        0.01, 0.25)
    assert w.device.type == "cuda" and tsgd.sgd_fit_cuda.launches == before + 1


def test_ordered_sums_card_equals_cpu(cuda):
    """The histogram sums on the card: sequential in sample order, bit for
    bit the CPU's (and numpy's add.at), run after run."""
    from edgeml_tpu_torch.estimators import trees as tt

    rng = np.random.default_rng(0)
    cell = rng.integers(0, 300, 200_000)
    cell[:5000] = 7  # one long segment
    vals = (rng.normal(size=cell.size)
            * 10 ** rng.uniform(-3, 3, cell.size)).astype(np.float32)
    want = np.zeros(300, np.float32)
    np.add.at(want, cell, vals)
    for _ in range(3):
        got = tt.ordered_sums(torch.from_numpy(cell).to(cuda),
                              torch.from_numpy(vals).to(cuda), 300)
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def _est_data(seed, n=400, n_val=100, f=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n + n_val, f))
    x[:, 3] = x[:, 1]
    x[:, 4] = 0.0
    x[:, 5] = np.round(x[:, 5])
    y = np.sin(x[:, 0]) + 0.5 * x[:, 1] ** 2 + 0.1 * rng.normal(size=n + n_val)
    return ([r for r in x[:n]], [r for r in x[n:]], y[:n], y[n:])


@pytest.mark.parametrize("family", ["RFR", "GBR"])
def test_trees_card_equal_cpu(cuda, family, tmp_path):
    """The card's trees equal the CPU's node for node, and so do the
    estimates."""
    import pickle

    from edgeml_tpu_torch import estimators as E

    data = _est_data(3)
    opts = (E.RFROpt(n_estimators=6, max_depth=8, min_samples_split=20)
            if family == "RFR" else E.GBROpt(n_estimators=60))
    fit = E.fit_RFR if family == "RFR" else E.fit_GBR
    res, trees = {}, {}
    for d in ("cuda", "cpu"):
        res[d] = fit(data, opts, E.SaveOpt(model_dir=str(tmp_path / d)),
                     device=d)
        with open(tmp_path / d / "wts1.pickle", "rb") as f:
            trees[d] = pickle.load(f)[0]["trees"]
    for k in trees["cpu"]:
        np.testing.assert_array_equal(trees["cuda"][k], trees["cpu"][k])
    for k in ("train_est", "val_est"):
        np.testing.assert_array_equal(res["cuda"][k], res["cpu"][k])


@pytest.mark.parametrize("family", ["LR", "EN", "BR", "SGD", "KNR"])
def test_linear_families_card_close_to_cpu(cuda, family):
    """Card against CPU within the CPU tests' 1e-5 of the largest
    estimate (TF32 off on the card)."""
    from edgeml_tpu_torch import estimators as E

    data = _est_data(4)
    fit = E.MODEL_FITTERS[E.MODEL_NAMES.index(family)]
    card, cpu = fit(data, device="cuda"), fit(data, device="cpu")
    for k in ("train_est", "val_est"):
        scale = float(np.abs(cpu[k]).max())
        assert float(np.abs(card[k] - cpu[k]).max()) <= 1e-5 * scale


def test_dcsb_card_equals_cpu(cuda):
    from edgeml_tpu_torch import estimators as E

    rng = np.random.default_rng(5)
    feats = []
    for _ in range(300):
        k = int(rng.integers(0, 9))
        conf = rng.random(k)
        conf[rng.random(k) < 0.2] = 0.50000001
        feats.append((conf, rng.random(k) * 0.5))
    r = rng.integers(0, 2, 300)
    data = (feats[:240], feats[240:], r[:240], r[240:])
    lab = rng.integers(0, 6, 240)
    card = E.fit_dcsb(data, lab, device="cuda")
    cpu = E.fit_dcsb(data, lab, device="cpu")
    for k in ("train_est", "val_est"):
        np.testing.assert_array_equal(card[k], cpu[k])


def test_estimator_clis_on_cuda(cuda, tmp_path):
    """The four new CLIs on the card (no --device) against --device cpu:
    the split and the features byte for byte, LR and SGD estimates within
    1e-5, DCSB's equal; the SGD kernel launched once per fold."""
    from edgeml_tpu_torch.cli import baseline as cb
    from edgeml_tpu_torch.cli import dataset_split as cs_
    from edgeml_tpu_torch.cli import extract_feature as cf
    from edgeml_tpu_torch.cli import regression as cr
    from edgeml_tpu_torch.ops import sgd as tsgd
    from test_torch_port_io import write_dataset

    weak, _, labels = write_dataset(str(tmp_path / "data"), seed=8, n_img=40)
    rng = np.random.default_rng(2)
    np.savez(tmp_path / "r.npz", reward=rng.normal(0, 0.1, 40).astype(
        np.float32), time=1.0)
    runs = {}
    for where, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        o = tmp_path / where
        cs_.main(cs_.getargs([labels, str(o) + "_split.npy", "--num-split",
                              "4", *extra]))
        cf.main(cf.getargs([weak, str(o / "feat"), labels, "--dataset", "voc",
                            *extra]))
        before = tsgd.sgd_fit_cuda.launches
        for model in ("LR", "SGD"):
            cr.main(cr.getargs([str(o / "feat"), str(tmp_path / "r.npz"),
                                str(o) + "_split.npy", str(o / model),
                                "--model", model, *extra]))
        cb.main(cb.getargs([weak, str(tmp_path / "r.npz"),
                            str(o) + "_split.npy", str(o / "dcsb"),
                            "--baseline", "dcsb", "--label_dir", labels,
                            *extra]))
        runs[where] = tsgd.sgd_fit_cuda.launches - before
    assert runs == {"card": 4, "cpu": 0}
    card, cpu = tmp_path / "card", tmp_path / "cpu"
    assert (tmp_path / "card_split.npy").read_bytes() == \
        (tmp_path / "cpu_split.npy").read_bytes()
    for name in sorted(os.listdir(cpu / "feat")):
        f = os.path.join(name, "stage24_output_features.npy")
        assert (card / "feat" / f).read_bytes() == (cpu / "feat" / f).read_bytes()
    for k in range(1, 5):
        for model, tol in (("LR", 1e-5), ("SGD", 1e-5), ("dcsb", 0)):
            a = np.load(card / model / f"estimate{k}.npz")
            b = np.load(cpu / model / f"estimate{k}.npz")
            for key in ("train_est", "val_est"):
                scale = float(np.abs(b[key]).max())
                assert float(np.abs(a[key] - b[key]).max()) <= tol * scale


# ---- hidden-stage features and the COCO evaluator --------------------------


def _padded_batch(seed, c, s, b=16):
    """Square-padded maps with ragged (h, w), content top-left, as
    load_feature builds them."""
    rng = np.random.default_rng(seed)
    sizes = np.stack([rng.integers(1, s + 1, b), rng.integers(1, s + 1, b)],
                     1).astype(np.float32)
    sizes[0] = s
    f = np.zeros((b, c, s, s), np.float32)
    for i, (h, w) in enumerate(sizes.astype(int)):
        f[i, :, :h, :w] = rng.normal(size=(c, h, w))
    return f, sizes


@pytest.mark.parametrize("c,s,p", [(64, 80, 8), (256, 20, 8), (128, 40, 1),
                                   (16, 7, 13)])
def test_roi_resize_card_vs_cpu(cuda, c, s, p):
    """max bit-equal; avg within 1e-6 of the call's largest value."""
    from edgeml_tpu_torch.ops.roi import roi_resize_batch

    f, sizes = _padded_batch(c + s + p, c, s)
    for func in ("max", "avg"):
        card = roi_resize_batch(f, sizes, p, func)
        cpu = roi_resize_batch(f, sizes, p, func, device="cpu")
        assert card.shape == cpu.shape == (len(f), c, p, p)
        if func == "max":
            np.testing.assert_array_equal(card, cpu)
        else:
            assert float(np.abs(card - cpu).max()) <= 1e-6 * float(
                np.abs(cpu).max())


def test_load_feature_pooled_on_cuda(cuda, tmp_path):
    from edgeml_tpu_torch.data import io as tio

    rng = np.random.default_rng(3)
    for i in range(7):
        d = tmp_path / f"img{i}"
        d.mkdir()
        h, w = (20, 15) if i % 2 else (12, 20)
        np.save(d / "stage23_C3_features.npy",
                rng.normal(size=(32, h, w)).astype(np.float32))
    for func in ("max", "avg"):
        card = tio.load_feature(str(tmp_path), 23, func=func, batch_size=3)
        cpu = tio.load_feature(str(tmp_path), 23, func=func, batch_size=3,
                               device="cpu")
        assert card.shape == (7, 32, 8, 8)
        tol = 0.0 if func == "max" else 1e-6 * float(np.abs(cpu).max())
        assert float(np.abs(card - cpu).max()) <= tol


def test_dump_features_card_vs_cpu(cuda, tmp_path):
    """dump_features of a seeded full-width YOLOv5n at 640 on the card
    against the CPU: the same files, each map within 1e-4 of its largest
    value."""
    from edgeml_tpu_torch.models.infer import dump_features
    from edgeml_tpu_torch.models.yolov5 import YoloV5

    rng = np.random.default_rng(4)
    (tmp_path / "img").mkdir()
    for i, (h, w) in enumerate([(480, 640), (640, 427)]):
        np.save(tmp_path / "img" / f"im{i}.npy",
                (rng.random((h, w, 3)) * 255).astype(np.uint8))
    net = YoloV5(num_classes=80, img_size=640,
                 generator=torch.Generator().manual_seed(0))
    dump_features(net, str(tmp_path / "img"), str(tmp_path / "card"))
    dump_features(net.cpu(), str(tmp_path / "img"), str(tmp_path / "cpu"),
                  device="cpu")
    names = sorted(os.listdir(tmp_path / "cpu" / "im0"))
    assert names == sorted(os.listdir(tmp_path / "card" / "im0")) and \
        len(names) == 4
    for im in ("im0", "im1"):
        for n in names:
            a = np.load(tmp_path / "card" / im / n)
            b = np.load(tmp_path / "cpu" / im / n)
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert float(np.abs(a - b).max()) <= 1e-4 * float(
                np.abs(b).max()), (im, n)
    assert np.load(tmp_path / "card" / "im0" /
                   "stage17_C3_features.npy").shape == (64, 80, 80)


def test_detection_evaluator_greedy_card_equals_cpu(cuda):
    """The greedy style's APs on the card equal the CPU's bit for bit."""
    from edgeml_tpu_torch.eval_coco import DetectionEvaluator

    rng = np.random.default_rng(5)
    dets, gts = [], []
    for _ in range(300):
        m, n = int(rng.integers(1, 6)), int(rng.integers(0, 12))
        g_xy = rng.uniform(0, 400, (m, 2))
        g = np.concatenate([g_xy, g_xy + rng.uniform(10, 200, (m, 2))], 1)
        gts.append((rng.integers(0, 20, m), g))
        pick = rng.integers(0, m, n)
        d = g[pick] + rng.normal(0, 15, (n, 4))
        cls = np.where(rng.random(n) < 0.8, gts[-1][0][pick],
                       rng.integers(0, 20, n))
        dets.append((cls, d, rng.uniform(0.05, 1.0, n)))
    res = {}
    for dev in ("cuda", "cpu"):
        ev = DetectionEvaluator(device=dev)
        ev.update(dets, gts)
        res[dev] = ev.summarize(verbose=False)
    np.testing.assert_array_equal(res["cuda"]["per_iou"],
                                  res["cpu"]["per_iou"])
    assert res["cuda"]["map"] == res["cpu"]["map"] > 0


# ---- training (the train step, the device HSV jitter, the train CLI and
# evaluate's kernels) -------------------------------------------------------


def _train_batch(seed, b=2, t=5, nc=4, s=64):
    rng = np.random.default_rng(seed)
    x = rng.random((b, s, s, 3)).astype(np.float32)
    tg = np.zeros((b, t, 5), np.float32)
    tg[..., 0] = rng.integers(0, nc, (b, t))
    tg[..., 1:3] = rng.uniform(0.2, 0.8, (b, t, 2))
    tg[..., 3:5] = rng.uniform(0.1, 0.5, (b, t, 2))
    return (torch.from_numpy(x), torch.from_numpy(tg),
            torch.ones(b, t, dtype=torch.bool))


def test_train_step_card_vs_cpu(cuda):
    """One SGD step of YOLOv5n (4 classes, 64 px, batch 2) on the card and
    on the CPU from the same weights: the loss within 1e-5 relative (the
    same parameters: the forward's rounding only), each tensor after the
    step within 1e-3 of its largest |value| (the gradients' rounding times
    lr), BatchNorm stats within 1e-4."""
    import copy

    from edgeml_tpu_torch.models.engine import make_family_train_step
    from edgeml_tpu_torch.models.train import TrainConfig
    from edgeml_tpu_torch.models.yolov5 import YoloV5

    net = YoloV5("n", 4, 64, generator=torch.Generator().manual_seed(3))
    nets = {"cpu": net, "cuda": copy.deepcopy(net).to(cuda)}
    x, tg, v = _train_batch(4)
    out = {}
    for dev, n in nets.items():
        _, step = make_family_train_step(n, TrainConfig())
        loss, parts = step(x.to(dev), tg.to(dev), v.to(dev), 0.02)
        out[dev] = float(loss)
        assert loss.device.type == dev
    assert abs(out["cuda"] - out["cpu"]) <= 1e-5 * out["cpu"]
    for (k, a), b in zip(nets["cuda"].state_dict().items(),
                         nets["cpu"].state_dict().values()):
        if not a.is_floating_point():
            continue
        tol = 1e-4 if "running" in k else 1e-3
        scale = max(float(b.abs().max()), 1e-6 if "running" in k else 1e-3)
        assert float((a.cpu() - b).abs().max()) <= tol * scale, k


def test_device_hsv_jitter_card_vs_cpu(cuda):
    from edgeml_tpu_torch.data.yolo_aug import hsv_gains
    from edgeml_tpu_torch.ops.color import hsv_jitter

    rng = np.random.default_rng(6)
    imgs = torch.from_numpy(rng.random((4, 64, 80, 3)).astype(np.float32))
    gains = torch.from_numpy(np.stack(
        [hsv_gains(np.random.default_rng(s)) for s in range(4)]).astype(
            np.float32))
    got = hsv_jitter(imgs.to(cuda), gains.to(cuda))
    assert got.device.type == "cuda"
    want = hsv_jitter(imgs, gains)
    assert float((got.cpu() - want).abs().max()) < 1e-6


def test_train_cli_on_cuda_and_served(cuda, tmp_path):
    """The train CLI on the card by default (no --device), --preset yolo
    --augment yolo --ema, then the detect CLI serves its checkpoint on the
    card."""
    from edgeml_tpu_torch.cli import detect as detect_cli
    from edgeml_tpu_torch.cli import train as train_cli

    rng = np.random.default_rng(7)
    img_dir, lab_dir = tmp_path / "images", tmp_path / "labels"
    img_dir.mkdir()
    lab_dir.mkdir()
    for i in range(8):
        np.save(img_dir / f"im{i}.npy",
                rng.random((64, 64, 3)).astype(np.float32))
        (lab_dir / f"im{i}.txt").write_text("1 0.5 0.5 0.3 0.4\n")
    res = train_cli.main(train_cli.getargs(
        [str(img_dir), str(tmp_path / "out"), "--label-dir", str(lab_dir),
         "--model", "yolov5n", "-b", "4", "--img-size", "64", "--epochs",
         "1", "--preset", "yolo", "--augment", "yolo", "--ema"]))
    assert next(res["state"].parameters()).device.type == "cuda"
    assert np.isfinite(res["epoch_loss"][0])
    detect_cli.main(detect_cli.getargs(
        [str(img_dir), str(tmp_path / "dets"), "--model", "yolov5n",
         "--dataset", "voc", "--model-path",
         str(tmp_path / "out" / "checkpoint.pth"), "--batch-size", "4"]))
    assert len(os.listdir(tmp_path / "dets")) == 8


@pytest.mark.parametrize("family", ["yolo", "ssd"])
def test_evaluate_launches_kernels_and_equals_cpu(cuda, family):
    """evaluate on the card serves through the suppressor kernels (YOLOv5n:
    the monolithic one at K = 1008 and the row gather; SSDLite: the blocked
    one at K = 1152) and its APs equal the CPU's within 3e-5."""
    import copy

    from edgeml_tpu_torch.models.engine import evaluate
    from edgeml_tpu_torch.models.ssdlite import SSDLite
    from edgeml_tpu_torch.models.yolov5 import YoloV5

    g = torch.Generator().manual_seed(8)
    net = YoloV5("n", 4, 64, generator=g) if family == "yolo" \
        else SSDLite(9, 64, generator=g)
    rng = np.random.default_rng(9)
    images = [rng.random((64, 48 + 8 * i, 3)).astype(np.float32)
              for i in range(6)]
    gts = [np.array([[1, 0.5, 0.5, 0.4, 0.3], [2, 0.3, 0.6, 0.2, 0.2]],
                    np.float32) for _ in images]
    before = [w.launches for w in (greedy_keep_mask_cuda,
                                   greedy_keep_mask_blocked_cuda,
                                   gather_rows_cuda)]
    got = evaluate(copy.deepcopy(net).to(cuda), images, gts, batch_size=4)
    mono, blocked, gath = (w.launches - b for w, b in zip(
        (greedy_keep_mask_cuda, greedy_keep_mask_blocked_cuda,
         gather_rows_cuda), before))
    if family == "yolo":
        assert mono == 2 and blocked == 0 and gath == 6
    else:
        assert blocked == 2 and mono == 0 and gath > 0
    want = evaluate(net, images, gts, batch_size=4)
    for k in ("map", "map50", "map75"):
        assert abs(got[k] - want[k]) <= 3e-5, k


# ---- training of the frozen-norm families (RetinaNet, Faster R-CNN) ------


def _frozen_net(family, seed=3):
    from edgeml_tpu_torch.models.engine import make_detector

    net = make_detector(family, 6, 128,
                        generator=torch.Generator().manual_seed(seed))
    if family == "faster_rcnn":
        net.rpn_post_nms = 64
    return net


def _frozen_draws(net, b, t, seed=4):
    """One step's sampling draws for ``net``'s family (None for RetinaNet),
    made on the CPU."""
    from edgeml_tpu_torch.models.rcnn_loss import uniform_draws

    if not isinstance(net, tfr.FasterRCNN):
        return None
    n_rpn = sum(len(a) for a in tfr.rpn_anchors(net.image_size))
    return uniform_draws(torch.Generator().manual_seed(seed), b, n_rpn,
                         net.rpn_post_nms + t, "cpu")


@pytest.mark.parametrize("family", ["retinanet", "faster_rcnn"])
def test_frozen_train_step_card_vs_cpu(cuda, family):
    """One SGD step of RetinaNet / Faster R-CNN (6 classes + background,
    128 px, batch 2, full width) on the card and on the CPU from the same
    weights and the same sampling draws: the loss within 1e-5 relative;
    the update (every trained tensor at once) within 1e-2 of the CPU
    update's norm (read on an NVIDIA H100 80GB HBM3: RetinaNet 2.35e-03,
    where 128 px puts a few pre-activations on the other side of a ReLU
    than the CPU's; 1.5e-05 at 256 px in ``chip_smoke.py``)."""
    import copy

    from edgeml_tpu_torch.models.engine import make_family_train_step
    from edgeml_tpu_torch.models.train import TrainConfig

    net = _frozen_net(family)
    before = [p.detach().clone() for p in net.parameters()]
    nets = {"cpu": net, "cuda": copy.deepcopy(net).to(cuda)}
    x, tg, v = _train_batch(5, s=128)
    draws = _frozen_draws(net, 2, 5)
    out = {}
    for dev, n in nets.items():
        _, step = make_family_train_step(n, TrainConfig())
        if draws is not None:
            step.draw_fn = lambda *a, dev=dev: type(draws)(
                *(d.to(dev) for d in draws))
        loss, _ = step(x.to(dev), tg.to(dev), v.to(dev), 0.02)
        out[dev] = float(loss)
        assert loss.device.type == dev
    assert abs(out["cuda"] - out["cpu"]) <= 1e-5 * out["cpu"]
    sq_d = sq_u = 0.0
    for a, b, p in zip(nets["cuda"].parameters(), nets["cpu"].parameters(),
                       before):
        sq_d += float(((a.detach().cpu() - b.detach()).double() ** 2).sum())
        sq_u += float(((b.detach() - p).double() ** 2).sum())
    err = (sq_d / sq_u) ** 0.5
    print(f"{family}: loss {abs(out['cuda'] - out['cpu']) / out['cpu']:.3e}"
          f", update {err:.3e}")
    assert sq_u > 0 and err <= 1e-2


def test_frcnn_step_proposals_kernel_equals_plain(cuda, monkeypatch):
    """The Faster R-CNN train step's proposals on the card: one launch of
    the sequential suppressor and three of the row gather a step, and the
    same boxes and masks as the plain versions on the step's own RPN
    outputs."""
    from edgeml_tpu_torch.models.engine import make_family_train_step
    from edgeml_tpu_torch.models.train import TrainConfig

    net = _frozen_net("faster_rcnn").to(cuda)
    _, step = make_family_train_step(net, TrainConfig())
    draws = _frozen_draws(net, 2, 5)
    step.draw_fn = lambda *a: type(draws)(*(d.to(cuda) for d in draws))
    x, tg, v = (t.to(cuda) for t in _train_batch(6, s=128))
    c0 = _counts()
    step(x, tg, v, 0.02)
    torch.cuda.synchronize()
    c1 = _counts()
    assert (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2],
            c1[3] - c0[3]) == (1, 0, 0, 3)
    net.train()
    with torch.no_grad():
        _, objs, regs = step.forward(x)
        boxes, valid = net.proposals(objs, regs)
        _Plain(monkeypatch)
        p_boxes, p_valid = net.proposals(objs, regs)
    assert torch.equal(boxes, p_boxes) and torch.equal(valid, p_valid)
    assert int(valid.sum()) == 2 * net.rpn_post_nms


@pytest.mark.parametrize("family", ["retinanet", "faster_rcnn"])
def test_frozen_train_cli_on_cuda_and_served(cuda, tmp_path, family):
    """The train CLI on the card by default (no --device), --ema --bf16,
    then the detect CLI serves its checkpoint on the card."""
    from edgeml_tpu_torch.cli import detect as detect_cli
    from edgeml_tpu_torch.cli import train as train_cli

    rng = np.random.default_rng(7)
    img_dir, lab_dir = tmp_path / "images", tmp_path / "labels"
    img_dir.mkdir()
    lab_dir.mkdir()
    for i in range(4):
        np.save(img_dir / f"im{i}.npy",
                rng.random((96, 96, 3)).astype(np.float32))
        (lab_dir / f"im{i}.txt").write_text("1 0.5 0.5 0.3 0.4\n")
    res = train_cli.main(train_cli.getargs(
        [str(img_dir), str(tmp_path / "out"), "--label-dir", str(lab_dir),
         "--model", family, "-b", "2", "--img-size", "128", "--epochs",
         "2", "--ema", "--bf16"]))
    assert next(res["state"].parameters()).device.type == "cuda"
    assert all(np.isfinite(res["epoch_loss"]))
    assert res["ema"].n_updates == 4
    detect_cli.main(detect_cli.getargs(
        [str(img_dir), str(tmp_path / "dets"), "--model", family,
         "--dataset", "voc", "--model-path",
         str(tmp_path / "out" / "checkpoint.pth"), "--batch-size", "2"]))
    assert len(os.listdir(tmp_path / "dets")) == 4
