"""The port's sequential greedy-NMS suppressor (``ops/nms_seq.py``) against
the JAX package's.

The plain version ``suppress_mask_seq_plain`` is held bit for bit against
the interpret-mode Pallas kernel (``nms_pallas.suppress_mask`` and
``nms_pallas.nms_pallas``, K <= 300), against the fixpoint form
``ops.nms.suppress_mask`` of both packages (K up to 1000, RPN-sized), and
against a NumPy transcription of the loop for the picks. Seeded sets:
dense RPN-like overlap, sparse boxes, and tie clusters with saturated 1.0
scores and zeros, at ``max_keep`` 8 and K. Tolerance: none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgeml_tpu.ops.nms import suppress_mask as jax_fixpoint_mask
from edgeml_tpu.ops.nms_pallas import nms_pallas as jax_nms_pallas
from edgeml_tpu.ops.nms_pallas import suppress_mask as jax_pallas_mask
from edgeml_tpu_torch.ops import nms as tnms
from edgeml_tpu_torch.ops.nms_seq import (
    MAX_K, nms_seq, suppress_mask, suppress_mask_seq,
    suppress_mask_seq_cuda, suppress_mask_seq_plain,
)

torch.set_num_threads(1)

REGIMES = ("dense", "sparse", "ties")


def candidates(seed, k, regime, segments=None):
    """Unsorted candidates (boxes (k, 4) of positive area, scores (k,)), or
    a leading segment axis when ``segments`` is given."""
    rng = np.random.default_rng(seed)
    shape = (k,) if segments is None else (segments, k)
    spread = {"dense": 120.0, "sparse": 2000.0, "ties": 300.0}[regime]
    c = rng.uniform(0, spread, shape + (2,))
    wh = rng.uniform(8, 150, shape + (2,))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if regime == "ties":
        # sigmoids of large logits saturate to exactly 1.0 in f32
        logits = rng.choice([30.0, 30.0, 2.0, 0.5, 0.5, -3.0], shape)
        scores = (1 / (1 + np.exp(-logits))).astype(np.float32)
        assert (scores == 1.0).sum() > k // 5
    else:
        scores = rng.random(shape).astype(np.float32)
    scores[rng.random(shape) < 0.2] = 0.0
    return boxes, scores


def greedy_numpy(boxes, scores, thr, max_keep):
    """The loop of the reference's kernel in NumPy f32: (kept, picks)."""
    alive = scores > 0
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    kept = np.zeros(len(scores), bool)
    picks = []
    for _ in range(max_keep):
        s = np.where(alive, scores, -np.inf)
        j = int(np.argmax(s))
        if not s[j] > 0:
            break
        picks.append(j)
        kept[j] = True
        ix1 = np.maximum(boxes[j, 0], boxes[:, 0])
        iy1 = np.maximum(boxes[j, 1], boxes[:, 1])
        ix2 = np.minimum(boxes[j, 2], boxes[:, 2])
        iy2 = np.minimum(boxes[j, 3], boxes[:, 3])
        inter = np.maximum(ix2 - ix1, np.float32(0)) \
            * np.maximum(iy2 - iy1, np.float32(0))
        iou = inter / np.maximum(area[j] + area - inter, np.float32(1e-12))
        alive &= iou <= np.float32(thr)
    return kept, picks


def sorted_numpy(boxes, scores, thr, max_keep, band=256):
    """The sorted form of the loop that ``csrc/nms_seq.cu`` computes, in
    NumPy f32: rank the live candidates by key (score descending, index
    ascending), build the relation R(j, i) = !(iou(j, i) <= thr) of earlier
    j over later i with sticky rows (a j with !R(j, j) removes every later
    target), walk it in bands of ``band`` (each band's targets against the
    kept of the bands before it, then its own triangle in groups of 32 by
    the fixpoint kw = cand & ~hit(kw) iterated from cand), keep the first
    ``max_keep`` kept in key order, and fill the picks after the last with
    it if it is sticky, else -1. Returns (kept, picks)."""
    k = len(scores)
    thr = np.float32(thr)
    live = scores > 0
    keys = np.where(live, (scores.view(np.uint32).astype(np.uint64) << 32)
                    | (0xffffffff - np.arange(k)).astype(np.uint64), 0)
    order = np.argsort(keys, kind="stable")[::-1][:int(live.sum())]
    if max_keep == 0:
        order = order[:0]
    n = len(order)
    x1, y1, x2, y2 = boxes[order].T
    area = (x2 - x1) * (y2 - y1)
    ix = np.minimum(x2[:, None], x2[None]) - np.maximum(x1[:, None], x1[None])
    iy = np.minimum(y2[:, None], y2[None]) - np.maximum(y1[:, None], y1[None])
    inter = np.maximum(ix, np.float32(0)) * np.maximum(iy, np.float32(0))
    q = inter / np.maximum(area[:, None] + area[None] - inter,
                           np.float32(1e-12))
    rel = ~(q <= thr)  # rel[j, i]: j removes i
    sticky = ~np.diagonal(rel)
    rel = (rel | sticky[:, None]) & np.triu(np.ones((n, n), bool), 1)
    kept_s = np.zeros(n, bool)
    for b0 in range(0, n, band):
        b1 = min(b0 + band, n)
        free = ~(rel[:b0, b0:b1] & kept_s[:b0, None]).any(axis=0)
        for g0 in range(b0, b1, 32):
            g1 = min(g0 + 32, b1)
            cand = free[g0 - b0:g1 - b0] \
                & ~(rel[b0:g0, g0:g1] & kept_s[b0:g0, None]).any(axis=0)
            kw = cand
            while True:
                new = cand & ~(rel[g0:g1, g0:g1] & kw[:, None]).any(axis=0)
                if np.array_equal(new, kw):
                    break
                kw = new
            kept_s[g0:g1] = kw
    pos = np.flatnonzero(kept_s)[:max_keep]
    kept = np.zeros(k, bool)
    kept[order[pos]] = True
    picks = np.full(max_keep, -1, np.int32)
    picks[:len(pos)] = order[pos]
    if 0 < len(pos) < max_keep and sticky[pos[-1]]:
        picks[len(pos):] = order[pos[-1]]
    return kept, picks


def edge_case(case):
    """(boxes, scores, thr, max_keep) of one regime the sorted form must
    get exactly right."""
    k = {"k1": 1, "k33": 33, "k257": 257}.get(case, 200)
    boxes, scores = candidates(60 + k + len(case),
                               k, "ties" if case == "ties" else "dense")
    thr, max_keep = 0.7, k
    if case in ("zero_area", "negative_area"):
        rng = np.random.default_rng(61)
        hit = rng.choice(k, 12, replace=False)
        if case == "zero_area":  # zero width or zero height
            boxes[hit[:6], 2] = boxes[hit[:6], 0]
            boxes[hit[6:], 3] = boxes[hit[6:], 1]
        else:  # x2 < x1, one with y2 < y1 too (a positive signed area)
            boxes[hit, 0], boxes[hit, 2] = boxes[hit, 2], boxes[hit, 0].copy()
            boxes[hit[0], 1], boxes[hit[0], 3] = boxes[hit[0], 3], \
                boxes[hit[0], 1].copy()
        scores[hit[:4]] = np.float32(0.99)  # picked early
        scores[hit[4:]] = np.float32(0.01)  # picked late, if at all
    elif case == "thr1":
        thr = 1.0
    elif case == "thr_above1":
        thr, max_keep = 1.5, 40
    elif case == "thr0":
        thr = 0.0
    elif case == "thr_negative":
        thr = -0.5
    elif case == "cap0":
        max_keep = 0
    elif case == "cap1":
        max_keep = 1
    elif case == "cap_short":
        max_keep = 9
    elif case == "all_dead":
        scores[:] = 0.0
        scores[::7] = -1.0
    elif case == "k1":
        scores[:] = 0.5
    return boxes, scores, thr, max_keep


EDGE_CASES = ["zero_area", "negative_area", "thr1", "thr_above1", "thr0",
              "thr_negative", "cap0", "cap1", "cap_short", "ties", "all_dead",
              "k1", "k33", "k257"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_sorted_form_equals_the_loop(case):
    """The kernel's sorted formulation (a NumPy transcription) gives the
    loop's kept mask and picks bit for bit: the plain loop, and the
    interpret-mode Pallas kernel's kept mask, on sticky zero-area and
    negative-area boxes, thr >= 1, thr = 0 and thr < 0, caps of 0, 1 and
    below the pick count, saturated 1.0 ties, an all-dead segment, K = 1
    and ragged K."""
    boxes, scores, thr, max_keep = edge_case(case)
    want_kept, want_picks = sorted_numpy(boxes, scores, thr, max_keep)
    kept, picks = suppress_mask_seq_plain(torch.from_numpy(boxes)[None],
                                          torch.from_numpy(scores)[None], thr,
                                          max_keep)
    np.testing.assert_array_equal(kept[0].numpy(), want_kept)
    np.testing.assert_array_equal(picks[0].numpy(), want_picks)
    if max_keep > 0:  # the Pallas kernel takes max_det >= 1
        np.testing.assert_array_equal(
            np.asarray(jax_pallas_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                       thr, max_keep)), want_kept)
    n_picks = int((want_picks >= 0).sum())
    if case in ("zero_area", "negative_area", "thr1", "thr_above1"):
        # a sticky pick repeats to the end
        assert n_picks == max_keep and want_picks[-1] == want_picks[-2]
    elif case == "cap0":
        assert want_picks.shape == (0,) and not want_kept.any()
    elif case == "all_dead":
        assert n_picks == 0 and not want_kept.any()
    elif case in ("cap1", "cap_short", "k1"):
        assert want_kept.sum() == n_picks == min(max_keep, 9)
    else:
        assert 0 < want_kept.sum() == n_picks < (scores > 0).sum()


@pytest.mark.parametrize("regime", REGIMES)
def test_sorted_form_equals_the_loop_at_rpn_size(regime):
    """K = 1000 in four bands, with a NaN threshold on one segment (every
    pair suppresses, a box itself too): the sorted form == the plain loop,
    kept and picks."""
    boxes, scores = candidates(70, 1000, regime, segments=2)
    for s, thr in ((0, 0.7), (1, float("nan"))):
        want_kept, want_picks = sorted_numpy(boxes[s], scores[s], thr, 1000)
        kept, picks = suppress_mask_seq_plain(
            torch.from_numpy(boxes[s:s + 1]),
            torch.from_numpy(scores[s:s + 1]), thr, 1000)
        np.testing.assert_array_equal(kept[0].numpy(), want_kept)
        np.testing.assert_array_equal(picks[0].numpy(), want_picks)
    assert want_kept.sum() == 1  # the NaN threshold: the first pick only


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("k", [96, 300])
def test_plain_matches_interpret_mode_kernel(regime, k):
    boxes, scores = candidates(10 + k, k, regime)
    for max_keep in (8, k):
        for thr in (0.7, 0.5):
            want = np.asarray(jax_pallas_mask(jnp.asarray(boxes),
                                              jnp.asarray(scores), thr,
                                              max_keep))
            got = suppress_mask(torch.from_numpy(boxes),
                                torch.from_numpy(scores), thr, max_keep)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("regime", REGIMES)
def test_plain_matches_fixpoint_at_rpn_size(regime):
    """K = 1000 (an RPN level): the sequential loop, JAX's fixpoint
    ``ops.nms.suppress_mask`` and the port's fixpoint agree."""
    k = 1000
    boxes, scores = candidates(20, k, regime, segments=3)
    for max_keep in (8, k):
        kept, _ = suppress_mask_seq_plain(torch.from_numpy(boxes),
                                          torch.from_numpy(scores), 0.7,
                                          max_keep)
        port_fix = tnms.suppress_mask(torch.from_numpy(boxes),
                                      torch.from_numpy(scores), 0.7, max_keep)
        np.testing.assert_array_equal(kept.numpy(), port_fix.numpy())
        for s in range(3):
            want = np.asarray(jax_fixpoint_mask(
                jnp.asarray(boxes[s]), jnp.asarray(scores[s]), 0.7,
                max_keep))
            np.testing.assert_array_equal(kept[s].numpy(), want)
            one = tnms.suppress_mask(torch.from_numpy(boxes[s]),
                                     torch.from_numpy(scores[s]), 0.7,
                                     max_keep)
            np.testing.assert_array_equal(one.numpy(), want)
        if max_keep == k:
            assert 0 < kept.sum() < (scores > 0).sum()


@pytest.mark.parametrize("regime", REGIMES)
def test_picks_follow_the_loop(regime):
    """Picks in pick order, -1 after the last; ties go to the lower index;
    segments are independent."""
    k, max_keep = 257, 40
    boxes, scores = candidates(30, k, regime, segments=4)
    kept, picks = suppress_mask_seq_plain(torch.from_numpy(boxes),
                                          torch.from_numpy(scores), 0.5,
                                          max_keep)
    assert picks.dtype == torch.int32 and picks.shape == (4, max_keep)
    for s in range(4):
        want_kept, want_picks = greedy_numpy(boxes[s], scores[s], 0.5,
                                             max_keep)
        np.testing.assert_array_equal(kept[s].numpy(), want_kept)
        got = picks[s].numpy()
        np.testing.assert_array_equal(got[:len(want_picks)], want_picks)
        assert np.all(got[len(want_picks):] == -1)
        one_kept, one_picks = suppress_mask_seq_plain(
            torch.from_numpy(boxes[s:s + 1]),
            torch.from_numpy(scores[s:s + 1]), 0.5, max_keep)
        assert torch.equal(one_kept[0], kept[s])
        assert torch.equal(one_picks[0], picks[s])


def test_zero_area_box_is_picked_again():
    """The literal loop: a live box of zero area has IoU 0 with itself, so it
    stays alive and is picked at every later step, as the reference's kernel
    does."""
    boxes, scores = candidates(40, 64, "sparse")
    boxes[5, 2] = boxes[5, 0]  # zero width
    scores[5] = 0.9999  # picked within the first steps
    thr, max_keep = 0.5, 12
    want = np.asarray(jax_pallas_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                      thr, max_keep))
    kept, picks = suppress_mask_seq(torch.from_numpy(boxes)[None],
                                    torch.from_numpy(scores)[None], thr,
                                    max_keep)
    np.testing.assert_array_equal(kept[0].numpy(), want)
    p = picks[0].tolist()
    assert 5 in p and p[p.index(5):] == [5] * (max_keep - p.index(5))


@pytest.mark.parametrize("regime", ["dense", "ties"])
def test_nms_seq_matches_nms_pallas(regime):
    """Class-aware dets from the picks equal the interpret-mode kernel's
    ``nms_pallas``, single and batched."""
    k = 200
    boxes, scores = candidates(50, k, regime)
    cls = np.random.default_rng(51).integers(0, 3, k).astype(np.float32)
    want_d, want_v = jax_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(cls), iou_thres=0.5,
                                    max_det=32)
    args = (torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(cls))
    d, v = nms_seq(*args, iou_thres=0.5, max_det=32)
    np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want_d))
    assert v.sum() > 8
    db, vb = nms_seq(*(a[None].expand(2, *a.shape) for a in args),
                     iou_thres=0.5, max_det=32)
    assert torch.equal(db[1], d) and torch.equal(vb[0], v)


def test_cuda_wrapper_refuses_cpu_tensors():
    before = suppress_mask_seq_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        suppress_mask_seq_cuda(torch.zeros(1, 8, 4), torch.zeros(1, 8), 0.5,
                               8)
    assert suppress_mask_seq_cuda.launches == before
    assert MAX_K == 1024
