"""The port's NMS against the JAX package, bit for bit.

Inputs are made from a seed with numpy and handed to both frameworks as
numpy arrays. Tolerance everywhere in this file: none — keep masks, dets and
valid masks must be identical, because the port repeats the reference's f32
arithmetic op for op and ranks with stable sorts (the reference's canonical
tie order). bf16 values are made in f32 (every bf16 value is exact in f32)
and cast on each side.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.ops.nms import MAX_WH, greedy_keep_mask
from edgeml_tpu.ops.nms import nms_split_batch as jax_nms_split_batch
from edgeml_tpu.ops.nms import topk1d as jax_topk1d
from edgeml_tpu.ops.nms_fused import greedy_keep_mask_fused as jax_fused
from edgeml_tpu_torch.ops import nms as tnms
from edgeml_tpu_torch.ops.nms_fused import (
    greedy_keep_mask_blocked_plain, greedy_keep_mask_fused,
    greedy_keep_mask_plain,
)

torch.set_num_threads(1)


def fuzz_boxes(seed, b, k, spread, ncls):
    """The fuzz regimes of tests/test_nms_fused.py: sorted scores with a
    gated-out tail, class offsets applied."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(20, 20 + spread, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(30, 150, (b, k, 2)).astype(np.float32)
    scores = np.sort(rng.random((b, k)).astype(np.float32), axis=-1)[:, ::-1]
    scores = np.ascontiguousarray(scores)
    scores[scores < 0.05] = 0.0  # gated-out tail
    cls = rng.integers(0, ncls, (b, k)).astype(np.float32)
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], axis=-1)
    return (boxes + cls[..., None] * np.float32(MAX_WH)).astype(np.float32), \
        scores


REGIMES = [(0, 80.0, 1), (1, 300.0, 4), (2, 2000.0, 80)]


@pytest.mark.parametrize("k", [256, 1024])
@pytest.mark.parametrize("thr", [0.6, 0.45])
@pytest.mark.parametrize("seed,spread,ncls", REGIMES)
def test_keep_mask_plain_matches_jax(seed, spread, ncls, k, thr):
    """greedy_keep_mask_plain == the interpret-mode Pallas kernel ==
    vmap(greedy_keep_mask), bit for bit."""
    b = 2
    off, sc = fuzz_boxes(seed + k, b, k, spread, ncls)
    want = np.asarray(jax.vmap(
        lambda bb, ss: greedy_keep_mask(bb, ss, thr))(jnp.asarray(off),
                                                      jnp.asarray(sc)))
    got = greedy_keep_mask_plain(torch.from_numpy(off),
                                 torch.from_numpy(sc), thr).numpy()
    np.testing.assert_array_equal(got, want)
    if k == 256 or seed == 0:  # interpret mode is slow at K = 1024
        pallas = np.asarray(jax_fused(jnp.asarray(off), jnp.asarray(sc), thr,
                                      interpret=True))
        np.testing.assert_array_equal(got, pallas)
    # the CPU dispatch of the public entry point is the plain version
    np.testing.assert_array_equal(
        greedy_keep_mask_fused(torch.from_numpy(off), torch.from_numpy(sc),
                               thr).numpy(), want)
    # and the single-image form
    np.testing.assert_array_equal(
        tnms.greedy_keep_mask(torch.from_numpy(off[0]),
                              torch.from_numpy(sc[0]), thr).numpy(), want[0])


def test_iou_threshold_rounds_to_f32_like_jax():
    """Two boxes whose IoU lies between the f64 threshold and its f32
    rounding: the compare must use the f32-rounded threshold, as JAX's weakly
    typed compare does. IoU here is exactly 0.6f32 (> 0.6 in f64)."""
    thr = 0.6
    t32 = np.float32(thr)
    assert float(t32) > thr  # 0.6f32 = 0.60000002384...
    # box0 area 100, box1 inside it with area 60 -> iou = 60/100
    boxes = np.array([[[0, 0, 10, 10], [0, 0, 6, 10]]], np.float32)
    iou = np.float32(60.0) / np.float32(100.0)
    assert iou == t32
    sc = np.array([[0.9, 0.8]], np.float32)
    want = np.asarray(jax.vmap(
        lambda bb, ss: greedy_keep_mask(bb, ss, thr))(jnp.asarray(boxes),
                                                      jnp.asarray(sc)))
    got = greedy_keep_mask_plain(torch.from_numpy(boxes),
                                 torch.from_numpy(sc), thr).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [[True, True]]  # iou == thr: not suppressed


def make_case(rng, b, n, nc, hot_boxes=0):
    """Copy of tests/test_nms_split_batch.py make_case, returning numpy."""
    obj = rng.random((b, n)).astype(np.float32)
    xywh = np.stack(
        [
            rng.uniform(50, 600, (b, n)),
            rng.uniform(50, 600, (b, n)),
            rng.uniform(5, 80, (b, n)),
            rng.uniform(5, 80, (b, n)),
        ],
        axis=-1,
    ).astype(np.float32)
    cls = (rng.random((b, n, nc)) ** 4).astype(np.float32)
    if hot_boxes:
        h = hot_boxes
        cls[:, :h, :] *= 1e-3
        cls[:, np.arange(h), rng.integers(0, nc, h)] = 0.99
        obj[:, :h] = 1.0
        cls[:, h : h + 10, :] = 0.9
        obj[:, h : h + 10] = 1.0
        cls[:, h + 10 :, :] *= 0.05
    return obj, xywh, cls


def tie_case(rng, b, n, nc):
    """tests/test_nms_split_batch.py:187 — a coarse score grid, so every
    value collides with ~n*nc/12 others (bf16 tie clusters)."""
    obj = np.ones((b, n), np.float32)
    cls = rng.choice(
        [0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99],
        (b, n, nc),
    ).astype(np.float32)
    xywh = np.stack(
        [
            rng.uniform(50, 600, (b, n)),
            rng.uniform(50, 600, (b, n)),
            rng.uniform(5, 80, (b, n)),
            rng.uniform(5, 80, (b, n)),
        ],
        axis=-1,
    ).astype(np.float32)
    return obj, xywh, cls


def _both(obj, xywh, cls, bf16, pool, **kw):
    if bf16:
        jo = jnp.asarray(obj, jnp.bfloat16)
        jc = jnp.asarray(cls, jnp.bfloat16)
        to = torch.from_numpy(obj).to(torch.bfloat16)
        tc = torch.from_numpy(cls).to(torch.bfloat16)
    else:
        jo, jc = jnp.asarray(obj), jnp.asarray(cls)
        to, tc = torch.from_numpy(obj), torch.from_numpy(cls)
    d_ref, v_ref = jax_nms_split_batch(jo, jnp.asarray(xywh), jc, pool=pool,
                                       **kw)
    d, v = tnms.nms_split_batch(to, torch.from_numpy(xywh), tc, **kw)
    return (np.asarray(d_ref), np.asarray(v_ref)), (d.numpy(), v.numpy())


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize(
    "b,n,nc,max_cand,hot,pool",
    [
        (3, 500, 80, 128, 0, True),
        (2, 2000, 80, 1024, 0, True),
        (2, 600, 80, 256, 200, True),  # hot boxes: JAX takes its fallback
        (2, 600, 80, 256, 200, False),
        (2, 300, 6, 64, 0, False),
        (1, 50, 3, 32, 0, True),  # tiny n, pool smaller than k
    ],
)
def test_nms_split_batch_matches_jax(b, n, nc, max_cand, hot, pool, bf16):
    rng = np.random.default_rng(b * 1000 + n + nc + hot)
    obj, xywh, cls = make_case(rng, b, n, nc, hot_boxes=hot)
    kw = dict(conf_thres=1e-4, iou_thres=0.6, max_det=64, max_cand=max_cand)
    (d_ref, v_ref), (d, v) = _both(obj, xywh, cls, bf16, pool, **kw)
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(d, d_ref)


@pytest.mark.parametrize("bf16", [False, True])
def test_tie_clusters_match_jax(bf16):
    """Stable-sort ranking reproduces the reference's canonical order
    (score descending, index ascending) through large tie clusters — in
    bf16 the reference ranks packed integer keys, in f32 plain values."""
    rng = np.random.default_rng(9)
    obj, xywh, cls = tie_case(rng, 2, 2000, 80)
    kw = dict(conf_thres=1e-4, iou_thres=0.6, max_det=300, max_cand=1024)
    (d_ref, v_ref), (d, v) = _both(obj, xywh, cls, bf16, True, **kw)
    assert v_ref.sum() > 0
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(d, d_ref)


@pytest.mark.parametrize("bf16", [False, True])
def test_single_label_matches_jax(bf16):
    rng = np.random.default_rng(2)
    obj, xywh, cls = make_case(rng, 2, 400, 20)
    kw = dict(conf_thres=1e-3, iou_thres=0.5, max_det=32, max_cand=64,
              multi_label=False)
    (d_ref, v_ref), (d, v) = _both(obj, xywh, cls, bf16, True, **kw)
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(d, d_ref)


def test_conf_threshold_rounds_to_score_dtype():
    """A bf16 score equal to bf16(conf_thres) — above conf_thres in f32 —
    must be gated out in bf16, as the reference's weakly typed compare does
    (a compare in f32 would keep it)."""
    conf = 0.003  # bf16 rounds it up, to 0.0030059814453125
    t16 = float(torch.tensor(conf, dtype=torch.bfloat16))
    assert t16 > conf
    b, n, nc = 1, 8, 2
    obj = np.ones((b, n), np.float32)
    cls = np.zeros((b, n, nc), np.float32)
    cls[0, :4, 0] = t16  # exactly bf16(conf) after the cast
    cls[0, 4:, 1] = 0.5
    xywh = np.tile(np.array([100, 100, 20, 20], np.float32), (b, n, 1))
    xywh[0, :, 0] += 40 * np.arange(n, dtype=np.float32)
    kw = dict(conf_thres=conf, iou_thres=0.6, max_det=16, max_cand=16)
    (d_ref, v_ref), (d, v) = _both(obj, xywh, cls, True, True, **kw)
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(d, d_ref)
    assert int(v.sum()) == 4  # boxes 4..7 only; 0..3 sit at the threshold


def test_topk1d_is_stable_descending():
    x = torch.tensor([0.5, 0.9, 0.5, 0.9, -1.0, 0.5])
    v, i = tnms.topk1d(x, 4)
    assert torch.equal(v, torch.tensor([0.9, 0.9, 0.5, 0.5]))
    assert i.tolist() == [1, 3, 0, 2]


@pytest.mark.parametrize("k", [1280, 1536, 2048])
@pytest.mark.parametrize("seed,spread,ncls", REGIMES)
def test_keep_mask_blocked_plain_matches_jax(seed, spread, ncls, k):
    """K in (1024, 2048], the blocked suppressor's range: the plain blocked
    and global masks == JAX greedy_keep_mask(block=256) ==
    vmap(greedy_keep_mask), bit for bit; the CPU dispatch of the entry point
    takes the blocked plain version there."""
    thr = 0.6 if seed != 1 else 0.45
    off, sc = fuzz_boxes(seed + k, 2, k, spread, ncls)
    jb, js = jnp.asarray(off), jnp.asarray(sc)
    want = np.asarray(jax.jit(jax.vmap(
        lambda bb, ss: greedy_keep_mask(bb, ss, thr)))(jb, js))
    want_blk = np.asarray(jax.jit(jax.vmap(
        lambda bb, ss: greedy_keep_mask(bb, ss, thr, block=256)))(jb, js))
    np.testing.assert_array_equal(want_blk, want)
    tb, ts = torch.from_numpy(off), torch.from_numpy(sc)
    got = greedy_keep_mask_blocked_plain(tb, ts, thr).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(greedy_keep_mask_plain(tb, ts, thr).numpy(),
                                  want)
    np.testing.assert_array_equal(greedy_keep_mask_fused(tb, ts, thr).numpy(),
                                  want)
    np.testing.assert_array_equal(
        tnms.greedy_keep_mask(tb[1], ts[1], thr, block=256).numpy(), want[1])
    assert want.sum() > 0
    if ncls < 80:  # the dense regimes: some candidates are suppressed
        assert want.sum() < (sc > 0).sum()


@pytest.mark.parametrize("num,den", [(6, 10), (1, 3), (2, 3)])
def test_keep_mask_blocked_plain_exact_ties_match_jax(num, den):
    """Integer-cornered boxes of one class on a small grid (many pairs share
    an IoU exactly) with the threshold set to one such f32 quotient: IoU at
    the threshold does not suppress. Blocked plain == global plain == JAX
    greedy_keep_mask(block=256), bit for bit, at K = 1100."""
    thr = float(np.float32(num) / np.float32(den))
    rng = np.random.default_rng(num * 100 + den)
    b, k = 2, 1100
    xy = rng.integers(0, 24, (b, k, 2))
    wh = rng.integers(1, 13, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    boxes[0, 0] = [0, 0, den, 7]  # a pair at the threshold, by hand
    boxes[0, 1] = [0, 0, num, 7]
    sc = np.sort(rng.random((b, k)).astype(np.float32), axis=-1)[:, ::-1]
    sc = np.ascontiguousarray(sc)
    jb, js = jnp.asarray(boxes), jnp.asarray(sc)
    want = np.asarray(jax.jit(jax.vmap(
        lambda bb, ss: greedy_keep_mask(bb, ss, thr, block=256)))(jb, js))
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(sc)
    np.testing.assert_array_equal(
        greedy_keep_mask_blocked_plain(tb, ts, thr).numpy(), want)
    np.testing.assert_array_equal(greedy_keep_mask_plain(tb, ts, thr).numpy(),
                                  want)
    iou01 = np.float32(num * 7) / np.float32(den * 7)
    assert iou01 == np.float32(thr)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("case", ["all_invalid", "hole", "leading_bands",
                                  "thr0", "k1025", "k2047"])
def test_keep_mask_blocked_plain_edge_cases_match_jax(case):
    """The answers the blocked kernel is held to on the card where its
    shortcuts could go wrong: an all-invalid image, an invalid hole inside
    the valid prefix (across a band's edge), whole leading bands invalid,
    thr = 0.0 (any overlap suppresses) and ragged last bands and words
    (K = 1025, 2047). Blocked plain == global plain == JAX
    greedy_keep_mask(block=256), bit for bit."""
    k = {"k1025": 1025, "k2047": 2047}.get(case, 2048)
    thr = 0.0 if case == "thr0" else 0.6
    off, sc = fuzz_boxes(len(case) + k, 2, k, 300.0, 4)
    if case == "all_invalid":
        sc[0] = 0.0
    elif case == "hole":
        sc[0, 100:300] = 0.0
        sc[1, 5] = 0.0
        sc[1, 1000:1100] = 0.0
    elif case == "leading_bands":
        sc[0, :600] = 0.0
        sc[1, 1:] = 0.0
    jb, js = jnp.asarray(off), jnp.asarray(sc)
    want = np.asarray(jax.jit(jax.vmap(
        lambda bb, ss: greedy_keep_mask(bb, ss, thr, block=256)))(jb, js))
    tb, ts = torch.from_numpy(off), torch.from_numpy(sc)
    np.testing.assert_array_equal(
        greedy_keep_mask_blocked_plain(tb, ts, thr).numpy(), want)
    np.testing.assert_array_equal(greedy_keep_mask_plain(tb, ts, thr).numpy(),
                                  want)
    np.testing.assert_array_equal(greedy_keep_mask_fused(tb, ts, thr).numpy(),
                                  want)
    assert not want[sc <= 0].any()
    if case == "all_invalid":
        assert not want[0].any() and want[1].any()
    elif case == "leading_bands":
        assert want[1].tolist() == [True] + [False] * (k - 1)
    else:
        assert 0 < want.sum() < (sc > 0).sum()


@pytest.mark.parametrize("case", ["k33", "k257", "k1000", "all_invalid",
                                  "holes", "ties"])
def test_keep_mask_blocked_plain_at_monolithic_k_matches_jax(case):
    """K <= 1024, where the monolithic kernel runs the blocked kernel's
    banded walk as a cluster of 4 bands of 256: the blocked plain version
    (block = 256) == the global plain version == JAX greedy_keep_mask with
    and without block=256, bit for bit, on ragged K (a partial last band and
    word), an all-invalid image, invalid holes (one across a band's edge)
    and exact IoU ties at the threshold. The card holds the kernel against
    both plain versions."""
    k = {"k33": 33, "k257": 257, "k1000": 1000}.get(case, 1024)
    thr = 0.6
    off, sc = fuzz_boxes(len(case) + k, 2, k, 300.0, 4)
    if case == "all_invalid":
        sc[0] = 0.0
    elif case == "holes":
        sc[0, 200:300] = 0.0
        sc[1, 5] = 0.0
        sc[1, 700:800] = 0.0
    elif case == "ties":
        thr = float(np.float32(1) / np.float32(3))
        rng = np.random.default_rng(13)
        xy = rng.integers(0, 24, (2, k, 2))
        off = np.concatenate([xy, xy + rng.integers(1, 13, xy.shape)],
                             axis=-1).astype(np.float32)
        off[0, 0] = [0, 0, 3, 7]  # a pair at the threshold, by hand
        off[0, 1] = [0, 0, 1, 7]
    jb, js = jnp.asarray(off), jnp.asarray(sc)
    want = np.asarray(jax.jit(jax.vmap(
        lambda bb, ss: greedy_keep_mask(bb, ss, thr, block=256)))(jb, js))
    np.testing.assert_array_equal(want, np.asarray(jax.jit(jax.vmap(
        lambda bb, ss: greedy_keep_mask(bb, ss, thr)))(jb, js)))
    tb, ts = torch.from_numpy(off), torch.from_numpy(sc)
    got = greedy_keep_mask_blocked_plain(tb, ts, thr, block=256).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(greedy_keep_mask_plain(tb, ts, thr).numpy(),
                                  want)
    assert not want[sc <= 0].any()
    if case == "all_invalid":
        assert not want[0].any() and want[1].any()
    elif k > 33:  # 33 spread boxes of 4 classes rarely overlap
        assert 0 < want.sum() < (sc > 0).sum()


def test_keep_mask_blocked_matches_interpret_mode_kernel():
    """The blocked plain version == the reference's blocked Pallas kernel
    (_kernel_blocked) run in interpret mode at K = 2048, on clustered boxes
    (long suppression chains) with an invalid tail."""
    rng = np.random.default_rng(2048)
    b, k, hot = 2, 2048, 400
    centers = rng.uniform(50, 600, (b, hot, 2))
    idx = rng.integers(0, hot, (b, k))
    c = np.take_along_axis(centers, idx[..., None], axis=1) \
        + rng.normal(0, 6, (b, k, 2))
    wh = np.exp(rng.uniform(np.log(10), np.log(80), (b, k, 2)))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = np.sort(rng.random((b, k)).astype(np.float32))[:, ::-1].copy()
    scores[:, -k // 8:] = 0.0
    want = np.asarray(jax_fused(jnp.asarray(boxes), jnp.asarray(scores), 0.55,
                                interpret=True))
    got = greedy_keep_mask_blocked_plain(torch.from_numpy(boxes),
                                         torch.from_numpy(scores), 0.55)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < (scores > 0).sum()


@pytest.mark.parametrize("bf16", [False, True])
def test_nms_split_batch_max_cand_2048_matches_jax(bf16):
    """max_cand = 2048 (the SSDLite/RetinaNet tail): exact pair ranking over
    2048 boxes and the K = 2048 suppressor, bit for bit against JAX."""
    rng = np.random.default_rng(2048 + bf16)
    obj, xywh, cls = make_case(rng, 2, 3000, 8)
    kw = dict(conf_thres=1e-3, iou_thres=0.55, max_det=300, max_cand=2048)
    (d_ref, v_ref), (d, v) = _both(obj, xywh, cls, bf16, False, **kw)
    assert v_ref.sum() > 100
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(d, d_ref)


def test_topk1d_ties_at_retinanet_width():
    """N = 76,725 (RetinaNet's anchors at 640 px) with heavy ties: the stable
    sort's order equals the reference's chunked topk1d (lowest index first
    within a tie), values and indices."""
    rng = np.random.default_rng(76725)
    x = rng.choice(np.linspace(0.0, 1.0, 97).astype(np.float32), 76725)
    x[rng.random(76725) < 0.3] = -1.0
    v_ref, i_ref = jax_topk1d(jnp.asarray(x), 2048, chunk=10240)
    v, i = tnms.topk1d(torch.from_numpy(x), 2048)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
