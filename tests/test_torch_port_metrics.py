"""The port's box geometry and matcher (``ops/metrics.py``) against the JAX
package's, on the CPU.

``box_correct`` (batched over images in the port, vmapped in the reference)
is held bit for bit against JAX on fuzzed padded sets: random boxes, boxes
on an integer grid (exact IoU ties, including ties for the best label of a
detection, where the largest label index wins), degenerate zero-area pairs
(NaN IoU), all-padding images and T = 10 thresholds. The geometry helpers
agree with JAX to f32 rounding (1e-6). Tolerance of the matcher: none.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.ops import metrics as jm
from edgeml_tpu_torch.ops import metrics as tm

torch.set_num_threads(1)

IOUV10 = np.linspace(0.5, 0.95, 10).astype(np.float32)
_jax_batched = jax.jit(jax.vmap(jm.box_correct, in_axes=(0, 0, 0, 0, 0, 0,
                                                         None)))


def padded_sets(seed, b, n, m, ncls, grid=False, degenerate=False):
    rng = np.random.default_rng(seed)

    def boxes(k):
        if grid:  # integer corners: many exactly equal IoUs
            lo = rng.integers(0, 6, (b, k, 2))
            return np.concatenate([lo, lo + rng.integers(1, 4, (b, k, 2))],
                                  -1).astype(np.float32)
        c = rng.uniform(0, 1, (b, k, 2))
        wh = rng.uniform(0.05, 0.4, (b, k, 2))
        return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)

    db, lb = boxes(n), boxes(m)
    dc = rng.integers(0, ncls, (b, n)).astype(np.int32)
    lc = rng.integers(0, ncls, (b, m)).astype(np.int32)
    if not grid:  # most detections near a label: matches at every t
        src = rng.integers(0, m, (b, n))
        near = np.take_along_axis(lb, src[..., None], 1)
        db = np.where(rng.random((b, n, 1)) < 0.7, near + rng.normal(
            0, 0.02, (b, n, 4)), db).astype(np.float32)
        dc = np.where(rng.random((b, n)) < 0.8,
                      np.take_along_axis(lc, src, 1), dc).astype(np.int32)
    dv = rng.random((b, n)) < 0.85
    lv = rng.random((b, m)) < 0.85
    dv[0] = False  # an image of padding only
    lv[1] = False  # an image without labels
    if degenerate:  # zero-area pairs: IoU 0 / 0 = NaN
        pt = rng.uniform(0, 1, (b, 2)).astype(np.float32)
        db[:, 0] = np.concatenate([pt, pt], -1)
        lb[:, 0] = np.concatenate([pt, pt], -1)
        dc[:, 0] = lc[:, 0]
        dv[2:, 0] = lv[2:, 0] = True
    return db, dc, dv, lb, lc, lv


def both(db, dc, dv, lb, lc, lv, iouv):
    want = np.asarray(_jax_batched(*map(jnp.asarray, (db, dc, dv, lb, lc, lv)),
                                   jnp.asarray(iouv)))
    got = tm.box_correct(*map(torch.from_numpy, (db, dc, dv, lb, lc, lv)),
                         torch.from_numpy(iouv)).numpy()
    return got, want


@pytest.mark.parametrize("t", [1, 10])
@pytest.mark.parametrize("case", ["random", "grid", "degenerate"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_correct_bit_identical(seed, case, t):
    iouv = np.array([0.5], np.float32) if t == 1 else IOUV10
    sets = padded_sets(seed * 10 + t, 6, 24, 12, 3, grid=case == "grid",
                       degenerate=case == "degenerate")
    got, want = both(*sets, iouv)
    assert got.shape == want.shape == (6, 24, t)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want[0].any() and not want[1].any()


def test_box_correct_ties_and_nan_by_hand():
    """Two equal labels and two equal detections: both detections choose
    the larger label index, so only the first is a true positive and label
    0 stays unmatched (the reference's tie rule). Two degenerate boxes at
    one point give NaN and no match."""
    lab = np.array([[[0, 0, 2, 2], [0, 0, 2, 2], [5, 5, 5, 5]]], np.float32)
    det = np.array([[[0, 0, 2, 2], [0, 0, 2, 2], [5, 5, 5, 5]]], np.float32)
    cls = np.zeros((1, 3), np.int32)
    valid = np.ones((1, 3), bool)
    got, want = both(det, cls, valid, lab, cls, valid,
                     np.array([0.5], np.float32))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :, 0], [True, False, False])
    iou = tm.box_iou(torch.from_numpy(lab[0]), torch.from_numpy(det[0]))
    assert torch.isnan(iou[2, 2]) and float(tm.box_iou_safe(
        torch.from_numpy(lab[0]), torch.from_numpy(det[0]))[2, 2]) == 0.0


def test_box_correct_empty_sides():
    z4 = np.zeros((2, 0, 4), np.float32)
    got = tm.box_correct(torch.from_numpy(z4), torch.zeros(2, 0),
                         torch.zeros(2, 0, dtype=torch.bool),
                         torch.ones(2, 3, 4), torch.zeros(2, 3),
                         torch.ones(2, 3, dtype=torch.bool),
                         torch.tensor([0.5]))
    assert got.shape == (2, 0, 1)
    got = tm.box_correct(torch.ones(2, 3, 4), torch.zeros(2, 3),
                         torch.ones(2, 3, dtype=torch.bool),
                         torch.from_numpy(z4), torch.zeros(2, 0),
                         torch.zeros(2, 0, dtype=torch.bool),
                         torch.tensor([0.5, 0.7]))
    assert got.shape == (2, 3, 2) and not got.any()


def test_geometry_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (7, 4)).astype(np.float32)
    a = rng.uniform(0, 1, (5, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    for tf, jf in ((tm.xywh2xyxy, jm.xywh2xyxy), (tm.xyxy2xywh, jm.xyxy2xywh),
                   (tm.box_area, jm.box_area)):
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                                   np.asarray(jf(jnp.asarray(x))), atol=1e-6)
    b = tm.xywh2xyxy(torch.from_numpy(x)).numpy()
    for tf, jf in ((tm.box_iou, jm.box_iou), (tm.box_iou_safe,
                                              jm.box_iou_safe)):
        np.testing.assert_allclose(
            tf(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
            np.asarray(jf(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
