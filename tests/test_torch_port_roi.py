"""The port's RoI resize (roi_align / roi_pool of square-padded maps) against
the JAX package's and against straight-line oracles.

Tolerances: "max" (roi_pool) exactly equal to the JAX package's; "avg"
(roi_align) within 1e-6 of the call's largest output value (measured over
this file's 37 calls, ``pytest -s`` prints each: 29 bit-equal, at most
1.762e-07; the port follows XLA's compiled op order, and only XLA's
vectorised reduction sums some samples in another order). Against the oracles of
``tests/test_roi.py`` (copied, not imported): "avg" 1e-4 and "max" 1e-5
absolute, their bounds there.
"""

import itertools

import numpy as np
import pytest
import torch

from edgeml_tpu.ops.roi import roi_resize_batch as jax_roi_resize_batch
from edgeml_tpu_torch.ops.roi import roi_resize, roi_resize_batch

torch.set_num_threads(1)
AVG_TOL = 1e-6


def bilinear(fm, y, x):
    c, S, _ = fm.shape
    if y < -1.0 or y > S or x < -1.0 or x > S:
        return np.zeros(c)
    y = min(max(y, 0.0), S - 1)
    x = min(max(x, 0.0), S - 1)
    y0, x0 = int(np.floor(y)), int(np.floor(x))
    y1, x1 = min(y0 + 1, S - 1), min(x0 + 1, S - 1)
    ly, lx = y - y0, x - x0
    return (
        fm[:, y0, x0] * (1 - ly) * (1 - lx)
        + fm[:, y0, x1] * (1 - ly) * lx
        + fm[:, y1, x0] * ly * (1 - lx)
        + fm[:, y1, x1] * ly * lx
    )


def oracle_align(fm, h, w, P):
    c = fm.shape[0]
    h, w = max(h, 1.0), max(w, 1.0)
    bin_h, bin_w = h / P, w / P
    gh, gw = int(np.ceil(bin_h)), int(np.ceil(bin_w))
    out = np.zeros((c, P, P))
    for ph in range(P):
        for pw in range(P):
            acc = np.zeros(c)
            for iy in range(gh):
                for ix in range(gw):
                    yy = ph * bin_h + (iy + 0.5) * bin_h / gh
                    xx = pw * bin_w + (ix + 0.5) * bin_w / gw
                    acc += bilinear(fm, yy, xx)
            out[:, ph, pw] = acc / (gh * gw)
    return out


def oracle_pool(fm, h, w, P):
    c, S, _ = fm.shape
    rh = max(round(h) + 1, 1)
    rw = max(round(w) + 1, 1)
    out = np.zeros((c, P, P))
    for ph in range(P):
        for pw in range(P):
            hs = min(max(int(np.floor(ph * rh / P)), 0), S)
            he = min(max(int(np.ceil((ph + 1) * rh / P)), 0), S)
            ws = min(max(int(np.floor(pw * rw / P)), 0), S)
            we = min(max(int(np.ceil((pw + 1) * rw / P)), 0), S)
            if he <= hs or we <= ws:
                out[:, ph, pw] = 0.0
            else:
                out[:, ph, pw] = fm[:, hs:he, ws:we].max(axis=(1, 2))
    return out


def ragged_batch(seed, S, b=5, c=3):
    """Seeded square-padded maps (content top-left, zeros beyond) and their
    (h, w): one full map, integer and fractional sides, and sides below 1."""
    rng = np.random.default_rng(seed)
    sizes = np.stack([rng.uniform(0.2, S + 0.49, b),
                      rng.uniform(0.2, S + 0.49, b)], 1).astype(np.float32)
    sizes[0] = S
    sizes[1] = np.round(sizes[1])
    sizes[2, 0] = 0.4  # h < 1
    if b > 3:
        sizes[3, 1] = 0.75  # w < 1
    f = np.zeros((b, c, S, S), np.float32)
    for i, (h, w) in enumerate(sizes):
        hh, ww = min(int(np.ceil(h)), S), min(int(np.ceil(w)), S)
        f[i, :, :hh, :ww] = rng.normal(size=(c, hh, ww))
    return f, sizes


def check_against_jax(f, sizes, P):
    for func in ("max", "avg"):
        got = roi_resize_batch(f, sizes, P, func, device="cpu")
        want = jax_roi_resize_batch(f, sizes, P, func)
        assert got.dtype == np.float32 and got.shape == want.shape == (
            len(f), f.shape[1], P, P)
        if func == "max":
            np.testing.assert_array_equal(got, want)
        else:
            err = float(np.abs(got - want).max())
            scale = float(np.abs(want).max())
            print(f"[roi_avg_vs_jax] S={f.shape[-1]} P={P} "
                  f"rel_err={err / scale:.3e}")  # shown with pytest -s
            assert err <= AVG_TOL * scale, err


@pytest.mark.parametrize("S,P", [(20, 8), (40, 8), (80, 8), (20, 1),
                                 (80, 1), (40, 2), (20, 7), (80, 5)])
def test_stage_sizes_match_jax(S, P):
    """The real stage sizes (20: SPPF / C3 23, 40: C3 20, 80: C3 17) at the
    CLI's P = 8, P = 1, and sides that do not divide S."""
    check_against_jax(*ragged_batch(S * 10 + P, S), P)


@pytest.mark.parametrize("S,P", [(3, 8), (7, 13), (20, 32), (1, 4), (5, 100)])
def test_p_above_s_matches_jax(S, P):
    check_against_jax(*ragged_batch(S + P, S, b=6), P)


@pytest.mark.parametrize("seed", range(3))
def test_seeded_ragged_batches_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    for S, P in itertools.product((4, 11), (1, 3, 4, 6)):
        f, sizes = ragged_batch(int(rng.integers(1 << 30)), S, b=4, c=2)
        check_against_jax(f, sizes, P)


@pytest.mark.parametrize("hw", [(10, 16), (16, 10), (13, 13), (0.3, 9),
                                (9, 0.6)])
def test_avg_matches_oracle(hw):
    """tests/test_roi.py's roi_align cases, and sides below 1."""
    rng = np.random.default_rng(0)
    h, w = hw
    side = int(max(np.ceil(h), np.ceil(w)))
    fm = np.zeros((3, side, side), np.float32)
    fm[:, :int(np.ceil(h)), :int(np.ceil(w))] = rng.random(
        (3, int(np.ceil(h)), int(np.ceil(w))))
    got = roi_resize_batch(fm[None], np.array([[h, w]], np.float32), 4,
                           "avg", device="cpu")[0]
    np.testing.assert_allclose(got, oracle_align(fm, float(h), float(w), 4),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("hw", [(10, 16), (16, 10), (0.3, 9)])
def test_max_matches_oracle(hw):
    """tests/test_roi.py's roi_pool cases, and a side below 1."""
    rng = np.random.default_rng(1)
    h, w = hw
    side = int(max(np.ceil(h), np.ceil(w)))
    fm = np.zeros((2, side, side), np.float32)
    fm[:, :int(np.ceil(h)), :int(np.ceil(w))] = rng.random(
        (2, int(np.ceil(h)), int(np.ceil(w))))
    got = roi_resize_batch(fm[None], np.array([[h, w]], np.float32), 4,
                           "max", device="cpu")[0]
    np.testing.assert_allclose(got, oracle_pool(fm, float(h), float(w), 4),
                               atol=1e-5, rtol=0)


def test_batch_independent_and_device_guard(monkeypatch):
    """An image's result does not depend on the rest of its batch; a bad
    func raises; no CUDA device and none asked for raises."""
    f, sizes = ragged_batch(9, 20)
    for func in ("avg", "max"):
        whole = roi_resize(torch.from_numpy(f), torch.from_numpy(sizes), 8,
                           func)
        for i in range(len(f)):
            one = roi_resize(torch.from_numpy(f[i:i + 1]),
                             torch.from_numpy(sizes[i:i + 1]), 8, func)
            assert torch.equal(one[0], whole[i])
    with pytest.raises(ValueError, match="func"):
        roi_resize_batch(f, sizes, 8, "sum", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        roi_resize_batch(f, sizes, 8)
