"""The port's mAP core (``ops/map_kernel.py``) against the JAX package's and
the NumPy oracle, on the CPU.

``build_pool``'s arrays equal JAX's, array for array (K rounded up to 128
in both). On injected masks, ``map_from_masks``, ``map_per_threshold``,
``orie_map_pair`` and ``dataset_map`` (the port batched over draws, JAX
vmapped) agree with JAX within 3e-5 per mAP value, and with
``tests/oracle.py masked_map`` within the same; no labelled class gives NaN,
no detection gives 0. A draw's mAP does not depend on the batch it shares.
Inputs: up to 48 images, up to 8 classes, T in {1, 10}.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.ops import map_kernel as jmk
from edgeml_tpu_torch.ops import map_kernel as tmk
from oracle import make_random_dataset, masked_map

torch.set_num_threads(1)

TOL = 3e-5


def dataset(seed, n_img=24, n_cls=6, t=1, max_det=8, max_lab=5):
    rng = np.random.default_rng(seed)
    return make_random_dataset(rng, n_img=n_img, n_cls=n_cls,
                               max_det=max_det, max_lab=max_lab, t=t)


def masks(seed, b, n, p=0.5):
    rng = np.random.default_rng(seed)
    return rng.random((b, n)) < p


@pytest.mark.parametrize("num_classes", [None, 9])
@pytest.mark.parametrize("t", [1, 10])
def test_build_pool_arrays_equal_jax(t, num_classes):
    weak, strong, labels = dataset(t, n_img=40, n_cls=7, t=t)
    want = jmk.build_pool(weak, strong, labels, num_classes=num_classes)
    got = tmk.build_pool(weak, strong, labels, num_classes=num_classes)
    for name in ("tp", "img", "strong", "valid", "hist"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.class_ids == want.class_ids
    assert got.tp.shape[1] % 128 == 0 and got.num_iou_thresholds == t


def test_build_pool_tied_confidences_keep_row_order():
    """Equal confidences keep the row order of the stable per-class sort
    (weak stream first, then image order)."""
    weak, strong, labels = dataset(4, n_img=16, n_cls=3)
    weak = [(tp, np.round(conf, 1), cls) for tp, conf, cls in weak]
    strong = [(tp, np.round(conf, 1), cls) for tp, conf, cls in strong]
    want = jmk.build_pool(weak, strong, labels)
    got = tmk.build_pool(weak, strong, labels)
    for name in ("tp", "img", "strong", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_build_pool_unknown_class_raises_like_jax():
    weak, strong, labels = dataset(5, n_img=4, n_cls=3)
    labels[0] = np.array([7])
    with pytest.raises(KeyError):
        jmk.build_pool(weak, strong, labels, num_classes=3)
    with pytest.raises(KeyError):
        tmk.build_pool(weak, strong, labels, num_classes=3)


def _jax_batched(fn, pool, *arrays):
    return np.asarray(jax.vmap(lambda *a: fn(pool, *a))(
        *map(jnp.asarray, arrays)))


@pytest.mark.parametrize("t", [1, 10])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_from_masks_matches_jax_and_oracle(seed, t):
    weak, strong, labels = dataset(10 + seed, n_img=32, t=t)
    n = len(labels)
    wsel, ssel = masks(seed, 8, n), masks(seed + 50, 8, n, 0.3)
    lsel = wsel | ssel
    lsel[0] = True
    jpool = jmk.build_pool(weak, strong, labels)
    tpool = tmk.build_pool(weak, strong, labels)
    want = _jax_batched(jmk.map_from_masks, jpool, wsel, ssel, lsel)
    got = tmk.map_from_masks(tpool, *map(torch.from_numpy,
                                         (wsel, ssel, lsel))).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    oracle = [masked_map(weak, strong, labels, w, s, l)
              for w, s, l in zip(wsel, ssel, lsel)]
    np.testing.assert_allclose(got, oracle, atol=TOL, rtol=0)
    if t > 1:
        want_t = _jax_batched(jmk.map_per_threshold, jpool, wsel, ssel, lsel)
        got_t = tmk.map_per_threshold(tpool, *map(
            torch.from_numpy, (wsel, ssel, lsel))).numpy()
        assert got_t.shape == (8, t)
        np.testing.assert_allclose(got_t, want_t, atol=TOL, rtol=0)


@pytest.mark.parametrize("t", [1, 10])
def test_orie_map_pair_matches_jax(t):
    weak, strong, labels = dataset(20 + t, n_img=48, n_cls=8, t=t)
    n = len(labels)
    in_ens = masks(t, 16, n, 0.4)
    target = np.arange(16) * 3 % n
    in_ens[0, target[0]] = True  # the target counts as excluded anyway
    jpool = jmk.build_pool(weak, strong, labels)
    tpool = tmk.build_pool(weak, strong, labels)
    w_ref, s_ref = jax.vmap(lambda e, i: jmk.orie_map_pair(jpool, e, i))(
        jnp.asarray(in_ens), jnp.asarray(target))
    w, s = tmk.orie_map_pair(tpool, torch.from_numpy(in_ens),
                             torch.from_numpy(target))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), atol=TOL, rtol=0)
    # and the pair equals two map_from_masks evaluations (oracle too)
    is_t = np.arange(n)[None, :] == target[:, None]
    ens = in_ens & ~is_t
    lm = ens | is_t
    for i in range(16):
        assert float(w[i]) == pytest.approx(masked_map(
            weak, strong, labels, lm[i], np.zeros(n, bool), lm[i]), abs=TOL)
        assert float(s[i]) == pytest.approx(masked_map(
            weak, strong, labels, ens[i], is_t[i], lm[i]), abs=TOL)


def test_dataset_map_matches_jax():
    weak, strong, labels = dataset(30, n_img=40)
    n = len(labels)
    off = masks(3, 11, n)
    off[0] = False
    off[-1] = True
    want = _jax_batched(jmk.dataset_map, jmk.build_pool(weak, strong, labels),
                        off)
    got = tmk.dataset_map(tmk.build_pool(weak, strong, labels),
                          torch.from_numpy(off)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_no_labels_nan_and_no_detections_zero():
    weak, strong, _ = dataset(3, n_img=4)
    pool = tmk.build_pool(weak, strong, [np.zeros(0, int)] * 4)
    ones = torch.ones(1, 4, dtype=torch.bool)
    assert torch.isnan(tmk.map_from_masks(pool, ones, ~ones, ones)).all()
    empty = [(np.zeros((0, 1), bool), np.array([]), np.array([]))] * 2
    pool = tmk.build_pool(empty, empty, [np.array([0, 1]), np.array([2])])
    ones = torch.ones(1, 2, dtype=torch.bool)
    assert float(tmk.map_from_masks(pool, ones, ~ones, ones)[0]) == 0.0


def test_ap_interp101_matches_jax_on_grid_ties():
    """Recall exactly on the 101-point grid (the scaled-integer branch):
    tpc = 1..n_labels with n_labels dividing 100."""
    for nl in (1, 4, 5, 20, 25, 3, 7):
        k = 2 * nl + 3
        rng = np.random.default_rng(nl)
        flags = (rng.random(k) < 0.6).astype(np.float32)
        flags[: nl] = 1.0
        tpc = np.minimum(np.cumsum(flags), nl).astype(np.float32)
        fpc = (np.arange(1, k + 1) - tpc).astype(np.float32)
        want = float(jmk.ap_interp101(jnp.asarray(tpc), jnp.asarray(fpc),
                                      jnp.float32(nl)))
        got = float(tmk.ap_interp101(torch.from_numpy(tpc)[None],
                                     torch.from_numpy(fpc)[None],
                                     torch.tensor([float(nl)]))[0])
        assert got == pytest.approx(want, abs=TOL)


def test_batch_does_not_change_a_draw():
    """The same draws evaluated one at a time, in one batch, and in a batch
    of another size give the same bits."""
    weak, strong, labels = dataset(40, n_img=32, t=10)
    n = len(labels)
    pool = tmk.build_pool(weak, strong, labels)
    in_ens = torch.from_numpy(masks(5, 12, n))
    target = torch.arange(12)
    w_all, s_all = tmk.orie_map_pair(pool, in_ens, target)
    for lo, hi in ((0, 1), (3, 10), (11, 12)):
        w, s = tmk.orie_map_pair(pool, in_ens[lo:hi], target[lo:hi])
        assert torch.equal(w, w_all[lo:hi]) and torch.equal(s, s_all[lo:hi])
