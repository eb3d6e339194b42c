"""The port's tree ensembles (``estimators/trees.py``) against the JAX
package's, on the CPU, on the same numpy-seeded data.

RFR gets JAX's bootstrap weights (replayed from its key) injected; GBR needs
none at subsample 1, and JAX's subsample masks are injected below it. Trees
are equal node for node (feature, bin, children, split flags: exact); leaf
values and predictions within 1e-6 of the largest. The pieces the equality
rests on are exact too: binning, the sequential sample-order sums and XLA's
CPU cumulative-sum order (bit-equal to ``jnp.cumsum``).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgeml_tpu.estimators import SaveOpt as JSaveOpt
from edgeml_tpu.estimators import trees as jt
from edgeml_tpu.estimators.common import StandardScaler
from edgeml_tpu_torch.estimators import SaveOpt
from edgeml_tpu_torch.estimators import trees as tt

torch.set_num_threads(1)
CPU = torch.device("cpu")


def tree_data(seed, n=300, n_val=80, f=6):
    """A nonlinear target, a duplicated column and a constant column (exact
    gain ties), standardised as fit_model does."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n + n_val, f))
    x[:, 3] = x[:, 1]
    x[:, 4] = 0.0
    x[:, 5] = np.round(x[:, 5])  # few distinct values: empty bins
    y = np.sin(x[:, 0]) + 0.5 * x[:, 1] ** 2 + 0.1 * rng.normal(size=n + n_val)
    sc = StandardScaler().fit(x[:n])
    return sc.transform(x[:n]), y[:n], sc.transform(x[n:]), y[n:]


def jax_bootstrap(seed, n, n_trees):
    keys = jax.random.split(jax.random.PRNGKey(seed), n_trees)
    return np.stack([np.asarray(jnp.zeros((n,), jnp.float32).at[
        jax.random.randint(k, (n,), 0, n)].add(1.0)) for k in keys])


def jax_subsample(seed, n, n_stages, frac):
    keys = jax.random.split(jax.random.PRNGKey(seed), n_stages)
    return np.stack([np.asarray((jax.random.uniform(k, (n,)) < frac).astype(
        jnp.float32)) for k in keys])


def _same_trees(got, want):
    for k in tt._TREE_KEYS:
        a, b = got["trees"][k], np.asarray(want["trees"][k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k == "leaf":
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-6 * max(np.abs(b).max(), 1))
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("depth", "scale", "base"):
        assert got[k] == want[k]
    np.testing.assert_array_equal(got["edges"], want["edges"])


def _same_pred(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * max(np.abs(want).max(), 1))


@pytest.mark.parametrize("depth,min_split", [(6, 10), (20, 100), (3, 2)])
def test_rfr_matches_jax_node_for_node(depth, min_split):
    x, y, xv, _ = tree_data(depth)
    kw = dict(n_estimators=4, max_depth=depth, min_samples_split=min_split)
    jm = jt._RFR(jt.RFROpt(**kw))
    want = jm.fit(x, y)
    tm = tt._RFR(tt.RFROpt(**kw), CPU,
                 jax_bootstrap(0, len(y), kw["n_estimators"]))
    got = tm.fit(x, y)
    _same_trees(got, want)
    assert got["trees"]["is_split"].any()
    _same_pred(tm.predict(got, xv), jm.predict(want, xv))


@pytest.mark.parametrize("subsample", [1.0, 0.7])
def test_gbr_matches_jax_node_for_node(subsample):
    x, y, xv, _ = tree_data(5)
    kw = dict(n_estimators=40, subsample=subsample)
    jm = jt._GBR(jt.GBROpt(**kw))
    want = jm.fit(x, y)
    weights = None if subsample == 1.0 else jax_subsample(0, len(y), 40,
                                                          subsample)
    tm = tt._GBR(tt.GBROpt(**kw), CPU, weights)
    got = tm.fit(x, y)
    _same_trees(got, want)
    _same_pred(tm.predict(got, xv), jm.predict(want, xv))


@pytest.mark.parametrize("n", [64, 16, 37, 300])
def test_xla_cumsum_bit_equal(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(7, 3, n))
         * 10 ** rng.uniform(-3, 3, (7, 3, n))).astype(np.float32)
    x[:, :, ::5] = 0.0  # empty bins
    got = tt.xla_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.cumsum(x, axis=2)))


def test_ordered_sums_are_sequential():
    rng = np.random.default_rng(2)
    cell = rng.integers(0, 9, 5000)
    vals = (rng.normal(size=5000) * 10 ** rng.uniform(-3, 3, 5000)).astype(
        np.float32)
    want = np.zeros(9, np.float32)
    np.add.at(want, cell, vals)
    got = tt.ordered_sums(torch.from_numpy(cell), torch.from_numpy(vals), 9)
    np.testing.assert_array_equal(got.numpy(), want)
    jx = jnp.zeros(9, jnp.float32).at[cell].add(vals)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jx))


def test_binning_matches_jax():
    x, _, xv, _ = tree_data(1)
    edges = tt.quantile_bins(x.astype(np.float32), 64)
    np.testing.assert_array_equal(edges, jt.quantile_bins(x.astype(np.float32),
                                                          64))
    got = tt.bin_features(xv.astype(np.float32), edges, CPU).numpy()
    np.testing.assert_array_equal(got, np.asarray(jt.bin_features(
        xv.astype(np.float32), edges)))


def test_pairwise_sum_is_elementwise():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(13, 5)).astype(np.float32))
    want = ((((x[0] + x[8]) + (x[4] + x[12])) + (x[2] + x[10]))
            + ((x[6]) + ((x[1] + x[9]) + (x[5])) + ((x[3] + x[11]) + x[7])))
    got = tt.pairwise_sum0(x)
    np.testing.assert_allclose(got.numpy(), x.sum(0).numpy(), rtol=1e-6)
    assert got.shape == (5,) and torch.isfinite(want).all()


def test_seeded_bootstrap():
    w = tt.bootstrap_weights(3, 50, 4)
    assert w.dtype == np.float32 and w.shape == (4, 50)
    assert (w.sum(1) == 50).all()
    np.testing.assert_array_equal(w, tt.bootstrap_weights(3, 50, 4))


def test_fit_rfr_pickles_interchange(tmp_path):
    x, y, xv, yv = tree_data(8, n=200, n_val=40)
    data = ([r for r in x], [r for r in xv], y, yv)
    opts = dict(n_estimators=3, max_depth=5, min_samples_split=20)
    ours = str(tmp_path / "ours")
    wrote = tt.fit_RFR(data, tt.RFROpt(**opts), SaveOpt(model_dir=ours),
                       device="cpu")
    with open(tmp_path / "ours" / "wts1.pickle", "rb") as f:
        state, _ = pickle.load(f)
    assert all(isinstance(v, np.ndarray) for v in state["trees"].values())
    read = jt.fit_RFR(data, jt.RFROpt(**opts),
                      JSaveOpt(model_dir=ours, load=True, save=False))
    _same_pred(wrote["val_est"], read["val_est"])
    _same_pred(wrote["train_est"], read["train_est"])
