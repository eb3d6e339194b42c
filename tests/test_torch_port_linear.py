"""The port's linear, kernel and neighbour estimators
(``estimators/linear.py``) and the SGD fit (``ops/sgd.py``) against the JAX
package's, on the CPU, on the same numpy-seeded data.

Tolerances, relative to the largest |estimate| (or |w|): LR (full rank and
rank-deficient), EN, BR and KNR 1e-5; SGD's plain version with JAX's
per-epoch orders replayed 1e-5 (they differ in each dot's summation order).
SVR and LSVR minimise a hinge by Adam: near the optimum residuals sit on the
hinge's kink and the bias steps by +-lr, so a rounding-level difference
flips a residual across the kink sooner or later and the two runs part.
They are held to 1e-4 over 300 steps, and at their default 1000 steps to a
validation MSE within 5% of JAX's. Pickled states (``wts{k}.pickle``) load
in the other package and predict the same.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgeml_tpu.estimators import SaveOpt as JSaveOpt
from edgeml_tpu.estimators import linear as jl
from edgeml_tpu_torch.estimators import SaveOpt
from edgeml_tpu_torch.estimators import linear as tl
from edgeml_tpu_torch.ops import sgd as tsgd

torch.set_num_threads(1)


def make_data(seed=0, n_train=120, n_val=40, f=8, noise=0.1, deficient=False):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=f)
    xs = rng.normal(size=(n_train + n_val, f))
    if deficient:
        # absent classes (all-zero columns) and a duplicated column, as in
        # stage-24 features
        xs[:, 2] = 0.0
        xs[:, 5] = 0.0
        xs[:, 6] = xs[:, 1]
    ys = xs @ w + noise * rng.normal(size=n_train + n_val) + 0.7
    return ([x for x in xs[:n_train]], [x for x in xs[n_train:]],
            ys[:n_train], ys[n_train:])


def _close(got, want, rtol):
    for k in ("train_est", "val_est"):
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        scale = max(float(np.abs(b).max()), 1e-12)
        assert float(np.abs(a - b).max()) <= rtol * scale, k
    for k in ("train_time", "val_time"):
        assert np.isfinite(got[k]) and got[k] >= 0


def _fitters(name, **opts):
    """(JAX fitter, port fitter) of a family with options ``opts``."""
    jfit, tfit = getattr(jl, f"fit_{name}"), getattr(tl, f"fit_{name}")
    if not opts:
        return jfit, tfit
    jo, to = getattr(jl, f"{name}Opt")(**opts), getattr(tl, f"{name}Opt")(**opts)
    return (lambda d, **kw: jfit(d, jo, **kw)), (lambda d, **kw: tfit(d, to, **kw))


FAMILIES = {
    "LR": ({}, 1e-5),
    "EN": ({}, 1e-5),
    "BR": ({}, 1e-5),
    "KNR": ({}, 1e-5),
    "SVR": ({"max_iter": 300}, 1e-4),
    "SVR-linear": ({"max_iter": 300, "kernel": "linear"}, 1e-4),
    "LSVR": ({"max_iter": 300}, 1e-4),
}


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_family_matches_jax(name, deficient):
    opts, rtol = FAMILIES[name]
    jfit, tfit = _fitters(name.split("-")[0], **opts)
    data = make_data(seed=len(name), deficient=deficient)
    _close(tfit(data, device="cpu"), jfit(data), rtol)


def _val_mse(result, data):
    return float(np.mean((result["val_est"] - data[3]) ** 2))


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("name", ["SVR", "LSVR"])
def test_hinge_families_at_default_length(name, deficient):
    """1000 Adam steps: the validation MSE within 5% of JAX's."""
    jfit, tfit = _fitters(name)
    data = make_data(seed=len(name), deficient=deficient)
    got, want = _val_mse(tfit(data, device="cpu"), data), _val_mse(jfit(data),
                                                                   data)
    assert abs(got - want) <= 0.05 * want


@pytest.mark.parametrize("m,n", [(50, 8), (8, 50), (60, 12)])
def test_lstsq_min_norm_rank_deficient(m, n):
    """The minimum-norm solution with zero and duplicated columns (rank <
    min(M, N)), as numpy's SVD solve gives it in f64."""
    rng = np.random.default_rng(m + n)
    a = rng.normal(size=(m, n)).astype(np.float32)
    a[:, 1] = 0.0
    a[:, 3] = a[:, 2]
    b = rng.normal(size=m).astype(np.float32)
    got = tl.lstsq_min_norm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.linalg.lstsq(a.astype(np.float64), b.astype(np.float64),
                           rcond=None)[0]
    jx = np.asarray(jnp.linalg.lstsq(jnp.asarray(a), jnp.asarray(b))[0])
    assert abs(got[1]) <= 1e-6  # the zero column's weight
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-5 * np.abs(jx).max())


def test_knr_ties_go_to_the_lower_index():
    """Duplicated training rows tie exactly in distance; the k-th neighbour
    is cut inside a tie, so the lower index must win, as lax.top_k breaks
    ties. Targets are distinct whole numbers, so another choice of
    neighbours moves a mean by at least 1/k; the means themselves may differ
    in summation order (1e-6)."""
    rng = np.random.default_rng(4)
    base = rng.normal(size=(6, 3))
    x = np.repeat(base, 4, axis=0)  # 24 rows, groups of 4 identical rows
    y = np.arange(24, dtype=np.float64)  # distinct targets inside a group
    xv = base + 1e-3 * rng.normal(size=base.shape)
    data = ([r for r in x], [r for r in xv], y, np.zeros(6))
    for k in (2, 5, 7):
        got = tl.fit_KNR(data, tl.KNROpt(n_neighbors=k), device="cpu")
        want = jl.fit_KNR(data, jl.KNROpt(n_neighbors=k))
        for key in ("val_est", "train_est"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=0)


def jax_orders(seed, n, epochs):
    """The per-epoch permutations of the JAX package's _sgd_fit, replayed
    from its key."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(sub, n)))
    return np.stack(out)


@pytest.mark.parametrize("n,f,epochs", [(64, 8, 5), (40, 37, 3), (97, 145, 2)])
def test_sgd_plain_matches_jax_with_its_orders(n, f, epochs):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x @ rng.normal(size=f) + 0.3).astype(np.float32)
    o = jl.SGDOpt(max_epochs=epochs)
    wj, bj = jl._sgd_fit(jnp.asarray(x), jnp.asarray(y), o.alpha, o.eta0,
                         o.power_t, jax.random.PRNGKey(o.seed), epochs)
    before = tsgd.sgd_fit_cuda.launches
    wt, bt = tsgd.sgd_fit(torch.from_numpy(x), torch.from_numpy(y),
                          jax_orders(o.seed, n, epochs), o.alpha, o.eta0,
                          o.power_t)
    assert tsgd.sgd_fit_cuda.launches == before  # CPU: the plain version
    wj = np.asarray(wj)
    scale = float(np.abs(wj).max())
    assert float(np.abs(wt.numpy() - wj).max()) <= 1e-5 * scale
    assert abs(float(bt) - float(bj)) <= 1e-5 * max(scale, abs(float(bj)))


def test_fit_sgd_matches_jax_with_its_orders():
    data = make_data(seed=3, n_train=50, n_val=20)
    o = tl.SGDOpt(max_epochs=4)
    got = tl.fit_SGD(data, o, device="cpu",
                     orders=jax_orders(o.seed, 50, o.max_epochs))
    _close(got, jl.fit_SGD(data, jl.SGDOpt(max_epochs=4)), 1e-5)


def test_sgd_orders_and_step_sizes():
    a = tsgd.sgd_orders(3, 17, 4)
    assert a.dtype == np.int32 and a.shape == (4, 17)
    assert all(sorted(r) == list(range(17)) for r in a)
    np.testing.assert_array_equal(a, tsgd.sgd_orders(3, 17, 4))
    assert not np.array_equal(a, tsgd.sgd_orders(4, 17, 4))
    eta = tsgd.sgd_eta(0.01, 0.25, 5)
    want = [np.float32(0.01) / np.float32(t) ** np.float32(0.25)
            for t in range(1, 6)]
    assert eta.dtype == np.float32
    np.testing.assert_array_equal(eta, np.array(want, np.float32))


def test_sgd_wrapper_checks():
    x = torch.zeros(4, 3)
    y = torch.zeros(4)
    with pytest.raises(ValueError, match="outside"):
        tsgd.sgd_fit(x, y, np.array([[0, 1, 2, 4]]), 0.001, 0.01, 0.25)
    before = tsgd.sgd_fit_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tsgd.sgd_fit_cuda(x, y, torch.zeros(4, dtype=torch.int32),
                          torch.zeros(4), 0.001)
    assert tsgd.sgd_fit_cuda.launches == before


@pytest.mark.parametrize("name", ["LR", "SVR", "KNR"])
def test_pickles_interchange(tmp_path, name):
    """A wts{k}.pickle written by either package loads in the other
    (SaveOpt.load) and predicts what the writer predicted."""
    jfit, tfit = _fitters(name)
    data = make_data(seed=9)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    wrote_t = tfit(data, save_opts=SaveOpt(model_dir=ours), device="cpu")
    wrote_j = jfit(data, save_opts=JSaveOpt(model_dir=theirs))
    with open(tmp_path / "ours" / "wts1.pickle", "rb") as f:
        state, scaler = pickle.load(f)
    assert set(scaler) == {"mean", "scale"}
    for v in state.values():
        assert not isinstance(v, torch.Tensor)
    read_j = jfit(data, save_opts=JSaveOpt(model_dir=ours, load=True,
                                           save=False))
    read_t = tfit(data, save_opts=SaveOpt(model_dir=theirs, load=True,
                                          save=False), device="cpu")
    _close(read_j, wrote_t, 1e-5)
    _close(read_t, wrote_j, 1e-5)
