"""The port's CNN estimator (``estimators/nn.py``, ``train_cnn.py``) against
the JAX package's, on the CPU.

Weights cross with ``from_jax_params`` / ``to_jax_params``; dropout masks
are replayed from JAX's keys and injected. Tolerances: forwards (eval and
train, MLP, conv and resize=False paths) and the BatchNorm running state
within 1e-5 of the largest value; training (several Adam steps, JAX's init
and masks injected) within 2e-4 of the largest estimate, since the two
packages' gradients round differently and Adam's normalised steps carry
that along. Checkpoints (``wts{k}.npz``) load in either package and give the
writer's estimates within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgeml_tpu.estimators import SaveOpt as JSaveOpt
from edgeml_tpu.estimators import nn as jnn
from edgeml_tpu.estimators import train_cnn as jtc
from edgeml_tpu_torch.estimators import SaveOpt
from edgeml_tpu_torch.estimators import nn as tnn
from edgeml_tpu_torch.estimators import train_cnn as ttc

torch.set_num_threads(1)

ARCHS = {
    # name: (channels, kernels, pools, linear, resize, input shape)
    "mlp": ((), (3,), (True,), (12, 16, 8, 1), True, (6, 12)),
    "conv": ((4, 8, 6), (3, 3), (True, False), (96, 8, 1), True,
             (5, 4, 8, 8)),
    "fully_conv": ((4, 8, 1), (3, 5), (True, False), (), True, (5, 4, 8, 8)),
    "no_resize": ((4, 8, 6), (3, 3), (True, False), (6, 4, 1), False,
                  (1, 4, 9, 7)),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_net(name, seed=0):
    ch, k, p, lin, rs, shape = ARCHS[name]
    net = jnn.EdgeDetectionNet.from_opts(ch, k, p, lin, rs)
    params = net.init(jax.random.PRNGKey(seed))
    bn = net.init_bn_state()
    # non-trivial BatchNorm state and affine parameters
    rng = np.random.default_rng(seed)
    bn = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.uniform(0.1, 0.5, a.shape),
                              jnp.float32), bn)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) * rng.uniform(0.8, 1.2, a.shape),
                              jnp.float32), params)
    return net, params, bn, shape


def port_net(name, params, bn):
    ch, k, p, lin, rs, _ = ARCHS[name]
    return tnn.EdgeDetectionNet.from_opts(ch, k, p, lin, rs).from_jax_params(
        _np(params), _np(bn))


class Replay:
    """JAX's dropout masks, site by site: per step a key; per site the key
    split, the mask drawn from the second half (nn.py _dropout)."""

    def __init__(self, step_keys, sites):
        self.keys, self.sites = step_keys, sites
        self.step, self.site, self.rng = 0, 0, None

    def __call__(self, shape):
        if self.site == 0:
            self.rng = self.keys[self.step]
        self.rng, sub = jax.random.split(self.rng)
        keep = np.array(jax.random.bernoulli(sub, 0.9, tuple(shape)))
        self.site += 1
        if self.site == self.sites:
            self.site, self.step = 0, self.step + 1
        return torch.from_numpy(keep)


def _close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rtol * max(float(np.abs(b).max()), 1e-6))


@pytest.mark.parametrize("name", list(ARCHS))
def test_forward_eval_matches_jax(name):
    net, params, bn, shape = jax_net(name)
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want, _ = net.apply(params, bn, jnp.asarray(x), train=False)
    tn = port_net(name, params, bn).eval()
    with torch.no_grad():
        got = tn(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("name", list(ARCHS))
def test_forward_train_matches_jax(name):
    """Training mode: batch statistics, JAX's masks injected, and the
    running statistics it returns."""
    net, params, bn, shape = jax_net(name, seed=2)
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want, new_bn = net.apply(params, bn, jnp.asarray(x), train=True, rng=key)
    tn = port_net(name, params, bn).train()
    got = tn(torch.from_numpy(x), Replay([key], tn.dropout_sites))
    _close(got.detach().numpy(), want, 1e-5)
    _, got_bn = tn.to_jax_params()
    for a, b in zip(jax.tree_util.tree_leaves(got_bn),
                    jax.tree_util.tree_leaves(_np(new_bn))):
        _close(a, b, 1e-5)


def test_batchnorm_on_a_batch_of_one():
    """A training batch of one (N_train % 64 == 1): torch's BatchNorm
    refuses it; the written-out BN takes it as JAX does (variance 0, the
    running update var * 1 / max(0, 1))."""
    net, params, bn, _ = jax_net("mlp", seed=4)
    x = np.random.default_rng(5).normal(size=(1, 12)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    want, new_bn = net.apply(params, bn, jnp.asarray(x), train=True, rng=key)
    tn = port_net("mlp", params, bn).train()
    got = tn(torch.from_numpy(x), Replay([key], tn.dropout_sites))
    _close(got.detach().numpy(), want, 1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(tn.to_jax_params()[1]),
                    jax.tree_util.tree_leaves(_np(new_bn))):
        _close(a, b, 1e-5)


def test_params_round_trip():
    net, params, bn, _ = jax_net("conv")
    p, s = port_net("conv", params, bn).to_jax_params()
    assert jax.tree_util.tree_structure(p) == jax.tree_util.tree_structure(
        _np(params))
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(_np(params))):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tnn.EdgeDetectionNet.from_opts((), (3,), (True,), (12, 16, 1)) \
            .from_jax_params(_np(params), _np(bn))


def cnn_data(seed, n=130, nv=40, f=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n + nv, f)).astype(np.float32)
    y = rng.random(n + nv).astype(np.float32)
    return ([r for r in x[:n]], [r for r in x[n:]], y[:n], y[n:])


def jax_init_and_steps(seed, opts, n):
    """fit_CNN's key chain: the init key, then one key per training
    step."""
    net = jnn.EdgeDetectionNet.from_opts(opts.channels, opts.kernels,
                                         opts.pools, opts.linear, opts.resize)
    key = jax.random.PRNGKey(seed)
    key, init_key = jax.random.split(key)
    params, bn = net.init(init_key), net.init_bn_state()
    steps = []
    for _ in range(opts.max_epoch * -(-n // opts.batch_size)):
        key, sub = jax.random.split(key)
        steps.append(sub)
    return (_np(params), _np(bn)), steps


@pytest.mark.parametrize("weight", [False, True])
def test_fit_cnn_steps_match_jax(tmp_path, monkeypatch, weight):
    monkeypatch.chdir(tmp_path)
    data = cnn_data(0)
    kw = dict(linear=[12, 16, 8, 1], max_epoch=3, milestones=[2],
              weight=weight)
    jb, jl = jtc.fit_CNN(data, jtc.CNNOpt(**kw), plot=False)
    opts = ttc.CNNOpt(**kw)
    init, steps = jax_init_and_steps(opts.seed, opts, 130)
    tb, tl = ttc.fit_CNN(data, opts, plot=False, device="cpu", init=init,
                         dropout=Replay(steps, 2))
    for got, want in ((tb, jb), (tl, jl)):
        for k in ("train_est", "val_est"):
            assert got[k].dtype == want[k].dtype == np.float32
            _close(got[k], want[k], 2e-4)
        assert got["train_time"] > 0 and got["val_time"] > 0


def test_checkpoints_interchange(tmp_path, monkeypatch):
    """wts{k}.npz from either package loads in the other (SaveOpt.load, no
    further epochs) and estimates what the writer's last weights
    estimated."""
    monkeypatch.chdir(tmp_path)
    data = cnn_data(1, n=65)  # 65 % 64 == 1: a training batch of one
    kw = dict(linear=[12, 8, 1], max_epoch=2)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    _, t_last = ttc.fit_CNN(data, ttc.CNNOpt(**kw), SaveOpt(model_dir=ours,
                                                             model_idx=2),
                            plot=False, device="cpu")
    _, j_last = jtc.fit_CNN(data, jtc.CNNOpt(**kw),
                            JSaveOpt(model_dir=theirs, model_idx=2),
                            plot=False)
    for d in ("ours_best", "ours_last"):
        f = np.load(tmp_path / d / "wts2.npz", allow_pickle=True)
        assert sorted(f.files) == ["bn", "params"]
        assert f["params"].dtype == object and f["params"].shape == ()
    kw0 = dict(kw, max_epoch=0)
    _, j_read = jtc.fit_CNN(data, jtc.CNNOpt(**kw0),
                            JSaveOpt(model_dir=ours, model_idx=2, load=True,
                                     save=False), plot=False)
    _, t_read = ttc.fit_CNN(data, ttc.CNNOpt(**kw0),
                            SaveOpt(model_dir=theirs, model_idx=2, load=True,
                                    save=False), plot=False, device="cpu")
    for got, want in ((j_read, t_last), (t_read, j_last)):
        for k in ("train_est", "val_est"):
            _close(got[k], want[k], 1e-6)


def test_fit_cnn_seeded_and_plots(tmp_path, monkeypatch):
    """The port's own init and masks are fixed by the seed; the loss figure
    lands in the working directory."""
    monkeypatch.chdir(tmp_path)
    data = cnn_data(2, n=70, nv=20)
    opts = ttc.CNNOpt(linear=[12, 8, 1], max_epoch=2, milestones=[1])
    a, _ = ttc.fit_CNN(data, opts, SaveOpt(model_idx=4), device="cpu")
    b, _ = ttc.fit_CNN(data, opts, plot=False, device="cpu")
    np.testing.assert_array_equal(a["val_est"], b["val_est"])
    assert os.path.isfile(tmp_path / "cnn_training4.pdf")
