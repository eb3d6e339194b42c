"""The port's rewards (``reward/orie.py``, ``cli/reward.py``) against the JAX
package's, on the CPU.

Where the ensemble draw does not matter, ORIE equals the JAX package's
within 6e-5 * (E + 1) per image (3e-5 per mAP): E = 0 (ORI) and E = N - 1
(every other image), also through the clamp of an oversized E. DCSB is
bit-exact. The port's own draw (its divergence from ``jax.random``) is
checked for its properties: exactly E images, never the target,
deterministic in the seed, independent of the batch, and uniform (a
chi-square test of how often each image is drawn). The reward CLI writes
the JAX CLI's files (keys, dtypes, shapes) on the same directory.
"""

import os
import types

import numpy as np
import pytest
import torch

from edgeml_tpu.data import set_data as jax_set_data
from edgeml_tpu.reward import orie as jorie
from edgeml_tpu_torch.cli import reward as treward_cli
from edgeml_tpu_torch.data.io import set_data
from edgeml_tpu_torch.reward import orie as torie
from oracle import make_random_dataset
from test_torch_port_io import write_dataset

torch.set_num_threads(1)


def dataset(seed, n_img=24, t=1):
    return make_random_dataset(np.random.default_rng(seed), n_img=n_img,
                               n_cls=5, max_det=6, max_lab=4, t=t)


@pytest.mark.parametrize("t", [1, 10])
@pytest.mark.parametrize("e", ["zero", "all", "oversized"])
def test_orie_matches_jax_where_the_draw_does_not_matter(e, t, capsys):
    weak, strong, labels = dataset(7 + t, n_img=20, t=t)
    n = len(labels)
    e_in = {"zero": 0, "all": n - 1, "oversized": 5 * n}[e]
    e_eff = min(e_in, n - 1)
    want = jorie.orie_rewards(weak, strong, labels, e_in, seed=3)
    got = torie.orie_rewards(weak, strong, labels, e_in, seed=9, batch=7,
                             device="cpu")
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, want, atol=6e-5 * (e_eff + 1), rtol=0)
    assert np.isfinite(got).all() and np.any(got != 0)
    if e == "oversized":
        assert "Ensemble size is too large. Set to the dataset size." in \
            capsys.readouterr().out


def test_negative_ensemble_clamps_to_ori(capsys):
    weak, strong, labels = dataset(3)
    got = torie.orie_rewards(weak, strong, labels, -4, device="cpu")
    assert "Ensemble size is negative. Set to 0." in capsys.readouterr().out
    np.testing.assert_array_equal(
        got, torie.orie_rewards(weak, strong, labels, 0, device="cpu"))


def test_nan_rewards_become_zero():
    """An image whose draw holds no labelled image has NaN mAPs: reward 0."""
    weak, strong, _ = dataset(4, n_img=6)
    labels = [np.zeros(0, int)] * 5 + [np.array([1])]
    got = torie.orie_rewards(weak, strong, labels, 0, device="cpu")
    want = jorie.orie_rewards(weak, strong, labels, 0)
    assert (got[:5] == 0).all()
    np.testing.assert_allclose(got, want, atol=6e-5, rtol=0)


def test_dcsb_bit_exact():
    weak, strong, labels = dataset(5, n_img=30)
    weak[0] = (weak[0][0], np.full(len(weak[0][1]), 0.5), weak[0][2])
    got = torie.dcsb_rewards(weak, strong)
    want = jorie.dcsb_rewards(weak, strong)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    r, secs = torie.compute_rewards(weak, strong, labels, "dcsb")
    r_ref, _ = jorie.compute_rewards(weak, strong, labels, "dcsb")
    assert r.dtype == r_ref.dtype and secs > 0
    np.testing.assert_array_equal(r, r_ref)


@pytest.mark.parametrize("e", [0, 1, 5, 63])
def test_draw_is_exactly_e_and_excludes_the_target(e):
    n = 64
    targets = torch.arange(n)
    m = torie.ensemble_masks(11, targets, n, e)
    assert m.shape == (n, n) and m.dtype == torch.bool
    assert bool((m.sum(dim=1) == e).all())
    assert not bool(m[targets, targets].any())


def test_draw_is_seeded_and_batch_independent():
    n = 50
    a = torie.ensemble_masks(0, torch.arange(n), n, 10)
    b = torie.ensemble_masks(0, torch.arange(n), n, 10)
    c = torie.ensemble_masks(1, torch.arange(n), n, 10)
    parts = torch.cat([torie.ensemble_masks(0, torch.arange(s, min(s + 7, n)),
                                            n, 10) for s in range(0, n, 7)])
    rev = torie.ensemble_masks(0, torch.arange(n).flip(0), n, 10).flip(0)
    assert torch.equal(a, b) and torch.equal(a, parts) and torch.equal(a, rev)
    assert not torch.equal(a, c)
    weak, strong, labels = dataset(6, n_img=30)
    r1 = torie.orie_rewards(weak, strong, labels, 8, seed=2, batch=4,
                            device="cpu")
    r2 = torie.orie_rewards(weak, strong, labels, 8, seed=2, device="cpu")
    r3 = torie.orie_rewards(weak, strong, labels, 8, seed=3, device="cpu")
    np.testing.assert_array_equal(r1, r2)
    assert not np.array_equal(r1, r3)


def test_draw_is_uniform():
    """How often each other image is drawn for one target, over 400 seeds:
    a chi-square test against the uniform expectation (p > 0.001), and
    every pair of images drawn together about as often as independence
    says."""
    n, e, seeds = 40, 8, 400
    target = torch.tensor([5])
    counts = torch.zeros(n)
    for s in range(seeds):
        counts += torie.ensemble_masks(s, target, n, e)[0].float()
    assert counts[5] == 0
    obs = np.delete(counts.numpy(), 5)
    expect = seeds * e / (n - 1)
    chi2 = float(((obs - expect) ** 2 / expect).sum())
    # 38 degrees of freedom: P(chi2 > 73.4) = 0.0005
    assert chi2 < 73.4, chi2
    # images across targets: image 0 drawn for target i about e / (n - 1)
    m = torie.ensemble_masks(7, torch.arange(1, n), n, e)[:, 0].float()
    assert abs(float(m.mean()) - e / (n - 1)) < 0.2


def _cli_opts(dirs, save, method, e, **kw):
    weak, strong, label = dirs
    base = dict(weak_dir=weak, strong_dir=strong, label_dir=label,
                save_dir=save, method=method, num_ensemble=e, seed=0,
                verbose=False, map_range=False, batch=None)
    base.update(kw)
    return base


@pytest.mark.parametrize("method,e", [("dcsb", 1000), ("orie", 0)])
def test_reward_cli_files_match_jax_cli(tmp_path, method, e):
    import reward as jax_reward_cli

    dirs = write_dataset(str(tmp_path / "data"), seed=12)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    jax_reward_cli.main(types.SimpleNamespace(**_cli_opts(dirs, theirs,
                                                          method, e)))
    treward_cli.main(types.SimpleNamespace(**_cli_opts(dirs, ours, method, e,
                                                       device="cpu")))
    name = "dcsb.npz" if method == "dcsb" else f"orie{e}.npz"
    got, want = np.load(os.path.join(ours, name)), np.load(
        os.path.join(theirs, name))
    assert sorted(got.files) == sorted(want.files) == ["reward", "time"]
    for key in ("reward", "time"):
        assert got[key].dtype == want[key].dtype
        assert got[key].shape == want[key].shape
    if method == "dcsb":
        np.testing.assert_array_equal(got["reward"], want["reward"])
    else:
        np.testing.assert_allclose(got["reward"], want["reward"], atol=6e-5,
                                   rtol=0)


def test_reward_cli_arguments_and_map_range(tmp_path):
    """The CLI's arguments; --map-range gives 10-threshold TP matrices."""
    dirs = write_dataset(str(tmp_path / "data"), seed=13, n_img=10)
    save = str(tmp_path / "out")
    opts = treward_cli.getargs([*dirs, save, "--method", "orie",
                                "--num-ensemble", "3", "--seed", "4",
                                "--map-range", "--batch", "2", "--device",
                                "cpu"])
    assert (opts.num_ensemble, opts.seed, opts.map_range, opts.batch,
            opts.device) == (3, 4, True, 2, "cpu")
    assert treward_cli.getargs([*dirs, save]).device == "cuda"
    treward_cli.main(opts)
    r = np.load(os.path.join(save, "orie3.npz"))["reward"]
    assert r.shape == (10,) and np.isfinite(r).all()
    w, _, _ = set_data(*dirs, iouv=np.linspace(0.5, 0.95, 10), device="cpu")
    w_ref, _, _ = jax_set_data(*dirs, iouv=np.linspace(0.5, 0.95, 10))
    assert w[1][0].shape[1] == 10
    np.testing.assert_array_equal(w[1][0], w_ref[1][0])
