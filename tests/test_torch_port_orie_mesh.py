"""ORIE over several devices (``compute_rewards(mesh=)``, ``orie_rewards(mesh=)``)
against one device and against the JAX package's sharded run, on the CPU.

The port's ensemble draw is a function of (seed, target, image) alone, so
dealing each batch over the devices cannot change a reward: two devices
against one is held bit for bit. Against the JAX package the draw is made
the same by injection: the port's ``ensemble_masks`` is replaced by the JAX
package's own draw (``jax.random.uniform`` under ``fold_in(key, i)``, the E
smallest), and both packages shard over their meshes (the port two CPU
devices, the JAX package its eight). Tolerance against JAX: 1e-5 per
reward, the JAX package's own sharded-against-single bound
(``tests/test_parallel.py``); measured 1.5e-7.
"""

import numpy as np
import pytest
import torch

import jax

from edgeml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from edgeml_tpu.reward import orie_rewards as jax_orie_rewards
from edgeml_tpu_torch.cli import reward as treward_cli
from edgeml_tpu_torch.reward import compute_rewards, orie_rewards
from edgeml_tpu_torch.reward import orie as torie
from oracle import make_random_dataset

torch.set_num_threads(1)

E = 4
SEED = 3


def _jax_masks(targets, n):
    """The JAX package's draw for each target image: (B, n) bool."""
    key = jax.random.PRNGKey(SEED)
    out = []
    for i in targets.tolist():
        u = np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (n,)))
        u = np.where(np.arange(n) == i, 2.0, u)
        kth = np.sort(u)[E - 1]
        out.append(u <= kth)
    return torch.from_numpy(np.stack(out)).to(targets.device)


def _dataset(seed=31, n_img=16):
    return make_random_dataset(np.random.default_rng(seed), n_img=n_img)


def test_two_devices_equal_one_bit_for_bit():
    weak, strong, labels = _dataset()
    one, _ = compute_rewards(weak, strong, labels, num_ensemble=E, seed=SEED,
                             batch=5, device="cpu", mesh=None)
    two, _ = compute_rewards(weak, strong, labels, num_ensemble=E, seed=SEED,
                             batch=5, device="cpu", mesh=["cpu", "cpu"])
    three = orie_rewards(weak, strong, labels, E, SEED, batch=16,
                         device="cpu", mesh=["cpu"] * 3)
    np.testing.assert_array_equal(two, one)
    np.testing.assert_array_equal(three, one)
    assert np.any(one != 0)


def test_two_devices_match_jax_sharded_with_its_draw(monkeypatch):
    weak, strong, labels = _dataset()
    n = len(labels)
    monkeypatch.setattr(torie, "ensemble_masks",
                        lambda seed, targets, n_img, e: _jax_masks(targets,
                                                                   n_img))
    got, _ = compute_rewards(weak, strong, labels, num_ensemble=E, seed=SEED,
                             batch=6, device="cpu", mesh=["cpu", "cpu"])
    want = jax_orie_rewards(weak, strong, labels, num_ensemble=E, seed=SEED,
                            mesh=jax_make_mesh(("dp",)))
    assert len(jax.devices()) == 8 and got.shape == (n,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.any(want != 0)


def test_auto_mesh_is_one_device_without_several_cards(monkeypatch):
    """``mesh="auto"`` on the CPU (or one card) is the one-device path;
    with several cards it deals over all of them."""
    seen = []
    real = torie.orie_rewards

    def spy(*a, **kw):
        seen.append(kw["mesh"])
        return real(*a, **kw)

    monkeypatch.setattr(torie, "orie_rewards", spy)
    weak, strong, labels = _dataset(n_img=6)
    compute_rewards(weak, strong, labels, num_ensemble=2, device="cpu")
    assert seen == [None]
    monkeypatch.setattr(torie, "make_mesh", lambda dev: ["cpu", "cpu"])
    compute_rewards(weak, strong, labels, num_ensemble=2, device="cpu")
    assert seen[-1] == ["cpu", "cpu"]


def test_reward_cli_uses_the_auto_mesh(monkeypatch, tmp_path):
    seen = []

    def fake(*a, **kw):
        seen.append(kw.get("mesh"))
        return np.zeros(1, np.float32), 0.0

    monkeypatch.setattr(treward_cli, "compute_rewards", fake)
    monkeypatch.setattr(treward_cli, "set_data", lambda *a, **kw: ([], [],
                                                                   []))
    opts = treward_cli.getargs(["w", "s", "l", str(tmp_path), "--device",
                                "cpu"])
    treward_cli.main(opts)
    assert seen == ["auto"]


@pytest.mark.parametrize("batch", [1, 7, None])
def test_blocks_cover_every_image_once(batch):
    weak, strong, labels = _dataset(n_img=11)
    one = orie_rewards(weak, strong, labels, 3, 1, batch=batch,
                       device="cpu")
    two = orie_rewards(weak, strong, labels, 3, 1, batch=batch,
                       device="cpu", mesh=["cpu", torch.device("cpu")])
    np.testing.assert_array_equal(two, one)
