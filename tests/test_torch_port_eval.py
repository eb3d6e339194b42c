"""The port's offloading-policy evaluation (``eval.py``, ``cli/test.py``)
against the JAX package's, on the CPU.

Offload masks from synthetic ``estimate{k}.npz`` files (ties between
estimates and thresholds included) are bit-identical to JAX's; ``test_map``
is within 3e-5 of JAX's at T = 1 and 10; the test CLI writes
``test_map.npy`` of shape (n_estimates, 11), as the JAX CLI does.
"""

import os
import types

import numpy as np
import pytest
import torch

from edgeml_tpu import eval as jeval
from edgeml_tpu_torch import eval as teval
from edgeml_tpu_torch.cli import test as ttest_cli
from oracle import make_random_dataset
from test_torch_port_io import write_dataset

torch.set_num_threads(1)


def split(n, folds, seed):
    rng = np.random.default_rng(seed)
    fold = rng.permutation(np.arange(n) % folds)
    return np.stack([fold == f for f in range(folds)])


def write_estimates(root, dataset_split, seed, ties=False):
    """One directory of per-fold estimate{k}.npz files (train_est over the
    other folds' images, val_est over the fold's)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for k, val in enumerate(dataset_split):
        n_train, n_val = int((~val).sum()), int(val.sum())
        if ties:  # a coarse grid: many estimates equal a threshold
            train = rng.integers(0, 4, n_train).astype(np.float64)
            est = rng.integers(0, 4, n_val).astype(np.float64)
        else:
            train, est = rng.normal(0, 1, n_train), rng.normal(0, 1, n_val)
        np.savez(os.path.join(root, f"estimate{k + 1}.npz"), train_est=train,
                 val_est=est)
    return root


@pytest.mark.parametrize("ties", [False, True])
def test_offload_masks_bit_identical(tmp_path, ties):
    sp = split(37, 5, 1)
    d = write_estimates(str(tmp_path / "est"), sp, 2, ties)
    got = teval.offload_masks_for_estimates(d, sp)
    want = jeval.offload_masks_for_estimates(d, sp)
    assert got.shape == (11, 37) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(teval.OFFLOADING_RATIOS,
                                  jeval.OFFLOADING_RATIOS)


@pytest.mark.parametrize("t", [1, 10])
def test_test_map_matches_jax(tmp_path, t):
    weak, strong, labels = make_random_dataset(
        np.random.default_rng(t), n_img=40, n_cls=6, max_det=7, max_lab=4,
        t=t)
    sp = split(40, 5, t)
    dirs = [write_estimates(str(tmp_path / f"est{i}"), sp, 10 * t + i,
                            ties=i == 2) for i in range(3)]
    got = teval.test_map(weak, strong, labels, dirs, sp, device="cpu")
    want = jeval.test_map(weak, strong, labels, dirs, sp)
    assert got.shape == want.shape == (3, 11)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)


def _jax_test_cli():
    """The JAX package's root ``test.py``, loaded by path (the standard
    library has a ``test`` package too)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "test.py")
    spec = importlib.util.spec_from_file_location("jax_test_cli", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_test_cli_writes_test_map(tmp_path):
    jax_test_cli = _jax_test_cli()

    dirs = write_dataset(str(tmp_path / "data"), seed=21, n_img=30)
    sp = split(30, 3, 4)
    np.save(tmp_path / "split.npy", sp)
    ests = [write_estimates(str(tmp_path / f"est{i}"), sp, i)
            for i in range(2)]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    opts = ttest_cli.getargs([*dirs, str(tmp_path / "split.npy"), ours,
                              "--estimates", *ests, "--device", "cpu"])
    ttest_cli.main(opts)
    jax_test_cli.main(types.SimpleNamespace(
        weak_dir=dirs[0], strong_dir=dirs[1], label_dir=dirs[2],
        split_path=str(tmp_path / "split.npy"), save_dir=theirs,
        estimates=ests, map_range=False))
    got = np.load(os.path.join(ours, "test_map.npy"))
    want = np.load(os.path.join(theirs, "test_map.npy"))
    assert got.shape == want.shape == (2, 11) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)
    assert ttest_cli.getargs([*dirs, "s.npy", ours]).device == "cuda"
