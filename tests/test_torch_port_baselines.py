"""The port's baselines (``estimators/baselines.py``) against the JAX
package's, on the CPU, on the same numpy-seeded data.

DCSB: thresholds, estimates and the pickled tuple equal (no tolerance: the
bisection runs in Python doubles, every threshold compares in f32, and the
grid's ties resolve as JAX resolves them). AF: w and b within 1e-5 of the
largest |w| (2000 Adam steps on a smooth objective; the two packages'
gradients differ in summation order), and the decisions equal wherever the
margin |x w + b| exceeds 1e-3.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edgeml_tpu.estimators import SaveOpt as JSaveOpt
from edgeml_tpu.estimators import baselines as jb
from edgeml_tpu_torch.estimators import SaveOpt
from edgeml_tpu_torch.estimators import baselines as tb

torch.set_num_threads(1)


def af_data(seed, n=200, f=10):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[:, 4] = 0.0  # an absent class
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.normal(size=n) > 0.3).astype(int)
    k = 3 * n // 4
    return ([r for r in x[:k]], [r for r in x[k:]], y[:k], y[k:]), x


@pytest.mark.parametrize("seed,weight", [(0, 3.0), (1, 1.0), (2, 7.5)])
def test_af_matches_jax(tmp_path, seed, weight):
    data, x = af_data(seed)
    want = jb.fit_af(data, weight, JSaveOpt(model_dir=str(tmp_path / "j")))
    got = tb.fit_af(data, weight, SaveOpt(model_dir=str(tmp_path / "t")),
                    device="cpu")
    with open(tmp_path / "j" / "wts1.pickle", "rb") as f:
        sj = pickle.load(f)
    with open(tmp_path / "t" / "wts1.pickle", "rb") as f:
        st = pickle.load(f)
    assert st["w"].dtype == np.float32 and isinstance(st["b"], float)
    scale = float(np.abs(sj["w"]).max())
    assert float(np.abs(st["w"] - sj["w"]).max()) <= 1e-5 * scale
    assert abs(st["b"] - sj["b"]) <= 1e-5 * scale
    margin = np.abs(x.astype(np.float32) @ sj["w"] + sj["b"])
    k = len(data[0])
    for key, sl in (("train_est", slice(0, k)), ("val_est", slice(k, None))):
        assert got[key].dtype == want[key].dtype
        far = margin[sl] > 1e-3
        np.testing.assert_array_equal(got[key][far], want[key][far])


def dcsb_data(seed, n=200, max_boxes=8):
    rng = np.random.default_rng(seed)
    feats = []
    for _ in range(n):
        k = int(rng.integers(0, max_boxes))
        conf = rng.random(k)
        conf[rng.random(k) < 0.2] = 0.5  # exactly the detection threshold
        conf[rng.random(k) < 0.1] = 0.50000001  # 0.5 in f32
        feats.append((conf, rng.random(k) * 0.5) if k else
                     (np.array([]), np.array([])))
    labels = rng.integers(0, 5, n)
    reward = rng.integers(0, 2, n)
    k = 3 * n // 4
    return (feats[:k], feats[k:], reward[:k], reward[k:]), labels[:k]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_dcsb_matches_jax(tmp_path, seed):
    data, label = dcsb_data(seed)
    want = jb.fit_dcsb(data, label, JSaveOpt(model_dir=str(tmp_path / "j")))
    got = tb.fit_dcsb(data, label, SaveOpt(model_dir=str(tmp_path / "t")),
                      device="cpu")
    with open(tmp_path / "j" / "wts1.pickle", "rb") as f:
        sj = pickle.load(f)
    with open(tmp_path / "t" / "wts1.pickle", "rb") as f:
        st = pickle.load(f)
    assert st == sj
    assert [type(v) for v in st] == [type(v) for v in sj]
    for key in ("train_est", "val_est"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_dcsb_grid_values():
    """The area grid's length and f32 values are JAX's arange's."""
    want = np.asarray(jnp.arange(0.2, 0.9, 0.01))
    assert tb.A_GRID.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(tb.A_GRID, want)
    np.testing.assert_array_equal(tb.N_GRID, np.arange(1, 11))


def test_dcsb_thresholds_compare_in_f32():
    """A confidence of 0.50000001 is 0.5 in f32, so it is not > 0.5."""
    conf = torch.tensor([[0.50000001, 0.7, -np.inf]], dtype=torch.float32)
    area = torch.tensor([[0.1, 0.2, 0.0]])
    num, amin = tb.filter_box(conf, area, 0.5)
    assert int(num[0]) == 1 and float(amin[0]) == pytest.approx(0.2)
    num, amin = tb.filter_box(conf, area, 0.9)
    assert int(num[0]) == 0 and float(amin[0]) == 0.0


def test_dcsb_pickles_interchange(tmp_path):
    data, label = dcsb_data(9)
    d = str(tmp_path / "m")
    wrote = jb.fit_dcsb(data, label, JSaveOpt(model_dir=d))
    read = tb.fit_dcsb(data, label, SaveOpt(model_dir=d, load=True,
                                            save=False), device="cpu")
    np.testing.assert_array_equal(read["val_est"], wrote["val_est"])
    np.testing.assert_array_equal(read["train_est"], wrote["train_est"])
