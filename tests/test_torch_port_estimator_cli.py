"""The port's estimator CLIs (``cli/regression.py``, ``cli/baseline.py``)
against the JAX package's root ``regression.py`` and ``baseline.py``, on the
CPU, on one seeded dataset: YOLO-format detection and label files, their
stage-24 output features (VOC: 20 + 5 x 25 = 145), seeded rewards and a
3-fold split.

Both write the same files (names, keys, shapes, dtypes). LR and KNR
estimates within 1e-5 of the largest; DCSB's equal. AF's weights within
1e-2 of the largest |w|: here the features (145) outnumber the training
images (32), the classes separate, and Adam near the optimum takes
rounding-driven steps, so the last bits of the input move the weights well
above f32 rounding (``test_af_is_rounding_sensitive_here`` shows it on JAX
alone); its decisions are equal wherever the margin exceeds what that
weight difference can move (1e-2 |w|max (|x|_1 + 1)). The CNN starts from
a different init and different dropout draws in each package (JAX's
``jax.random`` stream cannot be reproduced), so it is held statistically on
a learnable feature set of 300 images: the port's validation MSE, averaged
over 3 folds, within 25% of JAX's.
"""

import os
import pickle
import types

import numpy as np
import pytest
import torch

import baseline as jbase
import regression as jreg
from edgeml_tpu.estimators import train_cnn as jtc
from edgeml_tpu_torch.cli import baseline as tbase
from edgeml_tpu_torch.cli import extract_feature as tfeat
from edgeml_tpu_torch.cli import regression as treg
from edgeml_tpu_torch.dataprep import split_dataset
from edgeml_tpu_torch.estimators import train_cnn as ttc
from test_torch_port_io import write_dataset

torch.set_num_threads(1)
N_IMG = 48


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("est_cli")
    weak, _, labels = write_dataset(str(root / "data"), seed=21, n_img=N_IMG,
                                    n_cls=6)
    feat = str(root / "features")
    tfeat.main(tfeat.getargs([weak, feat, labels, "--dataset", "voc",
                              "--device", "cpu"]))
    rng = np.random.default_rng(5)
    reward = rng.normal(0, 0.05, N_IMG).astype(np.float32)
    np.savez(root / "reward.npz", reward=reward, time=1.0)
    split_dataset(N_IMG, 3, str(root / "split.npy"))
    return types.SimpleNamespace(root=root, weak=weak, labels=labels,
                                 feat=feat, reward=str(root / "reward.npz"),
                                 split=str(root / "split.npy"))


def _files(d):
    out = []
    for base, _, names in os.walk(d):
        out += [os.path.relpath(os.path.join(base, n), d) for n in names]
    return sorted(out)


def _same_layout(ours, theirs):
    assert _files(ours) == _files(theirs) and _files(ours)
    for f in _files(ours):
        if not f.endswith(".npz") or "wts" in f:
            continue
        a, b = np.load(os.path.join(ours, f)), np.load(os.path.join(theirs, f))
        assert sorted(a.files) == sorted(b.files) == [
            "train_est", "train_time", "val_est", "val_time"]
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def _reg_args(ds, save, model, model_dir, normalize=False, weight=False):
    return dict(data_dir=ds.feat, reward_path=ds.reward, split_path=ds.split,
                save_dir=save, normalize=normalize, weight=weight, stage=24,
                resize=0, model=model, model_dir=model_dir)


def _run_regression(ds, tmp_path, model, **kw):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    jreg.main(types.SimpleNamespace(**_reg_args(
        ds, str(theirs / "est"), model, str(theirs / "wts"), **kw)))
    argv = [ds.feat, ds.reward, ds.split, str(ours / "est"), "--model", model,
            "--model-dir", str(ours / "wts"), "--device", "cpu"]
    argv += ["--normalize"] * kw.get("normalize", False)
    argv += ["--weight"] * kw.get("weight", False)
    treg.main(treg.getargs(argv))
    return str(ours), str(theirs)


@pytest.mark.parametrize("model,normalize", [("LR", False), ("KNR", True)])
def test_regression_cli_matches_jax(dataset, tmp_path, model, normalize):
    ours, theirs = _run_regression(dataset, tmp_path, model,
                                   normalize=normalize)
    _same_layout(ours, theirs)
    for k in (1, 2, 3):
        a = np.load(os.path.join(ours, "est", f"estimate{k}.npz"))
        b = np.load(os.path.join(theirs, "est", f"estimate{k}.npz"))
        for key in ("train_est", "val_est"):
            scale = max(float(np.abs(b[key]).max()), 1e-6)
            assert float(np.abs(a[key] - b[key]).max()) <= 1e-5 * scale
        with open(os.path.join(ours, "wts", f"wts{k}.pickle"), "rb") as f:
            state, scaler = pickle.load(f)
        assert set(scaler) == {"mean", "scale"}


class _ShortCNNOpt:
    """The CLIs' CNN defaults with 30 epochs (milestones scaled)."""

    def __init__(self, base):
        self.base = base

    def __call__(self):
        return self.base(max_epoch=30, milestones=[18, 23, 27])


@pytest.fixture(scope="module")
def cnn_dataset(tmp_path_factory):
    """300 images of 145 features with a linear reward plus noise."""
    root = tmp_path_factory.mktemp("cnn_cli")
    rng = np.random.default_rng(0)
    n = 300
    x = rng.normal(size=(n, 145))
    y = (x @ rng.normal(size=145) / 12 + 0.1 * rng.normal(size=n))
    for i in range(n):
        os.makedirs(root / "feat" / f"im{i:03d}")
        np.save(root / "feat" / f"im{i:03d}" / "stage24_output_features.npy",
                x[i])
    np.savez(root / "reward.npz", reward=y.astype(np.float32), time=1.0)
    split_dataset(n, 3, str(root / "split.npy"))
    return types.SimpleNamespace(root=root, feat=str(root / "feat"),
                                 reward=str(root / "reward.npz"),
                                 split=str(root / "split.npy"))


def _val_mse(d, reward, split):
    r = np.load(reward)["reward"]
    return float(np.mean([
        np.mean((np.load(os.path.join(d, f"estimate{k + 1}.npz"))["val_est"]
                 - r[val]) ** 2) for k, val in enumerate(np.load(split))]))


def test_regression_cli_cnn_statistically(cnn_dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jreg, "CNNOpt", _ShortCNNOpt(jtc.CNNOpt))
    monkeypatch.setattr(treg, "CNNOpt", _ShortCNNOpt(ttc.CNNOpt))
    ours, theirs = _run_regression(cnn_dataset, tmp_path, "CNN")
    _same_layout(ours, theirs)
    assert sorted(os.listdir(ours)) == ["est_best", "est_last", "wts_best",
                                        "wts_last"]
    assert sorted(os.listdir(tmp_path)) == [
        "cnn_training1.pdf", "cnn_training2.pdf", "cnn_training3.pdf",
        "ours", "theirs"]
    for which in ("est_best", "est_last"):
        got = _val_mse(os.path.join(ours, which), cnn_dataset.reward,
                       cnn_dataset.split)
        want = _val_mse(os.path.join(theirs, which), cnn_dataset.reward,
                        cnn_dataset.split)
        assert abs(got - want) <= 0.25 * want, (which, got, want)


def test_regression_cli_cnn_options(dataset, tmp_path, monkeypatch):
    """--normalize --weight turn on the weighted loss and rank-normalised
    rewards, as in the JAX CLI."""
    seen = []

    def fake_fit(data, opts, save_opts, device=None):
        seen.append((opts.weight, np.asarray(data[2]).copy()))
        r = {"train_est": np.zeros(len(data[2]), np.float32),
             "val_est": np.zeros(len(data[3]), np.float32),
             "train_time": 0.0, "val_time": 0.0}
        return r, r

    monkeypatch.setattr(treg, "fit_CNN", fake_fit)
    r = np.load(dataset.reward)["reward"]
    train0 = r[~np.load(dataset.split)[0]]
    for flags, weight, want in (
            (["--normalize", "--weight"], True,
             (np.argsort(np.argsort(train0)) + 1) / len(train0)),
            (["--weight"], False, train0)):
        seen.clear()
        treg.main(treg.getargs([dataset.feat, dataset.reward, dataset.split,
                                str(tmp_path / "est"), "--device", "cpu",
                                *flags]))
        assert len(seen) == 3 and all(w is weight for w, _ in seen)
        np.testing.assert_array_equal(seen[0][1], want)


def test_regression_cli_pooled_hidden_stage_exits(dataset, tmp_path,
                                                  monkeypatch):
    """--resize > 0 with a hidden --stage no longer exits "not yet ported":
    the maps are RoI-pooled and reach the CNN at its default batch with
    BatchNorm (test_torch_port_hidden_features.py holds the route against
    the JAX CLI)."""
    root = tmp_path / "feat"
    rng = np.random.default_rng(2)
    for i in range(N_IMG):
        (root / f"img{i:03d}").mkdir(parents=True)
        np.save(root / f"img{i:03d}" / "stage17_C3_features.npy",
                rng.random((4, 6, 5)).astype(np.float32))
    seen = []

    def fake_fit(data, opts, save_opts, device=None):
        seen.append((opts.resize, opts.batch_size, np.asarray(data[0]).shape))
        r = {"train_est": np.zeros(len(data[2]), np.float32),
             "val_est": np.zeros(len(data[3]), np.float32),
             "train_time": 0.0, "val_time": 0.0}
        return r, r

    monkeypatch.setattr(treg, "fit_CNN", fake_fit)
    treg.main(treg.getargs([str(root), dataset.reward, dataset.split,
                            str(tmp_path / "est"), "--stage", "17",
                            "--resize", "8", "--device", "cpu"]))
    n_train = int((~np.load(dataset.split)[0]).sum())
    assert len(seen) == 3 and seen[0] == (True, 64, (n_train, 4, 8, 8))


def _base_args(ds, save, baseline, model_dir):
    return dict(data_dir=ds.feat if baseline == "af" else ds.weak,
                reward_path=ds.reward, split_path=ds.split, save_dir=save,
                baseline=baseline, positive_weight=2.0,
                label_dir=ds.labels if baseline == "dcsb" else "",
                model_dir=model_dir)


@pytest.mark.parametrize("baseline", ["af", "dcsb"])
def test_baseline_cli_matches_jax(dataset, tmp_path, baseline):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    jbase.main(types.SimpleNamespace(**_base_args(
        dataset, str(theirs / "est"), baseline, str(theirs / "wts"))))
    a = _base_args(dataset, str(ours / "est"), baseline, str(ours / "wts"))
    tbase.main(tbase.getargs([
        a["data_dir"], a["reward_path"], a["split_path"], a["save_dir"],
        "--baseline", baseline, "--positive_weight", "2.0",
        "--label_dir", a["label_dir"], "--model_dir", a["model_dir"],
        "--device", "cpu"]))
    _same_layout(str(ours), str(theirs))
    sub = "2.0" if baseline == "af" else ""
    for k in (1, 2, 3):
        got = np.load(ours / "est" / sub / f"estimate{k}.npz")
        want = np.load(theirs / "est" / sub / f"estimate{k}.npz")
        with open(ours / "wts" / sub / f"wts{k}.pickle", "rb") as f:
            st = pickle.load(f)
        with open(theirs / "wts" / sub / f"wts{k}.pickle", "rb") as f:
            sj = pickle.load(f)
        if baseline == "dcsb":
            assert st == sj
            for key in ("train_est", "val_est"):
                np.testing.assert_array_equal(got[key], want[key])
        else:
            tol = 1e-2 * float(np.abs(sj["w"]).max())
            assert float(np.abs(st["w"] - sj["w"]).max()) <= tol
            assert abs(st["b"] - sj["b"]) <= tol
            val = np.load(dataset.split)[k - 1]
            x = np.stack(treg.load_feature(dataset.feat, 24, pool=False))
            x = x.astype(np.float32)
            for key, rows in (("train_est", x[~val]), ("val_est", x[val])):
                margin = np.abs(rows @ sj["w"] + sj["b"])
                far = margin > tol * (np.abs(rows).sum(1) + 1)
                np.testing.assert_array_equal(got[key][far], want[key][far])


def test_af_is_rounding_sensitive_here(dataset):
    """JAX's own AF fit on fold 1 moves by more than f32 rounding (1e-5 of
    the largest |w|) when its features are scaled by 1 + 1e-7, and stays
    within the 1e-2 the comparison above allows."""
    import jax.numpy as jnp

    from edgeml_tpu.estimators import baselines as jb

    x = np.stack(treg.load_feature(dataset.feat, 24, pool=False)).astype(
        np.float32)
    val = np.load(dataset.split)[0]
    y = np.load(dataset.reward)["reward"][~val] > 0
    t = jnp.asarray(np.where(y, 1.0, -1.0), jnp.float32)
    cw = jnp.asarray(np.where(y, 2.0, 1.0), jnp.float32)
    w1, _ = jb._svc_fit(jnp.asarray(x[~val]), t, cw, 1.0, 0.05, 2000)
    w2, _ = jb._svc_fit(jnp.asarray(x[~val] * np.float32(1 + 1e-7)), t, cw,
                        1.0, 0.05, 2000)
    moved = float(np.abs(np.asarray(w1) - np.asarray(w2)).max())
    scale = float(np.abs(np.asarray(w1)).max())
    assert 1e-5 * scale < moved <= 1e-2 * scale
