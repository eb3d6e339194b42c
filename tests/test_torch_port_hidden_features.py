"""Hidden-stage feature maps: the port's YOLOv5 taps, ``dump_features``,
``load_feature(pool=True)`` and the regression CLI's hidden-stage route
against the JAX package's.

Tolerances: taps and dumped maps within 1e-4 of each tap's largest value
(the two conv stacks sum in different orders, as for the heads in
``test_torch_port_yolov5.py``); pooled features with "max" exactly equal
and with "avg" within 1e-6 of the call's largest value (``ops/roi.py``'s
bounds) on the same feature tree. The CLI: the same files and keys as the
JAX CLI's, and the same CNN options (``resize``, ``batch_size``,
``channels``, ``linear``) for ``--resize 0`` and ``--resize P``.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import regression as jreg
from edgeml_tpu.data import io as jio
from edgeml_tpu.models.infer import dump_features as jax_dump_features
from edgeml_tpu_torch.cli import regression as treg
from edgeml_tpu_torch.data import io as tio
from edgeml_tpu_torch.dataprep import split_dataset
from edgeml_tpu_torch.estimators import train_cnn as ttc
from edgeml_tpu_torch.models.infer import dump_features
from test_torch_port_yolov5 import carried

torch.set_num_threads(1)
TAP_TOL = 1e-4
AVG_TOL = 1e-6
SIZE = 64


@pytest.fixture(scope="module")
def nets():
    x = np.random.default_rng(1).random((2, SIZE, SIZE, 3)).astype(
        np.float32)
    jnet, params, stats, net = carried(0, x)
    return types.SimpleNamespace(x=x, jnet=jnet, params=params, stats=stats,
                                 net=net)


def rel_err(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def test_taps_match_jax_every_stage(nets):
    """Every stage 0..23 at once, on the batch the weights were calibrated
    on; NCHW against the JAX package's NHWC."""
    stages = tuple(range(24))
    _, _, jtaps = nets.jnet.apply(nets.params, nets.stats,
                                  jnp.asarray(nets.x), taps=stages)
    taps = nets.net.taps(torch.from_numpy(nets.x), stages)
    assert sorted(taps) == list(stages)
    for s in stages:
        want = np.asarray(jtaps[s]).transpose(0, 3, 1, 2)
        got = taps[s].numpy()
        assert got.dtype == np.float32 and got.shape == want.shape, s
        assert rel_err(got, want) <= TAP_TOL, (s, rel_err(got, want))
    # the stage table's widths at 64 px, nc 8 (YOLOv5n)
    assert taps[17].shape == (2, 64, 8, 8)
    assert taps[23].shape == (2, 256, 2, 2)
    with pytest.raises(ValueError, match="0..23"):
        nets.net.taps(torch.from_numpy(nets.x), (24,))


def test_taps_leave_the_serving_path_alone(nets):
    """Asking for taps changes nothing the heads compute."""
    x = torch.from_numpy(nets.x)
    before = [h.clone() for h in nets.net.raw_heads(x)]
    taps = nets.net.taps(x, (17, 20, 23))
    for h, b, s in zip(nets.net.raw_heads(x), before, (17, 20, 23)):
        assert torch.equal(h, b)
    feats = nets.net.trunk(x.permute(0, 3, 1, 2))
    for f, s in zip(feats, (17, 20, 23)):
        assert torch.equal(f, taps[s])


def write_images(img_dir, seed, n=5):
    rng = np.random.default_rng(seed)
    os.makedirs(img_dir)
    shapes = [(48, 64), (64, 40), (64, 64), (30, 50), (64, 48)]
    for i in range(n):
        h, w = shapes[i % len(shapes)]
        name = f"im.{i}.npy" if i == 1 else f"im{i}.npy"  # a dotted stem
        np.save(os.path.join(img_dir, name),
                (rng.random((h, w, 3)) * 255).astype(np.uint8))


def tree(root):
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            p = os.path.join(base, n)
            out[os.path.relpath(p, root)] = np.load(p)
    return out


@pytest.fixture(scope="module")
def dumped(nets, tmp_path_factory):
    root = tmp_path_factory.mktemp("dump")
    write_images(str(root / "img"), 3)
    dump_features(nets.net, str(root / "img"), str(root / "ours"),
                  img_size=SIZE, device="cpu")
    jax_dump_features(nets.jnet, nets.params, nets.stats, str(root / "img"),
                      str(root / "theirs"), img_size=SIZE)
    return root


def test_dump_features_tree_matches_jax(dumped):
    ours, theirs = tree(dumped / "ours"), tree(dumped / "theirs")
    assert sorted(ours) == sorted(theirs) and len(ours) == 5 * 4
    assert "im.1/stage17_C3_features.npy" in ours  # all dots but the last
    assert "im0/stage9_SPPF_features.npy" in ours
    for k, want in theirs.items():
        got = ours[k]
        assert got.dtype == np.float32 and got.shape == want.shape, k
        assert rel_err(got, want) <= TAP_TOL, (k, rel_err(got, want))


def test_dump_features_stages_and_device_guard(nets, tmp_path, monkeypatch):
    write_images(str(tmp_path / "img"), 4, n=2)
    dump_features(nets.net, str(tmp_path / "img"), str(tmp_path / "out"),
                  stages=(0, 12), img_size=SIZE, device="cpu")
    got = tree(tmp_path / "out")
    assert sorted(got) == ["im.1/stage0_Conv_features.npy",
                           "im.1/stage12_Concat_features.npy",
                           "im0/stage0_Conv_features.npy",
                           "im0/stage12_Concat_features.npy"]
    assert got["im0/stage0_Conv_features.npy"].shape == (16, 32, 32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dump_features(nets.net, str(tmp_path / "img"), str(tmp_path / "x"),
                      img_size=SIZE)
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("stage,size", [(17, 4), (23, 8), (9, 1)])
def test_load_feature_pooled_matches_jax(dumped, stage, size):
    """Pooled maps of the JAX package's own dump, batches of 2 so that the
    tail batch is partial."""
    path = str(dumped / "theirs")
    for func in ("avg", "max"):
        got = tio.load_feature(path, stage, pool=True, batch_size=2,
                               func=func, size=size, device="cpu")
        want = jio.load_feature(path, stage, pool=True, batch_size=2,
                                func=func, size=size)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.shape[0] == 5 and got.shape[2:] == (size, size)
        if func == "max":
            np.testing.assert_array_equal(got, want)
        else:
            assert float(np.abs(got - want).max()) <= AVG_TOL * float(
                np.abs(want).max())


def test_load_feature_pooled_ragged_and_empty(tmp_path):
    """Non-square maps (one longest side) are square-padded top-left; no
    image directory gives np.zeros((0,)) as in the JAX package."""
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate([(6, 9), (9, 4), (9, 9), (1, 9)]):
        d = tmp_path / "f" / f"img{i}"
        d.mkdir(parents=True)
        np.save(d / "stage20_C3_features.npy",
                rng.normal(size=(3, h, w)).astype(np.float32))
    for func in ("avg", "max"):
        got = tio.load_feature(str(tmp_path / "f"), 20, func=func, size=4,
                               batch_size=3, device="cpu")
        want = jio.load_feature(str(tmp_path / "f"), 20, func=func, size=4,
                                batch_size=3)
        assert got.shape == want.shape == (4, 3, 4, 4)
        assert float(np.abs(got - want).max()) <= AVG_TOL * float(
            np.abs(want).max())
    (tmp_path / "none").mkdir()
    got = tio.load_feature(str(tmp_path / "none"), 20, device="cpu")
    want = jio.load_feature(str(tmp_path / "none"), 20)
    assert got.shape == want.shape == (0,)


class _ShortCNNOpt:
    """The CLIs' CNN defaults, 2 epochs."""

    def __init__(self, base):
        self.base = base

    def __call__(self):
        return self.base(max_epoch=2, milestones=[1])


@pytest.fixture(scope="module")
def hidden_tree(dumped, tmp_path_factory):
    root = tmp_path_factory.mktemp("hidden_cli")
    n = len(os.listdir(dumped / "theirs"))
    rng = np.random.default_rng(6)
    np.savez(root / "reward.npz",
             reward=rng.normal(0, 0.05, n).astype(np.float32), time=1.0)
    split_dataset(n, 2, str(root / "split.npy"))
    return types.SimpleNamespace(feat=str(dumped / "theirs"),
                                 reward=str(root / "reward.npz"),
                                 split=str(root / "split.npy"))


def _capture(module, monkeypatch):
    """Swap a CLI's fit_CNN for one that records its options and inputs."""
    seen = []

    def fake_fit(data, opts, save_opts, device=None):
        seen.append((opts, [np.asarray(f).shape for f in data[0]]))
        r = {"train_est": np.zeros(len(data[2]), np.float32),
             "val_est": np.zeros(len(data[3]), np.float32),
             "train_time": 0.0, "val_time": 0.0}
        return r, r

    monkeypatch.setattr(module, "fit_CNN", fake_fit)
    return seen


@pytest.mark.parametrize("stage,resize", [(17, 4), (23, 8), (20, 0)])
def test_regression_hidden_stage_cnn_options_match_jax(
        hidden_tree, tmp_path, monkeypatch, stage, resize):
    """--resize P pools the maps and keeps BatchNorm at the default batch;
    --resize 0 feeds the raw maps one image a batch without BatchNorm; the
    channel chain is taken from the data. The options and the inputs'
    shapes equal the JAX CLI's."""
    ours_seen = _capture(treg, monkeypatch)
    theirs_seen = _capture(jreg, monkeypatch)
    argv = [hidden_tree.feat, hidden_tree.reward, hidden_tree.split,
            str(tmp_path / "ours"), "--stage", str(stage), "--resize",
            str(resize), "--model", "CNN"]
    treg.main(treg.getargs(argv + ["--device", "cpu"]))
    jreg.main(types.SimpleNamespace(
        data_dir=hidden_tree.feat, reward_path=hidden_tree.reward,
        split_path=hidden_tree.split, save_dir=str(tmp_path / "theirs"),
        normalize=False, weight=False, stage=stage, resize=resize,
        model="CNN", model_dir=""))
    assert len(ours_seen) == len(theirs_seen) == 2
    for (o, oshapes), (t, tshapes) in zip(ours_seen, theirs_seen):
        for field in ("resize", "batch_size", "channels", "linear", "kernels",
                      "pools", "max_epoch", "weight"):
            assert getattr(o, field) == getattr(t, field), field
        assert oshapes == tshapes
    opts = ours_seen[0][0]
    cin = {17: 64, 20: 128, 23: 256}[stage]
    assert opts.channels == [cin, 16, 16, 16, 16, 1] and opts.linear == []
    assert (opts.resize, opts.batch_size) == ((True, 64) if resize else
                                              (False, 1))
    if resize:
        assert ours_seen[0][1][0] == (cin, resize, resize)


@pytest.mark.parametrize("resize", [4, 0])
def test_regression_hidden_stage_runs_and_writes_jax_files(
        hidden_tree, tmp_path, monkeypatch, resize):
    """The route end to end on the CPU (2 epochs): the JAX CLI's file names
    and estimate keys, finite estimates of the fold's sizes."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(treg, "CNNOpt", _ShortCNNOpt(ttc.CNNOpt))
    save = str(tmp_path / "est")
    treg.main(treg.getargs([hidden_tree.feat, hidden_tree.reward,
                            hidden_tree.split, save, "--stage", "17",
                            "--resize", str(resize), "--model", "CNN",
                            "--model-dir", str(tmp_path / "wts"),
                            "--device", "cpu"]))
    split = np.load(hidden_tree.split)
    for which in ("est_best", "est_last"):
        for k, val in enumerate(split):
            e = np.load(tmp_path / which / f"estimate{k + 1}.npz")
            assert sorted(e.files) == ["train_est", "train_time", "val_est",
                                       "val_time"]
            assert e["val_est"].shape == (int(val.sum()),)
            assert e["train_est"].shape == (int((~val).sum()),)
            assert np.isfinite(e["val_est"]).all()
    for which in ("wts_best", "wts_last"):
        assert sorted(os.listdir(tmp_path / which)) == ["wts1.npz",
                                                        "wts2.npz"]
