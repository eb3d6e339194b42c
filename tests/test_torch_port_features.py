"""The port's data-prep path against the JAX package's, on the CPU: the
dataset split (``dataprep/split.py``, ``cli/dataset_split.py``), the output
features (``data/io.py extract_output_feature``, ``cli/extract_feature.py``),
``load_feature`` and the path helpers (``utils/paths.py``).

Tolerance: none. Split files and feature files are compared byte for byte
with the JAX CLIs' (``data_processing/``) on the same inputs, and loaded
features array for array.
"""

import os
import sys
import types

import numpy as np
import pytest
import torch

import data_processing.dataset_split as jsplit_cli
import data_processing.extract_feature as jfeat_cli
from edgeml_tpu.data import io as jio
from edgeml_tpu.dataprep import split_dataset as jsplit_dataset
from edgeml_tpu.utils import paths as jpaths
from edgeml_tpu_torch.cli import dataset_split as tsplit_cli
from edgeml_tpu_torch.cli import extract_feature as tfeat_cli
from edgeml_tpu_torch.data import io as tio
from edgeml_tpu_torch.dataprep import split_dataset
from edgeml_tpu_torch.utils import paths as tpaths
from test_torch_port_io import write_dataset

torch.set_num_threads(1)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("n_img,n_split,seed", [(10, 2, 0), (37, 5, 0),
                                                (4952, 5, 0), (100, 3, 7)])
def test_split_bit_equal(n_img, n_split, seed):
    got = split_dataset(n_img, n_split, seed=seed)
    want = jsplit_dataset(n_img, n_split, seed=seed)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert (got.sum(0) == 1).all()


@pytest.mark.parametrize("n_img,n_split", [(23, 5), (12, 3)])
def test_dataset_split_cli_file_equal(tmp_path, n_img, n_split):
    img = tmp_path / "images"
    img.mkdir()
    for i in range(n_img):
        (img / f"{i:04d}.jpg").write_bytes(b"")
    ours, theirs = str(tmp_path / "ours.npy"), str(tmp_path / "theirs.npy")
    tsplit_cli.main(tsplit_cli.getargs([str(img), ours, "--num-split",
                                        str(n_split), "--device", "cpu"]))
    jsplit_cli.main(types.SimpleNamespace(img_dir=str(img), save_path=theirs,
                                          num_split=n_split))
    assert _bytes(ours) == _bytes(theirs)


def _write_detections(root, seed, n_img=14, n_cls=20, long_rows=40):
    """weak-detector files with every case: more rows than k, .npy files,
    empty and missing files; and a label directory naming the images."""
    rng = np.random.default_rng(seed)
    det, lab = os.path.join(root, "weak"), os.path.join(root, "labels")
    os.makedirs(det)
    os.makedirs(lab)
    for i in range(n_img):
        name = f"im{i:03d}"
        open(os.path.join(lab, name + ".txt"), "w").close()
        n = long_rows if i % 4 == 0 else int(rng.integers(0, 9))
        rows = np.concatenate([rng.integers(0, n_cls, (n, 1)),
                               rng.random((n, 5))], 1)
        path = os.path.join(det, name)
        if i % 6 == 5:
            continue  # missing
        if i % 5 == 2:
            np.save(path + ".npy", rows)
        else:
            with open(path + ".txt", "w") as f:
                f.writelines(f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} "
                             f"{r[4]:.6f} {r[5]:.9f}\n" for r in rows)
    return det, lab


@pytest.mark.parametrize("dataset,k", [("voc", 25), ("coco", 25), ("voc", 3)])
def test_extract_feature_cli_byte_equal(tmp_path, dataset, k):
    det, lab = _write_detections(str(tmp_path), seed=k)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    tfeat_cli.main(tfeat_cli.getargs([det, ours, lab, "--k", str(k),
                                      "--dataset", dataset, "--device", "cpu"]))
    jfeat_cli.main(types.SimpleNamespace(output_dir=det, save_dir=theirs,
                                         label_dir=lab, k=k, dataset=dataset))
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == names and len(names) == 14
    nc = 20 if dataset == "voc" else 80
    for name in names:
        f = os.path.join(name, "stage24_output_features.npy")
        assert _bytes(os.path.join(ours, f)) == _bytes(os.path.join(theirs, f))
        arr = np.load(os.path.join(ours, f))
        assert arr.dtype == np.float64 and arr.shape == (nc + 5 * k,)


def test_features_take_rows_in_file_order(tmp_path):
    """The first k rows as the file lists them, not the k most confident."""
    det, lab = tmp_path / "det", tmp_path / "lab"
    det.mkdir()
    lab.mkdir()
    (lab / "a.txt").write_text("")
    (det / "a.txt").write_text("3 0.1 0.2 0.3 0.4 0.1\n1 0.5 0.5 0.5 0.5 0.9\n"
                               "2 0.6 0.6 0.6 0.6 0.95\n")
    out = tmp_path / "out"
    (out / "a").mkdir(parents=True)
    tio.extract_output_feature(str(det), str(out), 20, k=2)
    f = np.load(out / "a" / "stage24_output_features.npy")
    assert f[3] == 1 and f[1] == 1 and f[2] == 0
    np.testing.assert_array_equal(f[20:30], [0.1, 0.2, 0.3, 0.4, 0.1,
                                             0.5, 0.5, 0.5, 0.5, 0.9])


def test_load_feature_stage24_and_raw_maps(tmp_path):
    rng = np.random.default_rng(3)
    root = tmp_path / "feats"
    for i in range(5):
        d = root / f"img{i}"
        d.mkdir(parents=True)
        np.save(d / "stage24_output_features.npy", rng.random(145))
        np.save(d / "stage17_C3_features.npy",
                rng.random((8, 4 + i, 6)).astype(np.float32))
    (root / "stray.txt").write_text("not an image directory")
    for stage in (24, 17):
        got = tio.load_feature(str(root), stage, pool=False)
        want = jio.load_feature(str(root), stage, pool=False)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # pool=True RoI-resizes the hidden maps (test_torch_port_roi.py and
    # test_torch_port_hidden_features.py hold it against the JAX package);
    # maps of several longest sides go one image a batch
    got = tio.load_feature(str(root), 17, pool=True, size=4, batch_size=1,
                           device="cpu")
    want = jio.load_feature(str(root), 17, pool=True, size=4, batch_size=1)
    assert got.shape == want.shape == (5, 8, 4, 4)
    assert float(np.abs(got - want).max()) <= 1e-6 * float(
        np.abs(want).max())


@pytest.mark.parametrize("path", ["", "est", "out/est", "out/est/",
                                  "/abs/dir/est", "a/../b"])
def test_parse_path_matches_jax(path):
    assert tpaths.parse_path(path) == jpaths.parse_path(path)


def test_save_result_matches_jax(tmp_path):
    result = {"train_est": np.arange(5, dtype=np.float32),
              "val_est": np.array([1, 0, 1]), "train_time": 0.25,
              "val_time": 1e-6}
    tpaths.save_result(str(tmp_path / "ours" / "x"), result, 2)
    jpaths.save_result(str(tmp_path / "theirs" / "x"), result, 2)
    got = np.load(tmp_path / "ours" / "x" / "estimate3.npz")
    want = np.load(tmp_path / "theirs" / "x" / "estimate3.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _jax_args(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    return vars(module.getargs())


@pytest.mark.parametrize("cli", ["dataset_split", "extract_feature",
                                 "regression", "baseline"])
def test_cli_arguments_are_the_jax_clis_plus_device(cli, monkeypatch):
    import baseline as jbase
    import regression as jreg
    from edgeml_tpu_torch.cli import baseline as tbase
    from edgeml_tpu_torch.cli import regression as treg

    argv, jmod, tmod = {
        "dataset_split": (["imgs", "s.npy", "--num-split", "4"], jsplit_cli,
                          tsplit_cli),
        "extract_feature": (["det", "feat", "lab", "--k", "9", "--dataset",
                             "voc"], jfeat_cli, tfeat_cli),
        "regression": (["feat", "r.npz", "s.npy", "out", "--normalize",
                        "--weight", "--stage", "17", "--model", "KNR",
                        "--model-dir", "m"], jreg, treg),
        "baseline": (["det", "r.npz", "s.npy", "out", "--baseline", "dcsb",
                      "--positive_weight", "2.5", "--label_dir", "lab",
                      "--model_dir", "m"], jbase, tbase),
    }[cli]
    ours = vars(tmod.getargs(argv))
    assert ours.pop("device") == "cuda"
    assert ours == _jax_args(jmod, argv, monkeypatch)


def test_clis_need_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    """With no CUDA device and no --device, each new CLI raises before it
    writes anything."""
    from edgeml_tpu_torch.cli import baseline as tbase
    from edgeml_tpu_torch.cli import regression as treg

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = tmp_path / "imgs"
    img.mkdir()
    (img / "a.jpg").write_bytes(b"")
    det, lab = _write_detections(str(tmp_path), seed=1, n_img=3)
    calls = [
        (tsplit_cli, [str(img), str(tmp_path / "s.npy")]),
        (tfeat_cli, [det, str(tmp_path / "feat"), lab]),
        (treg, [str(tmp_path / "feat"), "r.npz", "s.npy",
                str(tmp_path / "out")]),
        (tbase, [det, "r.npz", "s.npy", str(tmp_path / "out")]),
    ]
    for mod, argv in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main(mod.getargs(argv))
    assert sorted(os.listdir(tmp_path)) == ["imgs", "labels", "weak"]


def test_extract_feature_on_the_reward_dataset(tmp_path):
    """The weak detector's files of the reward tests (.txt, .npy, empty,
    missing), through both CLIs: byte-equal."""
    weak, _, lab = write_dataset(str(tmp_path / "data"), seed=5, n_img=16)
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    tfeat_cli.main(tfeat_cli.getargs([weak, ours, lab, "--dataset", "voc",
                                      "--k", "4", "--device", "cpu"]))
    jfeat_cli.main(types.SimpleNamespace(output_dir=weak, save_dir=theirs,
                                         label_dir=lab, k=4, dataset="voc"))
    for name in sorted(os.listdir(theirs)):
        f = os.path.join(name, "stage24_output_features.npy")
        assert _bytes(os.path.join(ours, f)) == _bytes(os.path.join(theirs, f))
