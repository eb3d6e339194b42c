"""The port's data layer (``data/io.py``, ``data/fastio.py``) against the
JAX package's, on the CPU.

The native reader builds with g++ into ``edgeml_tpu_torch/_build/`` and never
into ``native/``; ``load_data`` gives JAX's arrays on .txt and .npy files,
empty, missing and malformed files, and a file too long for the native
reader (parsed in Python by both); ``set_data``'s triples (TP matrices,
confidences, classes, labels) are bit-identical to JAX's at T = 1 and 10.
Tolerance: none.
"""

import os

import numpy as np
import pytest
import torch

from edgeml_tpu.data import io as jio
from edgeml_tpu_torch.data import fastio
from edgeml_tpu_torch.data import io as tio

torch.set_num_threads(1)


def write_dataset(root, seed, n_img=24, n_cls=4, extras=True):
    """weak/strong/label directories of YOLO-format files: detections near
    the labels (so that many match), confidences printed with 9 digits
    (some within f32 rounding of 0.5), a few .npy files, empty and missing
    files. Returns the three directories."""
    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in ("weak", "strong", "label")}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(n_img):
        name = f"img{i:03d}"
        m = int(rng.integers(0, 5)) if i % 7 else 0
        lab = np.concatenate([rng.integers(0, n_cls, (m, 1)),
                              rng.uniform(0.2, 0.8, (m, 2)),
                              rng.uniform(0.05, 0.3, (m, 2))], 1)
        with open(os.path.join(dirs["label"], name + ".txt"), "w") as f:
            f.writelines(f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} "
                         f"{r[4]:.6f}\n" for r in lab)
        for det in ("weak", "strong"):
            n = int(rng.integers(0, 7))
            src = lab[rng.integers(0, max(m, 1), n)] if m else \
                np.concatenate([rng.integers(0, n_cls, (n, 1)),
                                rng.uniform(0.2, 0.8, (n, 4))], 1)
            rows = src.copy()
            rows[:, 1:5] += rng.normal(0, 0.02, (n, 4))
            rows[:, 0] = np.where(rng.random(n) < 0.8, rows[:, 0],
                                  rng.integers(0, n_cls, n))
            conf = rng.uniform(0.05, 1.0, n)
            conf[rng.random(n) < 0.2] = 0.50000001  # 0.5 in f32
            path = os.path.join(dirs[det], name)
            if extras and i % 5 == 3:
                np.save(path + ".npy", np.concatenate([rows, conf[:, None]],
                                                      1))
            elif extras and i % 11 == 4:
                continue  # missing
            else:
                with open(path + ".txt", "w") as f:
                    f.writelines(f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} "
                                 f"{r[3]:.6f} {r[4]:.6f} {c:.9f}\n"
                                 for r, c in zip(rows, conf))
    return dirs["weak"], dirs["strong"], dirs["label"]


def test_fastio_builds_into_port_build_dir(tmp_path, monkeypatch):
    """A fresh build goes to the port's build directory (here redirected
    to a temporary one), never into native/."""
    import edgeml_tpu_torch

    assert fastio.BUILD_DIR == os.path.join(
        os.path.dirname(os.path.abspath(edgeml_tpu_torch.__file__)), "_build")
    native = os.path.dirname(fastio.SRC)
    assert os.path.basename(native) == "native"
    before = sorted(os.listdir(native))
    monkeypatch.setattr(fastio, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(fastio, "_lib", None)
    (tmp_path / "a.txt").write_text("1 0.5 0.5 0.2 0.2\n")
    out = fastio.load_txt_boxes([str(tmp_path / "a.txt")], 5)
    so = fastio.library_path()
    assert so.startswith(str(tmp_path / "_build")) and os.path.isfile(so)
    assert sorted(os.listdir(native)) == before
    assert out[0].dtype == np.float32 and out[0].shape == (1, 5)


def test_fastio_failed_build_raises(tmp_path, monkeypatch):
    """A build that fails raises; it does not switch files to Python."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fastio, "SRC", str(bad))
    monkeypatch.setattr(fastio, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(fastio, "_lib", None)
    (tmp_path / "a.txt").write_text("1 0.5 0.5 0.2 0.2\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        fastio.load_txt_boxes([str(tmp_path / "a.txt")], 5)


def _assert_same_data(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


def test_load_data_matches_jax(tmp_path):
    d = tmp_path / "dets"
    d.mkdir()
    (d / "a.txt").write_text("1 0.5 0.5 0.2 0.2 0.9\n0 0.3 0.3 0.1 0.1 "
                             "0.50000001\n")
    np.save(d / "b.npy", np.array([[2, 0.6, 0.6, 0.2, 0.4, 0.7]]))
    (d / "c.txt").write_text("")
    np.save(d / "e.npy", np.zeros((0, 6)))
    rng = np.random.default_rng(0)
    long_rows = rng.uniform(0.1, 0.9, (1100, 6))
    long_rows[:, 0] = rng.integers(0, 5, 1100)
    with open(d / "long.txt", "w") as f:  # beyond the native reader's rows
        f.writelines(" ".join(f"{v:.7f}" for v in r) + "\n"
                     for r in long_rows)
    files = ["a", "b", "c", "e", "long", "missing"]
    got = tio.load_data(str(d), files, with_conf=True)
    want = jio.load_data(str(d), files, with_conf=True)
    _assert_same_data(got, want)
    assert got[0][2][1] == np.float32(0.50000001) == 0.5  # parsed in f32
    assert got[2] == () and got[3] == () and got[5] == ()
    assert got[4][0].shape == (1100,)
    labels = tmp_path / "labels"
    labels.mkdir()
    (labels / "a.txt").write_text("3 0.5 0.5 0.25 0.125\n")
    _assert_same_data(tio.load_data(str(labels), ["a", "b"]),
                      jio.load_data(str(labels), ["a", "b"]))


def test_load_data_malformed_file_raises_like_jax(tmp_path):
    """A row with a wrong column count: the native reader rejects the
    file, and the Python parse fails in both packages."""
    d = tmp_path / "dets"
    d.mkdir()
    (d / "bad.txt").write_text("1 0.5 0.5 0.2 0.2 0.9\n0 0.3 0.3\n")
    with pytest.raises(ValueError):
        jio.load_data(str(d), ["bad"], with_conf=True)
    with pytest.raises(ValueError):
        tio.load_data(str(d), ["bad"], with_conf=True)


def test_list_image_names_matches_jax(tmp_path):
    for n in ("b.txt", "a.npy", "c.d.txt"):
        (tmp_path / n).write_text("")
    assert tio.list_image_names(str(tmp_path)) == \
        jio.list_image_names(str(tmp_path))
    assert tio.V5_STAGE_NAMES == jio.V5_STAGE_NAMES


@pytest.mark.parametrize("t", [1, 10])
def test_set_data_bit_identical(tmp_path, t):
    weak, strong, label = write_dataset(str(tmp_path), seed=t)
    iouv = None if t == 1 else np.linspace(0.5, 0.95, 10)
    got = tio.set_data(weak, strong, label, iouv=iouv, device="cpu")
    want = jio.set_data(weak, strong, label, iouv=iouv)
    for g_stream, w_stream in zip(got[:2], want[:2]):
        _assert_same_data(g_stream, w_stream)
    _assert_same_data([(l,) for l in got[2]], [(l,) for l in want[2]])
    n_tp = sum(int(w[0].sum()) for w in got[0] + got[1])
    assert n_tp > 10 and got[0][0][0].shape[1] == t


def test_set_data_needs_cuda_unless_cpu_asked(tmp_path, monkeypatch):
    weak, strong, label = write_dataset(str(tmp_path), seed=3, n_img=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tio.set_data(weak, strong, label)
