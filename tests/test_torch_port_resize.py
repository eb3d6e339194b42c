"""The port's letterbox and square resize against the JAX package's, on the
CPU: bit-equal on seeded ragged images, downscale and upscale.

Both packages evaluate the same banded taps (``_linear_taps``) through the
same arithmetic (the JAX package through ``native/resize.cpp``; the port's
letterbox and square resize through ``data/fastprep.cpp``, which evaluates
the taps element for element as ``resize.cpp`` does, in one pass; both
built with the same g++ flags), so the tolerance is none. The port's
bindings build into ``edgeml_tpu_torch/_build/`` and raise when the build
fails; the NumPy tap evaluation it keeps for reference agrees within 2e-6.
"""

import os

import numpy as np
import pytest
import torch

from edgeml_tpu.data import fastresize as jfastresize
from edgeml_tpu.data import loader as jloader
from edgeml_tpu.models.common import letterbox_batch as jletterbox_batch
from edgeml_tpu_torch.data import fastio, fastprep, fastresize, loader
from edgeml_tpu_torch.models.common import letterbox_batch
from edgeml_tpu_torch.models.infer import square_batch

torch.set_num_threads(1)

SHAPES = [(480, 640), (640, 427), (640, 640), (500, 375)]


def images(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [rng.random((h, w, 3), dtype=np.float32) for h, w in shapes]


def jax_square_batch(imgs, size):
    """The JAX package's square resize and normalisation
    (``edgeml_tpu/models/infer.py`` make_batch)."""
    rs = np.stack([jloader.resize_bilinear(im, size, size) for im in imgs])
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (rs - mean) / std


def test_jax_package_uses_its_native_resampler():
    """The comparison below is against the JAX package's native path, not
    its NumPy fallback."""
    assert jfastresize._load() is not None


@pytest.mark.parametrize("size", [640, 320, 1280])
def test_letterbox_batch_bit_equal(size):
    imgs = images(size)
    got, meta = letterbox_batch(imgs, size)
    want, wmeta = jletterbox_batch(imgs, size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(meta, np.asarray(wmeta))


@pytest.mark.parametrize("size", [320, 640, 1000])
def test_square_batch_bit_equal(size):
    imgs = images(size + 1)
    got = square_batch(imgs, size)
    want = jax_square_batch(imgs, size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("out_hw", [(320, 240), (700, 900), (33, 17)])
def test_numpy_evaluation_is_the_same_resampling(out_hw):
    """``eval_taps_numpy`` (the reference the smoke run times) computes the
    same weights in another summation order: within 2e-6."""
    img = images(3, [(123, 77)])[0]
    oh, ow = out_hw
    taps = (loader._linear_taps(123, oh), loader._linear_taps(77, ow))
    native = loader._eval_taps(img, oh, ow, *taps)
    plain = loader.eval_taps_numpy(img, oh, ow, *taps)
    assert native.shape == plain.shape == (oh, ow, 3)
    np.testing.assert_allclose(native, plain, rtol=0, atol=2e-6)


def test_builds_into_the_package_build_dir(tmp_path, monkeypatch):
    """The one-pass prep library that letterbox_batch and square_batch call
    is compiled into the port's _build/ (here redirected to a temporary
    one), never into native/."""
    native = os.path.dirname(fastresize.SRC)
    before = sorted(os.listdir(native))
    monkeypatch.setattr(fastio, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(fastprep, "_lib", None)
    lb, _ = letterbox_batch(images(4, [(40, 30)]), 64)
    sq = square_batch(images(4, [(40, 30)]), 32)
    so = fastio.library_path(fastprep.SRC, "libfastprep")
    assert so.startswith(str(tmp_path / "_build")) and os.path.isfile(so)
    assert sorted(os.listdir(native)) == before
    assert lb.dtype == sq.dtype == np.float32
    assert lb.shape == (1, 64, 64, 3) and sq.shape == (1, 32, 32, 3)


def test_resampler_builds_into_the_package_build_dir(tmp_path, monkeypatch):
    """The resampler that resize_bilinear calls (yolo_aug, the train CLI)
    is compiled into the port's _build/ too, never into native/."""
    native = os.path.dirname(fastresize.SRC)
    before = sorted(os.listdir(native))
    monkeypatch.setattr(fastio, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(fastresize, "_lib", None)
    out = loader.resize_bilinear(images(4, [(40, 30)])[0], 20, 15)
    so = fastio.library_path(fastresize.SRC, "libresize")
    assert so.startswith(str(tmp_path / "_build")) and os.path.isfile(so)
    assert sorted(os.listdir(native)) == before
    assert out.dtype == np.float32 and out.shape == (20, 15, 3)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A build of the prep library that fails raises; letterbox_batch and
    square_batch do not switch to the two-step NumPy path."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fastprep, "SRC", str(bad))
    monkeypatch.setattr(fastio, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(fastprep, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        letterbox_batch(images(6, [(40, 30)]), 64)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        square_batch(images(6, [(40, 30)]), 64)


def test_failed_resampler_build_raises(tmp_path, monkeypatch):
    """A build of the resampler that fails raises; resizing does not switch
    to NumPy."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fastresize, "SRC", str(bad))
    monkeypatch.setattr(fastio, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(fastresize, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        loader.resize_bilinear(images(5, [(40, 30)])[0], 20, 15)


def test_nonzero_return_raises(monkeypatch):
    """The library's error code raises too (an empty image is refused by
    resize_bilinear_f32 itself)."""
    jh, wh = loader._linear_taps(4, 2)
    with pytest.raises(RuntimeError, match="failed with code 1"):
        fastresize.native_resize(np.zeros((4, 0, 3), np.float32), 2, 0, jh,
                                 wh, np.zeros((0, 1), np.int32),
                                 np.zeros((0, 1), np.float32))
