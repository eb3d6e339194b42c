"""The port's training data path against the JAX package's: the YOLO
recipe's augmentation (mosaic-4, scale/translate, HSV jitter, flip), the
native host HSV jitter, the device HSV jitter, the five ``--augment
flip|ssd`` transforms, the windowed resize, the taps without antialiasing
and ``iter_batches(order, drop_last)``.

Tolerances: images and labels of ``yolo_augment_batch`` equal for the same
key (the same draws, the same taps through the same native resampler, the
same native jitter); the native jitter bit-equal, and within 2e-6 of the
NumPy expression (float64 gains there); the device jitter within 1e-6 of
the JAX package's; the transforms equal for the same generator; the
windowed resize bit-equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgeml_tpu.data import loader as jloader
from edgeml_tpu.data import transforms as jtf
from edgeml_tpu.data import yolo_aug as jaug
from edgeml_tpu.ops.color import hsv_jitter as jax_hsv_jitter
from edgeml_tpu_torch.data import loader as tloader
from edgeml_tpu_torch.data import transforms as ttf
from edgeml_tpu_torch.data import yolo_aug as taug
from edgeml_tpu_torch.ops.color import hsv_jitter

torch.set_num_threads(1)


def _examples(seed, n=4):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = [(48, 64), (64, 40), (64, 64), (50, 37)][i % 4]
        img = rng.random((h, w, 3)).astype(np.float32)
        k = int(rng.integers(0, 4))
        xy = rng.uniform(0.1, 0.6, (k, 2))
        wh = rng.uniform(0.05, 0.4, (k, 2))
        xyxy = np.concatenate([xy, np.minimum(xy + wh, 1.0)], 1)
        out.append((img, (rng.integers(0, 5, k).astype(np.float32),
                          xyxy.astype(np.float32))))
    return out


@pytest.mark.parametrize("hsv", [True, False, "device"])
@pytest.mark.parametrize("key", [[0, 0, 0], [3, 1, 7]])
def test_yolo_augment_batch_equals_jax(hsv, key):
    ex = _examples(key[0] + 10)
    got = taug.yolo_augment_batch(ex, 64, key, hsv=hsv)
    want = jaug.yolo_augment_batch(ex, 64, key, hsv=hsv)
    assert len(got) == len(want) == (3 if hsv == "device" else 2)
    assert got[0].dtype == np.float32 and got[0].shape == (4, 64, 64, 3)
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert sum(len(r) for r in got[1]) > 0
    if hsv == "device":
        np.testing.assert_array_equal(got[2], want[2])


def test_native_hsv_jitter_bit_equal_and_near_numpy():
    rng = np.random.default_rng(1)
    img = rng.random((37, 53, 3)).astype(np.float32)
    img[0, :5] = 0.5  # grey pixels: diff 0
    img[1, :5] = 0.0  # black: mx 0
    for seed in range(4):
        got = taug.hsv_jitter(img, np.random.default_rng(seed))
        want = jaug.hsv_jitter(img, np.random.default_rng(seed))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        gains = taug.hsv_gains(np.random.default_rng(seed))
        oracle = taug.hsv_jitter_numpy(img, *gains)
        assert float(np.abs(got - oracle).max()) < 2e-6


def test_native_hsv_jitter_rejects_non_rgb():
    from edgeml_tpu_torch.data.fastaug import native_hsv_jitter

    with pytest.raises(ValueError, match="RGB"):
        native_hsv_jitter(np.zeros((4, 4, 2), np.float32), 1.0, 1.0, 1.0)


def test_device_hsv_jitter_matches_jax():
    rng = np.random.default_rng(2)
    imgs = rng.random((3, 16, 24, 3)).astype(np.float32)
    imgs[0, 0, :4] = 0.25
    imgs[1, 1, :4] = 0.0
    gains = np.stack([taug.hsv_gains(np.random.default_rng(s))
                      for s in range(3)]).astype(np.float32)
    got = hsv_jitter(torch.from_numpy(imgs), torch.from_numpy(gains))
    want = np.asarray(jax_hsv_jitter(jnp.asarray(imgs), jnp.asarray(gains)))
    assert got.dtype == torch.float32 and got.shape == imgs.shape
    assert float(np.abs(got.numpy() - want).max()) < 1e-6
    host = np.stack([taug.hsv_jitter_numpy(im, *g)
                     for im, g in zip(imgs, gains.astype(np.float64))])
    assert float(np.abs(got.numpy() - host).max()) < 1e-5


def _sample(seed):
    rng = np.random.default_rng(seed)
    img = rng.random((60, 80, 3)).astype(np.float32)
    xy = rng.uniform(0, 50, (5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (5, 2))], 1)
    return img, {"boxes": boxes.astype(np.float32),
                 "labels": rng.integers(1, 9, 5)}


@pytest.mark.parametrize("name", ["Compose_flip", "RandomHorizontalFlip",
                                  "RandomIoUCrop", "RandomZoomOut",
                                  "RandomPhotometricDistort", "ssd"])
def test_transforms_equal_jax(name):
    def build(mod):
        if name == "Compose_flip":
            return mod.Compose([mod.RandomHorizontalFlip(0.5)])
        if name == "ssd":
            return mod.Compose([mod.RandomPhotometricDistort(),
                                mod.RandomZoomOut(), mod.RandomIoUCrop(),
                                mod.RandomHorizontalFlip(0.5)])
        return getattr(mod, name)()

    t, j = build(ttf), build(jtf)
    changed = 0
    for seed in range(8):
        img, tgt = _sample(seed)
        gi, gt = t(img, dict(tgt), np.random.default_rng(seed))
        wi, wt = j(img, dict(tgt), np.random.default_rng(seed))
        assert gi.dtype == wi.dtype and np.array_equal(gi, wi)
        assert set(gt) == set(wt)
        for k in gt:
            assert np.array_equal(gt[k], wt[k]), k
        changed += not np.array_equal(gi, img)
    assert changed > 0


def test_resize_bilinear_window_bit_equal():
    rng = np.random.default_rng(4)
    img = rng.random((45, 70, 3)).astype(np.float32)
    for (oh, ow), (y0, y1, x0, x1) in [((90, 140), (10, 60, 5, 140)),
                                       ((30, 47), (0, 30, 3, 20)),
                                       ((45, 70), (2, 40, 0, 70))]:
        got = tloader.resize_bilinear_window(img, oh, ow, y0, y1, x0, x1)
        want = jloader.resize_bilinear_window(img, oh, ow, y0, y1, x0, x1)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, tloader.resize_bilinear(img, oh, ow)[y0:y1, x0:x1])


@pytest.mark.parametrize("antialias", [True, False])
def test_linear_taps_equal(antialias):
    for n_in, n_out in [(100, 37), (37, 100), (64, 64), (640, 320)]:
        gj, gw = tloader._linear_taps(n_in, n_out, antialias)
        wj, ww = jloader._linear_taps(n_in, n_out, antialias)
        assert np.array_equal(gj, wj) and np.array_equal(gw, ww)


@pytest.mark.parametrize("drop_last", [False, True])
def test_iter_batches_order_and_drop_last(tmp_path, drop_last):
    names = []
    for i in range(7):
        np.save(tmp_path / f"im{i}.npy",
                np.full((2, 2, 3), i / 10, np.float32))
        names.append(f"im{i}.npy")
    order = np.random.default_rng(0).permutation(7)

    def batch(items):
        return ([n for n, _ in items],
                [int(round(im[0, 0, 0] * 10)) for _, im in items])

    got = list(tloader.iter_batches(str(tmp_path), names, 3, batch,
                                    order=order, drop_last=drop_last))
    want = list(jloader.iter_batches(str(tmp_path), names, 3, batch,
                                     order=order, drop_last=drop_last))
    assert got == want
    assert len(got) == (2 if drop_last else 3)
    assert [v for _, vals in got for v in vals] == \
        list(order[: 6 if drop_last else 7])
    # the default order stays the names' own
    plain = list(tloader.iter_batches(str(tmp_path), names, 4, batch))
    assert [n for ns, _ in plain for n in ns] == names


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_iter_batches_decodes_image_by_image(tmp_path, workers):
    """Each image decodes as a task of its own and a batch is made once its
    images are decoded: the same batches on one worker (a batch's task waits
    for decodes queued before it) as on four, with every batch prefetched,
    and a file that fails to decode raises from the iterator."""
    names = []
    for i in range(7):
        np.save(tmp_path / f"im{i}.npy", np.full((2, 2, 3), i / 10, np.float32))
        names.append(f"im{i}.npy")

    def batch(items):
        return [int(round(im[0, 0, 0] * 10)) for _, im in items]

    got = list(tloader.iter_batches(str(tmp_path), names, 2, batch,
                                    prefetch=8, workers=workers))
    assert got == [[0, 1], [2, 3], [4, 5], [6]]
    (tmp_path / "im5.npy").write_bytes(b"not an array")
    with pytest.raises(ValueError):
        list(tloader.iter_batches(str(tmp_path), names, 2, batch,
                                  workers=workers))


@pytest.mark.parametrize("mode,ext", [("RGB", "jpg"), ("L", "jpg"),
                                      ("RGBA", "png"), ("P", "png")])
def test_decode_image_equal(tmp_path, mode, ext):
    """An image file decodes to the JAX package's array bit for bit, RGB
    (read as it is) or any other mode (converted to RGB first)."""
    from PIL import Image

    rng = np.random.default_rng(3)
    px = (rng.random((37, 53, 3)) * 255).astype(np.uint8)
    im = Image.fromarray(px).convert(mode)
    path = str(tmp_path / f"im.{ext}")
    im.save(path)
    got, want = tloader.decode_image(path), jloader.decode_image(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
