"""The transforms the train CLI does not build (PILToTensor,
ConvertImageDtype, COCO person keypoints under the flip, ScaleJitter,
FixedSizeCrop, RandomShortestSize, SimpleCopyPaste) against the JAX
package's classes on the same seeded generator, on the cases of
``tests/test_transforms.py``, and the generator left at the same position.

Tolerances: every integer, box and crop result exact; the two resizing
transforms' images 5e-6 of pixel values in [0, 1] (the port's
antialiased bilinear against ``jax.image.resize(..., "bilinear")``, whose
tap weights round in another order: measured 1.8e-7 when shrinking, 1.8e-6
when enlarging 2.5x), their boxes exact (the same NumPy arithmetic).
"""

import numpy as np
import pytest

from edgeml_tpu.data import transforms as jtf
from edgeml_tpu_torch.data import transforms as ttf

RESIZE_TOL = 5e-6


def sample(h=60, w=80, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w, 3)).astype(np.float32)
    boxes = np.array([[10, 10, 30, 40], [50, 20, 70, 50]], np.float32)
    labels = np.array([1, 2])
    return img, {"boxes": boxes, "labels": labels}


def both(make, *args, seed=5, tol=0.0):
    """Run the JAX package's and the port's transform (``make(module)``)
    on the same sample and generator seed; compare everything."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = make(jtf)(*args, rj)
    got = make(ttf)(*args, rt)
    assert rj.random() == rt.random()  # the same draws were taken
    (wi, wt), (gi, gt) = want, got
    assert gi.shape == wi.shape and gi.dtype == wi.dtype
    if tol:
        np.testing.assert_allclose(gi, wi, atol=tol, rtol=0)
    else:
        np.testing.assert_array_equal(gi, wi)
    assert gt.keys() == wt.keys()
    for k in wt:
        np.testing.assert_array_equal(np.asarray(gt[k]), np.asarray(wt[k]))
    return got


@pytest.mark.parametrize("seed", [5, 6, 7])
@pytest.mark.parametrize("scale", [(0.5, 0.5), (0.1, 2.0)])
def test_scale_jitter_equals_jax(seed, scale):
    img, tgt = sample()
    out, t2 = both(lambda m: m.ScaleJitter(target_size=(120, 160),
                                           scale_range=scale),
                   img, tgt, seed=seed, tol=RESIZE_TOL)
    if scale == (0.5, 0.5):
        r = out.shape[0] / img.shape[0]
        assert np.allclose(t2["boxes"], tgt["boxes"] * r, atol=1e-4)


@pytest.mark.parametrize("size", [(32, 32), (100, 50), (60, 80)])
def test_fixed_size_crop_equals_jax(size):
    img, tgt = sample()
    out, _ = both(lambda m: m.FixedSizeCrop(size=size, fill=0.25), img, tgt,
                  seed=6)
    assert out.shape == size + (3,)


@pytest.mark.parametrize("min_size,max_size", [((48,), 100),
                                               ((30, 90, 120), 1000),
                                               (200, 150)])
def test_random_shortest_size_equals_jax(min_size, max_size):
    img, tgt = sample()
    for seed in (7, 8):
        both(lambda m: m.RandomShortestSize(min_size=min_size,
                                            max_size=max_size),
             img, tgt, seed=seed, tol=RESIZE_TOL)


@pytest.mark.parametrize("seed", [8, 9, 10, 11])
def test_copy_paste_equals_jax(seed):
    a, b = sample(seed=1), sample(seed=2)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    wi, wt = jtf.SimpleCopyPaste(p=0.7)(a, b, rj)
    gi, gt = ttf.SimpleCopyPaste(p=0.7)(a, b, rt)
    assert rj.random() == rt.random()
    np.testing.assert_array_equal(gi, wi)
    for k in ("boxes", "labels"):
        np.testing.assert_array_equal(gt[k], wt[k])
    assert len(gt["boxes"]) >= len(a[1]["boxes"])
    assert len(gt["boxes"]) == len(gt["labels"])


def test_hflip_masks_and_keypoints_equal_jax():
    img, tgt = sample()
    h, w = img.shape[:2]
    masks = np.zeros((2, h, w), np.uint8)
    masks[0, :, :10] = 1
    kps = np.random.default_rng(4).uniform(0, 60, (3, 17, 3)).astype(
        np.float32)
    kps[..., 2] = np.random.default_rng(5).integers(0, 3, (3, 17))
    tgt = {**tgt, "masks": masks, "keypoints": kps}
    _, t2 = both(lambda m: m.RandomHorizontalFlip(p=1.0), img, tgt, seed=3)
    # invisible joints stay pinned at zero; the round trip is the identity
    assert (t2["keypoints"][t2["keypoints"][..., 2] == 0] == 0).all()
    back = ttf.flip_coco_person_keypoints(t2["keypoints"], w)
    vis = kps[..., 2] > 0
    np.testing.assert_allclose(back[vis], kps[vis], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        ttf.flip_coco_person_keypoints(kps, w),
        jtf.flip_coco_person_keypoints(kps, w))


def test_conversion_shims_equal_jax():
    img, tgt = sample()
    u8, t1 = both(lambda m: m.PILToTensor(), img, tgt)
    assert u8.dtype == np.uint8 and t1 is not None
    both(lambda m: m.PILToTensor(), u8, tgt)
    for dtype in (np.float32, np.float16, np.float64):
        both(lambda m: m.ConvertImageDtype(dtype), u8, tgt)
        both(lambda m: m.ConvertImageDtype(dtype), img, tgt)


def test_compose_with_the_new_transforms_equals_jax():
    img, tgt = sample()

    def pipe(m):
        return m.Compose([m.RandomShortestSize(min_size=(40, 56),
                                               max_size=90),
                          m.RandomHorizontalFlip(), m.ScaleJitter(
                              target_size=(64, 64), scale_range=(0.5, 1.5)),
                          m.FixedSizeCrop(size=(48, 48))])

    for seed in range(4):
        both(pipe, img, tgt, seed=seed, tol=RESIZE_TOL)


def test_resize_antialiased_is_jax_bilinear():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    for h, w, nh, nw in [(40, 56, 13, 19), (40, 56, 80, 112), (37, 23, 51,
                                                                 17),
                         (50, 70, 7, 9), (64, 48, 64, 48)]:
        im = rng.random((h, w, 3)).astype(np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(im), (nh, nw, 3),
                                           "bilinear"))
        got = ttf.resize_antialiased(im, nh, nw)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)
