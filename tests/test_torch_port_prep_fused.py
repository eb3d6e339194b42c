"""The one-pass frame prep (``data/fastprep.py``) against the two-step
composition it replaced, on the CPU: ``resize_bilinear`` (the native
resampler) per image, then the NumPy normalisation (``square_batch``) or the
copy into a gray-filled slot (``letterbox_batch``). The arithmetic is the
same element for element, so every case is compared bit for bit (as
uint32, so that a signed zero counts too): ragged batches of COCO's shapes,
1-pixel and odd sizes, downscales whose taps span 7-11 pixels, upscales,
inputs that are views, other dtypes or one channel, and four threads calling
at once. The counters say which images were resampled and which copied.
"""

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from edgeml_tpu_torch.data import fastprep, loader
from edgeml_tpu_torch.models.common import PAD_VALUE, letterbox_batch
from edgeml_tpu_torch.models.infer import IMAGENET_MEAN, IMAGENET_STD, \
    square_batch

torch.set_num_threads(1)

COCO = [(480, 640), (640, 427), (640, 640), (500, 375)]
ODD = [(1, 1), (1, 7), (7, 1), (3, 5), (17, 13), (2, 11)]
DOWN = [(100, 90), (130, 211), (301, 77)]  # to 40 or below: spans 7-11
UP = [(20, 30), (9, 4), (33, 33)]


def images(seed, shapes, signed=False):
    rng = np.random.default_rng(seed)
    if signed:  # values of both signs: zero-weight taps give signed zeros
        return [rng.standard_normal((h, w, 3)).astype(np.float32) * 4
                for h, w in shapes]
    return [rng.random((h, w, 3), dtype=np.float32) for h, w in shapes]


def two_step_square(imgs, size):
    rs = np.stack([loader.resize_bilinear(np.asarray(im, np.float32), size,
                                          size) for im in imgs])
    return (rs - IMAGENET_MEAN) / IMAGENET_STD


def two_step_letterbox(imgs, size):
    out = np.full((len(imgs), size, size, 3), PAD_VALUE, np.float32)
    meta = np.zeros((len(imgs), 3), np.float32)
    for i, img in enumerate(imgs):
        h, w = img.shape[:2]
        r = min(size / h, size / w)
        nh, nw = int(round(h * r)), int(round(w * r))
        resized = loader.resize_bilinear(np.asarray(img, np.float32), nh, nw)
        dh, dw = (size - nh) // 2, (size - nw) // 2
        out[i, dh:dh + nh, dw:dw + nw] = resized
        meta[i] = (r, dw, dh)
    return out, meta


def assert_bits(got, want):
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def check_square(imgs, size):
    assert_bits(square_batch(imgs, size), two_step_square(imgs, size))


def check_letterbox(imgs, size):
    got, meta = letterbox_batch(imgs, size)
    want, wmeta = two_step_letterbox(imgs, size)
    assert_bits(got, want)
    np.testing.assert_array_equal(meta, wmeta)


def placed(hw, size):
    """(nh, nw) of an image of shape ``hw`` in a ``size`` letterbox."""
    h, w = hw
    r = min(size / h, size / w)
    return int(round(h * r)), int(round(w * r))


@pytest.mark.parametrize("size", [640, 320, 257])
def test_coco_shapes_ragged_batch(size):
    imgs = images(size, COCO + COCO[::-1])
    check_square(imgs, size)
    check_letterbox(imgs, size)


@pytest.mark.parametrize("size", [1, 5, 33])
def test_one_pixel_and_odd_sizes(size):
    imgs = images(size + 100, ODD, signed=True)
    check_square(imgs, size)
    # in a small letterbox a long thin image's short side rounds to 0 rows,
    # which both paths refuse (test_zero_rows_raise)
    check_letterbox([im for im in imgs
                     if min(placed(im.shape[:2], size)) > 0], size)


def test_zero_rows_raise():
    img = images(12, [(2, 64)])
    for prep in (letterbox_batch, two_step_letterbox):
        with pytest.raises(ZeroDivisionError):
            prep(img, 5)


@pytest.mark.parametrize("size", [40, 23])
def test_downscale_wide_taps(size):
    imgs = images(size + 200, DOWN, signed=True)
    spans = [loader._linear_taps(n, size)[1].shape[1]
             for h, w in DOWN for n in (h, w)]
    assert max(spans) >= 7
    check_square(imgs, size)
    check_letterbox(imgs, size)


@pytest.mark.parametrize("size", [64, 97])
def test_upscale(size):
    imgs = images(size + 300, UP, signed=True)
    check_square(imgs, size)
    check_letterbox(imgs, size)


def test_views_dtypes_and_one_channel():
    base = images(7, [(90, 120)], signed=True)[0]
    rng = np.random.default_rng(8)
    imgs = [base[::2, ::3],  # strided view
            base.transpose(1, 0, 2),  # (W, H, 3) view
            base[..., ::-1],  # channels reversed
            base[10:70, 20:100],  # window
            base.astype(np.float64),
            rng.integers(0, 256, (50, 40, 3), dtype=np.uint8)]
    gray = [base[..., :1]]  # one channel: broadcast into three
    for size in (64, 120):
        check_square(imgs, size)
        check_letterbox(imgs + gray, size)
        check_square(gray, size)


def test_refuses_other_channel_counts():
    for bad in (np.zeros((8, 8), np.float32), np.zeros((8, 8, 4), np.float32)):
        with pytest.raises(ValueError):
            square_batch([bad], 16)
        with pytest.raises(ValueError):
            letterbox_batch([bad], 16)


def test_nonzero_return_raises():
    """A window that does not fit its slot is refused by the library."""
    img = images(9, [(10, 10)])
    with pytest.raises(RuntimeError, match="failed with code 2"):
        fastprep.letterbox(img, 16, [(10, 10, 8, 0)], PAD_VALUE)


def test_empty_letterbox_batch():
    lb, meta = letterbox_batch([], 32)
    assert lb.shape == (0, 32, 32, 3) and meta.shape == (0, 3)


def test_counters_follow_the_shapes():
    """COCO's four shapes at 640: the letterbox copies three (their longer
    side is 640) and resamples 500x375; the square resize copies 640x640
    and resamples the other three."""
    imgs = images(11, COCO)
    r0, c0 = fastprep.resampled, fastprep.copied
    letterbox_batch(imgs, 640)
    assert (fastprep.resampled - r0, fastprep.copied - c0) == (1, 3)
    square_batch(imgs, 640)
    assert (fastprep.resampled - r0, fastprep.copied - c0) == (4, 4)
    square_batch(imgs[:1], 320)
    assert (fastprep.resampled - r0, fastprep.copied - c0) == (5, 4)


def test_four_threads_at_once():
    """Four threads (more than this test's one torch thread, each call
    with its own native threads) prepare different batches at once, three
    each: every array bit-equal to the two-step composition, and no count
    lost."""
    jobs = [[(images(20 + 4 * k + j, COCO[k:] + UP[:k], signed=bool(j % 2)),
              96 + k) for j in range(3)] for k in range(4)]
    flat = [job for mine in jobs for job in mine]
    want = [(two_step_square(im, s), two_step_letterbox(im, s)[0])
            for im, s in flat]
    shapes = [(x.shape[:2], s) for im, s in flat for x in im]
    n_copied = sum(hw == (s, s) for hw, s in shapes) + \
        sum(placed(hw, s) == hw for hw, s in shapes)
    start = threading.Barrier(4)

    def run(mine):
        start.wait(timeout=60)
        return [(square_batch(im, s), letterbox_batch(im, s)[0])
                for im, s in mine]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        r0, c0 = fastprep.resampled, fastprep.copied
        with ThreadPoolExecutor(4) as pool:
            done = [f.result(timeout=120)
                    for f in [pool.submit(run, mine) for mine in jobs]]
    finally:
        sys.setswitchinterval(old)
    got = [pair for mine in done for pair in mine]
    assert len(got) == len(want) == 12
    for (gs, gl), (ws, wl) in zip(got, want):
        assert_bits(gs, ws)
        assert_bits(gl, wl)
    assert fastprep.copied - c0 == n_copied
    assert fastprep.resampled - r0 == 2 * len(shapes) - n_copied


def test_many_callers_share_the_helper_threads():
    """Eight threads, forty small calls each (64 rows or more, so each call
    wants the library's helper threads; a call that finds them busy runs
    alone): no call hangs, every array is bit-equal, no count is lost."""
    imgs = images(30, [(70, 50), (33, 90), (64, 64)])
    want = two_step_square(imgs, 64), two_step_letterbox(imgs, 64)[0]
    start = threading.Barrier(8)

    def run(_):
        start.wait(timeout=60)
        return [(square_batch(imgs, 64), letterbox_batch(imgs, 64)[0])
                for _ in range(40)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        r0, c0 = fastprep.resampled, fastprep.copied
        with ThreadPoolExecutor(8) as pool:
            done = [f.result(timeout=120)
                    for f in [pool.submit(run, k) for k in range(8)]]
    finally:
        sys.setswitchinterval(old)
    for mine in done:
        for sq, lb in mine:
            assert_bits(sq, want[0])
            assert_bits(lb, want[1])
    # per call: 64x64 copied by both; 70x50 and 33x90 resampled by both
    assert fastprep.copied - c0 == 8 * 40 * 2
    assert fastprep.resampled - r0 == 8 * 40 * 4


@pytest.mark.parametrize("kind", ["square", "letterbox"])
def test_writes_into_a_given_array(kind):
    """``out``: the batch is written into the given array (a torch tensor's
    memory, as the serving loop's pinned batches are), bit-equal to a new
    one; an array of another shape, dtype or layout is refused."""
    imgs = images(13, COCO)
    t = torch.full((4, 64, 64, 3), float("nan"))
    if kind == "square":
        got = square_batch(imgs, 64, out=t.numpy())
        assert_bits(t.numpy(), square_batch(imgs, 64))
    else:
        got, meta = letterbox_batch(imgs, 64, out=t.numpy())
        want, wmeta = letterbox_batch(imgs, 64)
        assert_bits(t.numpy(), want)
        np.testing.assert_array_equal(meta, wmeta)
    assert np.shares_memory(got, t.numpy())
    bad = [np.empty((3, 64, 64, 3), np.float32),
           np.empty((4, 64, 64, 3), np.float64),
           np.empty((4, 64, 3, 64), np.float32).transpose(0, 1, 3, 2)]
    for out in bad:
        with pytest.raises(ValueError, match="out must be"):
            if kind == "square":
                fastprep.square(imgs, 64, IMAGENET_MEAN, IMAGENET_STD, out=out)
            else:
                fastprep.letterbox(imgs, 64, [placed(im.shape[:2], 64) + (0, 0)
                                              for im in imgs], PAD_VALUE,
                                   out=out)
