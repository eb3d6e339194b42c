"""Streaming image-batch pipeline (host side).

Images decode one by one on background threads, and each batch is then
prepared (letterboxed or resized) on one of them, prefetched so the host
prepares the next batches while the device runs the current one. Peak host
memory is bounded by (prefetch + 1) batches of decoded images.

Resizing computes banded bilinear taps with the semantics of the reference
package's resize (half-pixel centres, triangle kernel widened to 1/scale
when downscaling, out-of-range taps dropped and rows renormalised) and
evaluates them through the repository's native resampler
(``native/resize.cpp``, bound by ``fastresize``), as the JAX package does:
the same taps through the same library, so the pixels are bit-equal to its.
``eval_taps_numpy`` evaluates the same taps in NumPy, in another summation
order (within 2e-6); the tests and the smoke run use it as the reference,
serving never calls it.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np

from ..utils.profiling import span


def list_images(img_dir: str):
    """Sorted image file names — every regular file in the directory. No
    extension filter: a file that cannot be decoded raises rather than being
    skipped, so the per-image output files never have holes."""
    return sorted(
        n for n in os.listdir(img_dir)
        if os.path.isfile(os.path.join(img_dir, n))
    )


def decode_image(path: str) -> np.ndarray:
    """One image file -> HWC float32 in [0, 1]. ``.npy`` arrays with values
    above 1.5 are taken as 0..255 pixels."""
    if path.lower().endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        return arr
    from PIL import Image

    im = Image.open(path)
    arr = np.asarray(im if im.mode == "RGB" else im.convert("RGB"), np.float32)
    arr /= 255.0
    return arr


@lru_cache(maxsize=16)
def _linear_taps(in_size: int, out_size: int, antialias: bool = True):
    """Banded resampling taps (idx (out, span) int, w (out, span) f32):
    half-pixel centres, triangle kernel widened to 1/scale when downscaling
    (``antialias``; without it the kernel keeps width 1), out-of-range taps
    dropped and rows renormalised.

    The kernel has finite support (span = ceil(2*max(1, 1/scale)) + 2), so
    the resampling matrix is banded and evaluating it as gathered taps costs
    O(out*span) per line instead of O(out*in). The cache is small on purpose:
    a large dataset has hundreds of distinct (in, out) pairs and the taps are
    cheap to recompute."""
    scale = out_size / in_size
    x = np.arange(out_size, dtype=np.float64)
    u = (x + 0.5) / scale - 0.5
    s = max(1.0, 1.0 / scale) if antialias else 1.0
    lo = np.floor(u - s).astype(int)
    span = int(np.ceil(2 * s)) + 2
    j = lo[:, None] + np.arange(span)[None, :]
    w = np.clip(1.0 - np.abs((j - u[:, None]) / s), 0.0, None)
    w = np.where((j >= 0) & (j < in_size), w, 0.0)
    w = w / np.maximum(w.sum(1, keepdims=True), 1e-12)
    # out-of-range taps carry zero weight, so clipping their index is safe
    return np.clip(j, 0, in_size - 1), w.astype(np.float32)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Host NumPy bilinear image resize (see _linear_taps)."""
    if (out_h, out_w) == img.shape[:2]:
        # scale-1 taps are the identity (half-pixel centres, the s=1
        # triangle peaks exactly on the source pixel)
        return np.array(img, dtype=np.float32, order="C", copy=True)
    return _eval_taps(img, out_h, out_w,
                      _linear_taps(img.shape[0], out_h),
                      _linear_taps(img.shape[1], out_w))


def resize_bilinear_window(img: np.ndarray, out_h: int, out_w: int,
                           y0: int, y1: int, x0: int, x1: int) -> np.ndarray:
    """The [y0:y1, x0:x1] window of ``resize_bilinear(img, out_h, out_w)``,
    computed directly: each output row and column depends only on its own
    taps, so the sliced tap tables give the very same pixels for the
    window's share of the work (mosaic pastes only the visible part of each
    quadrant)."""
    if (out_h, out_w) == img.shape[:2]:  # identity taps (resize_bilinear)
        return np.array(img[y0:y1, x0:x1], dtype=np.float32, order="C",
                        copy=True)
    jh, wh = _linear_taps(img.shape[0], out_h)
    jw, ww = _linear_taps(img.shape[1], out_w)
    return _eval_taps(img, y1 - y0, x1 - x0,
                      (jh[y0:y1], wh[y0:y1]), (jw[x0:x1], ww[x0:x1]))


def _eval_taps(img, out_h, out_w, row_taps, col_taps):
    """Evaluate banded resampling taps with the native resampler (raises if
    it cannot be built)."""
    from .fastresize import native_resize

    return native_resize(img, out_h, out_w, *row_taps, *col_taps)


def eval_taps_numpy(img, out_h, out_w, row_taps, col_taps):
    """Evaluate banded resampling taps by per-tap NumPy accumulation: the
    same weights as ``_eval_taps`` in another summation order."""
    jh, wh = row_taps
    jw, ww = col_taps
    img = np.ascontiguousarray(img, np.float32)
    # rows first when downscaling height (shrink the data before the column
    # pass); per-tap accumulation keeps temporaries at one (.., C) plane
    if out_h <= img.shape[0]:
        tmp = wh[:, 0, None, None] * img[jh[:, 0]]
        for t in range(1, wh.shape[1]):
            tmp += wh[:, t, None, None] * img[jh[:, t]]
        out = ww[:, 0, None] * tmp[:, jw[:, 0]]
        for t in range(1, ww.shape[1]):
            out += ww[:, t, None] * tmp[:, jw[:, t]]
    else:
        tmp = ww[:, 0, None] * img[:, jw[:, 0]]
        for t in range(1, ww.shape[1]):
            tmp += ww[:, t, None] * img[:, jw[:, t]]
        out = wh[:, 0, None, None] * tmp[jh[:, 0]]
        for t in range(1, wh.shape[1]):
            out += wh[:, t, None, None] * tmp[jh[:, t]]
    return out


def iter_batches(
    img_dir: str,
    names: list,
    batch_size: int,
    make_batch,
    order=None,
    prefetch: int = 2,
    workers: int = 4,
    drop_last: bool = False,
):
    """Yield make_batch([(name, decoded_image), ...]) per batch, prefetched.

    Each image decodes as a task of its own, so the workers share every
    batch's decodes, the first batch's too; the batch's ``make_batch`` then
    runs on one worker.

    :param names: image file names (relative to img_dir).
    :param make_batch: host preprocess: list of (name, HWC float image) ->
        arbitrary batch payload. Runs in a worker thread.
    :param order: optional index permutation (an epoch's shuffle); names
        in order when None.
    :param prefetch: batches prepared ahead of the consumer.
    :param drop_last: skip a trailing partial batch (training) or keep it
        (inference).
    """
    idx = np.arange(len(names)) if order is None else np.asarray(order)
    chunks = [
        idx[s : s + batch_size] for s in range(0, len(idx), batch_size)
    ]
    if drop_last and chunks and len(chunks[-1]) < batch_size:
        chunks.pop()

    def decode(i):
        with span("load.decode"):
            return names[i], decode_image(os.path.join(img_dir, names[i]))

    def build(decodes):
        # the pool takes tasks in the order they were queued, and a batch's
        # decodes were queued before it: each is done or running on another
        # worker, so this wait cannot deadlock
        items = [d.result() for d in decodes]
        with span("load.batch"):
            return make_batch(items)

    with ThreadPoolExecutor(max_workers=workers) as pool:

        def submit(chunk):
            return pool.submit(build, [pool.submit(decode, i) for i in chunk])

        window: deque = deque(submit(chunk) for chunk in chunks[: prefetch + 1])
        next_submit = prefetch + 1
        while window:
            yield window.popleft().result()
            if next_submit < len(chunks):
                window.append(submit(chunks[next_submit]))
                next_submit += 1
