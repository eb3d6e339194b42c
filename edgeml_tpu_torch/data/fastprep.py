"""ctypes binding of the port's one-pass frame prep (``fastprep.cpp``).

``square`` and ``letterbox`` write each image of a batch straight into its
slot of the returned (B, size, size, 3) float32 array: resampled with the
taps of ``loader._linear_taps`` (copied where the image already has its
resampled size), then normalised per channel (``square``) or framed by the
pad value (``letterbox``). The arithmetic is ``native/resize.cpp``'s element
for element, so the arrays are bit-equal to ``resize_bilinear`` followed by
the NumPy normalisation or the padded slot copy.

Built with ``g++`` at first use into ``edgeml_tpu_torch/_build/`` by the
same recipe and flags as ``fastio``. A failed build or a nonzero return
raises; nothing falls back to the two-step NumPy path.

Counters: ``resampled`` and ``copied``, the images that the calls since
import resampled and copied (at scale 1).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import fastio
from .loader import _linear_taps

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "fastprep.cpp")

_lock = threading.Lock()
_lib = None

resampled = 0
copied = 0


class _Image(ctypes.Structure):
    """``PrepImage`` of ``fastprep.cpp``."""

    _fields_ = [
        ("img", ctypes.c_void_p),
        ("h", ctypes.c_int64), ("w", ctypes.c_int64),
        ("nh", ctypes.c_int64), ("nw", ctypes.c_int64),
        ("dh", ctypes.c_int64), ("dw", ctypes.c_int64),
        ("jh", ctypes.c_void_p), ("wh", ctypes.c_void_p),
        ("span_h", ctypes.c_int64),
        ("jw", ctypes.c_void_p), ("ww", ctypes.c_void_p),
        ("span_w", ctypes.c_int64),
    ]


def _load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on a failed build."""
    global _lib
    with _lock:
        if _lib is None:
            lib = fastio.build_native(SRC, "libfastprep")
            lib.fastprep_square.restype = ctypes.c_int
            lib.fastprep_square.argtypes = [
                ctypes.POINTER(_Image), ctypes.c_int64,  # images, count
                ctypes.c_void_p, ctypes.c_int64,  # out (n, size, size, 3)
                ctypes.c_void_p, ctypes.c_void_p,  # mean (3), std (3)
            ]
            lib.fastprep_letterbox.restype = ctypes.c_int
            lib.fastprep_letterbox.argtypes = [
                ctypes.POINTER(_Image), ctypes.c_int64,  # images, count
                ctypes.c_void_p, ctypes.c_int64,  # out (n, size, size, 3)
                ctypes.c_float,  # pad
            ]
            _lib = lib
        return _lib


def _rgb(im) -> np.ndarray:
    """An (H, W, 3) or (H, W, 1) image as contiguous (H, W, 3) float32 (one
    channel repeated, as broadcasting it into the batch does)."""
    img = np.asarray(im, np.float32)
    if img.ndim != 3 or img.shape[2] not in (1, 3):
        raise ValueError(f"expected an (H, W, 3) or (H, W, 1) image, got "
                         f"{img.shape}")
    if img.shape[2] == 1:
        img = np.broadcast_to(img, img.shape[:2] + (3,))
    return np.ascontiguousarray(img)


def _describe(images, places):
    """The C descriptors of ``images`` at ``places`` [(nh, nw, dh, dw)], the
    arrays they point into (to keep alive over the call) and the number of
    images copied."""
    descs = (_Image * len(images))()
    keep = []
    n_copied = 0
    for d, im, (nh, nw, dh, dw) in zip(descs, images, places):
        img = _rgb(im)
        h, w = img.shape[:2]
        keep.append(img)
        d.img, d.h, d.w = img.ctypes.data, h, w
        d.nh, d.nw, d.dh, d.dw = nh, nw, dh, dw
        if (nh, nw) == (h, w):
            n_copied += 1
            continue
        (jh, wh), (jw, ww) = _linear_taps(h, nh), _linear_taps(w, nw)
        jh, jw = (np.ascontiguousarray(j, np.int32) for j in (jh, jw))
        wh, ww = (np.ascontiguousarray(x, np.float32) for x in (wh, ww))
        keep += [jh, wh, jw, ww]
        d.jh, d.wh, d.span_h = jh.ctypes.data, wh.ctypes.data, wh.shape[1]
        d.jw, d.ww, d.span_w = jw.ctypes.data, ww.ctypes.data, ww.shape[1]
    return descs, keep, n_copied


def _finish(rc, what, n, n_copied):
    global resampled, copied
    if rc != 0:
        raise RuntimeError(f"{what} failed with code {rc}")
    with _lock:
        resampled += n - n_copied
        copied += n_copied


def _out(out, n: int, size: int) -> np.ndarray:
    """``out`` checked as the (n, size, size, 3) float32 array of a call,
    or a new one where it is None."""
    if out is None:
        return np.empty((n, size, size, 3), np.float32)
    if (out.shape != (n, size, size, 3) or out.dtype != np.float32
            or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out must be a writeable C-contiguous "
                         f"({n}, {size}, {size}, 3) float32 array, got "
                         f"{out.dtype} {out.shape}")
    return out


def square(images, size: int, mean: np.ndarray, std: np.ndarray,
           out=None) -> np.ndarray:
    """(B, size, size, 3) float32: each image resampled to (size, size),
    then ``(v - mean[c]) / std[c]`` (float32); written into ``out`` where
    it is given (pinned memory, say), else into a new array."""
    if len(images) == 0:
        raise ValueError("square: no images")
    lib = _load()
    descs, keep, n_copied = _describe(images, [(size, size, 0, 0)] *
                                      len(images))
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError(f"square: mean {mean.shape} and std {std.shape} "
                         f"must be (3,)")
    out = _out(out, len(images), size)
    rc = lib.fastprep_square(descs, len(images), out.ctypes.data, size,
                             mean.ctypes.data, std.ctypes.data)
    _finish(rc, "fastprep_square", len(images), n_copied)
    return out


def letterbox(images, size: int, places, pad: float,
              out=None) -> np.ndarray:
    """(B, size, size, 3) float32: image i resampled to (nh, nw) of
    ``places[i] = (nh, nw, dh, dw)`` with its top-left corner at (dh, dw);
    ``pad`` (as float32) everywhere else; written into ``out`` where it is
    given, else into a new array."""
    lib = _load()
    descs, keep, n_copied = _describe(images, places)
    out = _out(out, len(images), size)
    rc = lib.fastprep_letterbox(descs, len(images), out.ctypes.data, size,
                                pad)
    _finish(rc, "fastprep_letterbox", len(images), n_copied)
    return out
