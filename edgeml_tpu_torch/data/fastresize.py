"""ctypes binding of the repository's native banded-tap resampler
(``native/resize.cpp``), read in place.

Built with ``g++`` at first use into ``edgeml_tpu_torch/_build/`` by the same
recipe and flags as ``fastio`` (never into ``native/``). The JAX package
evaluates its resize taps through this library, and so does the port's
``loader.resize_bilinear`` (YOLO augmentation, the train CLI): with the same
taps (``loader._linear_taps``) and the same machine code its pixels are
bit-equal to the JAX package's. The port's letterbox and square resize go
through ``fastprep`` instead, the same arithmetic in one pass. A failed build
or a nonzero return raises; nothing falls back to the NumPy evaluation.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import fastio

SRC = os.path.normpath(os.path.join(os.path.dirname(fastio.SRC), "resize.cpp"))

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on a failed build."""
    global _lib
    with _lock:
        if _lib is None:
            lib = fastio.build_native(SRC, "libresize")
            lib.resize_bilinear_f32.restype = ctypes.c_int
            lib.resize_bilinear_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # img (h, w, c)
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # h, w, c
                ctypes.POINTER(ctypes.c_float),  # out (oh, ow, c)
                ctypes.c_int64, ctypes.c_int64,  # oh, ow
                ctypes.POINTER(ctypes.c_int32),  # jh (oh, span_h)
                ctypes.POINTER(ctypes.c_float),  # wh (oh, span_h)
                ctypes.c_int,  # span_h
                ctypes.POINTER(ctypes.c_int32),  # jw (ow, span_w)
                ctypes.POINTER(ctypes.c_float),  # ww (ow, span_w)
                ctypes.c_int,  # span_w
                ctypes.POINTER(ctypes.c_float),  # scratch (oh, w, c)
                ctypes.c_int,  # threads (0: the hardware's, at most 8)
            ]
            _lib = lib
        return _lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def native_resize(img: np.ndarray, out_h: int, out_w: int, jh: np.ndarray,
                  wh: np.ndarray, jw: np.ndarray, ww: np.ndarray
                  ) -> np.ndarray:
    """Evaluate the banded taps (rows ``jh``/``wh``, columns ``jw``/``ww``)
    on an (H, W, C) image: the (out_h, out_w, C) float32 result. Raises on a
    failed build or a nonzero return."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    jh32 = np.ascontiguousarray(jh, np.int32)
    jw32 = np.ascontiguousarray(jw, np.int32)
    wh32 = np.ascontiguousarray(wh, np.float32)
    ww32 = np.ascontiguousarray(ww, np.float32)
    if jh32.shape != wh32.shape or jw32.shape != ww32.shape or \
            jh32.shape[0] != out_h or jw32.shape[0] != out_w:
        raise ValueError(
            f"native_resize: taps {jh32.shape}/{wh32.shape} and "
            f"{jw32.shape}/{ww32.shape} do not fit ({out_h}, {out_w})")
    out = np.empty((out_h, out_w, c), np.float32)
    scratch = np.empty((out_h, w, c), np.float32)
    rc = lib.resize_bilinear_f32(
        _fptr(img), h, w, c, _fptr(out), out_h, out_w,
        _iptr(jh32), _fptr(wh32), wh32.shape[1],
        _iptr(jw32), _fptr(ww32), ww32.shape[1], _fptr(scratch), 0)
    if rc != 0:
        raise RuntimeError(f"resize_bilinear_f32 failed with code {rc} on "
                           f"{img.shape} -> ({out_h}, {out_w})")
    return out
