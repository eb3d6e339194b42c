"""ctypes binding of the repository's native fused HSV jitter
(``native/aug.cpp``), read in place.

Built with ``g++`` at first use into ``edgeml_tpu_torch/_build/`` by the
same recipe and flags as ``fastio``. The JAX package evaluates the host
HSV jitter of its YOLO augmentation through this library, so the port
does too and its pixels are bit-equal to the JAX package's. A failed build
or a nonzero return raises; nothing falls back to the NumPy expression,
which ``yolo_aug.hsv_jitter_numpy`` keeps as the tests' oracle.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import fastio

SRC = os.path.normpath(os.path.join(os.path.dirname(fastio.SRC), "aug.cpp"))

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on a failed build."""
    global _lib
    with _lock:
        if _lib is None:
            lib = fastio.build_native(SRC, "libaug")
            lib.hsv_jitter_f32.restype = ctypes.c_int
            lib.hsv_jitter_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # img
                ctypes.c_int64,  # pixels
                ctypes.c_double, ctypes.c_double, ctypes.c_double,  # gains
                ctypes.POINTER(ctypes.c_float),  # out
                ctypes.c_int,  # threads (0: the hardware's, at most 8)
            ]
            _lib = lib
        return _lib


def native_hsv_jitter(img: np.ndarray, rh: float, rs: float,
                      rv: float) -> np.ndarray:
    """The fused HSV jitter of an (..., 3) RGB image in [0, 1] with gains
    (rh, rs, rv): a new float32 array. Raises on a failed build or a
    nonzero return."""
    if img.ndim < 1 or img.shape[-1] != 3:
        raise ValueError(f"native_hsv_jitter: want (..., 3) RGB, got "
                         f"{img.shape}")
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    out = np.empty_like(img)
    rc = lib.hsv_jitter_f32(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), img.size // 3,
        float(rh), float(rs), float(rv),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 0)
    if rc != 0:
        raise RuntimeError(f"hsv_jitter_f32 failed with code {rc}")
    return out
