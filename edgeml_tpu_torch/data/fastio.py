"""ctypes binding of the repository's native text-file reader
(``native/fastio.cpp``), read in place.

The library is compiled with ``g++`` at first use into
``edgeml_tpu_torch/_build/`` (never into ``native/``), under a name keyed on
a hash of the source and the flags. It parses into float32, as the JAX
package's reader does; that rounding decides the confidence order of the
detection pool and DCSB's strict ``conf > 0.5``, so the port parses through
the same reader and a failed build raises instead of switching every file
to a float64 parse. A file the parser rejects (missing, malformed, too many
rows) comes back as None, and the caller parses that one in Python, as the
JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.normpath(os.path.join(_HERE, "..", "..", "native", "fastio.cpp"))
BUILD_DIR = os.path.normpath(os.path.join(_HERE, "..", "_build"))
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def library_path(src: str | None = None, stem: str = "libfastio") -> str:
    """Where the library of ``src`` (default: ``fastio.cpp``) and the flags
    is built."""
    src = src or SRC
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build_native(src: str, stem: str) -> ctypes.CDLL:
    """Compile ``src`` with g++ into ``_build/`` (once per source and flags)
    and load it; raises with g++'s stderr on a failed build."""
    so = library_path(src, stem)
    if not os.path.isfile(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        res = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, src, "-lpthread"],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src}:\n{res.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def _load() -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on a failed build."""
    global _lib
    with _lock:
        if _lib is None:
            lib = build_native(SRC, "libfastio")
            lib.fastio_load_boxes.argtypes = [
                ctypes.c_char_p,  # NUL-separated paths
                ctypes.c_long,  # files
                ctypes.c_long,  # columns
                ctypes.c_long,  # rows per file
                ctypes.POINTER(ctypes.c_float),  # out (files, rows, cols)
                ctypes.POINTER(ctypes.c_long),  # rows read, -1 if rejected
                ctypes.c_int,  # threads (0: the hardware's)
            ]
            lib.fastio_load_boxes.restype = ctypes.c_int
            _lib = lib
        return _lib


def load_txt_boxes(paths, cols: int, max_rows: int = 1024,
                   n_threads: int = 0):
    """Parse many ``cls x y w h [conf]`` text files at once.

    :return: a list of (rows_i, cols) float32 arrays, with None for each
        file the parser rejected (missing, malformed, more than
        ``max_rows`` rows): the caller parses those in Python.
    """
    if not paths:
        return []
    lib = _load()
    blob = b"\0".join(p.encode() for p in paths) + b"\0"
    n = len(paths)
    out = np.zeros((n, max_rows, cols), np.float32)
    rows = np.zeros((n,), np.int64)
    rc = lib.fastio_load_boxes(
        blob, n, cols, max_rows,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n_threads)
    if rc != 0:
        raise RuntimeError(f"fastio_load_boxes failed with code {rc}")
    return [None if rows[i] < 0 else out[i, :rows[i]].copy()
            for i in range(n)]
