"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface, loaded with ``ctypes``. The output goes to
``edgeml_tpu_torch/_build/`` under a name keyed on a hash of every source in
``csrc/`` and of the flags, so an edited source rebuilds and an unchanged one
loads at once. Several sources build in parallel (one ``nvcc`` each, all
started together). A failed build raises with nvcc's stderr; nothing falls
back to another implementation.

nvcc is taken from ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``) or the
``PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# -fmad=false: no multiply-add contraction, so f32 arithmetic rounds op by
# op as in the plain versions. No --use_fast_math: division stays IEEE.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
        "kernels of edgeml_tpu_torch are built from source at first use")


def _sources_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(fn.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _library_path(name: str, key: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{key}.so")


def build(names) -> None:
    """Compile the named sources that are not built yet, in parallel."""
    key = _sources_key()
    todo = [n for n in names if not os.path.isfile(_library_path(n, key))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for n in todo:
        src = os.path.join(CSRC, n + ".cu")
        tmp = _library_path(n, key) + f".tmp{os.getpid()}"
        p = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
        procs.append((n, src, tmp, p))
    errors = []
    for n, src, tmp, p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed to build {src}:\n{err}")
        else:
            os.replace(tmp, _library_path(n, key))
    if errors:
        raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built if needed)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_library_path(name, _sources_key()))
            _libs[name] = lib
        return lib
