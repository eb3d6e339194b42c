"""Per-sample SGD regression fit: a CUDA kernel for Hopper and its plain
version.

    for s in 0 .. E*N - 1:  i = order[s]
        err = x[i] . w + b - y[i]
        w -= eta[s] * (err * x[i] + alpha * w);   b -= eta[s] * err

with eta[s] = eta0 / t^power_t, t = s + 1, as f32 (the JAX package's
``estimators/linear.py _sgd_fit``). The order is E per-epoch permutations
given as input (``sgd_orders`` draws the port's own from a seed; the tests
replay JAX's). The step sizes are one f32 table made on the host
(``sgd_eta``) and read by both versions.

``sgd_fit`` is the entry point. For a CUDA tensor it launches
``csrc/sgd_scan.cu`` (``sgd_fit_cuda``, one warp for the whole chain), or
raises; it takes the plain version ``sgd_fit_plain`` (the same steps as
torch ops, some ten launches a step) only for a tensor on the CPU. The two
differ only in the summation order of each step's dot.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

MAX_F = 1024
_lib = None
_launch = None


def _load():
    """The launch function of ``csrc/sgd_scan.cu``, built and bound at first
    use."""
    global _lib, _launch
    if _launch is None:
        from .. import _build

        lib = _build.load_library("sgd_scan")
        fn = lib.sgd_scan_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # x (n, f) f32
            ctypes.c_void_p,  # y (n,) f32
            ctypes.c_void_p,  # order (steps,) int32
            ctypes.c_void_p,  # eta (steps,) f32
            ctypes.c_longlong,  # steps
            ctypes.c_int,  # f
            ctypes.c_float,  # alpha
            ctypes.c_void_p,  # out (f + 1,) f32: w then b
            ctypes.c_void_p,  # cudaStream_t
        ]
        lib.sgd_scan_error_string.restype = ctypes.c_char_p
        lib.sgd_scan_error_string.argtypes = [ctypes.c_int]
        _lib, _launch = lib, fn
    return _launch


def sgd_orders(seed: int, n: int, epochs: int) -> np.ndarray:
    """The port's per-epoch sample orders: (epochs, n) int32, epoch e a
    ``torch.randperm`` from one CPU generator seeded with ``seed`` (the JAX
    package draws ``jax.random.permutation``, which torch cannot
    reproduce)."""
    g = torch.Generator().manual_seed(seed)
    if epochs == 0:
        return np.zeros((0, n), np.int32)
    return torch.stack([torch.randperm(n, generator=g)
                        for _ in range(epochs)]).to(torch.int32).numpy()


def sgd_eta(eta0: float, power_t: float, steps: int) -> np.ndarray:
    """Step sizes eta0 / t^power_t for t = 1 .. steps, in f32."""
    t = np.arange(1, steps + 1, dtype=np.float32)
    return (np.float32(eta0) / np.power(t, np.float32(power_t))).astype(
        np.float32)


def _check(x, y, order, eta):
    if x.dim() != 2 or y.shape != (x.shape[0],) or order.dim() != 1 or \
            eta.shape != order.shape:
        raise ValueError(
            f"sgd_fit: want x (N, F), y (N,), order (S,), eta (S,); got "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(order.shape)}, "
            f"{tuple(eta.shape)}")
    if x.dtype != torch.float32 or y.dtype != torch.float32 or \
            eta.dtype != torch.float32 or order.dtype != torch.int32:
        raise TypeError(
            f"sgd_fit: want f32 x, y, eta and int32 order; got {x.dtype}, "
            f"{y.dtype}, {eta.dtype}, {order.dtype}")


def sgd_fit_plain(x: torch.Tensor, y: torch.Tensor, order: torch.Tensor,
                  eta: torch.Tensor, alpha: float):
    """The chain of steps as plain torch ops on x's device. Arguments and
    result as ``sgd_fit``."""
    _check(x, y, order, eta)
    w = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    b = torch.zeros((), dtype=x.dtype, device=x.device)
    for i, e in zip(order.tolist(), eta.tolist()):
        xi = x[i]
        err = torch.dot(xi, w) + b - y[i]
        w = w - e * (err * xi + alpha * w)
        b = b - e * err
    return w, b


def sgd_fit_cuda(x: torch.Tensor, y: torch.Tensor, order: torch.Tensor,
                 eta: torch.Tensor, alpha: float):
    """Launch the kernel (``csrc/sgd_scan.cu``) on the current stream. All
    tensors on one CUDA device (made contiguous here if they are not), F <=
    1024. Raises on anything else and on a refused launch. Counts its
    launches in ``sgd_fit_cuda.launches``."""
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in (y, order, eta)):
        raise ValueError(
            "sgd_fit_cuda: tensors must share one CUDA device (got "
            + ", ".join(str(t.device) for t in (x, y, order, eta)) + ")")
    _check(x, y, order, eta)
    n, f = x.shape
    if not 1 <= f <= MAX_F:
        raise ValueError(f"sgd_fit_cuda: F = {f} outside [1, {MAX_F}]")
    if order.numel() and n == 0:
        raise ValueError("sgd_fit_cuda: steps over an empty sample set")
    x, y, order, eta = (t.contiguous() for t in (x, y, order, eta))
    out = torch.empty(f + 1, dtype=torch.float32, device=dev)
    launch = _launch or _load()
    args = (x.data_ptr(), y.data_ptr(), order.data_ptr(), eta.data_ptr(),
            order.numel(), f, float(alpha), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        rc = launch(*args)
    else:
        with torch.cuda.device(dev):
            rc = launch(*args)
    if rc != 0:
        msg = _lib.sgd_scan_error_string(rc).decode()
        raise RuntimeError(
            f"sgd_scan kernel launch failed: CUDA error {rc} ({msg})")
    sgd_fit_cuda.launches += 1
    return out[:f], out[f]


sgd_fit_cuda.launches = 0


def sgd_fit(x: torch.Tensor, y: torch.Tensor, orders: np.ndarray,
            alpha: float, eta0: float, power_t: float):
    """Fit w (F,) and b () by per-sample SGD over ``orders``.

    :param x: (N, F) f32 features; ``y`` (N,) f32 targets, on one device.
    :param orders: (E, N) int sample orders, one row an epoch, each entry in
        [0, N).
    :return: (w, b) f32 tensors on x's device: the CUDA kernel for CUDA
        tensors, the plain version for CPU tensors.
    """
    orders = np.asarray(orders)
    if orders.size and (orders.min() < 0 or orders.max() >= x.shape[0]):
        raise ValueError("sgd_fit: an order entry lies outside [0, N)")
    flat = torch.from_numpy(orders.reshape(-1).astype(np.int32)).to(x.device)
    eta = torch.from_numpy(sgd_eta(eta0, power_t, flat.numel())).to(x.device)
    if x.device.type == "cpu":
        return sgd_fit_plain(x, y, flat, eta, alpha)
    if x.device.type != "cuda":
        raise ValueError(f"sgd_fit: unsupported device {x.device}")
    return sgd_fit_cuda(x, y, flat, eta, alpha)
