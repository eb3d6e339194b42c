"""Eval BatchNorm and its activation after a conv: a CUDA kernel for Hopper
and its plain version.

    out[:, c] = act(((y[:, c] - m[c]) * rsqrt(v[c] + eps)) * g[c] + b[c])

over (N, C, H, W) ``y`` (contiguous or channels-last), in ``y``'s dtype (f32 or bf16), with the four per-channel
tensors in that dtype too and ``eps`` rounded to it. ``act`` is one of
``ACTIVATIONS``: None, "relu", "relu6", "hardswish" or "silu".

``norm_act`` is the entry point. For a CUDA tensor it launches the kernel of
``csrc/norm_act.cu`` (``norm_act_cuda``), which overwrites ``y`` with the
result, or raises; it takes the plain version ``norm_act_plain`` (the op
sequence, a new tensor) only for a tensor on the CPU. On the card the two
are bit-identical: the kernel rounds where each of the plain ops rounds.
"""

from __future__ import annotations

import ctypes

import torch


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def hardswish(x):
    """x * clip(x + 3, 0, 6) / 6, written out as the reference writes it."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def silu(x):
    return x * torch.sigmoid(x)


ACTIVATIONS = {
    "relu": torch.relu,
    "relu6": relu6,
    "hardswish": hardswish,
    "silu": silu,
    None: lambda x: x,
}
_ACT_CODES = {None: 0, "relu": 1, "relu6": 2, "hardswish": 3, "silu": 4}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_eps_in = {}
_lib = None
_launch = None


def norm_act_plain(y, m, v, g, b, eps: float, act: str | None = None):
    """The norm and activation in plain PyTorch ops: ``v + eps`` with eps
    made a tensor of ``v``'s dtype, ``rsqrt``, then ``(y - m) * inv * g + b``
    over broadcast (C, 1, 1) views, then the activation. Differentiable; a
    new tensor."""
    inv = torch.rsqrt(v + torch.full((), eps, dtype=v.dtype,
                                     device=v.device))
    return ACTIVATIONS[act]((y - m[:, None, None]) * inv[:, None, None]
                            * g[:, None, None] + b[:, None, None])


def _load():
    """The launch function of ``csrc/norm_act.cu``, built and bound at first
    use."""
    global _lib, _launch
    if _launch is None:
        from .. import _build

        lib = _build.load_library("norm_act")
        fn = lib.norm_act_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # y, overwritten
            ctypes.c_void_p,  # m
            ctypes.c_void_p,  # v
            ctypes.c_void_p,  # g
            ctypes.c_void_p,  # b
            ctypes.c_float,  # eps, rounded to y's dtype
            ctypes.c_longlong,  # n
            ctypes.c_int,  # c
            ctypes.c_longlong,  # h * w
            ctypes.c_int,  # 1: channels-last, 0: contiguous NCHW
            ctypes.c_int,  # dtype
            ctypes.c_int,  # activation
            ctypes.c_void_p,  # cudaStream_t
        ]
        lib.norm_act_error_string.restype = ctypes.c_char_p
        lib.norm_act_error_string.argtypes = [ctypes.c_int]
        _lib, _launch = lib, fn
    return _launch


def _eps(eps: float, dtype: torch.dtype) -> float:
    """``eps`` rounded to ``dtype`` as ``torch.full((), eps, dtype=dtype)``
    rounds it (remembered per pair)."""
    key = (eps, dtype)
    val = _eps_in.get(key)
    if val is None:
        val = _eps_in[key] = torch.full((), eps, dtype=dtype).item()
    return val


def norm_act_cuda(y, m, v, g, b, eps: float, act: str | None = None):
    """Launch the kernel (``csrc/norm_act.cu``) on the current stream over
    ``y`` in place and return ``y``. y (N, C, H, W) f32 or bf16 on a CUDA
    device, contiguous or channels-last (as cuDNN returns the port's convs);
    m, v, g, b contiguous (C,) of y's dtype on its device. Raises on anything else and on a refused launch. Counts its
    launches in ``norm_act_cuda.launches``."""
    dt, dev = y.dtype, y.device
    code = _DTYPES.get(dt)
    if code is None:
        raise TypeError(f"norm_act_cuda: want f32 or bf16, got {dt}")
    if y.dim() != 4:
        raise ValueError(f"norm_act_cuda: want (N, C, H, W), got "
                         f"{tuple(y.shape)}")
    if y.is_contiguous():
        channels_last = 0
    elif y.is_contiguous(memory_format=torch.channels_last):
        channels_last = 1
    else:
        raise ValueError(f"norm_act_cuda: want a contiguous or channels-last "
                         f"tensor, got strides {y.stride()}")
    n, c, h, w = y.shape
    for t in (m, v, g, b):
        if t.dtype != dt or t.numel() != c or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(
                f"norm_act_cuda: want per-channel tensors of {c} contiguous "
                f"{dt} on {dev}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")
    if dev.type != "cuda":
        raise ValueError(f"norm_act_cuda: want a CUDA tensor, got {dev}")
    launch = _launch or _load()
    args = (y.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
            b.data_ptr(), _eps(eps, dt), n, c, h * w, channels_last, code,
            _ACT_CODES[act],
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        rc = launch(*args)
    else:
        with torch.cuda.device(dev):
            rc = launch(*args)
    if rc != 0:
        msg = _lib.norm_act_error_string(rc).decode()
        raise RuntimeError(
            f"norm_act kernel launch failed: CUDA error {rc} ({msg})")
    norm_act_cuda.launches += 1
    return y


norm_act_cuda.launches = 0


def norm_act(y, m, v, g, b, eps: float, act: str | None = None):
    """Eval BatchNorm and ``act`` over NCHW ``y``.

    :param y: (N, C, H, W) f32 or bf16, a conv's output; on the card it is
        overwritten with the result.
    :param m, v, g, b: (C,) running mean and variance, weight and bias in
        ``y``'s dtype.
    :param eps: the norm's epsilon (rounded to ``y``'s dtype here).
    :param act: a key of ``ACTIVATIONS``.
    :return: the kernel's result (``y`` itself) for CUDA tensors, the plain
        version's for CPU tensors, identical either way.
    """
    if y.device.type == "cpu":
        return norm_act_plain(y, m, v, g, b, eps, act)
    if y.device.type != "cuda":
        raise ValueError(f"norm_act: unsupported device {y.device}")
    return norm_act_cuda(y, m, v, g, b, eps, act)
