"""Row gather: a CUDA kernel for Hopper and its plain version.

    out[b, j, :] = src[b, idx[b, j], :]  (* scale[b, idx[b, j]])

the NMS tail's row gathers: YOLOv5's candidate boxes and its objectness-
scaled class rows, Faster R-CNN's proposal deltas, anchors and boxes, and
the ``nms_rows`` candidate gather. The output dtype is the promotion of the
source's and the scale's (f32 or bf16); a scaled product is formed in f32
and rounded once, as PyTorch's bf16 multiply does. Indices must lie in
[0, N) (int32 or int64); neither version checks them.

``gather_rows`` is the entry point. For a CUDA tensor it launches the kernel
of ``csrc/gather_rows.cu`` (``gather_rows_cuda``, one warp per output row),
or raises; it takes the plain version ``gather_rows_plain`` (``torch.gather``,
times the gathered scale) only for a tensor on the CPU. The two are
bit-identical.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IDX_DTYPES = {torch.int32: 0, torch.int64: 1}
_lib = None


def _load():
    """The ctypes handle of ``csrc/gather_rows.cu``, built at first use."""
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load_library("gather_rows")
        fn = lib.gather_rows_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # src
            ctypes.c_void_p,  # idx
            ctypes.c_void_p,  # scale or None
            ctypes.c_void_p,  # out
            ctypes.c_int,  # batch
            ctypes.c_int,  # k
            ctypes.c_int,  # c
            ctypes.c_longlong,  # n
            ctypes.c_longlong,  # src image stride (elements)
            ctypes.c_longlong,  # src row stride (elements)
            ctypes.c_int,  # src type
            ctypes.c_int,  # scale type (-1: none)
            ctypes.c_int,  # idx type
            ctypes.c_void_p,  # cudaStream_t
        ]
        lib.gather_rows_error_string.restype = ctypes.c_char_p
        lib.gather_rows_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _out_dtype(src: torch.Tensor, scale: torch.Tensor | None) -> torch.dtype:
    return src.dtype if scale is None else torch.promote_types(src.dtype,
                                                               scale.dtype)


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor,
                      scale: torch.Tensor | None = None) -> torch.Tensor:
    """The gather in plain PyTorch ops: ``torch.gather`` of the rows, times
    the gathered scale. Arguments and result as ``gather_rows``."""
    dt = _out_dtype(src, scale)
    idx = idx.long()
    rows = src.to(dt).gather(1, idx[..., None].expand(*idx.shape,
                                                      src.shape[-1]))
    if scale is None:
        return rows
    return rows * scale.to(dt).gather(1, idx)[..., None]


def gather_rows_cuda(src: torch.Tensor, idx: torch.Tensor,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel (``csrc/gather_rows.cu``) on the current stream.
    src (B, N, C) f32 or bf16 on a CUDA device with unit channel stride (any
    image and row strides: an expanded source of stride 0 is read in place);
    idx (B, K) int32 or int64 and scale (B, N) f32 or bf16 on the same
    device (made contiguous here). Raises on anything else and on a refused
    launch. Counts its launches in ``gather_rows_cuda.launches``."""
    tensors = [src, idx] + ([] if scale is None else [scale])
    if src.device.type != "cuda" or any(t.device != src.device
                                        for t in tensors):
        raise ValueError(
            "gather_rows_cuda: tensors must share one CUDA device (got "
            + ", ".join(str(t.device) for t in tensors) + ")")
    if src.dtype not in _DTYPES or idx.dtype not in _IDX_DTYPES or (
            scale is not None and scale.dtype not in _DTYPES):
        raise TypeError(
            f"gather_rows_cuda: want f32/bf16 src and scale and int32/int64 "
            f"idx, got {src.dtype}, "
            f"{None if scale is None else scale.dtype} and {idx.dtype}")
    if src.dim() != 3 or idx.dim() != 2 or idx.shape[0] != src.shape[0] or (
            scale is not None and tuple(scale.shape) != tuple(src.shape[:2])):
        raise ValueError(
            f"gather_rows_cuda: want src (B, N, C), idx (B, K), scale "
            f"(B, N); got {tuple(src.shape)}, {tuple(idx.shape)}, "
            f"{None if scale is None else tuple(scale.shape)}")
    b, n, c = src.shape
    if c > 1 and src.stride(2) != 1:
        raise ValueError("gather_rows_cuda: src channels must be contiguous")
    if n < 1 or c < 1:
        raise ValueError(f"gather_rows_cuda: empty source {tuple(src.shape)}")
    k = idx.shape[1]
    out = torch.empty((b, k, c), dtype=_out_dtype(src, scale),
                      device=src.device)
    if b == 0 or k == 0:
        return out
    idx = idx.contiguous()
    if scale is not None:
        scale = scale.contiguous()
    lib = _load()
    stream = torch.cuda.current_stream(src.device).cuda_stream
    with torch.cuda.device(src.device):
        rc = lib.gather_rows_launch(
            src.data_ptr(), idx.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            b, k, c, n, src.stride(0), src.stride(1), _DTYPES[src.dtype],
            -1 if scale is None else _DTYPES[scale.dtype],
            _IDX_DTYPES[idx.dtype], stream)
    if rc != 0:
        msg = lib.gather_rows_error_string(rc).decode()
        raise RuntimeError(
            f"gather_rows kernel launch failed: CUDA error {rc} ({msg})")
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """Rows of ``src`` at ``idx``, optionally scaled per source row.

    :param src: (B, N, C) f32 or bf16.
    :param idx: (B, K) int32 or int64 row indices in [0, N).
    :param scale: optional (B, N) per-row multiplier.
    :return: (B, K, C) in promote(src, scale): the CUDA kernel for CUDA
        tensors, the plain version for CPU tensors, identical either way.
    """
    if src.device.type == "cpu":
        return gather_rows_plain(src, idx, scale)
    if src.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {src.device}")
    return gather_rows_cuda(src, idx, scale)
