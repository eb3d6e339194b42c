"""Row gather: a CUDA kernel for Hopper and its plain version.

    out[b, j, :] = src[b, idx[b, j], :]  (* scale[b, idx[b, j]])

the NMS tail's row gathers: YOLOv5's candidate boxes and its objectness-
scaled class rows, Faster R-CNN's proposal deltas, anchors and boxes, and
the ``nms_rows`` candidate gather. The output dtype is the promotion of the
source's and the scale's (f32 or bf16); a scaled product is formed in f32
and rounded once, as PyTorch's bf16 multiply does. Indices must lie in
[0, N) (int32 or int64); neither version checks them.

``gather_rows`` is the entry point. For a CUDA tensor it launches a kernel
of ``csrc/gather_rows.cu`` (``gather_rows_cuda``), or raises: a thread per
16 bytes of output where ``vector_path`` says the rows allow it, a thread
per element otherwise. It takes the plain version ``gather_rows_plain``
(``torch.gather``, times the gathered scale) only for a tensor on the CPU.
All are bit-identical.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
_IDX_DTYPES = {torch.int32: 0, torch.int64: 1}
_lib = None
_launch = None


def _load():
    """The launch function of ``csrc/gather_rows.cu``, built and bound at
    first use."""
    global _lib, _launch
    if _launch is None:
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
            ctypes.c_int,  # 1: the 16-byte kernel, 0: the per-element one
            ctypes.c_void_p,  # cudaStream_t
        ]
        lib.gather_rows_error_string.restype = ctypes.c_char_p
        lib.gather_rows_error_string.argtypes = [ctypes.c_int]
        _lib, _launch = lib, fn
    return _launch


def vector_path(src_dtype: torch.dtype, scale_dtype: torch.dtype | None,
                c: int, image_stride: int, row_stride: int, src_ptr: int,
                out_ptr: int) -> bool:
    """Whether the kernel may move 16 bytes a thread: the source and the
    scale share one type (so the output has it too), a row's bytes are a
    multiple of 16, and the source's base address, its image and row strides
    (in elements; 0 for a broadcast) and the output's address are 16-byte
    aligned. Everything else moves an element a thread."""
    if scale_dtype is not None and scale_dtype != src_dtype:
        return False
    es = _ITEMSIZE[src_dtype]
    return ((c * es) % 16 == 0 and (image_stride * es) % 16 == 0
            and (row_stride * es) % 16 == 0 and src_ptr % 16 == 0
            and out_ptr % 16 == 0)


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
    device (made contiguous here if they are not). Raises on anything else
    and on a refused launch. Counts its launches in
    ``gather_rows_cuda.launches``."""
    dev = src.device
    if dev.type != "cuda" or idx.device != dev or (
            scale is not None and scale.device != dev):
        raise ValueError(
            "gather_rows_cuda: tensors must share one CUDA device (got "
            + ", ".join(str(t.device) for t in (src, idx, scale)
                        if t is not None) + ")")
    src_type = _DTYPES.get(src.dtype)
    idx_type = _IDX_DTYPES.get(idx.dtype)
    scale_type = -1 if scale is None else _DTYPES.get(scale.dtype)
    if src_type is None or idx_type is None or scale_type is None:
        raise TypeError(
            f"gather_rows_cuda: want f32/bf16 src and scale and int32/int64 "
            f"idx, got {src.dtype}, "
            f"{None if scale is None else scale.dtype} and {idx.dtype}")
    if src.dim() != 3 or idx.dim() != 2 or idx.shape[0] != src.shape[0] or (
            scale is not None and scale.shape != src.shape[:2]):
        raise ValueError(
            f"gather_rows_cuda: want src (B, N, C), idx (B, K), scale "
            f"(B, N); got {tuple(src.shape)}, {tuple(idx.shape)}, "
            f"{None if scale is None else tuple(scale.shape)}")
    b, n, c = src.shape
    sb, sr, sc = src.stride()
    if c > 1 and sc != 1:
        raise ValueError("gather_rows_cuda: src channels must be contiguous")
    if n < 1 or c < 1:
        raise ValueError(f"gather_rows_cuda: empty source {tuple(src.shape)}")
    k = idx.shape[1]
    # promote(f32, bf16) is f32
    out_dtype = src.dtype if scale_type in (-1, src_type) else torch.float32
    out = torch.empty((b, k, c), dtype=out_dtype, device=dev)
    if b == 0 or k == 0:
        return out
    if not idx.is_contiguous():
        idx = idx.contiguous()
    if scale is not None and not scale.is_contiguous():
        scale = scale.contiguous()
    launch = _launch or _load()
    src_ptr, out_ptr = src.data_ptr(), out.data_ptr()
    args = (src_ptr, idx.data_ptr(),
            None if scale is None else scale.data_ptr(), out_ptr, b, k, c, n,
            sb, sr, src_type, scale_type, idx_type,
            int(vector_path(src.dtype, None if scale is None else scale.dtype,
                            c, sb, sr, src_ptr, out_ptr)),
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        rc = launch(*args)
    else:
        with torch.cuda.device(dev):
            rc = launch(*args)
    if rc != 0:
        msg = _lib.gather_rows_error_string(rc).decode()
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
