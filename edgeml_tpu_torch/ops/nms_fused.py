"""Fused greedy-NMS suppressor: a CUDA kernel for Hopper and its plain version.

Computes, per image, the exact greedy-NMS survivor mask of candidates sorted
by descending score:

    kept[i]  <=>  scores[i] > 0  and  no kept j < i with iou(j, i) > thres.

``greedy_keep_mask_fused`` is the entry point. For a CUDA tensor it launches
the kernel of ``csrc/nms_fused.cu`` (one block per image, the suppression
relation as bits in shared memory, a one-warp greedy walk) or raises; it takes
the plain version only for a tensor on the CPU. The plain version
(``greedy_keep_mask_plain``) is the reference's global fixpoint formulation in
PyTorch ops: the same IoU arithmetic op for op, then
``kept <- valid & (sup @ kept == 0)`` until nothing changes. Both give the
unique greedy answer, bit for bit.

This module must not import ``ops/nms.py`` (that module imports this one).
"""

from __future__ import annotations

import ctypes

import torch

MAX_K = 1024
"""Largest candidate count the kernel takes (its bit matrix fills 128 KB of
shared memory at K = 1024)."""

_lib = None


def _load():
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load_library("nms_fused")
        lib.nms_fused_greedy_keep.restype = ctypes.c_int
        lib.nms_fused_greedy_keep.argtypes = [
            ctypes.c_void_p,  # boxes (B, K, 4) f32
            ctypes.c_void_p,  # valid (B, K) bool
            ctypes.c_void_p,  # out (B, K) bool
            ctypes.c_int,  # batch
            ctypes.c_int,  # k
            ctypes.c_float,  # iou threshold
            ctypes.c_void_p,  # cudaStream_t
        ]
        lib.nms_fused_error_string.restype = ctypes.c_char_p
        lib.nms_fused_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def greedy_keep_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                           iou_thres: float) -> torch.Tensor:
    """Batched exact greedy-NMS survivor masks in plain PyTorch ops.

    :param boxes: (B, K, 4) xyxy (class offsets already applied), each image
        sorted by descending score (ties broken by position).
    :param scores: (B, K); entries <= 0 never participate.
    :param iou_thres: strictly greater IoU suppresses; compared in f32.
    :return: (B, K) bool.
    """
    boxes = boxes.to(torch.float32)
    x1, y1, x2, y2 = boxes.unbind(-1)  # (B, K) each
    zero = torch.zeros((), dtype=torch.float32, device=boxes.device)
    eps = torch.full((), 1e-12, dtype=torch.float32, device=boxes.device)
    thr = torch.full((), iou_thres, dtype=torch.float32, device=boxes.device)
    # iou[b, i, j], the reference's op order: row i, column j
    ix = torch.minimum(x2[:, :, None], x2[:, None, :]) - torch.maximum(
        x1[:, :, None], x1[:, None, :])
    iy = torch.minimum(y2[:, :, None], y2[:, None, :]) - torch.maximum(
        y1[:, :, None], y1[:, None, :])
    inter = torch.maximum(ix, zero) * torch.maximum(iy, zero)
    del ix, iy
    area = torch.maximum(x2 - x1, zero) * torch.maximum(y2 - y1, zero)
    iou = inter / torch.maximum(area[:, :, None] + area[:, None, :] - inter,
                                eps)
    del inter
    k = boxes.shape[1]
    lower = torch.ones((k, k), dtype=torch.bool, device=boxes.device).tril(-1)
    sup = ((iou > thr) & lower).to(torch.float32)  # [b, i, j]: j suppresses i
    del iou
    valid = scores > 0
    kept = valid
    while True:
        # counts of kept suppressors: exact integers in f32
        hit = torch.bmm(sup, kept.to(torch.float32)[:, :, None])[:, :, 0]
        new = valid & (hit == 0)
        if torch.equal(new, kept):
            return kept
        kept = new


def greedy_keep_mask_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_thres: float) -> torch.Tensor:
    """Launch the CUDA kernel: boxes (B, K, 4) f32 contiguous on a CUDA
    device, valid (B, K) bool contiguous on the same device, K <= MAX_K.
    Returns (B, K) bool. Counts its launches in ``greedy_keep_mask_cuda.
    launches``."""
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(
            f"greedy_keep_mask_cuda: tensors must share one CUDA device "
            f"(boxes on {boxes.device}, valid on {valid.device})")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(
            f"greedy_keep_mask_cuda: want f32 boxes and bool valid, got "
            f"{boxes.dtype} and {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(
            f"greedy_keep_mask_cuda: want boxes (B, K, 4) and valid (B, K), "
            f"got {tuple(boxes.shape)} and {tuple(valid.shape)}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("greedy_keep_mask_cuda: inputs must be contiguous")
    b, k, _ = boxes.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(
            f"greedy_keep_mask_cuda: K = {k} outside [1, {MAX_K}]; the "
            f"blocked kernel for larger K is not ported yet")
    out = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0:
        return out
    lib = _load()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    with torch.cuda.device(boxes.device):
        rc = lib.nms_fused_greedy_keep(
            boxes.data_ptr(), valid.data_ptr(), out.data_ptr(), b, k,
            float(iou_thres), stream)
    if rc != 0:
        raise RuntimeError(
            f"nms_fused kernel launch failed: CUDA error {rc} "
            f"({lib.nms_fused_error_string(rc).decode()})")
    greedy_keep_mask_cuda.launches += 1
    return out


greedy_keep_mask_cuda.launches = 0


def greedy_keep_mask_fused(boxes: torch.Tensor, scores: torch.Tensor,
                           iou_thres: float) -> torch.Tensor:
    """Batched greedy-NMS survivor masks: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.

    :param boxes: (B, K, 4) xyxy (class offsets applied), each image sorted
        by descending score.
    :param scores: (B, K); entries <= 0 never participate.
    :return: (B, K) bool, identical either way.
    """
    if boxes.device.type == "cpu":
        return greedy_keep_mask_plain(boxes, scores, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_keep_mask_fused: unsupported device "
                         f"{boxes.device}")
    return greedy_keep_mask_cuda(
        boxes.to(torch.float32).contiguous(), (scores > 0).contiguous(),
        iou_thres)
