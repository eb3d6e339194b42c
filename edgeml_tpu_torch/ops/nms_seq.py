"""Sequential greedy NMS over unsorted candidates: a CUDA kernel for Hopper
and its plain version.

The literal loop of the reference's sequential suppressor, run over S
independent segments (Faster R-CNN: one per image and FPN level): up to
``max_keep`` steps of

    pick the live candidate of largest score (the lowest index among equal
    maxima); stop if its score is not > 0; record it; kill every live
    candidate whose IoU with it is > iou_thres (the pick included),

with area = (x2 - x1) * (y2 - y1) as the reference builds it. Candidates of
score <= 0 are never live.

``suppress_mask_seq`` is the entry point. For a CUDA tensor it launches a
kernel of ``csrc/nms_seq.cu``, chosen by K, or raises:
``suppress_mask_seq_cuda`` (a cluster of 4 blocks per segment, K <= 1024)
or, above that, ``suppress_mask_seq_wide_cuda`` (the literal loop, one block
of 1024 threads per segment, any K). It takes the plain version
``suppress_mask_seq_plain`` (the same loop in PyTorch ops, batched over
segments, the same IoU arithmetic op for op) only for a tensor on the CPU.
All three are bit-identical. The cluster kernel reaches the loop's answer
in its sorted form: the loop picks in strictly decreasing (score, -index)
order, so its picks are the greedy keep mask of the live candidates sorted
by that key, with a pick that does not remove itself (zero or negative
width or height, thr >= 1) picked again at every remaining step, capped at
``max_keep`` picks.

``suppress_mask`` and ``nms_seq`` are the reference's two wrappers of the
suppressor (RPN proposal filtering, and class-aware NMS on pre-scored rows).
"""

from __future__ import annotations

import ctypes

import torch

from .nms import MAX_WH

MAX_K = 1024
"""Largest candidate count per segment the kernel takes (a cluster of 4
bands of 256)."""

_lib = None


def _load():
    """The ctypes handle of ``csrc/nms_seq.cu``, built at first use."""
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load_library("nms_seq")
        fn = lib.nms_seq_suppress
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # boxes (S, K, 4) f32
            ctypes.c_void_p,  # scores (S, K) f32
            ctypes.c_void_p,  # kept (S, K) bool
            ctypes.c_void_p,  # picks (S, max_keep) int32
            ctypes.c_int,  # segments
            ctypes.c_int,  # k
            ctypes.c_int,  # max_keep
            ctypes.c_float,  # iou threshold
            ctypes.c_void_p,  # cudaStream_t
        ]
        lib.nms_seq_suppress_wide.restype = ctypes.c_int
        lib.nms_seq_suppress_wide.argtypes = fn.argtypes
        lib.nms_seq_error_string.restype = ctypes.c_char_p
        lib.nms_seq_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def suppress_mask_seq_plain(boxes: torch.Tensor, scores: torch.Tensor,
                            iou_thres: float, max_keep: int):
    """The sequential loop in plain PyTorch ops, batched over segments; it
    runs until ``max_keep`` steps are done or no segment has a live
    candidate. Arguments and result as ``suppress_mask_seq``."""
    boxes = boxes.to(torch.float32)
    scores = scores.to(torch.float32)
    s_, k = scores.shape
    dev = boxes.device
    x1, y1, x2, y2 = boxes.unbind(-1)  # (S, K) each
    area = (x2 - x1) * (y2 - y1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    eps = torch.full((), 1e-12, dtype=torch.float32, device=dev)
    thr = torch.full((), iou_thres, dtype=torch.float32, device=dev)
    ninf = torch.full((), -torch.inf, dtype=torch.float32, device=dev)
    lane = torch.arange(k, device=dev)
    rows = torch.arange(s_, device=dev)
    alive = scores > 0
    kept = torch.zeros((s_, k), dtype=torch.bool, device=dev)
    picks = torch.full((s_, max_keep), -1, dtype=torch.int32, device=dev)
    for step in range(max_keep):
        s = torch.where(alive, scores, ninf)
        m = s.amax(dim=1)
        # the lowest index among equal maxima
        j = torch.where(s == m[:, None], lane, k).amin(dim=1)
        ok = m > 0
        if not bool(ok.any()):
            break
        picks[:, step] = torch.where(ok, j, -1).to(torch.int32)
        kept[rows[ok], j[ok]] = True
        bx1, by1, bx2, by2, ba = (t.gather(1, j[:, None])
                                  for t in (x1, y1, x2, y2, area))
        ix1 = torch.maximum(bx1, x1)
        iy1 = torch.maximum(by1, y1)
        ix2 = torch.minimum(bx2, x2)
        iy2 = torch.minimum(by2, y2)
        inter = torch.maximum(ix2 - ix1, zero) * torch.maximum(iy2 - iy1,
                                                               zero)
        iou = inter / torch.maximum(ba + area - inter, eps)
        alive = alive & (iou <= thr) & ok[:, None]
    return kept, picks


def _launch(entry: str, counter, max_k, boxes: torch.Tensor,
            scores: torch.Tensor, iou_thres: float, max_keep: int):
    """Check the inputs, launch ``entry`` of ``csrc/nms_seq.cu`` on the
    current stream, raise on a refused launch, count it on ``counter``."""
    fn = counter.__name__
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError(
            f"{fn}: tensors must share one CUDA device "
            f"(boxes on {boxes.device}, scores on {scores.device})")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(
            f"{fn}: want f32 boxes and scores, got "
            f"{boxes.dtype} and {scores.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(
            f"{fn}: want boxes (S, K, 4) and scores "
            f"(S, K), got {tuple(boxes.shape)} and {tuple(scores.shape)}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError(f"{fn}: inputs must be contiguous")
    s_, k, _ = boxes.shape
    if k < 1 or (max_k is not None and k > max_k):
        raise ValueError(f"{fn}: K = {k} outside [1, {max_k}]")
    if max_keep < 0:
        raise ValueError(f"{fn}: max_keep = {max_keep}")
    kept = torch.empty((s_, k), dtype=torch.bool, device=boxes.device)
    picks = torch.empty((s_, max_keep), dtype=torch.int32,
                        device=boxes.device)
    if s_ == 0:
        return kept, picks
    lib = _load()
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    with torch.cuda.device(boxes.device):
        rc = getattr(lib, entry)(
            boxes.data_ptr(), scores.data_ptr(), kept.data_ptr(),
            picks.data_ptr(), s_, k, int(max_keep), float(iou_thres), stream)
    if rc != 0:
        msg = lib.nms_seq_error_string(rc).decode()
        raise RuntimeError(
            f"{entry} kernel launch failed: CUDA error {rc} ({msg})")
    counter.launches += 1
    return kept, picks


def suppress_mask_seq_cuda(boxes: torch.Tensor, scores: torch.Tensor,
                           iou_thres: float, max_keep: int):
    """Launch the cluster kernel (``csrc/nms_seq.cu``) on the current stream:
    boxes (S, K, 4) f32 contiguous on a CUDA device, scores (S, K) f32
    contiguous on the same device, K <= MAX_K. Counts its launches in
    ``suppress_mask_seq_cuda.launches``."""
    return _launch("nms_seq_suppress", suppress_mask_seq_cuda, MAX_K, boxes,
                   scores, iou_thres, max_keep)


suppress_mask_seq_cuda.launches = 0


def suppress_mask_seq_wide_cuda(boxes: torch.Tensor, scores: torch.Tensor,
                                iou_thres: float, max_keep: int):
    """Launch the literal-loop kernel (``csrc/nms_seq.cu`` seq_wide_kernel,
    one block of 1024 threads per segment) for any K; arguments as
    ``suppress_mask_seq_cuda``. The entry point takes it for K > MAX_K.
    Counts its launches in ``suppress_mask_seq_wide_cuda.launches``."""
    return _launch("nms_seq_suppress_wide", suppress_mask_seq_wide_cuda,
                   None, boxes, scores, iou_thres, max_keep)


suppress_mask_seq_wide_cuda.launches = 0


def suppress_mask_seq(boxes: torch.Tensor, scores: torch.Tensor,
                      iou_thres: float, max_keep: int):
    """Sequential greedy NMS over S independent segments of unsorted
    candidates.

    :param boxes: (S, K, 4) xyxy (class offsets already applied if any).
    :param scores: (S, K); entries <= 0 never participate.
    :param iou_thres: strictly greater IoU suppresses; compared in f32.
    :param max_keep: at most this many picks per segment.
    :return: (kept (S, K) bool, picks (S, max_keep) int32 in pick order, -1
        after the last pick): a CUDA kernel for CUDA tensors (the cluster
        kernel for K <= MAX_K, the literal loop above), the plain version
        for CPU tensors, identical either way.
    """
    if boxes.device.type == "cpu":
        return suppress_mask_seq_plain(boxes, scores, iou_thres, max_keep)
    if boxes.device.type != "cuda":
        raise ValueError(f"suppress_mask_seq: unsupported device "
                         f"{boxes.device}")
    launch = suppress_mask_seq_cuda if boxes.shape[1] <= MAX_K \
        else suppress_mask_seq_wide_cuda
    return launch(boxes.to(torch.float32).contiguous(),
                  scores.to(torch.float32).contiguous(), iou_thres, max_keep)


def _score_row(scores: torch.Tensor) -> torch.Tensor:
    """The reference's score row: entries <= 0 set to -1."""
    return torch.where(scores > 0, scores, -1.0).to(torch.float32)


def suppress_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_thres: float, max_keep: int) -> torch.Tensor:
    """Greedy-NMS survivors of one image's unsorted candidates as a (K,)
    bool mask (the reference's sequential ``suppress_mask``).

    :param boxes: (K, 4) xyxy (already class-offset if needed).
    :param scores: (K,); only entries > 0 participate.
    """
    kept, _ = suppress_mask_seq(boxes[None], _score_row(scores)[None],
                                iou_thres, max_keep)
    return kept[0]


def nms_seq(boxes: torch.Tensor, scores: torch.Tensor, cls_ids: torch.Tensor,
            iou_thres: float = 0.5, max_det: int = 300):
    """Greedy class-aware NMS on pre-scored rows through the sequential
    suppressor (the reference's ``nms_pallas``).

    :param boxes: (K, 4) or (B, K, 4) xyxy; scores: (K,) or (B, K), entries
        <= 0 ignored; cls_ids: float class ids of the same shape.
    :return: (dets (max_det, 6) [x1, y1, x2, y2, score, cls], valid
        (max_det,)), with a leading B for batched inputs; rows in pick
        order, zero rows after the last pick.
    """
    single = boxes.dim() == 2
    if single:
        boxes, scores, cls_ids = boxes[None], scores[None], cls_ids[None]
    boxes = boxes.to(torch.float32)
    cls_ids = cls_ids.to(torch.float32)
    off = boxes + cls_ids[..., None] * MAX_WH
    srow = _score_row(scores)
    _, picks = suppress_mask_seq(off, srow, iou_thres, max_det)
    sel = picks >= 0
    p = picks.clamp_min(0).long()
    rows = torch.cat([off, srow[..., None]], dim=-1).gather(
        1, p[..., None].expand(*p.shape, 5))
    rows = torch.where(sel[..., None], rows, 0.0)
    # undo the class offset and recover the class id from the offset box
    cls = torch.where(sel, torch.floor(rows[..., 0] / MAX_WH + 1e-6), 0.0)
    cls = torch.clamp(cls, min=0.0)
    dets = torch.stack([rows[..., 0] - cls * MAX_WH,
                        rows[..., 1] - cls * MAX_WH,
                        rows[..., 2] - cls * MAX_WH,
                        rows[..., 3] - cls * MAX_WH,
                        rows[..., 4], cls], dim=-1)
    dets = torch.where(sel[..., None], dets, 0.0)
    if single:
        return dets[0], sel[0]
    return dets, sel
