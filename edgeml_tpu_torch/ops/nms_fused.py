"""Greedy-NMS suppressors: CUDA kernels for Hopper and their plain versions.

Computes, per image, the exact greedy-NMS survivor mask of candidates sorted
by descending score:

    kept[i]  <=>  scores[i] > 0  and  no kept j < i with iou(j, i) > thres.

``greedy_keep_mask_fused`` is the entry point and dispatches on the candidate
count K as the reference does. For a CUDA tensor it launches, or raises:

  * K <= 1024: the kernel of ``csrc/nms_fused.cu`` (a cluster of 4 blocks
    per image), ``greedy_keep_mask_cuda``;
  * 1024 < K <= 2048: the blocked kernel of ``csrc/nms_blocked.cu`` (the
    same kernel as a cluster of 8), ``greedy_keep_mask_blocked_cuda``;
  * larger K: ValueError.

Both are ``csrc/nms_band.cuh``'s banded walk: block r of the cluster builds
the suppression bits of band r (256 targets) in its own shared memory while
the others build theirs, and the bands are decided in order, each block
handing its kept words to the later ones.

It takes a plain version only for a tensor on the CPU: the global fixpoint
``greedy_keep_mask_plain`` for K <= 1024 and the blocked fixpoint
``greedy_keep_mask_blocked_plain`` above. Both are the reference's
formulations in PyTorch ops (the same IoU arithmetic op for op) and give the
unique greedy answer, bit for bit, as the kernels do.

This module must not import ``ops/nms.py`` (that module imports this one).
"""

from __future__ import annotations

import ctypes

import torch

MAX_K = 1024
"""Largest candidate count the monolithic kernel takes (a cluster of 4 bands
of 256)."""

MAX_K_BLOCKED = 2048
"""Largest candidate count the blocked kernel takes (the reference's
``FUSED_MAX_K``)."""

BLOCK = 256
"""Band height of the blocked formulation (the reference's ``blk``)."""

_libs: dict = {}


def _load(name: str):
    """The ctypes handle of ``csrc/<name>.cu``, built at first use. Its entry
    point is ``<name>_greedy_keep`` and its error text ``<name>_error_string``.
    """
    lib = _libs.get(name)
    if lib is None:
        from .. import _build

        lib = _build.load_library(name)
        fn = getattr(lib, f"{name}_greedy_keep")
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p,  # boxes (B, K, 4) f32
            ctypes.c_void_p,  # valid (B, K) bool
            ctypes.c_void_p,  # out (B, K) bool
            ctypes.c_int,  # batch
            ctypes.c_int,  # k
            ctypes.c_float,  # iou threshold
            ctypes.c_void_p,  # cudaStream_t
        ]
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def _suppression(boxes: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """The strictly lower-triangular suppression matrix, (B, K, K) f32 0/1:
    sup[b, i, j] = 1 iff j < i and iou(i, j) > iou_thres (in f32), with the
    reference's IoU arithmetic op for op."""
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
    return ((iou > thr) & lower).to(torch.float32)


def _fixpoint(sup: torch.Tensor, free: torch.Tensor) -> torch.Tensor:
    """The unique solution of kept = free & (sup @ kept == 0), iterated from
    kept = free. sup (B, n, n) f32 0/1, free (B, n) bool."""
    kept = free
    while True:
        # counts of kept suppressors: exact integers in f32
        hit = torch.bmm(sup, kept.to(torch.float32)[:, :, None])[:, :, 0]
        new = free & (hit == 0)
        if torch.equal(new, kept):
            return kept
        kept = new


def greedy_keep_mask_plain(boxes: torch.Tensor, scores: torch.Tensor,
                           iou_thres: float) -> torch.Tensor:
    """Batched exact greedy-NMS survivor masks in plain PyTorch ops: the
    global fixpoint over the whole (K, K) suppression matrix.

    :param boxes: (B, K, 4) xyxy (class offsets already applied), each image
        sorted by descending score (ties broken by position).
    :param scores: (B, K); entries <= 0 never participate.
    :param iou_thres: strictly greater IoU suppresses; compared in f32.
    :return: (B, K) bool.
    """
    return _fixpoint(_suppression(boxes, iou_thres), scores > 0)


def greedy_keep_mask_blocked_plain(boxes: torch.Tensor, scores: torch.Tensor,
                                   iou_thres: float,
                                   block: int = BLOCK) -> torch.Tensor:
    """The same masks by the reference's blocked greedy (its
    ``greedy_keep_mask(block=...)``): pad K to a multiple of ``block``, then
    decide the bands in order, each with one matvec of its rows against the
    decided prefix and a fixpoint on its (block, block) diagonal tile.
    Bit-identical to ``greedy_keep_mask_plain`` (the fixpoint is unique).
    Arguments and result as ``greedy_keep_mask_plain``."""
    sup = _suppression(boxes, iou_thres)
    valid = scores > 0
    b, k = valid.shape
    pad = -k % block
    if pad:
        sup = torch.nn.functional.pad(sup, (0, pad, 0, pad))
        valid = torch.cat([valid, valid.new_zeros((b, pad))], dim=1)
    kept = torch.zeros_like(valid)
    for t in range(0, k + pad, block):
        s = slice(t, t + block)
        # undecided entries of kept (this band and later) are still False,
        # so one matvec counts exactly the decided-prefix hits
        hit_prev = torch.bmm(sup[:, s, :],
                             kept.to(torch.float32)[:, :, None])[:, :, 0]
        free = valid[:, s] & (hit_prev == 0)
        kept[:, s] = _fixpoint(sup[:, s, s], free)
    return kept[:, :k]


def _launch(name: str, counter, max_k: int, boxes: torch.Tensor,
            valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Check the inputs, launch ``csrc/<name>.cu`` on the current stream,
    raise on a refused launch, count it on ``counter``."""
    fn = counter.__name__
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(
            f"{fn}: tensors must share one CUDA device "
            f"(boxes on {boxes.device}, valid on {valid.device})")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(
            f"{fn}: want f32 boxes and bool valid, got "
            f"{boxes.dtype} and {valid.dtype}")
    if boxes.dim() != 3 or boxes.shape[2] != 4 \
            or tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(
            f"{fn}: want boxes (B, K, 4) and valid (B, K), "
            f"got {tuple(boxes.shape)} and {tuple(valid.shape)}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError(f"{fn}: inputs must be contiguous")
    b, k, _ = boxes.shape
    if not 1 <= k <= max_k:
        raise ValueError(f"{fn}: K = {k} outside [1, {max_k}]")
    out = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0:
        return out
    lib = _load(name)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    fn = getattr(lib, f"{name}_greedy_keep")
    args = (boxes.data_ptr(), valid.data_ptr(), out.data_ptr(), b, k,
            float(iou_thres), stream)
    if boxes.device.index == torch.cuda.current_device():
        rc = fn(*args)
    else:
        with torch.cuda.device(boxes.device):
            rc = fn(*args)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} ({msg})")
    counter.launches += 1
    return out


def greedy_keep_mask_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                          iou_thres: float) -> torch.Tensor:
    """Launch the monolithic kernel (``csrc/nms_fused.cu``): boxes (B, K, 4)
    f32 contiguous on a CUDA device, valid (B, K) bool contiguous on the same
    device, K <= MAX_K. Returns (B, K) bool. Counts its launches in
    ``greedy_keep_mask_cuda.launches``."""
    return _launch("nms_fused", greedy_keep_mask_cuda, MAX_K, boxes, valid,
                   iou_thres)


greedy_keep_mask_cuda.launches = 0


def greedy_keep_mask_blocked_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                                  iou_thres: float) -> torch.Tensor:
    """Launch the blocked kernel (``csrc/nms_blocked.cu``): arguments as
    ``greedy_keep_mask_cuda``, K <= MAX_K_BLOCKED. Counts its launches in
    ``greedy_keep_mask_blocked_cuda.launches``."""
    return _launch("nms_blocked", greedy_keep_mask_blocked_cuda,
                   MAX_K_BLOCKED, boxes, valid, iou_thres)


greedy_keep_mask_blocked_cuda.launches = 0


def max_active_clusters(name: str) -> int:
    """How many clusters of the kernel of ``csrc/<name>.cu`` (``nms_fused``,
    ``nms_blocked`` or ``nms_seq``: a cluster per image or segment) the
    current CUDA device holds at once (``cudaOccupancyMaxActiveClusters`` at
    the kernel's block size and shared memory); more run in waves."""
    from .. import _build

    lib = _build.load_library(name)
    fn = getattr(lib, f"{name}_max_active_clusters")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    n = ctypes.c_int(0)
    rc = fn(ctypes.byref(n))
    if rc != 0:
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} occupancy query failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    return n.value


def greedy_keep_mask_fused(boxes: torch.Tensor, scores: torch.Tensor,
                           iou_thres: float) -> torch.Tensor:
    """Batched greedy-NMS survivor masks: a CUDA kernel for CUDA tensors
    (by K, see the module docstring; K > MAX_K_BLOCKED raises), the plain
    version for CPU tensors.

    :param boxes: (B, K, 4) xyxy (class offsets applied), each image sorted
        by descending score.
    :param scores: (B, K); entries <= 0 never participate.
    :return: (B, K) bool, identical either way.
    """
    k = boxes.shape[1]
    if boxes.device.type == "cpu":
        if k <= MAX_K:
            return greedy_keep_mask_plain(boxes, scores, iou_thres)
        return greedy_keep_mask_blocked_plain(boxes, scores, iou_thres)
    if boxes.device.type != "cuda":
        raise ValueError(f"greedy_keep_mask_fused: unsupported device "
                         f"{boxes.device}")
    if k > MAX_K_BLOCKED:
        raise ValueError(
            f"greedy_keep_mask_fused: K = {k} above {MAX_K_BLOCKED}, the "
            f"largest candidate count of the suppressor kernels")
    launch = greedy_keep_mask_cuda if k <= MAX_K \
        else greedy_keep_mask_blocked_cuda
    return launch(boxes.to(torch.float32).contiguous(),
                  (scores > 0).contiguous(), iou_thres)
