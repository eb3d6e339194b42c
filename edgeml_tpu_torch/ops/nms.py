"""Batched class-aware non-maximum suppression with the exact NMS contract.

Semantics follow the yolov5 tooling that produced the reference's detection
files: confidence = objectness * class probability, candidates gated by
conf > conf_thres, multi-label (one candidate per (box, class) pair),
class-aware IoU through per-class box offsets, strict-greater suppression at
iou_thres, at most max_det survivors ordered by confidence.

Candidate selection is the exact two-stage ranking: boxes are pre-filtered by
their best pair confidence (every box holding a pair above the k-th pair
confidence holds its own best pair above it, so the top max_cand boxes contain
every top-max_cand pair), then all pairs of those boxes are ranked.

Every ranking is a stable descending sort: equal values keep ascending-index
order, the canonical order (score descending, index ascending) that the
reference's top-k produces on every path. Thresholds are compared in the
scores' own dtype, as a weakly typed scalar is in the reference.

Suppression runs in ``ops/nms_fused.py``: a CUDA kernel for CUDA tensors
(the monolithic one up to K = 1024 candidates, the blocked one up to 2048),
its plain version for CPU tensors. Above K = 2048 the dispatcher sends the
candidates, on any device, to the plain global fixpoint
(``greedy_keep_mask_global``), as the reference sends them to its XLA
fixpoint. The row gathers of the candidates run in ``ops/gather.py`` the
same way (a kernel for CUDA tensors).

``suppress_mask`` (greedy survivors of unsorted candidates, capped at
``max_keep`` picks) and ``nms_rows`` (class-aware NMS over pre-scored
(box, class) rows, Faster R-CNN's final tail) complete the reference's
contract; the RPN's own suppressor is the sequential kernel of
``ops/nms_seq.py``, which gives the same masks as ``suppress_mask``.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .gather import gather_rows
from .nms_fused import (
    MAX_K_BLOCKED, greedy_keep_mask_blocked_plain, greedy_keep_mask_fused,
    greedy_keep_mask_plain,
)

MAX_WH = 7680.0  # class-offset stride, matches the yolov5 convention


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``like``'s dtype and device, so a
    comparison rounds the threshold to the tensor's dtype first."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def greedy_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_thres: float, block: int | None = None
                     ) -> torch.Tensor:
    """Exact greedy-NMS survivor mask of one image.

    :param boxes: (K, 4) xyxy, sorted by descending score.
    :param scores: (K,); entries <= 0 never participate.
    :param block: None for the global fixpoint; a band height for the
        blocked greedy (K padded to a multiple of it, bands decided in
        order). The same mask either way.
    :return: (K,) bool.
    """
    if not block or block >= boxes.shape[0]:
        return greedy_keep_mask_plain(boxes[None], scores[None],
                                      iou_thres)[0]
    return greedy_keep_mask_blocked_plain(boxes[None], scores[None],
                                          iou_thres, block)[0]


def topk1d(x: torch.Tensor, k: int):
    """Top k along the last dimension, values descending, equal values in
    ascending-index order (a stable sort; ``torch.topk`` makes no tie-order
    promise). Returns (values, indices)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _compact(cand_boxes, top_scores, cls_idx, kept, max_det):
    """Compact each image's survivors into (B, max_det, 6) rows
    [x1, y1, x2, y2, conf, cls] in candidate (= descending score) order,
    zero rows after the last survivor, plus the (B, max_det) valid mask."""
    b, k = top_scores.shape
    m = min(max_det, k)
    # kept candidates first, each group in ascending index order
    order = torch.sort(kept.to(torch.uint8), dim=1, descending=True,
                       stable=True).indices
    sel = order[:, :m]
    sel_kept = kept.gather(1, sel)
    rows = torch.cat(
        [cand_boxes, top_scores.to(torch.float32)[..., None],
         cls_idx[..., None]], dim=2)
    out = rows.gather(1, sel[..., None].expand(b, m, 6))
    out = torch.where(sel_kept[..., None], out, 0.0)
    if m < max_det:
        out = torch.cat([out, out.new_zeros((b, max_det - m, 6))], dim=1)
    valid = out[..., 4] > 0.0
    return torch.where(valid[..., None], out, 0.0), valid


def greedy_keep_mask_global(boxes: torch.Tensor, scores: torch.Tensor,
                            iou_thres: float) -> torch.Tensor:
    """The route of K > MAX_K_BLOCKED: the plain global fixpoint
    (``greedy_keep_mask_plain``) on the tensors' own device, where the
    reference takes its XLA fixpoint. Counts its calls in
    ``greedy_keep_mask_global.launches``, as the kernels count theirs."""
    kept = greedy_keep_mask_plain(boxes, scores, iou_thres)
    greedy_keep_mask_global.launches += 1
    return kept


greedy_keep_mask_global.launches = 0


def _emit_batch(cand_boxes, top_scores, cls_idx, iou_thres, max_det):
    """Suppression + compaction of (B, K) candidates. The route is chosen by
    K alone: up to MAX_K_BLOCKED the suppressor kernels for CUDA tensors (K
    <= 1024 the monolithic one, K <= 2048 the blocked one) and their plain
    versions for CPU tensors; above it the global fixpoint on any
    device."""
    with span("nms.suppress"):
        off = cand_boxes + cls_idx[..., None] * MAX_WH
        if top_scores.shape[1] > MAX_K_BLOCKED:
            kept = greedy_keep_mask_global(off, top_scores, float(iou_thres))
        else:
            kept = greedy_keep_mask_fused(off, top_scores, float(iou_thres))
    with span("nms.emit"):
        return _compact(cand_boxes, top_scores, cls_idx, kept, max_det)


def _gather_rows(x, idx):
    """x (B, N, C) rows at idx (B, K) -> (B, K, C), through the row-gather
    kernel for CUDA tensors."""
    return gather_rows(x, idx)


def _rank_pairs_exact(obj, xywh, cls, conf_thres, max_cand):
    """Exact two-stage pair selection for a batch: pre-filter boxes by their
    best pair confidence max_c(obj * cls_c), then rank all kb * nc pairs of
    the kept boxes.

    Returns (top_scores (B, k), bxywh (B, k, 4), col (B, k) int64)."""
    b, n, nc = cls.shape
    kb = min(max_cand, n)
    best = cls.amax(dim=2) * obj
    box_score = torch.where(
        (obj > _scalar(conf_thres, obj)) & (best > _scalar(conf_thres, best)),
        best, -1.0)
    best_top, box_pre = topk1d(box_score, kb)
    xywh_pre = _gather_rows(xywh, box_pre)
    # the class rows times their box's objectness, in one gather
    cls_conf = gather_rows(cls, box_pre, scale=obj)
    flat = torch.where(
        (best_top[..., None] > 0) & (cls_conf > _scalar(conf_thres, cls_conf)),
        cls_conf, -1.0).reshape(b, -1)
    k = min(max_cand, flat.shape[1])
    top_scores, top_idx = topk1d(flat, k)
    bxywh = _gather_rows(xywh_pre, torch.div(top_idx, nc,
                                             rounding_mode="floor"))
    return top_scores, bxywh, top_idx % nc


def _rank_boxes_single(obj, xywh, cls, conf_thres, max_cand):
    """Single-label selection: each box's best class only. Returns
    (top_scores (B, k), bxywh (B, k, 4), cls_idx (B, k) int64)."""
    n = obj.shape[1]
    best_conf = cls.amax(dim=2) * obj
    scores = torch.where(
        (obj > _scalar(conf_thres, obj))
        & (best_conf > _scalar(conf_thres, best_conf)), best_conf, -1.0)
    best_cls = cls.argmax(dim=2)  # first maximal index on ties
    top_scores, box_pre = topk1d(scores, min(max_cand, n))
    return top_scores, _gather_rows(xywh, box_pre), best_cls.gather(1, box_pre)


def candidates(obj, xywh, cls, conf_thres=0.001, max_cand=1024,
               multi_label=True):
    """The ranked candidates that enter suppression.

    Returns (cand_boxes (B, k, 4) f32 xyxy, top_scores (B, k) in the score
    dtype, entries <= 0 not real; cls_idx (B, k) f32)."""
    with span("nms.candidates"):
        nc = cls.shape[-1]
        if multi_label and nc > 1:
            top_scores, bxywh, col = _rank_pairs_exact(obj, xywh, cls,
                                                       conf_thres, max_cand)
        else:
            top_scores, bxywh, col = _rank_boxes_single(obj, xywh, cls,
                                                        conf_thres, max_cand)
        half = bxywh[..., 2:4] * 0.5
        cand_boxes = torch.cat([bxywh[..., :2] - half,
                                bxywh[..., :2] + half], dim=-1)
        return cand_boxes, top_scores, col.to(torch.float32)


def nms_split_batch(
    obj: torch.Tensor,  # (B, N) objectness, sigmoid space
    xywh: torch.Tensor,  # (B, N, 4) pixel xywh-center boxes, f32
    cls: torch.Tensor,  # (B, N, nc) class probabilities, sigmoid space
    conf_thres: float = 0.001,
    iou_thres: float = 0.6,
    max_det: int = 300,
    max_cand: int = 1024,
    multi_label: bool = True,
):
    """Batched NMS over split decode components (``YoloV5.predict`` output).

    The exact contract of the reference's ``nms_split_batch`` (its
    ``pool=False`` mode; its default pool mode gives the same results):
    exact pair ranking per image, then the batched suppressor.

    :return: (dets (B, max_det, 6) [x1, y1, x2, y2, conf, cls] f32,
        valid (B, max_det) bool).
    """
    cand_boxes, top_scores, cls_idx = candidates(
        obj, xywh, cls, conf_thres, max_cand, multi_label)
    return _emit_batch(cand_boxes, top_scores, cls_idx, float(iou_thres),
                       max_det)


def suppress_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_thres: float, max_keep: int) -> torch.Tensor:
    """Greedy-NMS survivors of UNSORTED candidates as a bool mask in the
    original order, at most the first ``max_keep`` greedy picks (RPN
    proposal filtering), in the reference's fixpoint form: a stable
    descending sort, the global keep mask, a cumulative-sum cap. Plain
    PyTorch ops on any device; the same mask as the sequential suppressor
    (``ops/nms_seq.py``) wherever every live box has a positive area.

    :param boxes: (K, 4) or (B, K, 4) xyxy.
    :param scores: (K,) or (B, K); only entries > 0 participate.
    :return: (K,) or (B, K) bool.
    """
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
    k = scores.shape[-1]
    order_scores, order = topk1d(torch.where(scores > 0, scores, -1.0), k)
    ordered = boxes.gather(1, order[..., None].expand(*order.shape, 4))
    kept = greedy_keep_mask_plain(ordered, order_scores, float(iou_thres))
    kept &= (torch.cumsum(kept.to(torch.int64), dim=-1) - 1) < max_keep
    out = torch.zeros_like(kept).scatter(1, order, kept)
    return out[0] if single else out


def nms_rows(boxes: torch.Tensor, scores: torch.Tensor,
             cls_ids: torch.Tensor, iou_thres: float = 0.5,
             max_det: int = 300, max_cand: int = 2048):
    """Batched class-aware greedy NMS over pre-scored (box, class) rows.

    The top ``max_cand`` rows by score (stable order) are gathered and
    suppressed by the batched suppressor (at K = 2048 the blocked kernel
    for CUDA tensors).

    :param boxes: (B, N, 4) xyxy f32.
    :param scores: (B, N); entries <= 0 are ignored.
    :param cls_ids: (B, N) float class ids (class-aware offsets).
    :return: (dets (B, max_det, 6) [x1, y1, x2, y2, score, cls], valid).
    """
    with span("nms.candidates"):
        k = min(max_cand, scores.shape[-1])
        top_scores, top_idx = topk1d(torch.where(scores > 0, scores, -1.0),
                                     k)
        cand_boxes = gather_rows(boxes, top_idx)
        cand_cls = gather_rows(cls_ids[..., None], top_idx)[..., 0]
    return _emit_batch(cand_boxes, top_scores, cand_cls, float(iou_thres),
                       max_det)
