"""Box geometry and detection matching on padded, fixed-shape tensors.

The port of the JAX package's ``ops/metrics.py``: the same closed-form
matcher, batched over a leading image axis where the reference vmaps. Plain
torch ops on whatever device the tensors lie on; the reference leaves all of
it to XLA, so there is no kernel here.
"""

from __future__ import annotations

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(x_center, y_center, w, h) -> (x1, y1, x2, y2) for an (..., 4)
    tensor."""
    xy, wh = x[..., :2], x[..., 2:4]
    half = wh * 0.5
    return torch.cat([xy - half, xy + half], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (x_center, y_center, w, h) for an (..., 4)
    tensor."""
    lo, hi = x[..., :2], x[..., 2:4]
    return torch.cat([(lo + hi) * 0.5, hi - lo], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes (unclamped)."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _inter_union(a: torch.Tensor, b: torch.Tensor):
    lo = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    hi = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = torch.clamp_min(hi - lo, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter, union


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between (..., m, 4) and (..., n, 4) xyxy boxes ->
    (..., m, n), without an epsilon: the IoU of two degenerate boxes is NaN,
    as in the reference."""
    inter, union = _inter_union(a, b)
    return inter / union


def box_iou_safe(a: torch.Tensor, b: torch.Tensor,
                 eps: float = 1e-12) -> torch.Tensor:
    """Pairwise IoU with an epsilon, so degenerate pairs give 0."""
    inter, union = _inter_union(a, b)
    return inter / (union + eps)


def box_correct(det_boxes: torch.Tensor, det_cls: torch.Tensor,
                det_valid: torch.Tensor, lab_boxes: torch.Tensor,
                lab_cls: torch.Tensor, lab_valid: torch.Tensor,
                iouv: torch.Tensor) -> torch.Tensor:
    """True-positive matrices of padded detections against padded labels,
    for a batch of images.

    The reference's closed form of the greedy matcher, per image and IoU
    threshold t:

        best(j)  = the label of largest masked IoU with detection j (ties:
                   the LARGEST label index),
        minj(i)  = min { j : best(j) = i, iou(best(j), j) >= t },
        tp(j, t) = iou(best(j), j) >= t and minj(best(j)) = j.

    A detection whose best IoU is NaN (two degenerate boxes) has no best
    label, as the reference's max propagates the NaN, and is never a true
    positive.

    :param det_boxes: (B, n, 4) xyxy; det_cls (B, n); det_valid (B, n) bool.
    :param lab_boxes: (B, m, 4) xyxy; lab_cls (B, m); lab_valid (B, m) bool.
    :param iouv: (t,) IoU thresholds, compared in f32.
    :return: (B, n, t) bool.
    """
    b, n = det_cls.shape
    m = lab_cls.shape[1]
    dev = det_boxes.device
    iouv = torch.as_tensor(iouv, dtype=torch.float32, device=dev)
    t = iouv.shape[0]
    if n == 0 or m == 0:
        return torch.zeros((b, n, t), dtype=torch.bool, device=dev)
    iou = box_iou(lab_boxes.to(torch.float32), det_boxes.to(torch.float32))
    ok = ((lab_cls[:, :, None] == det_cls[:, None, :])
          & lab_valid[:, :, None] & det_valid[:, None, :])
    iou = torch.where(ok, iou, -1.0)  # (B, m, n)
    best_iou = iou.amax(dim=1)  # (B, n), NaN where any masked IoU is NaN
    lab_idx = torch.arange(m, device=dev)[None, :, None]
    # the largest label index among the maxima, by a max over indices (no
    # argmax, whose tie order is not promised); -1 for a NaN column
    best_lab = torch.where(iou == best_iou[:, None, :], lab_idx,
                           -1).amax(dim=1)  # (B, n)
    det_idx = torch.arange(n, device=dev)
    cand = ((best_iou[:, None, :] >= iouv[None, :, None])
            & (best_iou[:, None, :] >= 0.0))  # (B, t, n)
    j_or_big = torch.where(cand, det_idx, n)
    # per-label minimum over the detections that chose it; a detection
    # without a best label (-1) goes to a spare slot m and is dropped
    slot = torch.where(best_lab >= 0, best_lab, m)[:, None, :].expand(b, t, n)
    minj = torch.full((b, t, m + 1), n, dtype=j_or_big.dtype, device=dev)
    minj.scatter_reduce_(2, slot, j_or_big, "amin")
    tp = cand & (minj.gather(2, slot) == det_idx)
    return tp.transpose(1, 2)
