"""SSD multibox loss and postprocessing.

Training and serving semantics of torchvision's SSD, as the reference
implements them:

  * matcher (``match_anchors``): each anchor takes its best GT when their
    IoU is at least 0.5, then every GT force-claims its single best anchor;
    unmatched anchors are background;
  * loss (``ssd_loss``): smooth-L1 (beta 1) on the matched regressions plus
    cross-entropy with 3:1 hard-negative mining, normalised by
    max(1, foreground anchors) (of the global batch: under several
    processes the count is summed over the ranks first);
  * postprocess (``ssd_postprocess``): softmax over the class logits with
    the background column dropped, the box deltas decoded onto the default
    boxes and clipped to the image, then the exact batched NMS with every
    box's objectness 1 and at most 2048 candidates per image.

Ties resolve as in the reference: ``argmax`` takes the first index; where
two GTs force-claim one anchor the later GT (padding included) wins, the
reference's scatter order, reproduced here with an explicit max instead of
an ``index_put_`` whose order is undefined on CUDA; hard negatives are
ranked by a stable sort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.metrics import box_iou_safe
from ..ops.nms import nms_split_batch
from ..parallel.mesh import all_sum

MAX_CAND = 2048


def match_anchors(anchors, gt_boxes, gt_valid, iou_thresh: float = 0.5):
    """SSDMatcher: per anchor the matched GT index, or -1 (background).

    :param anchors: (A, 4) xyxy.
    :param gt_boxes: (..., M, 4) xyxy (padded).
    :param gt_valid: (..., M) bool.
    :return: (..., A) int64 in [-1, M).
    """
    iou = box_iou_safe(gt_boxes, anchors)  # (..., M, A)
    iou = torch.where(gt_valid[..., :, None], iou, torch.full_like(iou, -1.0))
    best_iou = torch.amax(iou, dim=-2)
    best_gt = torch.argmax(iou, dim=-2)  # the first index on ties
    matches = torch.where(best_iou >= iou_thresh, best_gt,
                          torch.full_like(best_gt, -1))
    # forced match: each GT claims its best anchor; of several GTs claiming
    # one anchor the last (highest index) writes, as in the reference
    best_anchor = torch.argmax(iou, dim=-1)  # (..., M)
    m = gt_boxes.shape[-2]
    ids = torch.arange(m, device=anchors.device).expand(best_anchor.shape)
    writer = torch.full(matches.shape, -1, dtype=torch.int64,
                        device=anchors.device)
    writer = writer.scatter_reduce(-1, best_anchor, ids, "amax",
                                   include_self=True)
    won = torch.gather(gt_valid, -1, writer.clamp_min(0)) & (writer >= 0)
    forced = torch.where(won, writer, torch.full_like(writer, -1))
    return torch.where(forced >= 0, forced, matches)


def hard_negatives(ce, fg):
    """The 3:1 hard-negative mask: per image, the 3 x (foreground count)
    background anchors of largest CE. Ranked by a stable ascending sort of
    -CE (foreground last), so tied CE keeps anchor order."""
    neg_ce = torch.where(fg, torch.full_like(ce, -torch.inf), ce)
    order = torch.argsort(-neg_ce, dim=-1, stable=True)
    pos = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, pos)
    return rank < 3 * fg.sum(-1, keepdim=True)


def ssd_loss(net, cls_logits, reg, anchors, gt_boxes, gt_cls, gt_valid):
    """Multibox loss for a batch: (total, {bbox_regression,
    classification}).

    :param cls_logits: (B, A, C); reg: (B, A, 4); anchors (A, 4) xyxy
        pixels.
    :param gt_boxes: (B, M, 4) xyxy pixels; gt_cls: (B, M) int (1-based,
        0 = background); gt_valid: (B, M) bool.
    """
    match = match_anchors(anchors, gt_boxes, gt_valid)  # (B, A)
    fg = match >= 0
    num_fg = fg.sum(-1)  # (B,)
    midx = match.clamp_min(0)
    matched = torch.gather(gt_boxes, 1, midx[..., None].expand(-1, -1, 4))
    t_reg = net.encode_boxes(matched, anchors)  # (B, A, 4)
    d = reg - t_reg
    ad = torch.abs(d)
    sl1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
    box_loss = (sl1.sum(-1) * fg).sum(-1)  # (B,)

    labels = torch.where(fg, torch.gather(gt_cls.to(torch.int64), 1, midx),
                         torch.zeros_like(midx))
    logp = F.log_softmax(cls_logits, dim=-1)
    ce = -torch.gather(logp, 2, labels[..., None])[..., 0]  # (B, A)
    keep_neg = hard_negatives(ce.detach(), fg)
    cls_loss = (ce * (fg | keep_neg)).sum(-1)  # (B,)

    n = torch.clamp_min(all_sum(num_fg.sum()), 1).to(cls_logits.dtype)
    total = (box_loss.sum() + cls_loss.sum()) / n
    return total, {"bbox_regression": box_loss.sum() / n,
                   "classification": cls_loss.sum() / n}


def ssd_nms_inputs(net, cls_logits, reg, anchors):
    """The split NMS inputs of SSD serving: (obj (B, A) ones, xywh (B, A, 4)
    pixel xywh-center f32, scores (B, A, C - 1) softmax without background).
    """
    scores = torch.softmax(cls_logits, dim=-1)[..., 1:]
    boxes = net.decode_boxes(reg, anchors)
    boxes = torch.clamp(boxes, 0.0, float(net.image_size))
    # the candidates are rebuilt as xyxy from xywh inside the NMS: the same
    # round trip as the reference, so the suppressor sees the same bits
    xywh = torch.cat([(boxes[..., :2] + boxes[..., 2:4]) * 0.5,
                      boxes[..., 2:4] - boxes[..., :2]], dim=-1)
    obj = torch.ones(scores.shape[:2], dtype=scores.dtype,
                     device=scores.device)
    return obj, xywh, scores


@torch.no_grad()
def ssd_postprocess(net, cls_logits, reg, anchors,
                    score_thresh: float = 0.001, nms_thresh: float = 0.55,
                    max_det: int = 300):
    """Decode + score + class-aware NMS.

    :param net: the SSDLite module (its ``decode_boxes`` and ``image_size``).
    :param cls_logits: (B, A, C) f32; reg: (B, A, 4) f32; anchors: (A, 4).
    :return: (dets (B, max_det, 6) [x1, y1, x2, y2, score, cls_id], valid
        (B, max_det)); cls_id keeps the model's label space (background
        dropped, ids start at 1).
    """
    dets, valid = nms_split_batch(
        *ssd_nms_inputs(net, cls_logits, reg, anchors),
        conf_thres=score_thresh, iou_thres=nms_thresh, max_det=max_det,
        max_cand=MAX_CAND, multi_label=True)
    # class ids: the NMS counts from 0 over the background-dropped columns
    dets[..., 5] += valid.to(dets.dtype)
    return dets, valid
