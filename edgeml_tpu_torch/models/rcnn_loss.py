"""Faster R-CNN training losses: RPN objectness and regression, RoI head.

The reference package's ``models/rcnn_loss.py`` (torchvision's semantics):

  * RPN: every anchor matched at 0.7 / 0.3 with low-quality matches
    (``retinanet.retina_match``), 256 anchors an image sampled at 50%
    positives, BCE objectness over the sample and smooth-L1 (beta 1/9)
    regression on its positives, box coder (1, 1, 1, 1);
  * RoI head: the proposals plus the GT boxes matched at 0.5, 512 sampled
    at 25% positives, cross-entropy classification and per-class
    smooth-L1 (beta 1) regression on the positives, box coder
    (10, 10, 5, 5); both parts over the sample's size.

Fixed-width sampling (``_sample_balanced``): each candidate gets a uniform
draw, and the top draws within the positive and the negative pools are
taken (positions outside a pool rank -1, ties to the lower index), as the
reference's ``lax.top_k`` takes them. The draws are arguments (``Draws``):
from a ``torch.Generator`` by default (``uniform_draws``), or injected, so
a test can replay the reference's own.

Proposals come from ``FasterRCNN.proposals`` under ``torch.no_grad()``,
the counterpart of the reference's ``stop_gradient``: on a CUDA device one
launch of the sequential suppressor and three of the row gather a step.
The second stage runs the port's RoIAlign and box head under autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.metrics import box_iou_safe
from .faster_rcnn import BOX_WEIGHTS, RPN_WEIGHTS, encode
from .retinanet import retina_match

RPN_SAMPLES, RPN_POS_FRACTION = 256, 0.5
ROI_SAMPLES, ROI_POS_FRACTION = 512, 0.25
ROI_FG_IOU = 0.5


class Draws(NamedTuple):
    """The uniform draws of one step's sampling, (B, n) f32 each: positive
    and negative ranks of the RPN's anchors (n = A) and of the RoI head's
    boxes (n = P + M)."""

    rpn_pos: torch.Tensor
    rpn_neg: torch.Tensor
    roi_pos: torch.Tensor
    roi_neg: torch.Tensor


def uniform_draws(generator: torch.Generator, b: int, n_rpn: int,
                  n_roi: int, device) -> Draws:
    """A step's draws in [0, 1) from ``generator`` (on ``device``)."""
    def u(n):
        return torch.rand((b, n), generator=generator, device=device)

    return Draws(u(n_rpn), u(n_rpn), u(n_roi), u(n_roi))


def _sample_balanced(pos_mask, neg_mask, u_pos, u_neg, num_samples: int,
                     pos_fraction: float):
    """Up to ``num_samples`` entries an image, ``pos_fraction`` of them
    positive, chosen by their draws, at a fixed width: a fixed
    ``num_samples - num_pos_want`` negative slots, as the reference takes
    them.

    :param pos_mask: (B, n) bool; neg_mask (B, n) bool.
    :param u_pos: (B, n) uniform draws ranking the positives; u_neg the
        negatives.
    :return: (idx (B, S), weight (B, S) f32, positive indicator (B, S) f32),
        weight 0 on padding slots.
    """
    n = pos_mask.shape[1]
    num_pos_want = min(int(num_samples * pos_fraction), n)
    num_neg_want = min(num_samples - num_pos_want, n)
    parts = []
    for mask, u, k in ((pos_mask, u_pos, num_pos_want),
                       (neg_mask, u_neg, num_neg_want)):
        rank = torch.where(mask, u, -1.0)
        idx = torch.sort(rank, dim=1, descending=True, stable=True).indices
        keep = torch.clamp(mask.sum(1, keepdim=True), max=k)
        w = (torch.arange(k, device=mask.device)[None] < keep).to(
            torch.float32)
        parts.append((idx[:, :k], w))
    (pos_idx, pos_w), (neg_idx, neg_w) = parts
    return (torch.cat([pos_idx, neg_idx], 1), torch.cat([pos_w, neg_w], 1),
            torch.cat([pos_w, torch.zeros_like(neg_w)], 1))


def _smooth_l1(d, beta: float):
    ad = torch.abs(d)
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def _bce(x, y):
    return torch.clamp_min(x, 0) - x * y \
        + torch.log1p(torch.exp(-torch.abs(x)))


def _rows(t, idx):
    """t (B, n, ...) gathered at idx (B, S) along dim 1."""
    return t[torch.arange(t.shape[0], device=t.device)[:, None], idx]


def rpn_sample(anchors, gt_boxes, gt_valid, u_pos, u_neg):
    """The RPN's targets: (match (B, A), idx, weight, positive indicator
    (B, S)) of ``retina_match`` at 0.7 / 0.3 and ``_sample_balanced``."""
    match = retina_match(anchors, gt_boxes, gt_valid, hi=0.7, lo=0.3)
    return (match,) + _sample_balanced(match >= 0, match == -1, u_pos,
                                       u_neg, RPN_SAMPLES, RPN_POS_FRACTION)


def rpn_loss(obj_logits, deltas, anchors, gt_boxes, gt_valid, u_pos, u_neg):
    """Per image (objectness loss (B,), regression loss (B,)).

    :param obj_logits: (B, A) f32; deltas (B, A, 4) f32; anchors (A, 4).
    :param gt_boxes: (B, M, 4) xyxy pixels; gt_valid (B, M) bool.
    """
    match, idx, w, pos_w = rpn_sample(anchors, gt_boxes, gt_valid, u_pos,
                                      u_neg)
    labels = _rows(match >= 0, idx).to(obj_logits.dtype)
    lo = _rows(obj_logits, idx)
    denom = torch.clamp_min(w.sum(1), 1.0)
    obj_l = (_bce(lo, labels) * w).sum(1) / denom

    midx = _rows(torch.clamp_min(match, 0), idx)
    t_reg = encode(_rows(gt_boxes, midx), anchors[idx], RPN_WEIGHTS)
    sl1 = _smooth_l1(_rows(deltas, idx) - t_reg, 1.0 / 9.0)
    reg_l = (sl1.sum(-1) * pos_w).sum(1) / denom
    return obj_l, reg_l


def roi_sample(proposals, prop_valid, gt_boxes, gt_cls, gt_valid, u_pos,
               u_neg):
    """The RoI head's targets: the proposals plus the GT boxes matched at
    0.5 and sampled. Returns (best_gt (B, P + M), idx, weight, positive
    indicator (B, S), the sampled boxes (B, S, 4), their matched GT (B, S)
    and labels (B, S), 0 = background)."""
    boxes = torch.cat([proposals, gt_boxes], 1)  # (B, P + M, 4)
    bvalid = torch.cat([prop_valid, gt_valid], 1)
    iou = box_iou_safe(gt_boxes, boxes)  # (B, M, P + M)
    iou = torch.where(gt_valid[:, :, None] & bvalid[:, None, :], iou, -1.0)
    best_iou = iou.amax(dim=1)
    m = gt_boxes.shape[1]
    gt_idx = torch.arange(m, device=iou.device)[None, :, None]
    best_gt = torch.where(iou == best_iou[:, None, :], gt_idx, m).amin(1)
    matched = best_iou >= ROI_FG_IOU
    pos = matched & bvalid
    neg = ~matched & bvalid & (best_iou >= 0.0)
    idx, w, pos_w = _sample_balanced(pos, neg, u_pos, u_neg, ROI_SAMPLES,
                                     ROI_POS_FRACTION)
    midx = _rows(best_gt, idx)
    labels = torch.where(_rows(pos, idx), _rows(gt_cls.long(), midx), 0)
    return best_gt, idx, w, pos_w, _rows(boxes, idx), midx, labels


def roi_head_loss(net, feats, proposals, prop_valid, gt_boxes, gt_cls,
                  gt_valid, u_pos, u_neg, dtype=None):
    """Per image (classification loss (B,), regression loss (B,)) of the
    second stage.

    :param feats: the P2..P5 levels (B, C, H_l, W_l) in the compute dtype.
    :param proposals: (B, P, 4) f32 (no gradient); prop_valid (B, P).
    :param gt_cls: (B, M) 1-based ids (0 = background).
    :param dtype: the box head's compute dtype (None: f32).
    """
    _, idx, w, pos_w, sel_boxes, midx, labels = roi_sample(
        proposals, prop_valid, gt_boxes, gt_cls, gt_valid, u_pos, u_neg)
    b, s = idx.shape
    pooled = net.roi_align(feats, sel_boxes)
    cls_logits, reg = net.box_head(pooled, dtype)  # f32
    cls_logits = cls_logits.view(b, s, -1)
    reg = reg.view(b, s, -1, 4)
    logp = torch.log_softmax(cls_logits, -1)
    ce = -torch.gather(logp, 2, labels[..., None])[..., 0]
    denom = torch.clamp_min(w.sum(1), 1.0)
    cls_l = (ce * w).sum(1) / denom

    t_reg = encode(_rows(gt_boxes, midx), sel_boxes, BOX_WEIGHTS)
    reg_sel = torch.gather(
        reg, 2, labels[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    sl1 = _smooth_l1(reg_sel - t_reg, 1.0)
    reg_l = (sl1.sum(-1) * pos_w).sum(1) / denom
    return cls_l, reg_l


def rcnn_forward(net, images, dtype=None):
    """The differentiated trunk of a training step: (B, S, S, 3) images ->
    (FPN levels in ``dtype``, per-level objectness (B, A_l) and deltas
    (B, A_l, 4) in f32)."""
    feats = net.features(images if dtype is None else images.to(dtype))
    objs, regs = net.run_rpn(feats)
    return feats, objs, regs


def faster_rcnn_loss(net, feats, objs, regs, gt_boxes, gt_cls, gt_valid,
                     draws: Draws, dtype=None):
    """The two-stage training loss of a batch, from ``rcnn_forward``'s
    outputs: each part the mean over the images.

    dtype: the compute dtype of the trunk (``rcnn_forward``'s) and the box
    head; every decision stage (proposals, matching, sampling, box encode,
    the losses) is f32, as the reference's ``faster_rcnn_loss`` keeps it.

    :return: (total, {"rpn_obj", "rpn_reg", "cls", "reg"}).
    """
    b = gt_boxes.shape[0]
    _, anchors = net.anchors(gt_boxes.device)
    obj_l, rpn_reg_l = rpn_loss(torch.cat(objs, 1), torch.cat(regs, 1),
                                anchors, gt_boxes, gt_valid, draws.rpn_pos,
                                draws.rpn_neg)
    props, pvalid = net.proposals(objs, regs)  # no gradient
    cls_l, reg_l = roi_head_loss(net, feats[:4], props, pvalid, gt_boxes,
                                 gt_cls, gt_valid, draws.roi_pos,
                                 draws.roi_neg, dtype)
    parts = {k: (v / b).sum() for k, v in (("rpn_obj", obj_l),
                                            ("rpn_reg", rpn_reg_l),
                                            ("cls", cls_l), ("reg", reg_l))}
    total = parts["rpn_obj"] + parts["rpn_reg"] + parts["cls"] + parts["reg"]
    return total, parts
