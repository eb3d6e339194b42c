"""YOLOv5 training loss (fixed-shape target assignment, CIoU, BCE).

The reference package's ``yolo_loss``, op for op. Per detection level,
targets are assigned to the anchors whose wh ratio is below ``anchor_t`` in
the centre cell and up to two neighbour cells, as a fixed (T x na x 5)
candidate grid with validity masks; box regression is 1 - CIoU (its
``alpha`` detached), objectness is BCE against the detached IoU scattered
into the grid with max-combine (deterministic where two candidates land on
one cell), classification is one-hot BCE. Hyper-parameters are the yolov5
defaults: box 0.05, cls 0.5, obj 1.0, anchor_t 4.0, level balance
(4.0, 1.0, 0.4); the total is scaled by the batch size.

Under several processes each rank holds rows of one global batch: the
normalisers (matched candidates per level, grid cells, the batch size) are
summed over the ranks first, so the ranks' losses add up to the loss of
the global batch.
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import all_sum, world_size
from .yolov5 import STRIDES

HYP = dict(box=0.05, cls=0.5, obj=1.0, anchor_t=4.0)
BALANCE = (4.0, 1.0, 0.4)
# centre, left, top, right, bottom (x, y)
OFFSETS = ((0.0, 0.0), (-0.5, 0.0), (0.0, -0.5), (0.5, 0.0), (0.0, 0.5))


def bce_logits(logits, targets):
    """Elementwise BCE with logits, the reference's stable form."""
    return torch.clamp_min(logits, 0) - logits * targets + torch.log1p(
        torch.exp(-torch.abs(logits)))


def ciou(b1, b2, eps=1e-7):
    """Complete IoU between xywh-centre boxes (..., 4); ``alpha`` is held
    constant under differentiation."""
    b1xy, b1wh = b1[..., :2], b1[..., 2:4]
    b2xy, b2wh = b2[..., :2], b2[..., 2:4]
    lo = torch.maximum(b1xy - b1wh / 2, b2xy - b2wh / 2)
    hi = torch.minimum(b1xy + b1wh / 2, b2xy + b2wh / 2)
    wh = torch.clamp_min(hi - lo, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = (b1wh[..., 0] * b1wh[..., 1] + b2wh[..., 0] * b2wh[..., 1]
             - inter + eps)
    iou = inter / union
    # the enclosing box's diagonal
    clo = torch.minimum(b1xy - b1wh / 2, b2xy - b2wh / 2)
    chi = torch.maximum(b1xy + b1wh / 2, b2xy + b2wh / 2)
    d = (chi - clo) ** 2
    c2 = d[..., 0] + d[..., 1] + eps
    e = (b1xy - b2xy) ** 2
    rho2 = e[..., 0] + e[..., 1]
    v = (4 / math.pi ** 2) * (
        torch.atan(b2wh[..., 0] / (b2wh[..., 1] + eps))
        - torch.atan(b1wh[..., 0] / (b1wh[..., 1] + eps))) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - rho2 / c2 - alpha * v


def yolo_loss(net, heads, targets, target_valid):
    """Total loss (scalar) and its parts {box, obj, cls}, averaged like
    yolov5: per-level means, summed, the total scaled by the batch size.
    Under several processes: this rank's share of the global batch's loss
    and parts (their sums over the ranks are the global ones).

    :param net: the YoloV5 module (its anchors, ``na``, ``num_classes``).
    :param heads: per level the raw (B, H, W, na, no) f32 outputs.
    :param targets: (B, T, 5) rows [cls, x, y, w, h], normalised.
    :param target_valid: (B, T) bool.
    """
    b, _ = target_valid.shape
    spread = world_size() > 1
    na, nc = net.na, net.num_classes
    dev = targets.device
    f32 = heads[0].dtype
    offsets = torch.tensor(OFFSETS, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    lbox, lobj, lcls = zero, zero, zero
    for li, (head, stride, anchors) in enumerate(zip(heads, STRIDES,
                                                     net.anchors)):
        _, gh, gw, _, _ = head.shape
        anc = torch.tensor(anchors, dtype=f32, device=dev) / stride
        scale = torch.tensor([gw, gh], dtype=f32, device=dev)
        txy = targets[..., 1:3] * scale  # (B, T, 2), grid units
        twh = targets[..., 3:5] * scale
        tcls = targets[..., 0].to(torch.int32)

        # the anchor-ratio gate: (B, T, na)
        r = twh[:, :, None, :] / anc[None, None]
        ratio_ok = torch.amax(torch.maximum(r, 1.0 / r), dim=-1) \
            < HYP["anchor_t"]
        # the neighbour-offset gate: (B, T, 5)
        fx, fy = torch.remainder(txy[..., 0], 1.0), \
            torch.remainder(txy[..., 1], 1.0)
        gx, gy = txy[..., 0], txy[..., 1]
        off_ok = torch.stack([torch.ones_like(fx, dtype=torch.bool),
                              (fx < 0.5) & (gx > 1.0),
                              (fy < 0.5) & (gy > 1.0),
                              (fx >= 0.5) & (gx < gw - 1.0),
                              (fy >= 0.5) & (gy < gh - 1.0)], dim=-1)
        # the candidate grid: (B, T, na, 5)
        valid = (target_valid[:, :, None, None] & ratio_ok[:, :, :, None]
                 & off_ok[:, :, None, :]
                 & (twh.sum(-1) > 0)[:, :, None, None])
        cell = torch.floor(txy[:, :, None, None, :] - offsets)  # (B,T,1,5,2)
        shape = valid.shape
        gi = torch.clamp(cell[..., 0], 0, gw - 1).to(torch.int64) \
            .expand(shape)
        gj = torch.clamp(cell[..., 1], 0, gh - 1).to(torch.int64) \
            .expand(shape)
        bidx = torch.arange(b, device=dev)[:, None, None, None].expand(shape)
        aidx = torch.arange(na, device=dev)[None, None, :, None] \
            .expand(shape)
        p = head[bidx, gj, gi, aidx]  # (B, T, na, 5, no)

        pxy = torch.sigmoid(p[..., 0:2]) * 2.0 - 0.5
        pwh = (torch.sigmoid(p[..., 2:4]) * 2.0) ** 2 \
            * anc[None, None, :, None, :]
        rel_xy = txy[:, :, None, None, :] - torch.stack([gi, gj], -1).to(f32)
        pbox = torch.cat([pxy, pwh], -1)
        tbox = torch.cat([rel_xy, twh[:, :, None, None, :].expand(
            rel_xy.shape)], -1)
        iou = ciou(pbox, tbox)
        vf = valid.to(f32)
        nv = torch.clamp_min(all_sum(vf.sum()), 1.0)
        lbox = lbox + ((1.0 - iou) * vf).sum() / nv

        # the objectness target: the detached IoU, max-combined per cell
        iou_pos = torch.clamp_min(iou.detach(), 0.0) * vf
        cell_idx = ((bidx * gh + gj) * gw + gi) * na + aidx
        tobj = torch.zeros(b * gh * gw * na, dtype=f32, device=dev)
        tobj = tobj.scatter_reduce(0, cell_idx.reshape(-1),
                                   iou_pos.reshape(-1), "amax",
                                   include_self=True).reshape(b, gh, gw, na)
        bce = bce_logits(head[..., 4], tobj)
        lobj = lobj + (bce.sum() / all_sum(bce.numel()) if spread
                       else bce.mean()) * BALANCE[li]

        if nc > 1:
            cls_t = (tcls[:, :, None, None, None]
                     == torch.arange(nc, device=dev)).to(f32)
            lcls = lcls + (bce_logits(p[..., 5:], cls_t)
                           * vf[..., None]).sum() / (nv * nc)

    total = (HYP["box"] * lbox + HYP["obj"] * lobj + HYP["cls"] * lcls) \
        * all_sum(b)
    return total, {"box": lbox, "obj": lobj, "cls": lcls}
