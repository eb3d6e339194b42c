"""Faster R-CNN-ResNet50-FPN (v2) in PyTorch: fixed-width two-stage serving.

The reference's strongest detector (torchvision's
``fasterrcnn_resnet50_fpn_v2``). Structure: ResNet50-FPN over C2..C5 with
BatchNorm in the FPN and a 1x1 stride-2 max-pooled extra level
(``models/resnet.py``); a two-conv RPN head with 3 anchors per cell (sizes
32..512 over P2..pool, aspect ratios 0.5/1/2); multi-scale RoIAlign (7x7,
sampling ratio 2, canonical level mapping over P2..P5); a box head of four
3x3 conv + BatchNorm + ReLU layers and a 1024-wide fc; per-class box
regression with (10, 10, 5, 5) weights.

Serving, with every decision in f32 (``FasterRCNN.detect``):

  * proposals: per level the top 1000 objectness logits (stable order),
    their deltas and anchors gathered (``ops/gather.py``, one launch each for
    all levels), decoded, clipped, degenerate boxes dropped, sigmoid scores;
    then ONE launch of the sequential suppressor (``ops/nms_seq.py``) over
    all (image, level) segments, each padded to 1000 with dead scores, at
    IoU 0.7; then the global top 1000;
  * RoIAlign in the reference's "patch" form, image by image (the bilinear
    expansion of 1000 proposals is 0.8 GB at f32), over a bf16 pyramid with
    bf16 weighting under f32 serving (the reference's serving defaults;
    ``pyr_dtype=None`` gives the strict f32 form);
  * the box head over the whole batch, softmax scores, per-class decode,
    the score gate, and ``ops/nms.py nms_rows`` over the 90,000 (proposal,
    class) rows of an image: top 2048, the blocked suppressor kernel.

Module names follow torchvision (``backbone``, ``rpn.head.conv.{0,1}.0``,
``rpn.head.cls_logits``, ``rpn.head.bbox_pred``, ``roi_heads.box_head.{0..3,
5}``, ``roi_heads.box_predictor.{cls_score,bbox_pred}``), so a torchvision
state_dict loads by key. Training (``models/rcnn_loss.py``) runs the same
stages under autograd; every norm of the model is frozen (the body's
``FrozenBatchNorm2d``, and the FPN's and box head's identity norms, which
hold the reference's conv biases), and under bf16 every parameter, the
frozen statistics included, is cast as the reference casts its whole tree.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..ops.gather import gather_rows
from ..ops.nms import _scalar, nms_rows, topk1d
from ..ops.nms_seq import suppress_mask_seq
from ..utils.profiling import span
from .common import (
    ConvNormAct, DtypeConv2d, DtypeLinear, FrozenBatchNorm2d, host_array,
    jax_conv, load_jax_conv, seeded_init_,
)
from .resnet import FPN_CHANNELS, ResNet50FPN

RPN_STRIDES = (4, 8, 16, 32)  # P2..P5; + the pooled level (stride 64)
RPN_SIZES = (32, 64, 128, 256)  # + 512 on the pooled level
ASPECT_RATIOS = (0.5, 1.0, 2.0)
ROI_STRIDES = (4, 8, 16, 32)  # RoIAlign levels: P2..P5
RPN_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
PRE_NMS = 1000  # proposals per level entering the RPN suppressor
RPN_NMS_THRESH = 0.7
ROI_OUT = 7
ROI_SAMPLING = 2
ROI_PYR = torch.bfloat16
"""Serving RoIAlign pyramid dtype under f32 serving (the reference's
``ROI_PYR="bf16"`` default, with bf16 bilinear weighting, ``ROI_W16``)."""


def rpn_anchors(image_size: int):
    """Per-level (A_l, 4) f32 xyxy anchors for P2..P5 and the pooled level
    (3 per cell, one size per level, torchvision's default anchor
    generator: aspect ratio = h / w)."""
    out = []
    strides = list(RPN_STRIDES) + [RPN_STRIDES[-1] * 2]
    sizes = list(RPN_SIZES) + [512]
    for size, stride in zip(sizes, strides):
        f = math.ceil(image_size / stride)
        whs = np.array([(size / math.sqrt(r), size * math.sqrt(r))
                        for r in ASPECT_RATIOS], np.float32)
        ys, xs = np.meshgrid(np.arange(f), np.arange(f), indexing="ij")
        cx = (xs.reshape(-1, 1) + 0.5) * stride
        cy = (ys.reshape(-1, 1) + 0.5) * stride
        c = np.stack([np.repeat(cx, 3, 1).reshape(-1),
                      np.repeat(cy, 3, 1).reshape(-1)], 1)
        wh = np.tile(whs, (f * f, 1))
        out.append(
            np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32))
    return out


def decode(reg, anchors, weights):
    """Weighted deltas on xyxy reference boxes -> xyxy boxes; log-size
    deltas clipped at log(1000 / 16). ``anchors`` broadcasts against
    ``reg``."""
    wx, wy, ww, wh = weights
    acx = (anchors[..., 0] + anchors[..., 2]) * 0.5
    acy = (anchors[..., 1] + anchors[..., 3]) * 0.5
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    clip = math.log(1000.0 / 16)
    cx = reg[..., 0] / wx * aw + acx
    cy = reg[..., 1] / wy * ah + acy
    w = torch.exp(torch.clamp(reg[..., 2] / ww, max=clip)) * aw
    h = torch.exp(torch.clamp(reg[..., 3] / wh, max=clip)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def encode(gt, anchors, weights):
    """xyxy boxes -> weighted deltas on xyxy reference boxes (the inverse of
    ``decode``); reference and GT widths and heights floored at 1e-6, so a
    degenerate (zero-padded) reference box gives finite targets that the
    losses' zero weights remove."""
    wx, wy, ww, wh = weights
    acx = (anchors[..., 0] + anchors[..., 2]) * 0.5
    acy = (anchors[..., 1] + anchors[..., 3]) * 0.5
    aw = torch.clamp_min(anchors[..., 2] - anchors[..., 0], 1e-6)
    ah = torch.clamp_min(anchors[..., 3] - anchors[..., 1], 1e-6)
    gcx = (gt[..., 0] + gt[..., 2]) * 0.5
    gcy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = torch.clamp_min(gt[..., 2] - gt[..., 0], 1e-6)
    gh = torch.clamp_min(gt[..., 3] - gt[..., 1], 1e-6)
    return torch.stack([wx * (gcx - acx) / aw, wy * (gcy - acy) / ah,
                        ww * torch.log(gw / aw), wh * torch.log(gh / ah)], -1)


def _pyramid(feats, pyr_dtype=None):
    """(B, C, H_l, W_l) levels -> (B, sum H_l, W_0, C): channels last,
    levels stacked along rows, each padded to the first level's width."""
    w0 = feats[0].shape[-1]
    rows = []
    for f in feats:
        if pyr_dtype is not None:
            f = f.to(pyr_dtype)
        f = f.permute(0, 2, 3, 1)
        if f.shape[2] < w0:
            f = torch.nn.functional.pad(f, (0, 0, 0, w0 - f.shape[2]))
        rows.append(f)
    return torch.cat(rows, 1)


def _roi_align_pyr(pyr, boxes, heights, widths):
    """RoIAlign of one image's (N, 4) boxes on its (sum H_l, W_0, C)
    pyramid -> (N, 7, 7, C), in the reference's "patch" form: each box
    on its canonical level only, one (2, 2, C) patch per sample point at
    the shifted corner (y0', x0'), bilinear weights (1 - ly', ly') x
    (1 - lx', lx'). Over a bf16 pyramid the weighting runs in bf16 and the
    sample mean in f32, rounded once to bf16."""
    dev = boxes.device
    n = boxes.shape[0]
    ch = pyr.shape[-1]
    out, sampling = ROI_OUT, ROI_SAMPLING
    if n == 0:
        return pyr.new_zeros((0, out, out, ch))
    f32 = torch.float32
    areas = torch.clamp_min(
        (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), 1e-6)
    two = torch.full((), 2.0, dtype=f32, device=dev)
    # log2 as the reference computes it: log(x) / log(2)
    lvl = torch.floor(4.0 + torch.log(torch.sqrt(areas) / 224.0 + 1e-9)
                      / torch.log(two))
    ki = (torch.clamp(lvl, 2.0, 5.0) - 2.0).long()
    row_off = np.cumsum([0] + list(heights[:-1]))
    stride = torch.tensor(ROI_STRIDES, dtype=f32, device=dev)[ki]
    hl = torch.tensor(heights, dtype=f32, device=dev)[ki]
    wl = torch.tensor(widths, dtype=f32, device=dev)[ki]
    ro = torch.tensor(row_off, dtype=torch.long, device=dev)[ki]

    b = boxes / stride[:, None]
    w = torch.clamp_min(b[:, 2] - b[:, 0], 1.0)
    h = torch.clamp_min(b[:, 3] - b[:, 1], 1.0)
    bin_h = (h / out)[:, None, None]
    bin_w = (w / out)[:, None, None]
    iy = (torch.arange(sampling, dtype=f32, device=dev) + 0.5)[None, None]
    py = torch.arange(out, dtype=f32, device=dev)[None, :, None]
    ys = b[:, 1, None, None] + py * bin_h + iy * bin_h / sampling
    xs = b[:, 0, None, None] + py * bin_w + iy * bin_w / sampling
    zero = torch.zeros((), dtype=f32, device=dev)
    yc = torch.minimum(torch.maximum(ys, zero), (hl - 1)[:, None, None])
    xc = torch.minimum(torch.maximum(xs, zero), (wl - 1)[:, None, None])
    hi = (hl.long() - 1)[:, None, None]
    wi = (wl.long() - 1)[:, None, None]
    y0p = torch.clamp_min(torch.minimum(torch.floor(yc).long(), hi - 1), 0)
    x0p = torch.clamp_min(torch.minimum(torch.floor(xc).long(), wi - 1), 0)
    ly = (yc - y0p)[:, :, :, None, None, None]  # (n, out, s, 1, 1, 1)
    lx = (xc - x0p)[:, None, None, :, :, None]  # (n, 1, 1, out, s, 1)
    if pyr.dtype == torch.bfloat16:
        ly, lx = ly.to(pyr.dtype), lx.to(pyr.dtype)

    w0 = pyr.shape[1]
    flat = pyr.reshape(-1, ch)
    r = (ro[:, None, None] + y0p)[:, :, :, None, None]  # (n, out, s, 1, 1)
    c = x0p[:, None, None]  # (n, 1, 1, out, s)

    def corner(dy, dx):
        return flat[((r + dy) * w0 + (c + dx)).reshape(-1)].reshape(
            n, out, sampling, out, sampling, ch)

    val = corner(0, 0) * (1 - ly) * (1 - lx)
    val = val + corner(0, 1) * (1 - ly) * lx
    val = val + corner(1, 0) * ly * (1 - lx)
    val = val + corner(1, 1) * ly * lx
    return val.sum(dim=(2, 4), dtype=f32).div_(sampling * sampling).to(
        val.dtype)


def roi_align_fpn(feats, boxes, pyr_dtype=None):
    """Multi-scale RoIAlign of one image: (N, 4) xyxy boxes -> (N, 7, 7, C),
    the reference's layout and semantics (7x7 bins, 2x2 samples each,
    canonical level mapping k = floor(4 + log2(sqrt(area) / 224)) clamped
    to P2..P5).

    :param feats: the (H_l, W_l, C) maps of P2..P5, channels last.
    :param pyr_dtype: None for the strict f32 form, torch.bfloat16 for the
        serving form (bf16 pyramid and weighting).
    """
    pyr = _pyramid([f.permute(2, 0, 1)[None] for f in feats], pyr_dtype)[0]
    return _roi_align_pyr(pyr, boxes, [f.shape[0] for f in feats],
                          [f.shape[1] for f in feats])


class RPNHead(nn.Module):
    """Two 3x3 conv + ReLU layers (with biases), then 1x1 objectness and
    delta convs, shared over the levels."""

    def __init__(self):
        super().__init__()
        a = len(ASPECT_RATIOS)  # anchors per cell
        self.conv = nn.Sequential(*(
            nn.Sequential(DtypeConv2d(FPN_CHANNELS, FPN_CHANNELS, 3, 1, 1))
            for _ in range(2)))
        self.cls_logits = DtypeConv2d(FPN_CHANNELS, a, 1)
        self.bbox_pred = DtypeConv2d(FPN_CHANNELS, a * 4, 1)

    def forward(self, feats):
        """Per level (obj logits (B, A_l), deltas (B, A_l, 4)), rows ordered
        h, w, anchor."""
        objs, regs = [], []
        for f in feats:
            h = f
            for (conv,) in self.conv:
                h = torch.relu(conv(h))
            o = self.cls_logits(h)
            r = self.bbox_pred(h)
            b = o.shape[0]
            objs.append(o.permute(0, 2, 3, 1).reshape(b, -1))
            regs.append(r.permute(0, 2, 3, 1).reshape(b, -1, 4))
        return objs, regs


class RegionProposalNetwork(nn.Module):
    def __init__(self):
        super().__init__()
        self.head = RPNHead()


class FastRCNNPredictor(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.cls_score = DtypeLinear(1024, num_classes)
        self.bbox_pred = DtypeLinear(1024, num_classes * 4)


class RoIHeads(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.box_head = nn.Sequential(
            *(ConvNormAct(FPN_CHANNELS, FPN_CHANNELS, 3, act="relu",
                          eps=1e-5, frozen=True) for _ in range(4)),
            nn.Flatten(),
            DtypeLinear(FPN_CHANNELS * ROI_OUT * ROI_OUT, 1024),
            nn.ReLU())
        self.box_predictor = FastRCNNPredictor(num_classes)


class FasterRCNN(nn.Module):
    """Faster R-CNN-ResNet50-FPN-v2 serving. ``num_classes`` includes the
    background class 0; detections carry the background-inclusive ids."""

    def __init__(self, num_classes: int = 91, image_size: int = 640,
                 rpn_post_nms: int = 1000, detections_per_img: int = 100,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.image_size = image_size
        self.rpn_post_nms = rpn_post_nms
        self.detections_per_img = detections_per_img
        self.backbone = ResNet50FPN(extra="maxpool", first_stage=0,
                                    fpn_norm=True)
        self.rpn = RegionProposalNetwork()
        self.roi_heads = RoIHeads(num_classes)
        for m in self.modules():
            if isinstance(m, FrozenBatchNorm2d):
                m.cast_stats = True
        self.reset_parameters(generator)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Seeded init as the reference's: conv weights uniform in
        +-1/sqrt(fan_in), BatchNorm identity (the FPN's and box head's norms
        exact: var 1 - eps, so conv + norm is conv + bias), the fc uniform
        in +-1/sqrt(12544), class and box predictors normal with std 0.01
        and 0.001, every bias zero."""
        seeded_init_(self, generator)
        for m in self.modules():
            if isinstance(m, ConvNormAct) and m.frozen:
                m[1].running_var.fill_(
                    float(np.float32(1.0) - np.float32(m[1].eps)))
        fc = self.roi_heads.box_head[5]
        bound = 1.0 / math.sqrt(fc.in_features)
        fc.weight.copy_(torch.empty(fc.weight.shape).uniform_(
            -bound, bound, generator=generator))
        pred = self.roi_heads.box_predictor
        for lin, std in ((pred.cls_score, 0.01), (pred.bbox_pred, 0.001)):
            lin.weight.copy_(torch.randn(lin.weight.shape,
                                         generator=generator) * std)
        for lin in (fc, pred.cls_score, pred.bbox_pred):
            lin.bias.zero_()

    def anchors(self, device):
        """The per-level (A_l, 4) f32 anchors and their concatenation, on
        ``device``, cached."""
        cache = self.__dict__.setdefault("_anchors_on_device", {})
        key = str(device)
        if key not in cache:
            levels = [torch.from_numpy(a).to(device)
                      for a in rpn_anchors(self.image_size)]
            cache[key] = (levels, torch.cat(levels))
        return cache[key]

    # ---- stages ------------------------------------------------------------

    def features(self, x):
        """(B, S, S, 3) normalised images, NHWC, in the compute dtype ->
        the FPN levels [P2, .., P5, pool], NCHW."""
        return self.backbone(x.permute(0, 3, 1, 2))

    def run_rpn(self, feats):
        """Per level (obj logits (B, A_l), deltas (B, A_l, 4)) in f32."""
        objs, regs = self.rpn.head(feats)
        return ([o.to(torch.float32) for o in objs],
                [r.to(torch.float32) for r in regs])

    @torch.no_grad()
    def proposals(self, objs, regs):
        """Fixed-width proposal selection for the batch.

        :param objs: per level (B, A_l) f32 objectness logits.
        :param regs: per level (B, A_l, 4) f32 deltas.
        :return: (boxes (B, P, 4) f32, valid (B, P) bool), P =
            ``rpn_post_nms``.
        """
        dev = objs[0].device
        b = objs[0].shape[0]
        _, anc_all = self.anchors(dev)
        ks, scores, idx = [], [], []
        off = 0
        for o in objs:
            k = min(PRE_NMS, o.shape[1])
            s, i = topk1d(o, k)
            ks.append(k)
            scores.append(s)
            idx.append(i + off)
            off += o.shape[1]
        scores = torch.cat(scores, 1)
        idx = torch.cat(idx, 1)  # (B, sum k) rows of the level concatenation
        deltas = gather_rows(torch.cat(regs, 1), idx)
        anc = gather_rows(anc_all.expand(b, -1, -1), idx)
        boxes = torch.clamp(decode(deltas, anc, RPN_WEIGHTS), 0.0,
                            float(self.image_size))
        ok = (boxes[..., 2] - boxes[..., 0] > 1e-3) \
            & (boxes[..., 3] - boxes[..., 1] > 1e-3)
        # sigmoid is monotone and > 0; dropped boxes score 0 (never live)
        p = torch.where(ok, torch.sigmoid(scores), 0.0)

        # one suppressor launch: every (image, level) a segment of kmax
        kmax = max(ks)
        seg_boxes = boxes.new_zeros((b, len(ks), kmax, 4))
        seg_p = p.new_zeros((b, len(ks), kmax))
        starts = np.cumsum([0] + ks)
        for li, k in enumerate(ks):
            seg_boxes[:, li, :k] = boxes[:, starts[li]:starts[li + 1]]
            seg_p[:, li, :k] = p[:, starts[li]:starts[li + 1]]
        with span("nms.suppress"):
            kept, _ = suppress_mask_seq(seg_boxes.view(-1, kmax, 4),
                                        seg_p.view(-1, kmax), RPN_NMS_THRESH,
                                        kmax)
        kept = kept.view(b, len(ks), kmax)
        kept = torch.cat([kept[:, li, :k] for li, k in enumerate(ks)], 1)

        level_scores = torch.where(kept, p, -torch.inf)
        top, top_idx = topk1d(level_scores,
                              min(self.rpn_post_nms, idx.shape[1]))
        return gather_rows(boxes, top_idx), top > -torch.inf

    def roi_align(self, feats, boxes, pyr_dtype=None):
        """RoIAlign of every image's proposals, image by image: feats the
        P2..P5 levels (B, C, H_l, W_l), boxes (B, P, 4) -> (B * P, C, out,
        out), in the pyramid's dtype."""
        pyr = _pyramid(feats, pyr_dtype)
        heights = [f.shape[2] for f in feats]
        widths = [f.shape[3] for f in feats]
        pooled = torch.cat([_roi_align_pyr(pyr[bi], boxes[bi], heights,
                                           widths)
                            for bi in range(boxes.shape[0])])
        return pooled.permute(0, 3, 1, 2)

    def box_head(self, pooled, dtype=None):
        """(R, C, 7, 7) pooled features -> (cls logits (R, classes), deltas
        (R, classes, 4)), f32, the head run in ``dtype`` (None: f32)."""
        rh = self.roi_heads
        h = rh.box_head(pooled.to(dtype or torch.float32))
        cls = rh.box_predictor.cls_score(h).to(torch.float32)
        reg = rh.box_predictor.bbox_pred(h).to(torch.float32)
        return cls, reg.reshape(-1, self.num_classes, 4)

    def postprocess(self, cls, reg, boxes, valid, score_thresh: float = 0.05,
                    nms_thresh: float = 0.5):
        """Softmax scores, per-class decode and clip, the score gate, then
        class-aware NMS over each image's (proposal, class) rows.

        :param cls: (B, P, classes) f32 logits; reg: (B, P, classes, 4).
        :return: (dets (B, D, 6) [x1, y1, x2, y2, score, cls], valid (B, D)),
            cls in the background-inclusive ids.
        """
        b, p, nc1 = cls.shape
        nc = nc1 - 1
        scores = torch.softmax(cls, -1)[..., 1:]
        dec = decode(reg[:, :, 1:, :], boxes[:, :, None, :], BOX_WEIGHTS)
        dec = torch.clamp(dec, 0.0, float(self.image_size))
        scores = torch.where(valid[..., None], scores, 0.0)
        flat = torch.where(scores > _scalar(score_thresh, scores), scores,
                           0.0).reshape(b, -1)
        flat_cls = torch.arange(nc, dtype=torch.float32,
                                device=cls.device).repeat(p)
        dets, dvalid = nms_rows(dec.reshape(b, -1, 4), flat,
                                flat_cls.expand(b, -1), nms_thresh,
                                self.detections_per_img)
        dets[..., 5] += dvalid.to(dets.dtype)  # +1 for the background id
        return dets, dvalid

    @torch.no_grad()
    def detect(self, x, score_thresh: float = 0.05, nms_thresh: float = 0.5,
               dtype=None):
        """(B, S, S, 3) normalised f32 images -> (dets (B, D, 6), valid).

        dtype: None (f32) or torch.bfloat16 for the backbone, RPN head,
        RoIAlign and box head; every decision (proposal decode, top-k and
        suppression, softmax, box decode, final NMS) stays f32."""
        with span("detect.trunk"):
            feats = self.features(x if dtype is None else x.to(dtype))
            objs, regs = self.run_rpn(feats)
        with span("detect.proposals"):
            boxes, valid = self.proposals(objs, regs)
        with span("detect.roi_align"):
            pooled = self.roi_align(feats[:4], boxes,
                                    ROI_PYR if dtype is None else None)
        with span("detect.box_head"):
            cls, reg = self.box_head(pooled, dtype)
        b, p = valid.shape
        with span("detect.postprocess"):
            return self.postprocess(cls.view(b, p, -1),
                                    reg.view(b, p, -1, 4), boxes, valid,
                                    score_thresh, nms_thresh)

    # ---- weights -----------------------------------------------------------

    @torch.no_grad()
    def from_jax_params(self, params):
        """Fill the module from the reference package's parameter tree. Its
        box head convs carry biases where torchvision has BatchNorm: each
        norm becomes an exact identity that adds the bias
        (``common.load_jax_conv``). The fc's input is re-ordered from the
        reference's (H, W, C)-major flatten to torch's (C, H, W)."""

        def arr(a):
            return torch.from_numpy(np.array(a, dtype=np.float32))

        self.backbone.from_jax_params(params["backbone"])
        head = self.rpn.head
        rp = params["rpn"]
        load_jax_conv(head.conv[0][0], rp["conv1"])
        load_jax_conv(head.conv[1][0], rp["conv2"])
        load_jax_conv(head.cls_logits, rp["cls"])
        load_jax_conv(head.bbox_pred, rp["reg"])
        bh = params["box_head"]
        box_head = self.roi_heads.box_head
        for blk, p in zip(box_head, bh["convs"]):
            load_jax_conv(blk[0], p, blk[1])
        fc = box_head[5]
        w = arr(bh["fc"]["w"])  # (7 * 7 * C, 1024), (H, W, C)-major
        fc.weight.copy_(w.reshape(ROI_OUT, ROI_OUT, FPN_CHANNELS, -1)
                        .permute(3, 2, 0, 1).reshape(fc.weight.shape))
        fc.bias.copy_(arr(bh["fc"]["b"]))
        pred = self.roi_heads.box_predictor
        for lin, key in ((pred.cls_score, "cls"), (pred.bbox_pred, "reg")):
            lin.weight.copy_(arr(bh[key]["w"]).T)
            lin.bias.copy_(arr(bh[key]["b"]))
        return self

    @torch.no_grad()
    def to_jax_params(self):
        """(params, None): the reference package's parameter tree of this
        module (its frozen-norm family keeps no statistics tree), the exact
        inverse of ``from_jax_params``: the identity norms' biases back on
        their convs, the fc back in the (H, W, C)-major flatten."""
        head = self.rpn.head
        rpn = {"conv1": jax_conv(head.conv[0][0]),
               "conv2": jax_conv(head.conv[1][0]),
               "cls": jax_conv(head.cls_logits),
               "reg": jax_conv(head.bbox_pred)}
        box_head = self.roi_heads.box_head
        fc = box_head[5]
        w = fc.weight.reshape(-1, FPN_CHANNELS, ROI_OUT, ROI_OUT)
        pred = self.roi_heads.box_predictor
        bh = {"convs": [jax_conv(blk[0], blk[1]) for blk in box_head[:4]],
              "fc": {"w": host_array(w.permute(2, 3, 1, 0).reshape(
                  -1, fc.weight.shape[0])), "b": host_array(fc.bias)},
              "cls": {"w": host_array(pred.cls_score.weight.T),
                      "b": host_array(pred.cls_score.bias)},
              "reg": {"w": host_array(pred.bbox_pred.weight.T),
                      "b": host_array(pred.bbox_pred.bias)}}
        return {"backbone": self.backbone.to_jax_params(), "rpn": rpn,
                "box_head": bh}, None
