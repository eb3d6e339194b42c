"""RetinaNet-ResNet50-FPN (v2) in PyTorch.

One of the reference's strong detectors. Structure per torchvision v2:
ResNet50-FPN with P6/P7 (``models/resnet.py``), shared heads of four 3x3
convs + GroupNorm(32) + ReLU per branch, 9 anchors per location (sizes
{2^0, 2^(1/3), 2^(2/3)} x 32..512 over P3..P7, aspect ratios 0.5/1/2), box
deltas with weights (1, 1, 1, 1). The tower convs carry the reference's
conv bias, added before the GroupNorm (``TowerConv``): zero at init and
after a torchvision import, but trained by the reference's train step. The
bias stays out of ``state_dict()``, whose layout is torchvision's (which
has no tower bias), and loading a state_dict sets it to zero; it is carried
by ``from_jax_params`` / ``to_jax_params`` and by checkpoints in the
reference's tree layout.

Module names follow torchvision's ``retinanet_resnet50_fpn_v2``
(``backbone``, ``head.classification_head.{conv,cls_logits}``,
``head.regression_head.{conv,bbox_reg}``). The forward takes NHWC images and
returns (cls_logits (B, A, C), reg (B, A, 4)), rows ordered level, h, w,
anchor; it is ``head_outputs(features(x))``, the backbone and FPN, then the
two towers and output convs, which serving runs as two spans.

Training (``retina_match``, ``encode_boxes``, ``retina_loss``): the
reference's matcher (0.5 / 0.4 with low-quality matches), sigmoid focal
loss (alpha 0.25, gamma 2) over the anchors not ignored and smooth-L1
(beta 1/9) box regression on the matched, each over the foreground count,
batched over the images where the reference vmaps.

Serving tail (``retina_postprocess``): the reference's raw-logit tail. The
top 2048 boxes by max-class score are chosen from the row max of the logits
(sigmoid is monotone, so the order is the same), and only their rows are
cast to f32 and go through sigmoid, decode and the exact batched NMS.
The prefilter runs in the span ``nms.prefilter``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..ops.metrics import box_iou_safe
from ..ops.nms import nms_split_batch, topk1d
from ..parallel.mesh import all_sum, world_size
from ..utils.profiling import span
from .common import (
    DtypeConv2d, DtypeGroupNorm, host_array, jax_conv, seeded_init_,
)
from .resnet import FPN_CHANNELS, ResNet50FPN

ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
SCALE_OCTAVES = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
NUM_ANCHORS = len(ASPECT_RATIOS) * len(SCALE_OCTAVES)
STRIDES = (8, 16, 32, 64, 128)
RETINA_PRE = 2048  # raw-tail box prefilter width == the NMS max_cand
RETINA_MAX_DET = 300  # rows an image keeps after the NMS
PRIOR_PROB = 0.01


def retina_anchors(image_size: int, strides=STRIDES):
    """(A, 4) f32 xyxy anchors over all FPN levels (torchvision's
    AnchorGenerator: cell centres at (i + 0.5) * stride, ratio-major order
    within a cell with scale fastest, aspect ratio = h / w)."""
    out = []
    for size, stride in zip(ANCHOR_SIZES, strides):
        f = math.ceil(image_size / stride)
        whs = []
        for r in ASPECT_RATIOS:
            for octave in SCALE_OCTAVES:
                s = size * octave
                whs.append((s / math.sqrt(r), s * math.sqrt(r)))
        whs = np.array(whs, np.float32)  # (9, 2)
        ys, xs = np.meshgrid(np.arange(f), np.arange(f), indexing="ij")
        cx = (xs.reshape(-1, 1) + 0.5) * stride
        cy = (ys.reshape(-1, 1) + 0.5) * stride
        c = np.stack([np.repeat(cx, 9, 1).reshape(-1),
                      np.repeat(cy, 9, 1).reshape(-1)], 1)
        wh = np.tile(whs, (f * f, 1))
        out.append(
            np.concatenate([c - wh / 2, c + wh / 2], axis=1).astype(np.float32))
    return np.concatenate(out)


class TowerConv(DtypeConv2d):
    """A head tower's 3x3 conv with the reference's bias, which
    torchvision's layout lacks: the bias is left out of ``state_dict()``,
    and a state_dict loaded into the module sets it to zero."""

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        destination.pop(prefix + "bias", None)

    def _load_from_state_dict(self, state_dict, prefix, local_metadata,
                              strict, missing_keys, unexpected_keys,
                              error_msgs):
        super()._load_from_state_dict(state_dict, prefix, local_metadata,
                                      strict, missing_keys, unexpected_keys,
                                      error_msgs)
        if prefix + "bias" in missing_keys:
            missing_keys.remove(prefix + "bias")
            with torch.no_grad():
                self.bias.zero_()


def _tower() -> nn.Sequential:
    return nn.Sequential(*(
        nn.Sequential(TowerConv(FPN_CHANNELS, FPN_CHANNELS, 3, 1, 1),
                      DtypeGroupNorm(32, FPN_CHANNELS))
        for _ in range(4)))


def _run_tower(tower, x):
    for conv, gn in tower:
        x = torch.relu(gn(conv(x)))
    return x


class RetinaNetClassificationHead(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.conv = _tower()
        self.cls_logits = DtypeConv2d(FPN_CHANNELS,
                                      NUM_ANCHORS * num_classes, 3, 1, 1)


class RetinaNetRegressionHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = _tower()
        self.bbox_reg = DtypeConv2d(FPN_CHANNELS, NUM_ANCHORS * 4, 3, 1, 1)


class RetinaNetHead(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.classification_head = RetinaNetClassificationHead(num_classes)
        self.regression_head = RetinaNetRegressionHead()


class RetinaNet(nn.Module):
    """RetinaNet-ResNet50-FPN-v2; ``num_classes`` covers every label id
    (no background column, sigmoid scores)."""

    def __init__(self, num_classes: int = 91, image_size: int = 640,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.image_size = image_size
        self.backbone = ResNet50FPN()
        self.head = RetinaNetHead(num_classes)
        self.reset_parameters(generator)
        self.eval()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Seeded init: conv weights uniform in +-1/sqrt(fan_in), conv
        biases zero but the focal-loss prior -log((1 - 0.01) / 0.01) on the
        class logits, GroupNorm and frozen BatchNorm identity (the
        reference's init)."""
        seeded_init_(self, generator)
        self.head.classification_head.cls_logits.bias.fill_(
            -math.log((1 - PRIOR_PROB) / PRIOR_PROB))

    def forward(self, x):
        """x: (B, S, S, 3) normalised images, NHWC; the compute dtype is
        x's. Returns (cls_logits (B, A, C), reg (B, A, 4)) in that dtype."""
        return self.head_outputs(self.features(x))

    def features(self, x):
        """Backbone and FPN: (B, S, S, 3) NHWC images -> [P3, .., P7]."""
        return self.backbone(x.permute(0, 3, 1, 2))

    def head_outputs(self, feats):
        """The two towers and output convs on every level, concatenated
        over the levels: (cls_logits (B, A, C), reg (B, A, 4))."""
        ch, rh = self.head.classification_head, self.head.regression_head
        cls_all, reg_all = [], []
        for f in feats:
            c = ch.cls_logits(_run_tower(ch.conv, f))
            r = rh.bbox_reg(_run_tower(rh.conv, f))
            b = c.shape[0]
            cls_all.append(c.permute(0, 2, 3, 1).reshape(b, -1,
                                                         self.num_classes))
            reg_all.append(r.permute(0, 2, 3, 1).reshape(b, -1, 4))
        return torch.cat(cls_all, 1), torch.cat(reg_all, 1)

    def anchors(self, device) -> torch.Tensor:
        """The (A, 4) f32 anchors on ``device``, cached."""
        cache = self.__dict__.setdefault("_anchors_on_device", {})
        key = str(device)
        if key not in cache:
            cache[key] = torch.from_numpy(
                retina_anchors(self.image_size)).to(device)
        return cache[key]

    @staticmethod
    def decode_boxes(reg, anchors):
        """(1, 1, 1, 1)-weighted deltas on xyxy anchors -> xyxy; anchors
        (A, 4) broadcast against (B, A, 4) deltas, or gathered (B, K, 4)
        rows. Log-size deltas are clipped at log(1000 / 16)."""
        acx = (anchors[..., 0] + anchors[..., 2]) * 0.5
        acy = (anchors[..., 1] + anchors[..., 3]) * 0.5
        aw = anchors[..., 2] - anchors[..., 0]
        ah = anchors[..., 3] - anchors[..., 1]
        clip = math.log(1000.0 / 16)
        cx = reg[..., 0] * aw + acx
        cy = reg[..., 1] * ah + acy
        w = torch.exp(torch.clamp(reg[..., 2], max=clip)) * aw
        h = torch.exp(torch.clamp(reg[..., 3], max=clip)) * ah
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                           -1)

    # ---- weights -----------------------------------------------------------

    @staticmethod
    def encode_boxes(gt, anchors):
        """xyxy boxes -> (1, 1, 1, 1)-weighted deltas on xyxy anchors (the
        inverse of ``decode_boxes``), GT widths and heights floored at
        1e-6; ``anchors`` broadcasts against ``gt``."""
        acx = (anchors[..., 0] + anchors[..., 2]) * 0.5
        acy = (anchors[..., 1] + anchors[..., 3]) * 0.5
        aw = anchors[..., 2] - anchors[..., 0]
        ah = anchors[..., 3] - anchors[..., 1]
        gcx = (gt[..., 0] + gt[..., 2]) * 0.5
        gcy = (gt[..., 1] + gt[..., 3]) * 0.5
        gw = torch.clamp_min(gt[..., 2] - gt[..., 0], 1e-6)
        gh = torch.clamp_min(gt[..., 3] - gt[..., 1], 1e-6)
        return torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                            torch.log(gw / aw), torch.log(gh / ah)], -1)

    # ---- weights -----------------------------------------------------------

    def _convs(self):
        """(head, tower key, output conv, output key) per branch."""
        return ((self.head.classification_head, "cls_tower",
                 self.head.classification_head.cls_logits, "cls_out"),
                (self.head.regression_head, "reg_tower",
                 self.head.regression_head.bbox_reg, "reg_out"))

    @torch.no_grad()
    def from_jax_params(self, params):
        """Fill the module from the reference package's parameter tree
        (nested dicts/lists of arrays, HWIO conv kernels), tower conv
        biases included."""

        def arr(a):
            return torch.from_numpy(np.array(a, dtype=np.float32))

        def conv(mod, p):
            mod.weight.copy_(arr(p["w"]).permute(3, 2, 0, 1))
            mod.bias.copy_(arr(p["b"]))

        self.backbone.from_jax_params(params["backbone"])
        for head, tower, out, out_key in self._convs():
            for (c, gn), p in zip(head.conv, params[tower]):
                conv(c, p)
                gn.weight.copy_(arr(p["gn"]["g"]))
                gn.bias.copy_(arr(p["gn"]["b"]))
            conv(out, params[out_key])
        return self

    @torch.no_grad()
    def to_jax_params(self):
        """(params, None): the reference package's parameter tree of this
        module (its frozen-norm family keeps no statistics tree), the
        exact inverse of ``from_jax_params``."""
        params = {"backbone": self.backbone.to_jax_params()}
        for head, tower, out, out_key in self._convs():
            params[tower] = [
                dict(jax_conv(c), gn={"g": host_array(gn.weight),
                                      "b": host_array(gn.bias)})
                for c, gn in head.conv]
            params[out_key] = jax_conv(out)
        return params, None


def retina_match(anchors, gt_boxes, gt_valid, hi: float = 0.5,
                 lo: float = 0.4):
    """The reference's Matcher(hi, lo, allow_low_quality_matches=True),
    batched: per image and anchor the matched GT index, -1 background, -2
    ignored (between the thresholds); anchors tying a GT's best IoU are
    matched to their own best GT.

    :param anchors: (A, 4) xyxy; gt_boxes (B, M, 4); gt_valid (B, M) bool.
    :return: (B, A) int64.
    """
    iou = box_iou_safe(gt_boxes, anchors.expand(gt_boxes.shape[0], -1, -1))
    iou = torch.where(gt_valid[:, :, None], iou, -1.0)  # (B, M, A)
    best_iou, best_gt = iou.max(dim=1)
    # max's index is not promised to be the first on ties: take it so
    m = gt_boxes.shape[1]
    gt_idx = torch.arange(m, device=iou.device)[None, :, None]
    best_gt = torch.where(iou == best_iou[:, None, :], gt_idx, m).amin(1)
    matches = torch.where(best_iou >= hi, best_gt,
                          torch.where(best_iou < lo, -1, -2))
    gt_best = iou.amax(dim=2, keepdim=True)  # (B, M, 1)
    low_q = ((iou == gt_best) & (gt_best > 0)
             & gt_valid[:, :, None]).any(dim=1)
    return torch.where(low_q, best_gt, matches)


def retina_loss(net, cls_logits, reg, anchors, gt_boxes, gt_cls, gt_valid):
    """Sigmoid focal classification over the anchors not ignored plus
    smooth-L1 regression on the matched, each over the image's foreground
    count, then averaged over the images of the global batch, as the
    reference computes them.

    Under several processes each rank passes its rows of the global batch
    and returns its share of the global mean (its per-image sums over the
    global image count, ``all_sum(b)``): the ranks' shares add up to the
    whole batch's loss. The foreground count stays per image, so nothing
    else spans the ranks. One process keeps ``.mean()``, as ``loss.py``
    keeps YOLOv5's, so its value is what it was bit for bit on any device.

    :param cls_logits: (B, A, C) f32; reg (B, A, 4) f32; anchors (A, 4).
    :param gt_boxes: (B, M, 4) xyxy pixels; gt_cls (B, M) label ids in the
        logits' columns (the engine passes 1-based ids into num_classes + 1
        columns); gt_valid (B, M) bool.
    :return: (total, {"classification", "bbox_regression"}).
    """
    alpha, gamma = 0.25, 2.0
    nc = cls_logits.shape[-1]
    match = retina_match(anchors, gt_boxes, gt_valid)  # (B, A)
    fg = match >= 0
    num_fg = torch.clamp_min(fg.sum(1), 1).to(cls_logits.dtype)  # (B,)
    midx = torch.clamp_min(match, 0)
    cls_m = torch.gather(gt_cls.long(), 1, midx)
    target = torch.nn.functional.one_hot(
        torch.where(fg, cls_m, nc), nc + 1)[..., :nc].to(cls_logits.dtype)
    cl = cls_logits
    p = torch.sigmoid(cl)
    ce = torch.clamp_min(cl, 0) - cl * target \
        + torch.log1p(torch.exp(-torch.abs(cl)))
    p_t = p * target + (1 - p) * (1 - target)
    a_t = alpha * target + (1 - alpha) * (1 - target)
    focal = a_t * (1 - p_t) ** gamma * ce
    consider = (match != -2).to(cl.dtype)
    cls_l = torch.sum(focal * consider[..., None], dim=(1, 2)) / num_fg

    gb = torch.gather(gt_boxes, 1, midx[..., None].expand(-1, -1, 4))
    d = reg - net.encode_boxes(gb, anchors)
    ad = torch.abs(d)
    sl1 = torch.where(ad < 1.0 / 9.0, 4.5 * d * d, ad - 1.0 / 18.0)
    box_l = torch.sum(sl1.sum(-1) * fg, dim=1) / num_fg
    if world_size() > 1:
        b = all_sum(cls_l.shape[0])
        cls_mean, box_mean = cls_l.sum() / b, box_l.sum() / b
    else:
        cls_mean, box_mean = cls_l.mean(), box_l.mean()
    return cls_mean + box_mean, {"classification": cls_mean,
                                 "bbox_regression": box_mean}


def retina_nms_inputs(net, cls_logits, reg, anchors, score_thresh: float):
    """The split NMS inputs of RetinaNet serving, after the raw-logit tail
    when there are more than RETINA_PRE anchors: rank boxes by
    sigmoid(rowmax(logits)) in f32 gated at ``score_thresh``, keep the top
    RETINA_PRE (stable order: ties to the lower index) and cast only those
    rows to f32. Accepts bf16 logits/reg.

    :return: (obj (B, N) ones, xywh (B, N, 4) pixel xywh-center f32, scores
        (B, N, C) sigmoid f32), N = min(A, RETINA_PRE).
    """
    if cls_logits.shape[1] > RETINA_PRE:
        with span("nms.prefilter"):
            rowmax = cls_logits.amax(dim=-1)  # exact in any dtype
            score = torch.sigmoid(rowmax.to(torch.float32))  # (B, A)
            box_score = torch.where(
                score > torch.full((), score_thresh, dtype=score.dtype,
                                   device=score.device), score, -1.0)
            _, idx = topk1d(box_score, RETINA_PRE)
            cls_logits = cls_logits.gather(
                1, idx[..., None].expand(-1, -1, cls_logits.shape[-1])
            ).to(torch.float32)
            reg = reg.gather(1, idx[..., None].expand(-1, -1, 4)).to(
                torch.float32)
            anchors = anchors[idx]  # (B, RETINA_PRE, 4)
    else:
        cls_logits = cls_logits.to(torch.float32)
        reg = reg.to(torch.float32)
    scores = torch.sigmoid(cls_logits)
    boxes = net.decode_boxes(reg, anchors)
    boxes = torch.clamp(boxes, 0.0, float(net.image_size))
    xywh = torch.cat([(boxes[..., :2] + boxes[..., 2:4]) * 0.5,
                      boxes[..., 2:4] - boxes[..., :2]], dim=-1)
    obj = torch.ones(scores.shape[:2], dtype=scores.dtype,
                     device=scores.device)
    return obj, xywh, scores


@torch.no_grad()
def retina_postprocess(net, cls_logits, reg, anchors,
                       score_thresh: float = 0.05, nms_thresh: float = 0.5,
                       max_det: int = RETINA_MAX_DET):
    """Sigmoid scores -> threshold -> decode -> class-aware NMS, through the
    raw-logit tail (``retina_nms_inputs``).

    :return: (dets (B, max_det, 6) [x1, y1, x2, y2, score, cls], valid).
    """
    return nms_split_batch(
        *retina_nms_inputs(net, cls_logits, reg, anchors, score_thresh),
        conf_thres=score_thresh, iou_thres=nms_thresh, max_det=max_det,
        max_cand=RETINA_PRE, multi_label=True)
