"""RetinaNet-ResNet50-FPN (v2) in PyTorch.

One of the reference's strong detectors. Structure per torchvision v2:
ResNet50-FPN with P6/P7 (``models/resnet.py``), shared heads of four 3x3
convs + GroupNorm(32) + ReLU per branch, 9 anchors per location (sizes
{2^0, 2^(1/3), 2^(2/3)} x 32..512 over P3..P7, aspect ratios 0.5/1/2), box
deltas with weights (1, 1, 1, 1). torchvision's tower convs carry no bias
(GroupNorm follows); the reference's are zero at init and after its
torchvision import, so ``from_jax_params`` refuses nonzero ones.

Module names follow torchvision's ``retinanet_resnet50_fpn_v2``
(``backbone``, ``head.classification_head.{conv,cls_logits}``,
``head.regression_head.{conv,bbox_reg}``). The forward takes NHWC images and
returns (cls_logits (B, A, C), reg (B, A, 4)), rows ordered level, h, w,
anchor.

Serving tail (``retina_postprocess``): the reference's raw-logit tail. The
top 2048 boxes by max-class score are chosen from the row max of the logits
(sigmoid is monotone, so the order is the same), and only their rows are
cast to f32 and go through sigmoid, decode and the exact batched NMS.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..ops.nms import nms_split_batch, topk1d
from .common import DtypeConv2d, DtypeGroupNorm, seeded_init_
from .resnet import FPN_CHANNELS, ResNet50FPN

ANCHOR_SIZES = (32, 64, 128, 256, 512)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
SCALE_OCTAVES = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
NUM_ANCHORS = len(ASPECT_RATIOS) * len(SCALE_OCTAVES)
STRIDES = (8, 16, 32, 64, 128)
RETINA_PRE = 2048  # raw-tail box prefilter width == the NMS max_cand
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


def _tower() -> nn.Sequential:
    return nn.Sequential(*(
        nn.Sequential(DtypeConv2d(FPN_CHANNELS, FPN_CHANNELS, 3, 1, 1,
                                  bias=False),
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
        feats = self.backbone(x.permute(0, 3, 1, 2))
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

    @torch.no_grad()
    def from_jax_params(self, params):
        """Fill the module from the reference package's parameter tree
        (nested dicts/lists of arrays, HWIO conv kernels). Raises if a tower
        conv carries a nonzero bias, which torchvision's layout cannot
        hold."""

        def arr(a):
            return torch.from_numpy(np.array(a, dtype=np.float32))

        def conv(mod, p):
            mod.weight.copy_(arr(p["w"]).permute(3, 2, 0, 1))
            if mod.bias is not None:
                mod.bias.copy_(arr(p["b"]))

        self.backbone.from_jax_params(params["backbone"])
        for head, tower, out, out_key in (
                (self.head.classification_head, "cls_tower", "cls_logits",
                 "cls_out"),
                (self.head.regression_head, "reg_tower", "bbox_reg",
                 "reg_out")):
            for (c, gn), p in zip(head.conv, params[tower]):
                if np.any(np.asarray(p["b"]) != 0):
                    raise ValueError(
                        f"{tower}: nonzero tower conv bias; torchvision's "
                        f"RetinaNet head has no bias there")
                conv(c, p)
                gn.weight.copy_(arr(p["gn"]["g"]))
                gn.bias.copy_(arr(p["gn"]["b"]))
            conv(getattr(head, out), params[out_key])
        return self


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
                       max_det: int = 300):
    """Sigmoid scores -> threshold -> decode -> class-aware NMS, through the
    raw-logit tail (``retina_nms_inputs``).

    :return: (dets (B, max_det, 6) [x1, y1, x2, y2, score, cls], valid).
    """
    return nms_split_batch(
        *retina_nms_inputs(net, cls_logits, reg, anchors, score_thresh),
        conf_thres=score_thresh, iou_thres=nms_thresh, max_det=max_det,
        max_cand=RETINA_PRE, multi_label=True)
