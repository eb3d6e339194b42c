"""Frozen plain reference of RetinaNet-ResNet50-FPN-v2 serving.

torchvision's ``retinanet_resnet50_fpn_v2`` (focal loss and RetinaNet:
arXiv:1708.02002): a ResNet50 body (v1.5, frozen BatchNorm), an FPN of 256
channels over C3..C5 whose lateral and output convs carry biases and no
norm, P6 as a 3x3 stride-2 conv on C5 and P7 as one on relu(P6)
(``LastLevelP6P7(2048, 256)``), so levels P3..P7; two towers shared by the
levels, each of four 3x3 256->256 convs without bias, each followed by
GroupNorm(32) and ReLU; a 3x3 class conv of 9 anchors x ``num_classes``
outputs and a 3x3 box conv of 9 x 4; 9 anchors a cell (sizes 32..512 times
{2^0, 2^(1/3), 2^(2/3)}, aspect ratios h / w 0.5, 1, 2, ratio-major with the
scale fastest); box deltas with weights (1, 1, 1, 1), log-size deltas
clipped at log(1000 / 16); sigmoid scores. Parameters are a flat state dict
in torchvision's key names.

Serving follows the JAX package that the port mirrors, where it departs
from torchvision:

- the input is a 640x640 square resize normalised with ImageNet's mean and
  std (torchvision resizes to min side 800, max side 1333);
- anchor centres lie at (i + 0.5) * stride and the anchor sizes are not
  rounded (torchvision: i * stride, rounded sizes);
- the tail is global over the image: the top ``prefilter_top_n`` anchor
  rows by sigmoid(row max of the raw logits), gated at ``conf_thres``
  (torchvision: the top 1000 a level above ``score_thresh`` 0.05); then
  sigmoid scores, decode and clamp to the input; the boxes pass through
  centre-size form, as the split NMS takes them; the rows ranked by their
  best score, every (row, class) pair above ``conf_thres`` ranked, ties to
  the lower (row, class), the top ``prefilter_top_n`` pairs kept;
  class-aware greedy NMS at ``iou_thres`` (torchvision 0.5) and at most
  ``detections_per_img`` rows.

Rows are (cls, x, y, w, h, conf) normalised to the input, ``cls`` the
logit column.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .common import MAX_WH, calibrate_stats, compact, frozen_bn, greedy_nms, stable_desc
from .faster_rcnn import CHANNELS, STAGES, decode, prepare, to_rows

FPN = 256
STRIDES = (8, 16, 32, 64, 128)
SIZES = (32, 64, 128, 256, 512)
OCTAVES = (1.0, 2 ** (1 / 3), 2 ** (2 / 3))
RATIOS = (0.5, 1.0, 2.0)
ANCHORS = len(OCTAVES) * len(RATIOS)
GROUPS, GN_EPS = 32, 1e-5
PRIOR = 0.01
TOWERS = ("head.classification_head.conv", "head.regression_head.conv")


def param_shapes(cfg):
    """{state-dict key: shape} of every parameter and statistic."""
    out = {}

    def norm(p, c):
        for s in ("weight", "bias", "running_mean", "running_var"):
            out[f"{p}.{s}"] = (c,)

    out["backbone.body.conv1.weight"] = (64, 3, 7, 7)
    norm("backbone.body.bn1", 64)
    cin = 64
    for si, (n, cout) in enumerate(zip(STAGES, CHANNELS)):
        mid = cout // 4
        for bi in range(n):
            p = f"backbone.body.layer{si + 1}.{bi}"
            c0 = cin if bi == 0 else cout
            out[p + ".conv1.weight"] = (mid, c0, 1, 1)
            out[p + ".conv2.weight"] = (mid, mid, 3, 3)
            out[p + ".conv3.weight"] = (cout, mid, 1, 1)
            for j, c in ((1, mid), (2, mid), (3, cout)):
                norm(f"{p}.bn{j}", c)
            if bi == 0:
                out[p + ".downsample.0.weight"] = (cout, c0, 1, 1)
                norm(p + ".downsample.1", cout)
        cin = cout
    for i, c in enumerate(CHANNELS[1:]):
        out[f"backbone.fpn.inner_blocks.{i}.0.weight"] = (FPN, c, 1, 1)
        out[f"backbone.fpn.inner_blocks.{i}.0.bias"] = (FPN,)
        out[f"backbone.fpn.layer_blocks.{i}.0.weight"] = (FPN, FPN, 3, 3)
        out[f"backbone.fpn.layer_blocks.{i}.0.bias"] = (FPN,)
    for name, c in (("p6", CHANNELS[-1]), ("p7", FPN)):
        out[f"backbone.fpn.extra_blocks.{name}.weight"] = (FPN, c, 3, 3)
        out[f"backbone.fpn.extra_blocks.{name}.bias"] = (FPN,)
    for tower in TOWERS:
        for j in range(4):
            out[f"{tower}.{j}.0.weight"] = (FPN, FPN, 3, 3)
            out[f"{tower}.{j}.1.weight"] = (FPN,)
            out[f"{tower}.{j}.1.bias"] = (FPN,)
    nc = cfg["num_classes"]
    out["head.classification_head.cls_logits.weight"] = (ANCHORS * nc, FPN, 3, 3)
    out["head.classification_head.cls_logits.bias"] = (ANCHORS * nc,)
    out["head.regression_head.bbox_reg.weight"] = (ANCHORS * 4, FPN, 3, 3)
    out["head.regression_head.bbox_reg.bias"] = (ANCHORS * 4,)
    return out


def features(sd, x, calibrate=False):
    """NCHW normalised images -> [P3, P4, P5, P6, P7]. With ``calibrate``
    every frozen BatchNorm first takes its statistics from its own input
    batch."""

    def fbn(y, p):
        if calibrate:
            calibrate_stats(y, sd, p, floor=1e-3)
        return frozen_bn(y, sd, p)

    def conv(y, p, stride=1, pad=0):
        return F.conv2d(y, sd[p + ".weight"], sd[p + ".bias"], stride, pad)

    body = "backbone.body."
    y = torch.relu(fbn(F.conv2d(x, sd[body + "conv1.weight"], None, 2, 3), body + "bn1"))
    y = F.max_pool2d(y, 3, 2, 1)
    cs = []
    for si, n in enumerate(STAGES):
        for bi in range(n):
            p = f"{body}layer{si + 1}.{bi}."
            s = 2 if (bi == 0 and si > 0) else 1
            z = torch.relu(fbn(F.conv2d(y, sd[p + "conv1.weight"]), p + "bn1"))
            z = torch.relu(fbn(F.conv2d(z, sd[p + "conv2.weight"], None, s, 1), p + "bn2"))
            z = fbn(F.conv2d(z, sd[p + "conv3.weight"]), p + "bn3")
            if bi == 0:
                y = fbn(F.conv2d(y, sd[p + "downsample.0.weight"], None, s), p + "downsample.1")
            y = torch.relu(z + y)
        cs.append(y)
    cs = cs[1:]
    ps = [None] * 3
    for li in reversed(range(3)):
        p = conv(cs[li], f"backbone.fpn.inner_blocks.{li}.0")
        if li < 2:
            p = p + F.interpolate(ps[li + 1], scale_factor=2, mode="nearest")
        ps[li] = p
    feats = [conv(p, f"backbone.fpn.layer_blocks.{li}.0", 1, 1) for li, p in enumerate(ps)]
    p6 = conv(cs[-1], "backbone.fpn.extra_blocks.p6", 2, 1)
    p7 = conv(torch.relu(p6), "backbone.fpn.extra_blocks.p7", 2, 1)
    return feats + [p6, p7]


def _tower(sd, tower, f):
    for j in range(4):
        f = F.conv2d(f, sd[f"{tower}.{j}.0.weight"], None, 1, 1)
        f = torch.relu(F.group_norm(f, GROUPS, sd[f"{tower}.{j}.1.weight"],
                                    sd[f"{tower}.{j}.1.bias"], GN_EPS))
    return f


def head(sd, feats):
    """[P3..P7] -> (class logits (B, A, nc), deltas (B, A, 4)), rows
    ordered level, y, x, anchor."""
    cls_p, box_p = "head.classification_head.cls_logits", "head.regression_head.bbox_reg"
    cls_all, reg_all = [], []
    for f in feats:
        c = F.conv2d(_tower(sd, TOWERS[0], f), sd[cls_p + ".weight"], sd[cls_p + ".bias"], 1, 1)
        r = F.conv2d(_tower(sd, TOWERS[1], f), sd[box_p + ".weight"], sd[box_p + ".bias"], 1, 1)
        b = c.shape[0]
        cls_all.append(c.permute(0, 2, 3, 1).reshape(b, -1, c.shape[1] // ANCHORS))
        reg_all.append(r.permute(0, 2, 3, 1).reshape(b, -1, 4))
    return torch.cat(cls_all, 1), torch.cat(reg_all, 1)


def anchors(size, device):
    """(A, 4) f32 xyxy anchors over P3..P7: cell centres at (i + 0.5) *
    stride, 9 a cell, ratio-major with the scale fastest, w = s / sqrt(r),
    h = s * sqrt(r)."""
    out = []
    for base, stride in zip(SIZES, STRIDES):
        f = math.ceil(size / stride)
        whs = np.array([(base * o / math.sqrt(r), base * o * math.sqrt(r))
                        for r in RATIOS for o in OCTAVES], np.float32)
        ys, xs = np.meshgrid(np.arange(f), np.arange(f), indexing="ij")
        c = np.stack([np.repeat((xs.reshape(-1, 1) + 0.5) * stride, ANCHORS, 1).reshape(-1),
                      np.repeat((ys.reshape(-1, 1) + 0.5) * stride, ANCHORS, 1).reshape(-1)], 1)
        wh = np.tile(whs, (f * f, 1))
        out.append(np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32))
    return torch.from_numpy(np.concatenate(out)).to(device)


def postprocess(cfg, cls, reg):
    """The serving tail of the module docstring over (B, A, nc) logits and
    (B, A, 4) deltas. Returns a list of (n, 6) [x1, y1, x2, y2, conf, cls]
    tensors."""
    b, a, nc = cls.shape
    dev = cls.device
    thr = torch.full((), cfg["conf_thres"], dtype=torch.float32, device=dev)
    anc = anchors(cfg["image_size"], dev)
    pre = min(cfg["prefilter_top_n"], a)
    if a > pre:
        score = torch.sigmoid(cls.amax(-1))
        _, idx = stable_desc(torch.where(score > thr, score, -1.0), pre)
        cls = torch.gather(cls, 1, idx[..., None].expand(b, pre, nc))
        reg = torch.gather(reg, 1, idx[..., None].expand(b, pre, 4))
        anc = anc[idx]
    scores = torch.sigmoid(cls)
    boxes = torch.clamp(decode(reg, anc, (1.0, 1.0, 1.0, 1.0)), 0.0, float(cfg["image_size"]))
    ctr, wh = (boxes[..., :2] + boxes[..., 2:]) * 0.5, boxes[..., 2:] - boxes[..., :2]
    boxes = torch.cat([ctr - wh * 0.5, ctr + wh * 0.5], -1)
    # rows by their best score, then every pair of the rows in that order
    best = scores.amax(-1)
    best, order = stable_desc(torch.where(best > thr, best, -1.0), pre)
    scores = torch.gather(scores, 1, order[..., None].expand(b, pre, nc))
    boxes = torch.gather(boxes, 1, order[..., None].expand(b, pre, 4))
    flat = torch.where((best[..., None] > 0) & (scores > thr), scores, -1.0).reshape(b, -1)
    top, pair = stable_desc(flat, min(cfg["prefilter_top_n"], flat.shape[1]))
    cand = torch.gather(boxes, 1, (pair // nc)[..., None].expand(*pair.shape, 4))
    cand_cls = (pair % nc).to(torch.float32)
    kept = greedy_nms(cand + cand_cls[..., None] * MAX_WH, top > 0, cfg["iou_thres"])
    rows = torch.cat([cand, top[..., None], cand_cls[..., None]], -1)
    return compact(kept, rows, cfg["detections_per_img"])


@torch.no_grad()
def detect(sd, cfg, images, device):
    """Rows (n, 6) [cls, x, y, w, h, conf] of each (H, W, 3) f32 image, as
    float32 NumPy arrays normalised to the image."""
    x = prepare(images, cfg, device)
    dets = postprocess(cfg, *head(sd, features(sd, x.permute(0, 3, 1, 2))))
    return [to_rows(d, cfg["image_size"]).cpu().numpy() for d in dets]


@torch.no_grad()
def seeded_state(cfg, gen, device, calib_images):
    """A state dict from the seeded device generator ``gen``: conv weights
    uniform in +-1/sqrt(fan_in), the FPN's biases zero, GroupNorm and
    BatchNorm identity; then every frozen BatchNorm's statistics taken from
    the calibration images as they pass (variances floored at 1e-3), so the
    features stay near unit scale; then the output biases spread so that
    scores and boxes differ from anchor to anchor and class to class, and
    rankings are not decided by ties: each class channel at the focal
    prior -log(0.99 / 0.01) plus U(-2, 2), each box channel N(0, 0.1)."""
    shapes = param_shapes(cfg)
    uni = [k for k, s in shapes.items() if len(s) == 4]
    sizes = [int(np.prod(shapes[k])) for k in uni]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    sd = {}
    for k, part in zip(uni, torch.split(u, sizes)):
        fan_in = int(np.prod(shapes[k][1:]))
        sd[k] = ((part * 2.0 - 1.0) / math.sqrt(fan_in)).reshape(shapes[k])
    for k, s in shapes.items():
        if k not in sd:
            sd[k] = torch.full(s, 1.0 if k.endswith((".weight", "running_var")) else 0.0,
                               device=device)
    features(sd, prepare(calib_images, cfg, device).permute(0, 3, 1, 2), calibrate=True)
    n_cls = shapes["head.classification_head.cls_logits.bias"][0]
    prior = -math.log((1 - PRIOR) / PRIOR)
    sd["head.classification_head.cls_logits.bias"] = \
        prior + torch.rand(n_cls, generator=gen, device=device) * 4.0 - 2.0
    sd["head.regression_head.bbox_reg.bias"] = \
        torch.randn(ANCHORS * 4, generator=gen, device=device) * 0.1
    return sd


def flops(cfg):
    """{"conv", "linear"} FLOPs of one image, 2 per multiply-add, counted on
    meta tensors: ``trunk`` (body and FPN) and ``head`` (towers and output
    convs over every level)."""
    from torch.utils.flop_counter import FlopCounterMode

    sd = {k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()}
    s = cfg["image_size"]
    out = {}
    with FlopCounterMode(display=False) as fc:
        feats = features(sd, torch.empty(1, 3, s, s, device="meta"))
    out["trunk"] = _split(fc)
    with FlopCounterMode(display=False) as fc:
        head(sd, feats)
    out["head"] = _split(fc)
    return out


def _split(fc):
    counts = fc.get_flop_counts()["Global"]
    conv = sum(v for k, v in counts.items() if "convolution" in str(k))
    return {"conv": conv, "linear": fc.get_total_flops() - conv}
