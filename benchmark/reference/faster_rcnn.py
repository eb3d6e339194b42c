"""Frozen plain reference of Faster R-CNN-ResNet50-FPN-v2 serving.

torchvision's ``fasterrcnn_resnet50_fpn_v2`` (arXiv:2111.11429): a ResNet50
body (v1.5, frozen BatchNorm), an FPN of 256 channels over C2..C5 whose
lateral and output convs are followed by BatchNorm, a max-pooled extra
level, an RPN head of two 3x3 convs with 3 anchors per cell (sizes 32..512,
aspect ratios 0.5/1/2), 1000 proposals per level before and 1000 per image
after NMS at IoU 0.7, multi-scale RoIAlign (7x7, sampling ratio 2, canonical
levels P2..P5), a box head of four 3x3 conv + BatchNorm + ReLU layers and a
1024-wide fc, per-class box regression with weights (10, 10, 5, 5), softmax
scores, class-aware NMS over the top 2048 (proposal, class) rows and at most
100 detections. Parameters are a flat state dict in torchvision's key names.

Serving follows the JAX package that the port mirrors: the 640x640 square
input normalised with ImageNet's mean and std, and RoIAlign over a bfloat16
pyramid with bfloat16 bilinear weights and an f32 sample mean (every other
step in f32). Rows are (cls, x, y, w, h, conf) normalised to the input, the
class ids background-inclusive.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .common import (
    MAX_WH, bn_eval, calibrate_stats, compact, frozen_bn, greedy_nms, resize,
    stable_desc,
)

STAGES = (3, 4, 6, 3)
CHANNELS = (256, 512, 1024, 2048)
FPN = 256
RPN_STRIDES = (4, 8, 16, 32, 64)
RPN_SIZES = (32, 64, 128, 256, 512)
RATIOS = (0.5, 1.0, 2.0)
ROI_STRIDES = (4, 8, 16, 32)
ROI_OUT, ROI_SAMPLING = 7, 2
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
NORM_EPS = 1e-5
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


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
    for i, c in enumerate(CHANNELS):
        out[f"backbone.fpn.inner_blocks.{i}.0.weight"] = (FPN, c, 1, 1)
        norm(f"backbone.fpn.inner_blocks.{i}.1", FPN)
        out[f"backbone.fpn.layer_blocks.{i}.0.weight"] = (FPN, FPN, 3, 3)
        norm(f"backbone.fpn.layer_blocks.{i}.1", FPN)
    for j in range(2):
        out[f"rpn.head.conv.{j}.0.weight"] = (FPN, FPN, 3, 3)
        out[f"rpn.head.conv.{j}.0.bias"] = (FPN,)
    out["rpn.head.cls_logits.weight"] = (3, FPN, 1, 1)
    out["rpn.head.cls_logits.bias"] = (3,)
    out["rpn.head.bbox_pred.weight"] = (12, FPN, 1, 1)
    out["rpn.head.bbox_pred.bias"] = (12,)
    for j in range(4):
        out[f"roi_heads.box_head.{j}.0.weight"] = (FPN, FPN, 3, 3)
        norm(f"roi_heads.box_head.{j}.1", FPN)
    out["roi_heads.box_head.5.weight"] = (1024, FPN * ROI_OUT * ROI_OUT)
    out["roi_heads.box_head.5.bias"] = (1024,)
    nc = cfg["num_classes"]
    out["roi_heads.box_predictor.cls_score.weight"] = (nc, 1024)
    out["roi_heads.box_predictor.cls_score.bias"] = (nc,)
    out["roi_heads.box_predictor.bbox_pred.weight"] = (nc * 4, 1024)
    out["roi_heads.box_predictor.bbox_pred.bias"] = (nc * 4,)
    return out


def features(sd, x, calibrate=False):
    """NCHW normalised images -> [P2, P3, P4, P5, pool]. With ``calibrate``
    every norm first takes its statistics from its own input batch."""

    def fbn(y, p):
        if calibrate:
            calibrate_stats(y, sd, p, floor=1e-3)
        return frozen_bn(y, sd, p)

    def conv_norm(y, p, k):
        y = F.conv2d(y, sd[p + ".0.weight"], None, 1, k // 2)
        if calibrate:
            calibrate_stats(y, sd, p + ".1", floor=1e-3)
        return bn_eval(y, sd, p + ".1", NORM_EPS)

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
    ps = [None] * 4
    for li in reversed(range(4)):
        p = conv_norm(cs[li], f"backbone.fpn.inner_blocks.{li}", 1)
        if li < 3:
            p = p + F.interpolate(ps[li + 1], scale_factor=2, mode="nearest")
        ps[li] = p
    feats = [conv_norm(p, f"backbone.fpn.layer_blocks.{li}", 3) for li, p in enumerate(ps)]
    return feats + [F.max_pool2d(feats[-1], 1, 2)]


def rpn_head(sd, feats):
    """Per level (objectness logits (B, A_l), deltas (B, A_l, 4)), rows
    ordered y, x, anchor."""
    objs, regs = [], []
    for f in feats:
        h = f
        for j in range(2):
            h = torch.relu(F.conv2d(h, sd[f"rpn.head.conv.{j}.0.weight"],
                                    sd[f"rpn.head.conv.{j}.0.bias"], 1, 1))
        o = F.conv2d(h, sd["rpn.head.cls_logits.weight"], sd["rpn.head.cls_logits.bias"])
        r = F.conv2d(h, sd["rpn.head.bbox_pred.weight"], sd["rpn.head.bbox_pred.bias"])
        b = o.shape[0]
        objs.append(o.permute(0, 2, 3, 1).reshape(b, -1))
        regs.append(r.permute(0, 2, 3, 1).reshape(b, -1, 4))
    return objs, regs


def anchors(size, device):
    """(sum A_l, 4) f32 xyxy anchors, one size per level, 3 ratios a cell
    (aspect ratio = h / w), cell centres at (i + 0.5) * stride."""
    out = []
    for s, stride in zip(RPN_SIZES, RPN_STRIDES):
        f = math.ceil(size / stride)
        whs = np.array([(s / math.sqrt(r), s * math.sqrt(r)) for r in RATIOS], np.float32)
        ys, xs = np.meshgrid(np.arange(f), np.arange(f), indexing="ij")
        c = np.stack([np.repeat((xs.reshape(-1, 1) + 0.5) * stride, 3, 1).reshape(-1),
                      np.repeat((ys.reshape(-1, 1) + 0.5) * stride, 3, 1).reshape(-1)], 1)
        wh = np.tile(whs, (f * f, 1))
        out.append(np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32))
    return torch.from_numpy(np.concatenate(out)).to(device)


def decode(reg, ref, weights):
    """Weighted deltas on xyxy reference boxes -> xyxy boxes; log-size
    deltas clipped at log(1000 / 16)."""
    wx, wy, ww, wh = weights
    acx = (ref[..., 0] + ref[..., 2]) * 0.5
    acy = (ref[..., 1] + ref[..., 3]) * 0.5
    aw = ref[..., 2] - ref[..., 0]
    ah = ref[..., 3] - ref[..., 1]
    clip = math.log(1000.0 / 16)
    cx = reg[..., 0] / wx * aw + acx
    cy = reg[..., 1] / wy * ah + acy
    w = torch.exp(torch.clamp(reg[..., 2] / ww, max=clip)) * aw
    h = torch.exp(torch.clamp(reg[..., 3] / wh, max=clip)) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def proposals(cfg, objs, regs):
    """Per level the top ``pre_nms_top_n`` logits, decoded and clipped, tiny
    boxes dropped, sigmoid scores; greedy NMS at ``rpn_nms_thresh`` within
    each (image, level); then the best ``post_nms_top_n`` of the image.
    Returns (boxes (B, P, 4), valid (B, P))."""
    dev = objs[0].device
    b = objs[0].shape[0]
    size = float(cfg["image_size"])
    anc = anchors(cfg["image_size"], dev)
    sel_s, sel_i, off, ks = [], [], 0, []
    for o in objs:
        k = min(cfg["pre_nms_top_n"], o.shape[1])
        s, i = stable_desc(o, k)
        sel_s.append(s)
        sel_i.append(i + off)
        ks.append(k)
        off += o.shape[1]
    scores, idx = torch.cat(sel_s, 1), torch.cat(sel_i, 1)
    reg = torch.gather(torch.cat(regs, 1), 1, idx[..., None].expand(*idx.shape, 4))
    boxes = torch.clamp(decode(reg, anc[idx], (1.0, 1.0, 1.0, 1.0)), 0.0, size)
    ok = (boxes[..., 2] - boxes[..., 0] > 1e-3) & (boxes[..., 3] - boxes[..., 1] > 1e-3)
    p = torch.where(ok, torch.sigmoid(scores), 0.0)
    kept, start = [], 0
    for k in ks:
        seg = slice(start, start + k)
        kept.append(greedy_nms(boxes[:, seg], p[:, seg] > 0, cfg["rpn_nms_thresh"],
                               clamp_area=False))
        start += k
    kept = torch.cat(kept, 1)
    top, top_idx = stable_desc(torch.where(kept, p, -torch.inf),
                               min(cfg["post_nms_top_n"], idx.shape[1]))
    return torch.gather(boxes, 1, top_idx[..., None].expand(b, top_idx.shape[1], 4)), \
        top > -torch.inf


def _pyramid(feats):
    """P2..P5 (1, C, H_l, W_l) -> (sum H_l, W_0, C) bf16, channels last,
    each level padded to the first level's width."""
    w0 = feats[0].shape[-1]
    rows = []
    for f in feats:
        f = f.to(torch.bfloat16)[0].permute(1, 2, 0)
        rows.append(F.pad(f, (0, 0, 0, w0 - f.shape[1])))
    return torch.cat(rows, 0)


def roi_align(feats, boxes):
    """One image's (N, 4) boxes on its P2..P5 maps (each (1, C, H, W)) ->
    (N, C, 7, 7): each box on its canonical level k = floor(4 + log2(
    sqrt(area) / 224)) clamped to 2..5; 2x2 samples per bin at the bin's
    sub-cell centres, clamped into the map; each sample bilinear from its
    four neighbours, weights in bf16 over the bf16 pyramid; the mean of the
    four samples in f32, rounded once to bf16."""
    dev = boxes.device
    f32 = torch.float32
    pyr = _pyramid(feats)
    heights = [f.shape[2] for f in feats]
    widths = [f.shape[3] for f in feats]
    n, ch, out, smp = boxes.shape[0], pyr.shape[-1], ROI_OUT, ROI_SAMPLING
    areas = torch.clamp_min((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), 1e-6)
    two = torch.full((), 2.0, dtype=f32, device=dev)
    lvl = torch.floor(4.0 + torch.log(torch.sqrt(areas) / 224.0 + 1e-9) / torch.log(two))
    ki = (torch.clamp(lvl, 2.0, 5.0) - 2.0).long()
    stride = torch.tensor(ROI_STRIDES, dtype=f32, device=dev)[ki]
    hl = torch.tensor(heights, dtype=f32, device=dev)[ki]
    wl = torch.tensor(widths, dtype=f32, device=dev)[ki]
    ro = torch.tensor(np.cumsum([0] + heights[:-1]), dtype=torch.long, device=dev)[ki]
    b = boxes / stride[:, None]
    w = torch.clamp_min(b[:, 2] - b[:, 0], 1.0)
    h = torch.clamp_min(b[:, 3] - b[:, 1], 1.0)
    bin_h, bin_w = (h / out)[:, None, None], (w / out)[:, None, None]
    iy = (torch.arange(smp, dtype=f32, device=dev) + 0.5)[None, None]
    py = torch.arange(out, dtype=f32, device=dev)[None, :, None]
    ys = b[:, 1, None, None] + py * bin_h + iy * bin_h / smp
    xs = b[:, 0, None, None] + py * bin_w + iy * bin_w / smp
    zero = torch.zeros((), dtype=f32, device=dev)
    yc = torch.minimum(torch.maximum(ys, zero), (hl - 1)[:, None, None])
    xc = torch.minimum(torch.maximum(xs, zero), (wl - 1)[:, None, None])
    hi, wi = (hl.long() - 1)[:, None, None], (wl.long() - 1)[:, None, None]
    y0 = torch.clamp_min(torch.minimum(torch.floor(yc).long(), hi - 1), 0)
    x0 = torch.clamp_min(torch.minimum(torch.floor(xc).long(), wi - 1), 0)
    ly = (yc - y0)[:, :, :, None, None, None].to(torch.bfloat16)
    lx = (xc - x0)[:, None, None, :, :, None].to(torch.bfloat16)
    w0 = pyr.shape[1]
    flat = pyr.reshape(-1, ch)
    r = (ro[:, None, None] + y0)[:, :, :, None, None]
    c = x0[:, None, None]

    def corner(dy, dx):
        return flat[((r + dy) * w0 + (c + dx)).reshape(-1)].reshape(n, out, smp, out, smp, ch)

    val = corner(0, 0) * (1 - ly) * (1 - lx)
    val = val + corner(0, 1) * (1 - ly) * lx
    val = val + corner(1, 0) * ly * (1 - lx)
    val = val + corner(1, 1) * ly * lx
    pooled = val.sum(dim=(2, 4), dtype=f32).div_(smp * smp).to(val.dtype)
    return pooled.permute(0, 3, 1, 2)


def box_head(sd, pooled, calibrate=False):
    """(R, C, 7, 7) pooled features -> (class logits (R, nc), deltas
    (R, nc, 4)), f32."""
    h = pooled.to(torch.float32)
    for j in range(4):
        p = f"roi_heads.box_head.{j}"
        h = F.conv2d(h, sd[p + ".0.weight"], None, 1, 1)
        if calibrate:
            calibrate_stats(h, sd, p + ".1", floor=1e-3)
        h = torch.relu(bn_eval(h, sd, p + ".1", NORM_EPS))
    h = torch.relu(F.linear(h.flatten(1), sd["roi_heads.box_head.5.weight"],
                            sd["roi_heads.box_head.5.bias"]))
    cls = F.linear(h, sd["roi_heads.box_predictor.cls_score.weight"],
                   sd["roi_heads.box_predictor.cls_score.bias"])
    reg = F.linear(h, sd["roi_heads.box_predictor.bbox_pred.weight"],
                   sd["roi_heads.box_predictor.bbox_pred.bias"])
    return cls, reg.reshape(reg.shape[0], -1, 4)


def postprocess(cfg, cls, reg, boxes, valid):
    """Softmax scores without the background, per-class decode and clip,
    scores at or below ``conf_thres`` dropped, then class-aware greedy NMS
    over the image's top ``nms_top_n`` (proposal, class) rows and at most
    ``detections_per_img`` of them. Returns a list of (n, 6) [x1, y1, x2,
    y2, conf, cls] tensors, cls background-inclusive."""
    b, p, nc1 = cls.shape
    nc = nc1 - 1
    scores = torch.softmax(cls, -1)[..., 1:]
    dec = decode(reg[:, :, 1:, :], boxes[:, :, None, :], BOX_WEIGHTS)
    dec = torch.clamp(dec, 0.0, float(cfg["image_size"]))
    scores = torch.where(valid[..., None], scores, 0.0)
    thr = torch.full((), cfg["conf_thres"], dtype=torch.float32, device=cls.device)
    flat = torch.where(scores > thr, scores, 0.0).reshape(b, -1)
    flat_cls = torch.arange(nc, dtype=torch.float32, device=cls.device).repeat(p)
    k = min(cfg["nms_top_n"], flat.shape[1])
    top, idx = stable_desc(torch.where(flat > 0, flat, -1.0), k)
    cand = torch.gather(dec.reshape(b, -1, 4), 1, idx[..., None].expand(b, k, 4))
    cand_cls = flat_cls[idx]
    kept = greedy_nms(cand + cand_cls[..., None] * MAX_WH, top > 0, cfg["iou_thres"])
    rows = torch.cat([cand, top[..., None], cand_cls[..., None] + 1.0], -1)
    return compact(kept, rows, cfg["detections_per_img"])


def prepare(images, cfg, device):
    """Square-resize and normalise a list of (H, W, 3) f32 arrays:
    (B, S, S, 3) on ``device``."""
    s = cfg["image_size"]
    mean = torch.from_numpy(MEAN).to(device)
    std = torch.from_numpy(STD).to(device)
    return torch.stack([(resize(torch.from_numpy(np.ascontiguousarray(im)).to(device), s, s)
                         - mean) / std for im in images])


def forward(sd, cfg, x, calibrate=False):
    """(B, S, S, 3) prepared images -> (list of detections, valid proposal
    counts (B,))."""
    feats = features(sd, x.permute(0, 3, 1, 2), calibrate)
    boxes, valid = proposals(cfg, *rpn_head(sd, feats))
    pooled = torch.cat([roi_align([f[i:i + 1] for f in feats[:4]], boxes[i])
                        for i in range(boxes.shape[0])])
    cls, reg = box_head(sd, pooled, calibrate)
    b, p = valid.shape
    dets = postprocess(cfg, cls.view(b, p, -1), reg.view(b, p, -1, 4), boxes, valid)
    return dets, valid.sum(1)


def to_rows(det, size):
    """(n, 6) [x1, y1, x2, y2, conf, cls] -> (n, 6) [cls, x, y, w, h, conf]
    normalised by the input size."""
    x1, y1, x2, y2 = (det[:, i] / size for i in range(4))
    return torch.stack([det[:, 5], (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
                        y2 - y1, det[:, 4]], -1)


@torch.no_grad()
def detect(sd, cfg, images, device):
    """Rows (n, 6) [cls, x, y, w, h, conf] of each (H, W, 3) f32 image, as
    float32 NumPy arrays normalised to the image."""
    dets, _ = forward(sd, cfg, prepare(images, cfg, device))
    return [to_rows(d, cfg["image_size"]).cpu().numpy() for d in dets]


@torch.no_grad()
def kept_proposals(sd, cfg, images, device):
    """Valid proposals per image after the RPN's NMS (NumPy int)."""
    x = prepare(images, cfg, device)
    feats = features(sd, x.permute(0, 3, 1, 2))
    _, valid = proposals(cfg, *rpn_head(sd, feats))
    return valid.sum(1).cpu().numpy()


@torch.no_grad()
def seeded_state(cfg, gen, device, calib_images):
    """A state dict from the seeded device generator ``gen``: conv weights
    uniform in +-1/sqrt(fan_in), the fc uniform in +-1/sqrt(12544), the class
    and box predictors normal with std 0.01 and 0.001, biases zero, norms
    identity; then every norm's statistics taken from the calibration
    images as they pass (variances floored at 1e-3), so activations stay
    near unit scale and the proposals and scores are real; then the
    predictors' biases spread (classes U(-2, 2), boxes N(0, 0.1))."""
    shapes = param_shapes(cfg)
    uni = [k for k, s in shapes.items() if len(s) == 4 or k == "roi_heads.box_head.5.weight"]
    sizes = [int(np.prod(shapes[k])) for k in uni]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    sd = {}
    for k, part in zip(uni, torch.split(u, sizes)):
        fan_in = int(np.prod(shapes[k][1:]))
        sd[k] = ((part * 2.0 - 1.0) / math.sqrt(fan_in)).reshape(shapes[k])
    pred = "roi_heads.box_predictor."
    nrm = [(pred + "cls_score.weight", 0.01), (pred + "bbox_pred.weight", 0.001)]
    sizes = [int(np.prod(shapes[k])) for k, _ in nrm]
    g = torch.randn(sum(sizes), generator=gen, device=device)
    for (k, std), part in zip(nrm, torch.split(g, sizes)):
        sd[k] = (part * std).reshape(shapes[k])
    for k, s in shapes.items():
        if k not in sd:
            sd[k] = torch.full(s, 1.0 if k.endswith((".weight", "running_var")) else 0.0,
                               device=device)
    forward(sd, cfg, prepare(calib_images, cfg, device), calibrate=True)
    nc = cfg["num_classes"]
    sd[pred + "cls_score.bias"] = torch.rand(nc, generator=gen, device=device) * 4.0 - 2.0
    sd[pred + "bbox_pred.bias"] = torch.randn(nc * 4, generator=gen, device=device) * 0.1
    return sd


def flops(cfg):
    """{"conv", "linear"} FLOPs, 2 per multiply-add, counted on meta
    tensors: ``trunk`` of one image (body, FPN, RPN head) and ``roi`` of one
    proposal through the box head and predictors."""
    from torch.utils.flop_counter import FlopCounterMode

    sd = {k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()}
    s = cfg["image_size"]
    out = {}
    with FlopCounterMode(display=False) as fc:
        rpn_head(sd, features(sd, torch.empty(1, 3, s, s, device="meta")))
    out["trunk"] = _split(fc)
    with FlopCounterMode(display=False) as fc:
        box_head(sd, torch.empty(1, FPN, ROI_OUT, ROI_OUT, device="meta"))
    out["roi"] = _split(fc)
    return out


def _split(fc):
    counts = fc.get_flop_counts()["Global"]
    conv = sum(v for k, v in counts.items() if "convolution" in str(k))
    return {"conv": conv, "linear": fc.get_total_flops() - conv}
