"""Frozen plain reference of YOLOv5 (v6.0 and later) serving.

From ultralytics/yolov5 ``models/yolov5{n,s,m,l,x}.yaml`` (v6.0+): a 6x6
stride-2 stem, C3 blocks, SPPF, the PANet neck and the anchor-based detect
head over strides 8/16/32, with Conv = conv (no bias) + BatchNorm (eps 1e-3)
+ SiLU. Parameters are a flat state dict in ultralytics' key names
(``model.{i}.conv.weight``, ``model.{i}.cv1.bn.running_var``,
``model.24.m.{level}.bias``).

Serving, as the yolov5 tooling that writes detection files: the letterbox
(aspect-preserving bilinear resize, symmetric gray padding 114/255), the
trunk, the anchor decode, confidence = objectness x class probability, the
multi-label candidates above ``conf_thres`` ranked in two stages (the best
``max_cand`` boxes by their best pair, then their best ``max_cand`` pairs),
class-aware greedy NMS (IoU strictly above ``iou_thres`` suppresses) over
class-offset boxes, at most ``max_det`` rows, and the letterbox unmap to
(cls, x, y, w, h, conf) normalised to the original image.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .common import (
    MAX_WH, bn_eval, calibrate_stats, compact, greedy_nms, resize, stable_desc,
)

BN_EPS = 1e-3
STRIDES = (8, 16, 32)
HEAD_STAGES = (17, 20, 23)
PAD_VALUE = 114 / 255


def _gw(c, width):
    return max(int(math.ceil(c * width / 8) * 8), 8)


def layers(cfg):
    """The yaml's layer table: (index, kind, source, kwargs)."""
    d, w = cfg["depth_multiple"], cfg["width_multiple"]
    c = {k: _gw(k, w) for k in (64, 128, 256, 512, 1024)}

    def n(k):
        return max(round(k * d), 1)

    return [
        (0, "conv", -1, dict(cin=3, cout=c[64], k=6, s=2, p=2)),
        (1, "conv", -1, dict(cin=c[64], cout=c[128], k=3, s=2)),
        (2, "c3", -1, dict(cin=c[128], cout=c[128], n=n(3), sc=True)),
        (3, "conv", -1, dict(cin=c[128], cout=c[256], k=3, s=2)),
        (4, "c3", -1, dict(cin=c[256], cout=c[256], n=n(6), sc=True)),
        (5, "conv", -1, dict(cin=c[256], cout=c[512], k=3, s=2)),
        (6, "c3", -1, dict(cin=c[512], cout=c[512], n=n(9), sc=True)),
        (7, "conv", -1, dict(cin=c[512], cout=c[1024], k=3, s=2)),
        (8, "c3", -1, dict(cin=c[1024], cout=c[1024], n=n(3), sc=True)),
        (9, "sppf", -1, dict(cin=c[1024], cout=c[1024])),
        (10, "conv", -1, dict(cin=c[1024], cout=c[512], k=1, s=1)),
        (11, "up", -1, {}),
        (12, "cat", 6, {}),
        (13, "c3", -1, dict(cin=c[1024], cout=c[512], n=n(3), sc=False)),
        (14, "conv", -1, dict(cin=c[512], cout=c[256], k=1, s=1)),
        (15, "up", -1, {}),
        (16, "cat", 4, {}),
        (17, "c3", -1, dict(cin=c[512], cout=c[256], n=n(3), sc=False)),
        (18, "conv", -1, dict(cin=c[256], cout=c[256], k=3, s=2)),
        (19, "cat", 14, {}),
        (20, "c3", -1, dict(cin=c[512], cout=c[512], n=n(3), sc=False)),
        (21, "conv", -1, dict(cin=c[512], cout=c[512], k=3, s=2)),
        (22, "cat", 10, {}),
        (23, "c3", -1, dict(cin=c[1024], cout=c[1024], n=n(3), sc=False)),
    ], (c[256], c[512], c[1024])


def _anchors(cfg):
    """(3 levels, na, 2) anchors in pixels."""
    return [np.asarray(a, np.float32).reshape(-1, 2) for a in cfg["anchors"]]


def param_shapes(cfg):
    """{state-dict key: shape} of every parameter and statistic."""
    out = {}

    def convbn(p, cin, cout, k):
        out[p + ".conv.weight"] = (cout, cin, k, k)
        for s in ("weight", "bias", "running_mean", "running_var"):
            out[p + ".bn." + s] = (cout,)

    table, head = layers(cfg)
    for idx, kind, _, kw in table:
        p = f"model.{idx}"
        if kind == "conv":
            convbn(p, kw["cin"], kw["cout"], kw["k"])
        elif kind == "c3":
            ch = kw["cout"] // 2
            convbn(p + ".cv1", kw["cin"], ch, 1)
            convbn(p + ".cv2", kw["cin"], ch, 1)
            convbn(p + ".cv3", 2 * ch, kw["cout"], 1)
            for j in range(kw["n"]):
                convbn(f"{p}.m.{j}.cv1", ch, ch, 1)
                convbn(f"{p}.m.{j}.cv2", ch, ch, 3)
        elif kind == "sppf":
            ch = kw["cin"] // 2
            convbn(p + ".cv1", kw["cin"], ch, 1)
            convbn(p + ".cv2", ch * 4, kw["cout"], 1)
    na, no = len(_anchors(cfg)[0]), cfg["nc"] + 5
    for li, c in enumerate(head):
        out[f"model.24.m.{li}.weight"] = (na * no, c, 1, 1)
        out[f"model.24.m.{li}.bias"] = (na * no,)
    return out


def trunk(sd, cfg, x, calibrate=False):
    """Backbone + neck over NCHW ``x``; returns the three head inputs. With
    ``calibrate`` every norm first takes its statistics from its own input
    batch (``sd`` is updated in place)."""

    def cbs(p, y, k, s, pad=None):
        y = F.conv2d(y, sd[p + ".conv.weight"], None, s,
                     k // 2 if pad is None else pad)
        if calibrate:
            calibrate_stats(y, sd, p + ".bn")
        y = bn_eval(y, sd, p + ".bn", BN_EPS)
        return y * torch.sigmoid(y)

    def c3(p, y, kw):
        a = cbs(p + ".cv1", y, 1, 1)
        for j in range(kw["n"]):
            b = cbs(f"{p}.m.{j}.cv2", cbs(f"{p}.m.{j}.cv1", a, 1, 1), 3, 1)
            a = a + b if kw["sc"] else b
        return cbs(p + ".cv3", torch.cat([a, cbs(p + ".cv2", y, 1, 1)], 1), 1, 1)

    outs = {}
    y = x
    table, _ = layers(cfg)
    for idx, kind, src, kw in table:
        p = f"model.{idx}"
        if kind == "conv":
            y = cbs(p, y, kw["k"], kw["s"], kw.get("p"))
        elif kind == "c3":
            y = c3(p, y, kw)
        elif kind == "sppf":
            a = cbs(p + ".cv1", y, 1, 1)
            p1 = F.max_pool2d(a, 5, 1, 2)
            p2 = F.max_pool2d(p1, 5, 1, 2)
            p3 = F.max_pool2d(p2, 5, 1, 2)
            y = cbs(p + ".cv2", torch.cat([a, p1, p2, p3], 1), 1, 1)
        elif kind == "up":
            y = F.interpolate(y, scale_factor=2, mode="nearest")
        else:
            y = torch.cat([y, outs[src]], 1)
        outs[idx] = y
    return [outs[i] for i in HEAD_STAGES]


def predict(sd, cfg, x):
    """(B, S, S, 3) letterboxed images in [0, 1] -> obj (B, N), xywh
    (B, N, 4) pixel centres and sizes, cls (B, N, nc); rows ordered level,
    y, x, anchor."""
    feats = trunk(sd, cfg, x.permute(0, 3, 1, 2))
    anchors = _anchors(cfg)
    na, no = len(anchors[0]), cfg["nc"] + 5
    objs, boxes, clss = [], [], []
    for li, (f, stride) in enumerate(zip(feats, STRIDES)):
        h = F.conv2d(f, sd[f"model.24.m.{li}.weight"])
        bias = sd[f"model.24.m.{li}.bias"].reshape(na, no)
        b, _, hh, ww = h.shape
        h = h.reshape(b, na, no, hh, ww).permute(0, 3, 4, 1, 2) + bias
        gy, gx = torch.meshgrid(torch.arange(hh, dtype=torch.float32, device=x.device),
                                torch.arange(ww, dtype=torch.float32, device=x.device),
                                indexing="ij")
        grid = torch.stack([gx, gy], -1)[:, :, None, :]
        anc = torch.from_numpy(anchors[li]).to(x.device)
        xy = (torch.sigmoid(h[..., 0:2]) * 2.0 - 0.5 + grid) * stride
        wh = (torch.sigmoid(h[..., 2:4]) * 2.0) ** 2 * anc
        objs.append(torch.sigmoid(h[..., 4]).reshape(b, -1))
        boxes.append(torch.cat([xy, wh], -1).reshape(b, -1, 4))
        clss.append(torch.sigmoid(h[..., 5:]).reshape(b, -1, cfg["nc"]))
    return torch.cat(objs, 1), torch.cat(boxes, 1), torch.cat(clss, 1)


def nms(obj, xywh, cls, cfg):
    """Multi-label candidates and class-aware greedy NMS; returns a list of
    (n, 6) [x1, y1, x2, y2, conf, cls] tensors in letterbox pixels."""
    thr = torch.full((), cfg["conf_thres"], dtype=torch.float32, device=obj.device)
    b, n, nc = cls.shape
    kb = min(cfg["max_cand"], n)
    best = cls.amax(dim=2) * obj
    box_score = torch.where((obj > thr) & (best > thr), best, -1.0)
    best_top, pre = stable_desc(box_score, kb)
    pre_xywh = torch.gather(xywh, 1, pre[..., None].expand(b, kb, 4))
    pair = torch.gather(cls, 1, pre[..., None].expand(b, kb, nc)) \
        * torch.gather(obj, 1, pre)[..., None]
    flat = torch.where((best_top[..., None] > 0) & (pair > thr), pair, -1.0)
    k = min(cfg["max_cand"], kb * nc)
    scores, idx = stable_desc(flat.reshape(b, -1), k)
    bxywh = torch.gather(pre_xywh, 1, (idx // nc)[..., None].expand(b, k, 4))
    cls_id = (idx % nc).to(torch.float32)
    half = bxywh[..., 2:4] * 0.5
    boxes = torch.cat([bxywh[..., :2] - half, bxywh[..., :2] + half], -1)
    kept = greedy_nms(boxes + cls_id[..., None] * MAX_WH, scores > 0,
                      cfg["iou_thres"])
    rows = torch.cat([boxes, scores[..., None], cls_id[..., None]], -1)
    return compact(kept, rows, cfg["max_det"])


def letterbox(img, size):
    """(H, W, 3) f32 tensor -> ((size, size, 3), (ratio, dw, dh))."""
    h, w = img.shape[:2]
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    out = torch.full((size, size, 3), PAD_VALUE, dtype=torch.float32,
                     device=img.device)
    dh, dw = (size - nh) // 2, (size - nw) // 2
    out[dh:dh + nh, dw:dw + nw] = resize(img, nh, nw)
    return out, (r, dw, dh)


def unmap(det, meta, hw):
    """Letterbox-pixel (n, 6) [x1, y1, x2, y2, conf, cls] -> (n, 6)
    [cls, x, y, w, h, conf] normalised to the original (h, w)."""
    r, dw, dh = (torch.tensor(v, dtype=torch.float32, device=det.device) for v in meta)
    h, w = (torch.tensor(float(v), dtype=torch.float32, device=det.device) for v in hw)
    zero = torch.zeros((), device=det.device)
    x1 = torch.minimum(torch.maximum((det[:, 0] - dw) / r, zero), w)
    y1 = torch.minimum(torch.maximum((det[:, 1] - dh) / r, zero), h)
    x2 = torch.minimum(torch.maximum((det[:, 2] - dw) / r, zero), w)
    y2 = torch.minimum(torch.maximum((det[:, 3] - dh) / r, zero), h)
    return torch.stack([det[:, 5], (x1 + x2) / 2.0 / w, (y1 + y2) / 2.0 / h,
                        (x2 - x1) / w, (y2 - y1) / h, det[:, 4]], 1)


def prepare(images, cfg, device):
    """Letterbox a list of (H, W, 3) f32 arrays: (B, S, S, 3) on ``device``
    and the per-image (ratio, dw, dh)."""
    out, metas = [], []
    for im in images:
        lb, meta = letterbox(torch.from_numpy(np.ascontiguousarray(im)).to(device),
                             cfg["img_size"])
        out.append(lb)
        metas.append(meta)
    return torch.stack(out), metas


@torch.no_grad()
def detect(sd, cfg, images, device):
    """Rows (n, 6) [cls, x, y, w, h, conf] of each (H, W, 3) f32 image, as
    float32 NumPy arrays normalised to the image."""
    x, metas = prepare(images, cfg, device)
    dets = nms(*predict(sd, cfg, x), cfg)
    return [unmap(d, m, im.shape[:2]).cpu().numpy()
            for d, m, im in zip(dets, metas, images)]


@torch.no_grad()
def seeded_state(cfg, gen, device, calib_images):
    """A state dict from the seeded device generator ``gen``: conv weights
    uniform in +-1/sqrt(fan_in), norms identity, then every norm's
    statistics taken from the calibration images as they pass the trunk
    (activations stay near unit scale through the random trunk), then the
    head's weights tripled and its biases spread (box terms N(0, 0.5),
    objectness U(-3.5, -0.5), classes U(-5, -1)), so that many candidates
    pass conf 0.001 and overlapping same-class boxes are suppressed."""
    shapes = param_shapes(cfg)
    convs = [k for k, s in shapes.items() if len(s) == 4]
    sizes = [int(np.prod(shapes[k])) for k in convs]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    sd = {}
    for k, part in zip(convs, torch.split(u, sizes)):
        s = shapes[k]
        bound = 1.0 / math.sqrt(s[1] * s[2] * s[3])
        sd[k] = ((part * 2.0 - 1.0) * bound).reshape(s)
    for k, s in shapes.items():
        if k in sd:
            continue
        fill = 1.0 if k.endswith((".weight", "running_var")) else 0.0
        sd[k] = torch.full(s, fill, device=device)
    x, _ = prepare(calib_images, cfg, device)
    trunk(sd, cfg, x.permute(0, 3, 1, 2), calibrate=True)
    na, no = len(_anchors(cfg)[0]), cfg["nc"] + 5
    spread = torch.rand(len(STRIDES), na, no, generator=gen, device=device)
    boxn = torch.randn(len(STRIDES), na, 4, generator=gen, device=device)
    for li in range(len(STRIDES)):
        sd[f"model.24.m.{li}.weight"].mul_(3.0)
        b = torch.empty(na, no, device=device)
        b[:, 0:4] = boxn[li] * 0.5
        b[:, 4] = spread[li, :, 4] * 3.0 - 3.5
        b[:, 5:] = spread[li, :, 5:] * 4.0 - 5.0
        sd[f"model.24.m.{li}.bias"] = b.reshape(-1)
    return sd


def flops(cfg, batch=1):
    """{"conv": FLOPs, "linear": FLOPs} of the trunk and head for ``batch``
    letterboxed images, 2 per multiply-add, counted on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    sd = {k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()}
    x = torch.empty(batch, cfg["img_size"], cfg["img_size"], 3, device="meta")
    with FlopCounterMode(display=False) as fc:
        feats = trunk(sd, cfg, x.permute(0, 3, 1, 2))
        for li, f in enumerate(feats):
            F.conv2d(f, sd[f"model.24.m.{li}.weight"])
    return _split(fc)


def _split(fc):
    counts = fc.get_flop_counts()["Global"]
    conv = sum(v for k, v in counts.items() if "convolution" in str(k))
    return {"conv": conv, "linear": fc.get_total_flops() - conv}
