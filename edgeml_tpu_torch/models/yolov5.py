"""YOLOv5 (n/s/m/l/x) in PyTorch — the weak/strong detector pair.

The v6.x architecture (6x6 stem conv, CSP C3 blocks, SPPF, PANet neck,
anchor-based 3-level detect head) with width/depth multiples per variant,
ultralytics module naming (``model.{idx}...``) so yolov5 state_dicts load by
key. Activations are NCHW inside the module; the serving output of
``predict`` is in the reference package's layout:

    obj (B, N), xywh (B, N, 4) f32 pixel xywh-center, cls (B, N, nc),

rows ordered level, h, w, anchor (N = sum over levels of H * W * na).

Weights come from a seeded ``torch.Generator`` (torch's default conv init:
uniform in +-1/sqrt(fan_in); BatchNorm identity; yolov5's objectness/class
bias priors), from the reference package's parameter trees
(``from_jax_params``; ``to_jax_params`` writes them back) or from an
ultralytics state_dict (``load_ultralytics_state_dict``).

Training: ``net.train()`` then ``train_forward`` (batch-stat BatchNorm, the
raw per-level heads the loss reads, running stats updated in place).
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import (
    CastCache, ConvBN, cast_params, max_pool_same, running_stats,
    seeded_init_, upsample2x,
)

BN_EPS = 1e-3
BN_MOMENTUM = 0.03

# (depth_multiple, width_multiple) per variant.
YOLOV5_VARIANTS = {
    "n": (0.33, 0.25),
    "s": (0.33, 0.50),
    "m": (0.67, 0.75),
    "l": (1.00, 1.00),
    "x": (1.33, 1.25),
}

# Default P5 anchors in pixels, per detection level (stride 8 / 16 / 32).
DEFAULT_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
STRIDES = (8, 16, 32)
HEAD_STAGES = (17, 20, 23)  # layer indices feeding the detect head


def _gw(c, width):
    """Scale channel count by the width multiple, to a multiple of 8."""
    return max(int(math.ceil(c * width / 8) * 8), 8) if c != 3 else 3


def _gd(n, depth):
    return max(round(n * depth), 1)


def yolov5_layers(variant: str):
    """The layer table: (index, kind, from, kwargs); "from" -1 is the
    previous output."""
    d, w = YOLOV5_VARIANTS[variant]
    c = {k: _gw(k, w) for k in (64, 128, 256, 512, 1024)}
    return [
        (0, "conv", -1, dict(cin=3, cout=c[64], k=6, s=2, p=2)),
        (1, "conv", -1, dict(cin=c[64], cout=c[128], k=3, s=2)),
        (2, "c3", -1, dict(cin=c[128], cout=c[128], n=_gd(3, d), shortcut=True)),
        (3, "conv", -1, dict(cin=c[128], cout=c[256], k=3, s=2)),
        (4, "c3", -1, dict(cin=c[256], cout=c[256], n=_gd(6, d), shortcut=True)),
        (5, "conv", -1, dict(cin=c[256], cout=c[512], k=3, s=2)),
        (6, "c3", -1, dict(cin=c[512], cout=c[512], n=_gd(9, d), shortcut=True)),
        (7, "conv", -1, dict(cin=c[512], cout=c[1024], k=3, s=2)),
        (8, "c3", -1, dict(cin=c[1024], cout=c[1024], n=_gd(3, d), shortcut=True)),
        (9, "sppf", -1, dict(cin=c[1024], cout=c[1024], k=5)),
        (10, "conv", -1, dict(cin=c[1024], cout=c[512], k=1, s=1)),
        (11, "up", -1, {}),
        (12, "concat", (-1, 6), {}),
        (13, "c3", -1, dict(cin=c[1024], cout=c[512], n=_gd(3, d), shortcut=False)),
        (14, "conv", -1, dict(cin=c[512], cout=c[256], k=1, s=1)),
        (15, "up", -1, {}),
        (16, "concat", (-1, 4), {}),
        (17, "c3", -1, dict(cin=c[512], cout=c[256], n=_gd(3, d), shortcut=False)),
        (18, "conv", -1, dict(cin=c[256], cout=c[256], k=3, s=2)),
        (19, "concat", (-1, 14), {}),
        (20, "c3", -1, dict(cin=c[512], cout=c[512], n=_gd(3, d), shortcut=False)),
        (21, "conv", -1, dict(cin=c[512], cout=c[512], k=3, s=2)),
        (22, "concat", (-1, 10), {}),
        (23, "c3", -1, dict(cin=c[1024], cout=c[1024], n=_gd(3, d), shortcut=False)),
    ]


def _convbn(cin, cout, k=1, s=1, p=None):
    return ConvBN(cin, cout, k, s, p, eps=BN_EPS, momentum=BN_MOMENTUM)


class Bottleneck(nn.Module):
    def __init__(self, c, shortcut):
        super().__init__()
        self.cv1 = _convbn(c, c, 1)
        self.cv2 = _convbn(c, c, 3)
        self.add = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    def __init__(self, cin, cout, n, shortcut):
        super().__init__()
        ch = cout // 2
        self.cv1 = _convbn(cin, ch, 1)
        self.cv2 = _convbn(cin, ch, 1)
        self.cv3 = _convbn(2 * ch, cout, 1)
        self.m = nn.Sequential(*[Bottleneck(ch, shortcut) for _ in range(n)])

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPPF(nn.Module):
    def __init__(self, cin, cout, k=5):
        super().__init__()
        ch = cin // 2
        self.cv1 = _convbn(cin, ch, 1)
        self.cv2 = _convbn(ch * 4, cout, 1)
        self.k = k

    def forward(self, x):
        y = self.cv1(x)
        p1 = max_pool_same(y, self.k)
        p2 = max_pool_same(p1, self.k)
        p3 = max_pool_same(p2, self.k)
        return self.cv2(torch.cat([y, p1, p2, p3], 1))


class Detect(nn.Module):
    """Per-level 1x1 convs with bias (``model.24.m.{level}``)."""

    def __init__(self, nc, chs, na):
        super().__init__()
        self.m = nn.ModuleList(nn.Conv2d(c, na * (nc + 5), 1) for c in chs)
        self._cast = CastCache()


class YoloV5(nn.Module):
    """YOLOv5 detector. ``anchors`` are pixels per level, a plain tuple (not
    a buffer: a bf16 copy of the module must not round them)."""

    def __init__(self, variant: str = "n", num_classes: int = 80,
                 img_size: int = 640, anchors=DEFAULT_ANCHORS,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.variant = variant
        self.num_classes = num_classes
        self.img_size = img_size
        self.anchors = tuple(tuple(tuple(float(v) for v in a) for a in lvl)
                             for lvl in anchors)
        mods = []
        for idx, kind, _, kw in self.layers():
            if kind == "conv":
                mods.append(_convbn(kw["cin"], kw["cout"], kw["k"], kw["s"],
                                    kw.get("p")))
            elif kind == "c3":
                mods.append(C3(kw["cin"], kw["cout"], kw["n"], kw["shortcut"]))
            elif kind == "sppf":
                mods.append(SPPF(kw["cin"], kw["cout"], kw["k"]))
            else:  # up / concat: routing only, no parameters
                mods.append(nn.Identity())
        mods.append(Detect(num_classes, self.head_channels, self.na))
        self.model = nn.ModuleList(mods)
        self.reset_parameters(generator)
        self.eval()

    @property
    def na(self):
        return len(self.anchors[0])

    @property
    def no(self):
        return self.num_classes + 5

    @property
    def head_channels(self):
        w = YOLOV5_VARIANTS[self.variant][1]
        return (_gw(256, w), _gw(512, w), _gw(1024, w))

    def layers(self):
        return yolov5_layers(self.variant)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Seeded init: conv weights uniform in +-1/sqrt(fan_in) (torch's
        default conv init), BatchNorm identity, and yolov5's detect-head
        bias priors (objectness log(8 / (640 / stride)^2), class
        log(0.6 / (nc - 0.99999)))."""
        seeded_init_(self, generator)
        for conv, stride in zip(self.model[24].m, STRIDES):
            b = np.zeros((self.na, self.no), np.float32)
            b[:, 4] = math.log(8 / (self.img_size / stride) ** 2)
            b[:, 5:] = math.log(0.6 / (self.num_classes - 0.99999))
            conv.bias.copy_(torch.from_numpy(b.reshape(-1)))

    # ---- forward -----------------------------------------------------------

    def walk(self, x, conv_fn, c3_fn, sppf_fn):
        """The one traversal of the layer graph (backbone + neck): the float
        trunk, the int8 calibration pass and the int8 serving trunk
        (``models/quant.py``) all route through it, so their dataflow cannot
        drift apart (the int8 scales are valid only because calibration and
        serving walk the same graph).

        ``conv_fn`` / ``c3_fn`` / ``sppf_fn(name, x, kw)`` compute one block
        (``name`` is ``l{idx}``, ``kw`` the layer table's kwargs); the up and
        concat routing lives here. Returns (the HEAD_STAGES outputs, {stage
        index: output} of every stage)."""
        outputs = {}
        y = x
        for idx, kind, src, kw in self.layers():
            name = f"l{idx}"
            if kind == "conv":
                y = conv_fn(name, y, kw)
            elif kind == "c3":
                y = c3_fn(name, y, kw)
            elif kind == "sppf":
                y = sppf_fn(name, y, kw)
            elif kind == "up":
                y = upsample2x(y)
            elif kind == "concat":
                y = torch.cat([y, outputs[src[1]]], 1)
            else:
                raise ValueError(f"unknown layer kind {kind!r}")
            outputs[idx] = y
        return [outputs[i] for i in HEAD_STAGES], outputs

    def _walk(self, x):
        """Backbone + neck walk with this module's blocks; returns every
        stage's output (NCHW) by stage index 0..23."""

        def block(name, y, kw):
            return self.model[int(name[1:])](y)

        return self.walk(x, block, block, block)[1]

    def trunk(self, x):
        """Backbone + neck walk; returns the HEAD_STAGES outputs (NCHW)."""
        outputs = self._walk(x)
        return [outputs[i] for i in HEAD_STAGES]

    @torch.no_grad()
    def taps(self, x, stages):
        """Hidden-stage feature maps: {stage: (B, C, H, W) activation} for
        each requested stage index 0..23 (``data/io.py V5_STAGE_NAMES``
        numbering), in the input's dtype and on its device.

        :param x: (B, S, S, 3) float images in [0, 1], NHWC as the loader
            produces them.
        """
        stages = tuple(stages)
        bad = [s for s in stages if not 0 <= s <= HEAD_STAGES[-1]]
        if bad:
            raise ValueError(f"tap stages must lie in 0..{HEAD_STAGES[-1]}, "
                             f"not {bad}")
        outputs = self._walk(x.permute(0, 3, 1, 2))
        return {s: outputs[s] for s in stages}

    @torch.no_grad()
    def predict(self, x, dtype: torch.dtype | None = None):
        """Serving path: trunk + head + anchor decode.

        :param x: (B, S, S, 3) float images in [0, 1], NHWC as the loader
            produces them.
        :param dtype: optional compute dtype for the trunk and the obj/cls
            score path (torch.bfloat16). Box geometry is always decoded in
            f32: the xy/wh head outputs are cast to f32 before their (bf16-
            rounded) bias is added, as in the reference.
        :return: (obj (B, N), xywh (B, N, 4) f32, cls (B, N, nc)).
        """
        hdtype = torch.float32 if dtype is None else dtype
        x = x.permute(0, 3, 1, 2).to(hdtype)
        feats = self.trunk(x)
        det = self.model[24]
        params = det._cast.get(
            [t for conv in det.m for t in (conv.weight, conv.bias)], hdtype)
        na, no = self.na, self.no
        f32 = torch.float32
        objs, xywhs, clss = [], [], []
        for li, (f, stride, anchors) in enumerate(
                zip(feats, STRIDES, self.anchors)):
            w, bias = params[2 * li], params[2 * li + 1].reshape(na, no)
            h = F.conv2d(f, w)  # (B, na*no, H, W), bias added per component
            b, _, hh, ww = h.shape
            h = h.reshape(b, na, no, hh, ww).permute(0, 3, 4, 1, 2)
            o, xw, cl = self.decode_level_split(
                h[..., 0:2].to(f32) + bias[:, 0:2].to(f32),
                h[..., 2:4].to(f32) + bias[:, 2:4].to(f32),
                h[..., 4] + bias[:, 4], h[..., 5:] + bias[:, 5:], stride,
                anchors)
            objs.append(o)
            xywhs.append(xw)
            clss.append(cl)
        return torch.cat(objs, 1), torch.cat(xywhs, 1), torch.cat(clss, 1)

    def decode_level_split(self, h_xy, h_wh, h_obj, h_cls, stride, anchors):
        """Anchor decode of one level from its split head components, each
        (B, H, W, na, ...) with the bias added: ``h_xy`` / ``h_wh`` f32,
        ``h_obj`` / ``h_cls`` in the score dtype. Shared by the f32/bf16
        ``predict`` and the int8 head (``models/quant.py``), so the box
        parameterisation cannot drift between them.

        :return: (obj (B, H*W*na), xywh (B, H*W*na, 4) f32,
            cls (B, H*W*na, nc)).
        """
        f32 = torch.float32
        b, hh, ww = h_obj.shape[:3]
        gy, gx = torch.meshgrid(
            torch.arange(hh, dtype=f32, device=h_obj.device),
            torch.arange(ww, dtype=f32, device=h_obj.device), indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)  # (H, W, 2) = (x, y)
        anc = self._anchor_tensor(anchors, h_obj.device)
        xy = (torch.sigmoid(h_xy) * 2.0 - 0.5 + grid[:, :, None, :]) * stride
        wh = (torch.sigmoid(h_wh) * 2.0) ** 2 * anc[None, None, :, :]
        return (torch.sigmoid(h_obj).reshape(b, -1),
                torch.cat([xy, wh], -1).reshape(b, -1, 4),
                torch.sigmoid(h_cls).reshape(b, -1, self.num_classes))

    def _anchor_tensor(self, anchors, device):
        """One level's (na, 2) f32 anchors on ``device``, cached: a host to
        device copy per call would wait for the stream."""
        cache = self.__dict__.setdefault("_anchors_on_device", {})
        key = (anchors, str(device))
        if key not in cache:
            cache[key] = torch.tensor(anchors, dtype=torch.float32,
                                      device=device)
        return cache[key]

    def raw_heads(self, x):
        """Raw f32 head outputs per level, (B, H, W, na, no) — the
        reference's ``apply`` layout, for import checks. x: NHWC."""
        feats = self.trunk(x.permute(0, 3, 1, 2))
        out = []
        for f, conv in zip(feats, self.model[24].m):
            h = conv(f)
            b, _, hh, ww = h.shape
            out.append(h.reshape(b, self.na, self.no, hh, ww)
                       .permute(0, 3, 4, 1, 2))
        return out

    def train_forward(self, x, dtype: torch.dtype | None = None):
        """Training forward (the module must be in training mode).

        :param x: (B, S, S, 3) f32 images in [0, 1], NHWC.
        :param dtype: optional compute dtype (torch.bfloat16): weights are
            cast with autograd, BatchNorm statistics stay f32.
        :return: (heads, stats): the raw per-level heads, f32
            (B, H, W, na, no) as the reference's ``apply`` lays them out,
            and ``running_stats()`` after their in-place update.
        """
        if not self.training:
            raise RuntimeError("train_forward needs net.train()")
        hd = torch.float32 if dtype is None else dtype
        feats = self.trunk(x.permute(0, 3, 1, 2).to(hd))
        det = self.model[24]
        heads = []
        for f, conv in zip(feats, det.m):
            w, b = cast_params(det, [conv.weight, conv.bias], hd)
            h = F.conv2d(f, w) + b[:, None, None]
            bsz, _, hh, ww = h.shape
            heads.append(h.reshape(bsz, self.na, self.no, hh, ww)
                         .permute(0, 3, 4, 1, 2).to(torch.float32))
        return heads, running_stats(self)

    # ---- weights -----------------------------------------------------------

    @torch.no_grad()
    def to_jax_params(self):
        """The reference package's (params, stats) trees of this module:
        nested dicts and lists of f32 NumPy arrays, HWIO conv kernels; the
        exact inverse of ``from_jax_params``."""

        def arr(t):
            return t.detach().cpu().to(torch.float32).numpy().copy()

        def convbn(mod):
            return ({"w": arr(mod.conv.weight.permute(2, 3, 1, 0)),
                     "g": arr(mod.bn.weight), "b": arr(mod.bn.bias)},
                    {"m": arr(mod.bn.running_mean),
                     "v": arr(mod.bn.running_var)})

        params, stats = {}, {}
        for idx, kind, _, kw in self.layers():
            name = f"l{idx}"
            mod = self.model[idx]
            if kind == "conv":
                params[name], stats[name] = convbn(mod)
            elif kind == "c3":
                p, s = {}, {}
                for cv in ("cv1", "cv2", "cv3"):
                    p[cv], s[cv] = convbn(getattr(mod, cv))
                p["m"], s["m"] = [], []
                for j in range(kw["n"]):
                    bp, bs = {}, {}
                    for cv in ("cv1", "cv2"):
                        bp[cv], bs[cv] = convbn(getattr(mod.m[j], cv))
                    p["m"].append(bp)
                    s["m"].append(bs)
                params[name], stats[name] = p, s
            elif kind == "sppf":
                p, s = {}, {}
                p["cv1"], s["cv1"] = convbn(mod.cv1)
                p["cv2"], s["cv2"] = convbn(mod.cv2)
                params[name], stats[name] = p, s
        params["detect"] = [{"w": arr(conv.weight.permute(2, 3, 1, 0)),
                             "b": arr(conv.bias)}
                            for conv in self.model[24].m]
        return params, stats

    @torch.no_grad()
    def from_jax_params(self, params, stats):
        """Fill the module from the reference package's (params, stats)
        trees (nested dicts/lists of arrays, HWIO conv kernels)."""

        def arr(a):
            return torch.from_numpy(np.array(a, dtype=np.float32))

        def convbn(mod, p, s):
            mod.conv.weight.copy_(arr(p["w"]).permute(3, 2, 0, 1))
            mod.bn.weight.copy_(arr(p["g"]))
            mod.bn.bias.copy_(arr(p["b"]))
            mod.bn.running_mean.copy_(arr(s["m"]))
            mod.bn.running_var.copy_(arr(s["v"]))

        for idx, kind, _, kw in self.layers():
            name = f"l{idx}"
            mod = self.model[idx]
            if kind == "conv":
                convbn(mod, params[name], stats[name])
            elif kind == "c3":
                p, s = params[name], stats[name]
                for cv in ("cv1", "cv2", "cv3"):
                    convbn(getattr(mod, cv), p[cv], s[cv])
                for j in range(kw["n"]):
                    for cv in ("cv1", "cv2"):
                        convbn(getattr(mod.m[j], cv), p["m"][j][cv],
                               s["m"][j][cv])
            elif kind == "sppf":
                p, s = params[name], stats[name]
                convbn(mod.cv1, p["cv1"], s["cv1"])
                convbn(mod.cv2, p["cv2"], s["cv2"])
        for conv, p in zip(self.model[24].m, params["detect"]):
            conv.weight.copy_(arr(p["w"]).permute(3, 2, 0, 1))
            conv.bias.copy_(arr(p["b"]))
        return self

    @torch.no_grad()
    def load_ultralytics_state_dict(self, sd):
        """Load an ultralytics YOLOv5 state_dict (torch tensors or numpy
        arrays). Keys may carry a leading ``model.`` or not. The checkpoint's
        ``model.24.anchors`` is in grid units (anchors / stride) and is
        rescaled back to pixels."""

        def get(k):
            for cand in (k, "model." + k, k.replace("model.", "", 1)):
                if cand in sd:
                    v = sd[cand]
                    return np.asarray(v.detach().cpu().numpy()
                                      if hasattr(v, "detach") else v)
            raise KeyError(k)

        for key, dst in self.state_dict().items():
            if key.endswith("num_batches_tracked"):
                continue
            src = get(key)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: checkpoint shape {src.shape}, "
                                 f"model shape {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))
        try:
            anchors_grid = get("model.24.anchors")  # (3, na, 2), grid units
        except KeyError:
            return self
        anchors_px = anchors_grid * np.asarray(STRIDES)[:, None, None]
        self.anchors = tuple(tuple(map(tuple, lvl))
                             for lvl in anchors_px.tolist())
        return self


@torch.no_grad()
def fuse_convbn(net: YoloV5) -> YoloV5:
    """A copy of ``net`` with every BatchNorm's statistics folded into its
    conv for inference, the reference package's ``fuse_convbn``: the conv
    weight times ``scale = gain * rsqrt(var + eps)``, the shift ``bias -
    mean * scale``, then gain 1, mean 0 and variance 1. The norm stays in
    the walk, so the copy re-applies ``rsqrt(1 + eps)`` as the reference's
    does; ``models/quant.py`` folds without it."""
    out = copy.deepcopy(net)
    for mod in out.modules():
        if isinstance(mod, ConvBN):
            bn = mod.bn
            scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            mod.conv.weight.mul_(scale[:, None, None, None])
            bn.bias.copy_(bn.bias - bn.running_mean * scale)
            bn.weight.fill_(1.0)
            bn.running_mean.zero_()
            bn.running_var.fill_(1.0)
    return out


@torch.no_grad()
def calibrate_bn(net: YoloV5, images_fn, iters: int = 6) -> dict:
    """Set every BatchNorm's running statistics to the network's actual
    activation statistics, pooled over ``iters`` train-mode calibration
    batches; the reference package's ``calibrate_bn``.

    Each train-mode pass normalises with its own batch statistics from the
    same starting statistics, so the passes are independent samples. The
    momentum update of each pass is inverted (``batch = old + (new - old) /
    momentum``) to recover the pass's raw moments (the variance unbiased,
    as the update keeps it), and the passes are pooled in (E[x], E[x^2]):
    every batch contributes, not just the last. ``iters == 1`` gives that
    batch's statistics exactly, with no moment round trip. Calibrate at the
    serving image size: spatial statistics depend on it.

    :param images_fn: iteration -> (B, S, S, 3) f32 calibration batch on the
        net's device.
    :return: ``running_stats(net)`` (the live buffers, now calibrated); the
        net is left in the mode it came in.
    """
    bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
    old = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in bns]
    was_training = net.training
    net.train()
    moments = None
    try:
        for i in range(iters):
            for bn, (m0, v0) in zip(bns, old):
                bn.running_mean.copy_(m0)
                bn.running_var.copy_(v0)
            net.train_forward(images_fn(i))
            batch = [(m0 + (bn.running_mean - m0) / bn.momentum,
                      v0 + (bn.running_var - v0) / bn.momentum)
                     for bn, (m0, v0) in zip(bns, old)]
            if iters == 1:
                moments = batch
                break
            mom = [(m, v + m ** 2) for m, v in batch]
            moments = mom if moments is None else [
                (a + m, b + v) for (a, b), (m, v) in zip(moments, mom)]
        if iters > 1:
            moments = [(a / iters, torch.clamp_min(b / iters - (a / iters) ** 2,
                                                   0.0))
                       for a, b in moments]
        for bn, (m, v) in zip(bns, moments):
            bn.running_mean.copy_(m)
            bn.running_var.copy_(v)
    finally:
        net.train(was_training)
    return running_stats(net)
