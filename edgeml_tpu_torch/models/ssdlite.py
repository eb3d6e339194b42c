"""SSDLite320-MobileNetV3-Large in PyTorch.

The reference's default detector. Architecture per torchvision:

  * feature extractor: MobileNetV3-Large tapped at block 12's expansion conv
    (672 channels, stride 16) and its last map, plus four SSDLite extra
    blocks (1x1 reduce -> depthwise 3x3 s2 -> 1x1 expand, ReLU6, channels
    512/256/256/128) -> 6 feature maps, 20/10/5/3/2/1 for a 320 input;
  * default boxes: aspect ratios {2, 3}, scales linear 0.2..0.95 plus the
    geometric-mean box -> 6 boxes per location;
  * heads: depthwise-separable prediction blocks (classification to
    num_classes including background, regression to 4), box coder weights
    (10, 10, 5, 5).

Module names follow torchvision's ``ssdlite320_mobilenet_v3_large``
(``backbone.features``, ``backbone.extra``, ``head.classification_head.
module_list``, ``head.regression_head.module_list``), so its state_dict
loads with ``load_state_dict(strict=True)``. The forward takes NHWC images
and returns the reference's layout: (cls_logits (B, A, C), reg (B, A, 4)),
rows ordered level, h, w, box.

Weights come from a seeded ``torch.Generator`` (uniform +-1/sqrt(fan_in)
convs, zero biases, identity BatchNorm), from the reference package's
parameter trees (``from_jax_params``; ``to_jax_params`` writes them back) or
from a torchvision state_dict.

Training: ``net.train()`` then ``train_forward`` (batch-stat BatchNorm,
running stats updated in place); ``encode_boxes`` gives the regression
targets.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from .common import ConvNormAct, DtypeConv2d, running_stats, seeded_init_
from .mobilenetv3 import (
    BN_EPS, BN_MOMENTUM, mobilenet_v3_large_features, v3_large_config,
)

BOX_CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
BOXES_PER_LOCATION = 6


def default_boxes(image_size: int = 320, feature_sizes=(20, 10, 5, 3, 2, 1)):
    """Default-box grid, (A, 4) xyxy pixels, f32 — torchvision's
    DefaultBoxGenerator (aspect ratios [2, 3], scales 0.2..0.95 linear plus
    the geometric-mean box, wh clipped to [0, 1]); box-major within a cell."""
    k = len(feature_sizes)
    scales = [0.2 + (0.95 - 0.2) * i / (k - 1) for i in range(k)] + [1.0]
    out = []
    for fi, f in enumerate(feature_sizes):
        s = scales[fi]
        s_prime = math.sqrt(s * scales[fi + 1])
        wh = [[s, s], [s_prime, s_prime]]
        for r in (2, 3):
            sr = math.sqrt(r)
            wh.append([s * sr, s / sr])
            wh.append([s / sr, s * sr])
        wh = np.clip(np.array(wh, np.float32), 0.0, 1.0)  # (6, 2)
        ys, xs = np.meshgrid(np.arange(f), np.arange(f), indexing="ij")
        cx = (xs.reshape(-1, 1) + 0.5) / f
        cy = (ys.reshape(-1, 1) + 0.5) / f
        c = np.concatenate(
            [np.repeat(cx, 6, 1).reshape(-1, 1),
             np.repeat(cy, 6, 1).reshape(-1, 1)], axis=1)
        whs = np.tile(wh, (f * f, 1))
        boxes = np.concatenate([c - whs / 2, c + whs / 2], axis=1) * image_size
        out.append(boxes.astype(np.float32))
    return np.concatenate(out)


def _extra_block(cin: int, cout: int) -> nn.Sequential:
    mid = cout // 2
    kw = dict(act="relu6", eps=BN_EPS, momentum=BN_MOMENTUM)
    return nn.Sequential(
        ConvNormAct(cin, mid, 1, **kw),
        ConvNormAct(mid, mid, 3, 2, groups=mid, **kw),
        ConvNormAct(mid, cout, 1, **kw),
    )


class SSDLiteExtractor(nn.Module):
    """``backbone``: MobileNetV3 ``features`` (C4, C5) + four ``extra``
    blocks -> six NCHW maps."""

    def __init__(self, reduced_tail: bool):
        super().__init__()
        self.features = mobilenet_v3_large_features(reduced_tail)
        c5 = 6 * v3_large_config(reduced_tail)[-1][2]
        self.extra = nn.ModuleList(
            _extra_block(cin, cout) for cin, cout in
            ((c5, 512), (512, 256), (256, 256), (256, 128)))

    def forward(self, x):
        out = []
        for block in self.features:
            x = block(x)
            out.append(x)
        for block in self.extra:
            x = block(x)
            out.append(x)
        return out


class SSDLitePredictionHead(nn.Module):
    """Per level: depthwise 3x3 ConvNormAct (ReLU6) -> 1x1 conv to
    6 * cols; outputs concatenated as (B, sum H * W * 6, cols)."""

    def __init__(self, channels, cols: int):
        super().__init__()
        self.cols = cols
        self.module_list = nn.ModuleList(
            nn.Sequential(
                ConvNormAct(c, c, 3, groups=c, act="relu6", eps=BN_EPS,
                            momentum=BN_MOMENTUM),
                DtypeConv2d(c, BOXES_PER_LOCATION * cols, 1))
            for c in channels)

    def forward(self, feats):
        outs = []
        for f, mod in zip(feats, self.module_list):
            h = mod(f)  # (B, 6 * cols, H, W), channel = box * cols + col
            b = h.shape[0]
            outs.append(h.permute(0, 2, 3, 1).reshape(b, -1, self.cols))
        return torch.cat(outs, 1)


class SSDLiteHead(nn.Module):
    def __init__(self, channels, num_classes: int):
        super().__init__()
        self.classification_head = SSDLitePredictionHead(channels,
                                                         num_classes)
        self.regression_head = SSDLitePredictionHead(channels, 4)


class SSDLite(nn.Module):
    """SSDLite320-MobileNetV3-Large. ``num_classes`` includes background
    (class 0). ``reduced_tail``: torchvision's released COCO checkpoint has
    the reduced MobileNet tail (C5 = 480 channels); a model trained from an
    ImageNet backbone has the full one (960)."""

    def __init__(self, num_classes: int = 91, image_size: int = 320,
                 reduced_tail: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.image_size = image_size
        self.reduced_tail = reduced_tail
        self.backbone = SSDLiteExtractor(reduced_tail)
        self.head = SSDLiteHead(self.feature_channels, num_classes)
        self.reset_parameters(generator)
        self.eval()

    @property
    def c5_channels(self) -> int:
        return 6 * v3_large_config(self.reduced_tail)[-1][2]

    @property
    def feature_channels(self):
        return (672, self.c5_channels, 512, 256, 256, 128)

    @property
    def feature_sizes(self):
        """Per-level grid sizes for this image size (320 -> 20/10/5/3/2/1):
        C4 at stride 16, C5 at stride 32, then each extra block's stride-2
        conv halves with ceil."""
        f = [-(-self.image_size // 16), -(-self.image_size // 32)]
        for _ in range(4):
            f.append(-(-f[-1] // 2))
        return tuple(f)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """Seeded init: conv weights uniform in +-1/sqrt(fan_in), conv
        biases zero, BatchNorm identity (the reference's init)."""
        seeded_init_(self, generator)

    def forward(self, x):
        """x: (B, S, S, 3) normalised images, NHWC; the compute dtype is
        x's. Returns (cls_logits (B, A, C), reg (B, A, 4)) in that dtype."""
        feats = self.backbone(x.permute(0, 3, 1, 2))
        return (self.head.classification_head(feats),
                self.head.regression_head(feats))

    def train_forward(self, x, dtype: torch.dtype | None = None):
        """Training forward (the module must be in training mode).

        :param x: (B, S, S, 3) f32 normalised images, NHWC.
        :param dtype: optional compute dtype (torch.bfloat16): weights are
            cast with autograd, BatchNorm statistics stay f32.
        :return: ((cls_logits (B, A, C), reg (B, A, 4)) in f32, stats):
            ``running_stats()`` after their in-place update.
        """
        if not self.training:
            raise RuntimeError("train_forward needs net.train()")
        cls, reg = self(x if dtype is None else x.to(dtype))
        return (cls.to(torch.float32), reg.to(torch.float32)), \
            running_stats(self)

    def anchors(self, device) -> torch.Tensor:
        """The (A, 4) f32 default boxes on ``device``, cached."""
        cache = self.__dict__.setdefault("_anchors_on_device", {})
        key = str(device)
        if key not in cache:
            cache[key] = torch.from_numpy(
                default_boxes(self.image_size, self.feature_sizes)).to(device)
        return cache[key]

    @staticmethod
    def decode_boxes(reg, anchors):
        """Apply (10, 10, 5, 5)-weighted deltas to xyxy anchors -> xyxy, in
        the reference's op order (log-size deltas clipped at
        log(1000 / 16))."""
        wx, wy, ww, wh = BOX_CODER_WEIGHTS
        acx = (anchors[:, 0] + anchors[:, 2]) * 0.5
        acy = (anchors[:, 1] + anchors[:, 3]) * 0.5
        aw = anchors[:, 2] - anchors[:, 0]
        ah = anchors[:, 3] - anchors[:, 1]
        clip = math.log(1000.0 / 16)
        cx = reg[..., 0] / wx * aw + acx
        cy = reg[..., 1] / wy * ah + acy
        w = torch.exp(torch.clamp(reg[..., 2] / ww, max=clip)) * aw
        h = torch.exp(torch.clamp(reg[..., 3] / wh, max=clip)) * ah
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                           -1)

    @staticmethod
    def encode_boxes(gt, anchors):
        """Inverse of ``decode_boxes``: (10, 10, 5, 5)-weighted deltas of
        xyxy ``gt`` from xyxy ``anchors`` (the training targets), in the
        reference's op order (sides floored at 1e-6)."""
        wx, wy, ww, wh = BOX_CODER_WEIGHTS
        acx = (anchors[:, 0] + anchors[:, 2]) * 0.5
        acy = (anchors[:, 1] + anchors[:, 3]) * 0.5
        aw = anchors[:, 2] - anchors[:, 0]
        ah = anchors[:, 3] - anchors[:, 1]
        gcx = (gt[..., 0] + gt[..., 2]) * 0.5
        gcy = (gt[..., 1] + gt[..., 3]) * 0.5
        gw = torch.clamp_min(gt[..., 2] - gt[..., 0], 1e-6)
        gh = torch.clamp_min(gt[..., 3] - gt[..., 1], 1e-6)
        return torch.stack([wx * (gcx - acx) / aw, wy * (gcy - acy) / ah,
                            ww * torch.log(gw / aw), wh * torch.log(gh / ah)],
                           -1)

    # ---- weights -----------------------------------------------------------

    def _backbone_units(self):
        """The backbone's layers in the reference's tree order: [(block
        index or "stem"/"last", part name, kind, module)], kind "cna" (conv +
        norm) or "se"."""
        head, tail = self.backbone.features
        mods = list(head[1:]) + list(tail)
        units = [("stem", None, "cna", head[0])]
        cin = 16
        for bi, (k, exp, out, use_se, _, _) in enumerate(
                v3_large_config(self.reduced_tail)):
            if bi < 12:
                layers = list(mods[bi].block)
            elif bi == 12:
                layers = [mods[12]] + list(mods[13])
            else:
                layers = list(mods[bi + 1].block)
            parts = [("expand", "cna")] if exp != cin else []
            parts.append(("dw", "cna"))
            if use_se:
                parts.append(("se", "se"))
            parts.append(("project", "cna"))
            if len(parts) != len(layers):
                raise ValueError(f"block {bi}: {len(parts)} parts in the "
                                 f"config, {len(layers)} in the module")
            units += [(bi, name, kind, mod)
                      for (name, kind), mod in zip(parts, layers)]
            cin = out
        units.append(("last", None, "cna", tail[-1]))
        return units

    @torch.no_grad()
    def to_jax_params(self):
        """The reference package's (params, stats) trees of this module:
        nested dicts and lists of f32 NumPy arrays, HWIO conv kernels; the
        exact inverse of ``from_jax_params``."""

        def arr(t):
            return t.detach().cpu().to(torch.float32).numpy().copy()

        def conv(mod):
            return {"w": arr(mod.weight.permute(2, 3, 1, 0)),
                    "b": arr(mod.bias)}

        def cna(mod):
            return ({"w": arr(mod[0].weight.permute(2, 3, 1, 0)),
                     "g": arr(mod[1].weight), "b": arr(mod[1].bias)},
                    {"m": arr(mod[1].running_mean),
                     "v": arr(mod[1].running_var)})

        bp = {"blocks": [{} for _ in v3_large_config(self.reduced_tail)]}
        bs = {"blocks": [{} for _ in bp["blocks"]]}
        for where, name, kind, mod in self._backbone_units():
            if kind == "se":
                bp["blocks"][where][name] = {"fc1": conv(mod.fc1),
                                             "fc2": conv(mod.fc2)}
            elif name is None:
                bp[where], bs[where] = cna(mod)
            else:
                bp["blocks"][where][name], bs["blocks"][where][name] = \
                    cna(mod)
        params, stats = {"backbone": bp}, {"backbone": bs}
        params["extra"], stats["extra"] = [], []
        for mod in self.backbone.extra:
            ep, es = {}, {}
            for unit, part in zip(mod, ("reduce", "dw", "expand")):
                ep[part], es[part] = cna(unit)
            params["extra"].append(ep)
            stats["extra"].append(es)
        for head_mod, key in ((self.head.classification_head, "cls_head"),
                              (self.head.regression_head, "reg_head")):
            params[key], stats[key] = [], []
            for mod in head_mod.module_list:
                dw_p, dw_s = cna(mod[0])
                params[key].append({"dw": dw_p, "proj": conv(mod[1])})
                stats[key].append({"dw": dw_s})
        return params, stats

    @torch.no_grad()
    def from_jax_params(self, params, stats):
        """Fill the module from the reference package's (params, stats)
        trees (nested dicts/lists of arrays, HWIO conv kernels)."""

        def arr(a):
            return torch.from_numpy(np.array(a, dtype=np.float32))

        def conv(mod, p):
            mod.weight.copy_(arr(p["w"]).permute(3, 2, 0, 1))
            if "b" in p and mod.bias is not None:
                mod.bias.copy_(arr(p["b"]))

        def cna(mod, p, s):
            mod[0].weight.copy_(arr(p["w"]).permute(3, 2, 0, 1))
            mod[1].weight.copy_(arr(p["g"]))
            mod[1].bias.copy_(arr(p["b"]))
            mod[1].running_mean.copy_(arr(s["m"]))
            mod[1].running_var.copy_(arr(s["v"]))

        bp, bs = params["backbone"], stats["backbone"]
        for where, name, kind, mod in self._backbone_units():
            p = bp[where] if name is None else bp["blocks"][where][name]
            if kind == "se":
                conv(mod.fc1, p["fc1"])
                conv(mod.fc2, p["fc2"])
            else:
                cna(mod, p, bs[where] if name is None
                    else bs["blocks"][where][name])
        for mod, p, s in zip(self.backbone.extra, params["extra"],
                             stats["extra"]):
            for unit, part in zip(mod, ("reduce", "dw", "expand")):
                cna(unit, p[part], s[part])
        for head_mod, key in ((self.head.classification_head, "cls_head"),
                              (self.head.regression_head, "reg_head")):
            for mod, p, s in zip(head_mod.module_list, params[key],
                                 stats[key]):
                cna(mod[0], p["dw"], s["dw"])
                conv(mod[1], p["proj"])
        return self
