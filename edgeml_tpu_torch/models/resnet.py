"""ResNet-50 + Feature Pyramid Network in PyTorch.

The trunk of RetinaNet-ResNet50-FPN-v2 (P3..P7) and of
Faster R-CNN-ResNet50-FPN-v2 (P2..P5 and a pooled P6). Structure per
torchvision: 7x7 s2
pad 3 stem conv, frozen BatchNorm, ReLU, 3x3 s2 pad 1 max pool; bottleneck
stages (3, 4, 6, 3) with the stride on the 3x3 conv (v1.5) and a 1x1
downsample on each stage's first block; frozen BatchNorm everywhere
(detection backbones apply fixed running statistics). The FPN takes the
stages from ``first_stage`` on (1: C3..C5, RetinaNet's ``returned_layers``
[2, 3, 4]; 0: C2..C5, Faster R-CNN's [1, 2, 3, 4]) through 1x1 lateral convs
with a nearest 2x top-down merge and 3x3 output convs, all 256 channels.
Extra levels: ``"p6p7"`` adds P6 as a 3x3 s2 conv on C5 and P7 as one on
relu(P6) (``LastLevelP6P7(2048, 256)``); ``"maxpool"`` adds a 1x1 stride-2
max pool of the last level (``LastLevelMaxPool``). With ``fpn_norm`` the
lateral and output convs carry no bias and are followed by BatchNorm
(Faster R-CNN v2's ``Conv2dNormActivation`` layers, ``inner_blocks.0.0``
and ``.0.1``); RetinaNet v2's FPN convs have biases and no norm.

Module names are torchvision's (``body.conv1``, ``body.layer1.0.conv1``,
``body.layer1.0.downsample.0``, ``fpn.inner_blocks.0.0``,
``fpn.layer_blocks.0.0``, ``fpn.extra_blocks.p6``), so a torchvision
``retinanet_resnet50_fpn_v2`` backbone loads by key.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import (
    ConvNormAct, DtypeConv2d, FrozenBatchNorm2d, host_array, jax_conv,
    load_jax_conv, upsample2x,
)

STAGE_BLOCKS = (3, 4, 6, 3)
STAGE_CHANNELS = (256, 512, 1024, 2048)
FPN_CHANNELS = 256


class Bottleneck(nn.Module):
    def __init__(self, cin: int, cmid: int, cout: int, stride: int,
                 downsample: bool):
        super().__init__()
        self.conv1 = DtypeConv2d(cin, cmid, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(cmid)
        self.conv2 = DtypeConv2d(cmid, cmid, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(cmid)
        self.conv3 = DtypeConv2d(cmid, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.downsample = nn.Sequential(
            DtypeConv2d(cin, cout, 1, stride, bias=False),
            FrozenBatchNorm2d(cout)) if downsample else None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idt = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + idt)


class ResNet50Body(nn.Module):
    """Stem and the four stages; returns the stages from ``first_stage`` on
    (1: C3, C4, C5; 0: C2 .. C5), NCHW."""

    def __init__(self, first_stage: int = 1):
        super().__init__()
        self.first_stage = first_stage
        self.conv1 = DtypeConv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        cin = 64
        for si, (n, cout) in enumerate(zip(STAGE_BLOCKS, STAGE_CHANNELS)):
            stride = 1 if si == 0 else 2
            blocks = [Bottleneck(cin if bi == 0 else cout, cout // 4, cout,
                                 stride if bi == 0 else 1, bi == 0)
                      for bi in range(n)]
            self.add_module(f"layer{si + 1}", nn.Sequential(*blocks))
            cin = cout

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, 1)
        cs = []
        for si in range(4):
            y = getattr(self, f"layer{si + 1}")(y)
            cs.append(y)
        return cs[self.first_stage:]


class LastLevelP6P7(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.p6 = DtypeConv2d(cin, cout, 3, 2, 1)
        self.p7 = DtypeConv2d(cout, cout, 3, 2, 1)


class FeaturePyramid(nn.Module):
    """Lateral 1x1 (``inner_blocks``) and output 3x3 (``layer_blocks``)
    convs (with biases, or without and followed by BatchNorm when
    ``norm``), top-down nearest 2x merge, then the extra levels."""

    def __init__(self, in_channels=STAGE_CHANNELS[1:], out=FPN_CHANNELS,
                 extra: str = "p6p7", norm: bool = False):
        super().__init__()
        if extra not in ("p6p7", "maxpool"):
            raise ValueError(f"unknown extra FPN levels {extra!r}")
        self.extra = extra

        def block(cin, k):
            if norm:
                return ConvNormAct(cin, out, k, act=None, eps=1e-5,
                                   frozen=True)
            return nn.Sequential(DtypeConv2d(cin, out, k, 1, k // 2))

        self.inner_blocks = nn.ModuleList(block(c, 1) for c in in_channels)
        self.layer_blocks = nn.ModuleList(block(out, 3) for _ in in_channels)
        if extra == "p6p7":
            self.extra_blocks = LastLevelP6P7(in_channels[-1], out)

    def forward(self, cs):
        ps = [None] * len(cs)
        for li in reversed(range(len(cs))):
            p = self.inner_blocks[li](cs[li])
            if li + 1 < len(cs):
                p = p + upsample2x(ps[li + 1])
            ps[li] = p
        feats = [blk(p) for p, blk in zip(ps, self.layer_blocks)]
        if self.extra == "maxpool":
            return feats + [F.max_pool2d(feats[-1], 1, 2)]
        p6 = self.extra_blocks.p6(cs[-1])
        p7 = self.extra_blocks.p7(torch.relu(p6))
        return feats + [p6, p7]


class ResNet50FPN(nn.Module):
    """``backbone``: body + fpn; forward NCHW images -> the FPN levels
    ([P3, .., P7] for RetinaNet's defaults; [P2, .., P5, pool] for
    ``extra="maxpool", first_stage=0, fpn_norm=True``, Faster R-CNN v2)."""

    def __init__(self, extra: str = "p6p7", first_stage: int = 1,
                 fpn_norm: bool = False):
        super().__init__()
        self.body = ResNet50Body(first_stage)
        self.fpn = FeaturePyramid(STAGE_CHANNELS[first_stage:], FPN_CHANNELS,
                                  extra, fpn_norm)

    def forward(self, x):
        return self.fpn(self.body(x))

    @torch.no_grad()
    def from_jax_params(self, bp):
        """Fill body and FPN from the reference's backbone parameter tree
        (HWIO kernels, frozen BatchNorm as g/b/m/v, FPN convs with biases;
        with ``fpn_norm`` each FPN norm carries its conv's bias as an exact
        identity, ``common.load_jax_conv``)."""

        def arr(a):
            return torch.from_numpy(np.array(a, dtype=np.float32))

        def frozen(conv, bn, p):
            conv.weight.copy_(arr(p["w"]).permute(3, 2, 0, 1))
            bn.weight.copy_(arr(p["g"]))
            bn.bias.copy_(arr(p["b"]))
            bn.running_mean.copy_(arr(p["m"]))
            bn.running_var.copy_(arr(p["v"]))

        body = self.body
        frozen(body.conv1, body.bn1, bp["stem"])
        for si, blocks in enumerate(bp["stages"]):
            for blk, p in zip(getattr(body, f"layer{si + 1}"), blocks):
                frozen(blk.conv1, blk.bn1, p["conv1"])
                frozen(blk.conv2, blk.bn2, p["conv2"])
                frozen(blk.conv3, blk.bn3, p["conv3"])
                if "down" in p:
                    frozen(blk.downsample[0], blk.downsample[1], p["down"])
        fpn = self.fpn
        for mods, ps in ((fpn.inner_blocks, bp["fpn_lateral"]),
                         (fpn.layer_blocks, bp["fpn_output"])):
            for mod, p in zip(mods, ps):
                load_jax_conv(mod[0], p, mod[1] if len(mod) > 1 else None)
        if fpn.extra == "p6p7":
            load_jax_conv(fpn.extra_blocks.p6, bp["p6"])
            load_jax_conv(fpn.extra_blocks.p7, bp["p7"])
        return self

    @torch.no_grad()
    def to_jax_params(self) -> dict:
        """The reference's backbone parameter tree of this module: the
        exact inverse of ``from_jax_params`` (HWIO kernels, frozen
        BatchNorm as g/b/m/v, FPN convs with their biases)."""

        def frozen(conv, bn):
            return {"w": host_array(conv.weight.permute(2, 3, 1, 0)),
                    "g": host_array(bn.weight), "b": host_array(bn.bias),
                    "m": host_array(bn.running_mean),
                    "v": host_array(bn.running_var)}

        body = self.body
        stages = []
        for si in range(len(STAGE_BLOCKS)):
            blocks = []
            for blk in getattr(body, f"layer{si + 1}"):
                p = {"conv1": frozen(blk.conv1, blk.bn1),
                     "conv2": frozen(blk.conv2, blk.bn2),
                     "conv3": frozen(blk.conv3, blk.bn3)}
                if blk.downsample is not None:
                    p["down"] = frozen(blk.downsample[0], blk.downsample[1])
                blocks.append(p)
            stages.append(blocks)
        fpn = self.fpn
        bp = {"stem": frozen(body.conv1, body.bn1), "stages": stages}
        for key, mods in (("fpn_lateral", fpn.inner_blocks),
                          ("fpn_output", fpn.layer_blocks)):
            bp[key] = [jax_conv(m[0], m[1] if len(m) > 1 else None)
                       for m in mods]
        if fpn.extra == "p6p7":
            bp["p6"] = jax_conv(fpn.extra_blocks.p6)
            bp["p7"] = jax_conv(fpn.extra_blocks.p7)
        return bp
