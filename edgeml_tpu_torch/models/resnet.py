"""ResNet-50 + Feature Pyramid Network (P3..P7) in PyTorch.

The trunk of RetinaNet-ResNet50-FPN-v2. Structure per torchvision: 7x7 s2
pad 3 stem conv, frozen BatchNorm, ReLU, 3x3 s2 pad 1 max pool; bottleneck
stages (3, 4, 6, 3) with the stride on the 3x3 conv (v1.5) and a 1x1
downsample on each stage's first block; frozen BatchNorm everywhere
(detection backbones apply fixed running statistics). The FPN takes C3, C4
and C5 (``returned_layers`` [2, 3, 4]) through 1x1 lateral convs with a
nearest 2x top-down merge and 3x3 output convs, all 256 channels, and adds
P6 as a 3x3 s2 conv on C5 and P7 as one on relu(P6) (``LastLevelP6P7(2048,
256)``).

Module names are torchvision's (``body.conv1``, ``body.layer1.0.conv1``,
``body.layer1.0.downsample.0``, ``fpn.inner_blocks.0.0``,
``fpn.layer_blocks.0.0``, ``fpn.extra_blocks.p6``), so a torchvision
``retinanet_resnet50_fpn_v2`` backbone loads by key.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import DtypeConv2d, FrozenBatchNorm2d, upsample2x

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
    """Stem and the four stages; returns C3, C4, C5 (NCHW)."""

    def __init__(self):
        super().__init__()
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
        return cs[1:]


class LastLevelP6P7(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.p6 = DtypeConv2d(cin, cout, 3, 2, 1)
        self.p7 = DtypeConv2d(cout, cout, 3, 2, 1)


class FeaturePyramid(nn.Module):
    """Lateral 1x1 (``inner_blocks``) and output 3x3 (``layer_blocks``)
    convs with biases over C3..C5, top-down nearest 2x merge, P6/P7."""

    def __init__(self, in_channels=STAGE_CHANNELS[1:], out=FPN_CHANNELS):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            nn.Sequential(DtypeConv2d(c, out, 1)) for c in in_channels)
        self.layer_blocks = nn.ModuleList(
            nn.Sequential(DtypeConv2d(out, out, 3, 1, 1))
            for _ in in_channels)
        self.extra_blocks = LastLevelP6P7(in_channels[-1], out)

    def forward(self, cs):
        ps = [None] * len(cs)
        for li in reversed(range(len(cs))):
            p = self.inner_blocks[li](cs[li])
            if li + 1 < len(cs):
                p = p + upsample2x(ps[li + 1])
            ps[li] = p
        feats = [blk(p) for p, blk in zip(ps, self.layer_blocks)]
        p6 = self.extra_blocks.p6(cs[-1])
        p7 = self.extra_blocks.p7(torch.relu(p6))
        return feats + [p6, p7]


class ResNet50FPN(nn.Module):
    """``backbone``: body + fpn; forward NCHW images -> [P3, .., P7]."""

    def __init__(self):
        super().__init__()
        self.body = ResNet50Body()
        self.fpn = FeaturePyramid()

    def forward(self, x):
        return self.fpn(self.body(x))
