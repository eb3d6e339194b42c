"""MobileNetV3-Large in PyTorch, arranged as SSDLite's feature extractor.

The backbone of the reference's default detector (SSDLite320). Structure
per torchvision: stem conv 3x3 s2 (16, hardswish), 15 inverted residual
blocks (squeeze-excite on the 5x5 stages, ReLU or hardswish per the V3
paper), a last 1x1 conv to 6x the last block's width (960, or 480 with the
reduced tail). SSDLite taps the expansion conv of block 12 (zero-based; 672
channels, stride 16, "C4") and the last map ("C5"), so the module list is
split there as torchvision's ``SSDLiteFeatureExtractorMobileNet`` splits it:

    features.0 = stem, blocks 0..11, block 12's expansion conv  -> C4
    features.1 = block 12's depthwise/SE/project, blocks 13, 14, last -> C5

and state_dict keys match a torchvision ssdlite320_mobilenet_v3_large.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .common import ConvNormAct, DtypeConv2d

BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # torchvision's detection setting; only training reads it
C4_BLOCK = 12  # zero-based block index of the C4 tap


def v3_large_config(reduced_tail: bool = False):
    """(kernel, expanded, out, use_se, activation, stride) per inverted
    residual, torchvision's ``_mobilenet_v3_conf('mobilenet_v3_large')``;
    ``reduced_tail`` halves the channels of the last three blocks (and so
    the last conv)."""
    r = 2 if reduced_tail else 1
    return (
        (3, 16, 16, False, "RE", 1),
        (3, 64, 24, False, "RE", 2),
        (3, 72, 24, False, "RE", 1),
        (5, 72, 40, True, "RE", 2),
        (5, 120, 40, True, "RE", 1),
        (5, 120, 40, True, "RE", 1),
        (3, 240, 80, False, "HS", 2),
        (3, 200, 80, False, "HS", 1),
        (3, 184, 80, False, "HS", 1),
        (3, 184, 80, False, "HS", 1),
        (3, 480, 112, True, "HS", 1),
        (3, 672, 112, True, "HS", 1),
        (5, 672, 160 // r, True, "HS", 2),  # C4 tap: expansion conv here
        (5, 960 // r, 160 // r, True, "HS", 1),
        (5, 960 // r, 160 // r, True, "HS", 1),
    )


def hardsigmoid(x):
    """clip(x + 3, 0, 6) / 6, written out as the reference writes it."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _act(name):
    return "hardswish" if name == "HS" else "relu"


class SqueezeExcitation(nn.Module):
    """mean pool -> fc1 -> ReLU -> fc2 -> hardsigmoid, scaling the input."""

    def __init__(self, c: int, squeeze: int):
        super().__init__()
        self.fc1 = DtypeConv2d(c, squeeze, 1)
        self.fc2 = DtypeConv2d(squeeze, c, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.relu(self.fc1(s))
        s = self.fc2(s)
        return x * hardsigmoid(s)


def _block_layers(cin, k, exp, out, use_se, act, stride):
    layers = []
    if exp != cin:
        layers.append(ConvNormAct(cin, exp, 1, act=act, eps=BN_EPS,
                                  momentum=BN_MOMENTUM))
    layers.append(ConvNormAct(exp, exp, k, stride, groups=exp, act=act,
                              eps=BN_EPS, momentum=BN_MOMENTUM))
    if use_se:
        layers.append(SqueezeExcitation(exp, _make_divisible(exp // 4, 8)))
    layers.append(ConvNormAct(exp, out, 1, act=None, eps=BN_EPS,
                              momentum=BN_MOMENTUM))
    return layers


class InvertedResidual(nn.Module):
    """[expand 1x1] -> depthwise kxk -> [SE] -> project 1x1, plus the input
    when the stride is 1 and the widths agree (``block`` as torchvision)."""

    def __init__(self, cin, k, exp, out, use_se, act, stride):
        super().__init__()
        self.block = nn.Sequential(
            *_block_layers(cin, k, exp, out, use_se, act, stride))
        self.use_res = stride == 1 and cin == out

    def forward(self, x):
        y = self.block(x)
        return y + x if self.use_res else y


def mobilenet_v3_large_features(reduced_tail: bool = False) -> nn.Sequential:
    """The two-part ``features`` of SSDLite's extractor (module docstring):
    ``features[0](x)`` is C4, ``features[1](C4)`` is C5."""
    config = v3_large_config(reduced_tail)
    head = [ConvNormAct(3, 16, 3, 2, act="hardswish", eps=BN_EPS,
                        momentum=BN_MOMENTUM)]
    tail = []
    cin = 16
    for bi, (k, exp, out, use_se, act, stride) in enumerate(config):
        if bi < C4_BLOCK:
            head.append(InvertedResidual(cin, k, exp, out, use_se, _act(act),
                                         stride))
        elif bi == C4_BLOCK:  # stride 2: no residual to carry across
            layers = _block_layers(cin, k, exp, out, use_se, _act(act),
                                   stride)
            head.append(layers[0])  # the expansion conv: the C4 tap
            tail.append(nn.Sequential(*layers[1:]))
        else:
            tail.append(InvertedResidual(cin, k, exp, out, use_se, _act(act),
                                         stride))
        cin = out
    tail.append(ConvNormAct(cin, 6 * cin, 1, act="hardswish", eps=BN_EPS,
                            momentum=BN_MOMENTUM))
    return nn.Sequential(nn.Sequential(*head), nn.Sequential(*tail))
