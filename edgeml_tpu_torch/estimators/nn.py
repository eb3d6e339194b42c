"""EdgeDetectionNet: the configurable conv/MLP reward estimator as an
``nn.Module`` (the port of the JAX package's ``estimators/nn.py``).

  * conv stacks: Conv2d (kernel, 'same' padding, kaiming-uniform init)
    [+ BatchNorm if resize] + ReLU + Dropout(0.1) [+ 2x2 max pool];
  * linear stacks: Linear (kaiming-uniform) [+ BatchNorm + ReLU +
    Dropout(0.1) on all but the last];
  * no ``channels``: a pure MLP; no ``linear``: fully convolutional with
    global average pooling; resize=False: a spatial mean before the flatten,
    so maps of any shape pass (batch size 1).

NCHW, the JAX package's layout. BatchNorm is written out as the JAX package
writes it (eps 1e-5, momentum 0.1, the biased batch variance to normalise,
var * n / max(n - 1, 1) for the running update): ``torch.nn.BatchNorm*``
refuses a training batch of one, which a fold gives when N_train % 64 == 1.
Biases are added after the convolution and the product, and dropout
divides by 0.9, as the JAX expressions do. ``from_jax_params`` /
``to_jax_params`` carry weights across in the JAX package's pytree layout
(numpy arrays).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
DROPOUT_P = 0.1


class _Layer(nn.Module):
    """Weight, bias and, optionally, BatchNorm scale/bias with running
    statistics."""

    def __init__(self, shape, bn: bool):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(shape))
        self.b = nn.Parameter(torch.zeros(shape[0]))
        self.has_bn = bn
        if bn:
            self.scale = nn.Parameter(torch.ones(shape[0]))
            self.bias = nn.Parameter(torch.zeros(shape[0]))
            self.register_buffer("mean", torch.zeros(shape[0]))
            self.register_buffer("var", torch.ones(shape[0]))

    def bn(self, x, axes, train: bool):
        shape = [1] * x.dim()
        shape[1] = -1
        if train:
            mean = x.mean(dim=axes)
            var = ((x - mean.reshape(shape)) ** 2).mean(dim=axes)
            n = x.numel() / mean.numel()
            with torch.no_grad():
                unbiased = var * n / torch.full((), max(n - 1.0, 1.0),
                                                device=x.device)
                self.mean.copy_((1 - BN_MOMENTUM) * self.mean
                                + BN_MOMENTUM * mean)
                self.var.copy_((1 - BN_MOMENTUM) * self.var
                               + BN_MOMENTUM * unbiased)
        else:
            mean, var = self.mean, self.var
        x = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + BN_EPS)
        return x * self.scale.reshape(shape) + self.bias.reshape(shape)


class EdgeDetectionNet(nn.Module):
    """The estimator net; ``forward(x, dropout)`` -> (B, 1)."""

    def __init__(self, channels: Sequence[int], kernels, pools,
                 linear: Sequence[int], resize: bool = True):
        super().__init__()
        assert len(channels) > 1 or len(linear) > 1, (
            "Invalid CNN architecture. Please add at least 1 convolutional "
            "or linear layer.")
        self.channels, self.kernels = tuple(channels), tuple(kernels)
        self.pools, self.linear = tuple(pools), tuple(linear)
        self.resize = resize
        n_conv = max(len(self.channels) - 1, 0)
        n_lin = max(len(self.linear) - 1, 0)
        self.conv = nn.ModuleList(
            _Layer((self.channels[i + 1], self.channels[i], self.kernels[i],
                    self.kernels[i]), resize) for i in range(n_conv))
        self.fc = nn.ModuleList(
            _Layer((self.linear[i + 1], self.linear[i]),
                   resize and i != n_lin - 1) for i in range(n_lin))

    @staticmethod
    def from_opts(channels, kernels, pools, linear, resize=True):
        return EdgeDetectionNet(channels, kernels, pools, linear, resize)

    @property
    def dropout_sites(self) -> int:
        return len(self.conv) + max(len(self.fc) - 1, 0)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Kaiming-uniform weights (bound sqrt(6 / fan_in)) and uniform
        biases (1 / sqrt(fan_in)), drawn from ``generator`` layer by layer
        (conv, then linear; weight, then bias). BatchNorm starts at 1, 0."""
        for layer in list(self.conv) + list(self.fc):
            fan_in = math.prod(layer.w.shape[1:])
            for p, bound in ((layer.w, math.sqrt(6.0 / fan_in)),
                             (layer.b, 1.0 / math.sqrt(fan_in))):
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                      generator=generator))

    def forward(self, x: torch.Tensor,
                dropout: Callable | None = None) -> torch.Tensor:
        """x: (B, C, H, W) for conv nets, (B, F) or (B, C, H, W) for MLPs.
        In training mode each dropout site keeps the entries where
        ``dropout(shape)`` is True (a bool tensor on x's device; default a
        fresh draw)."""
        train = self.training

        def drop(x):
            if not train:
                return x
            keep = dropout(x.shape) if dropout is not None else \
                torch.rand(x.shape, device=x.device) < 1.0 - DROPOUT_P
            return torch.where(keep, x / torch.full((), 1.0 - DROPOUT_P,
                                                    device=x.device), 0.0)

        for i, layer in enumerate(self.conv):
            x = F.conv2d(x, layer.w, None, padding="same") \
                + layer.b.reshape(1, -1, 1, 1)
            if layer.has_bn:
                x = layer.bn(x, (0, 2, 3), train)
            x = drop(torch.relu(x))
            if self.pools[i]:
                x = F.max_pool2d(x, 2, 2)
        if x.dim() == 4:
            if not self.resize or not len(self.fc):
                x = x.mean(dim=(2, 3), keepdim=True)
            x = x.reshape(x.shape[0], -1)
        for i, layer in enumerate(self.fc):
            x = x @ layer.w.T + layer.b
            if layer.has_bn:
                x = layer.bn(x, (0,), train)
            if i != len(self.fc) - 1:
                x = drop(torch.relu(x))
        return x

    @torch.no_grad()
    def from_jax_params(self, params: dict, bn_state: dict):
        """Load the JAX package's parameter and BatchNorm pytrees ({'conv':
        [...], 'linear': [...]} of numpy arrays). Returns self."""
        for mods, key in ((self.conv, "conv"), (self.fc, "linear")):
            if len(params[key]) != len(mods) or len(bn_state[key]) != len(mods):
                raise ValueError(f"{key}: {len(params[key])} layers, want "
                                 f"{len(mods)}")
            for layer, p, s in zip(mods, params[key], bn_state[key]):
                pairs = [(layer.w, p["w"]), (layer.b, p["b"])]
                if layer.has_bn:
                    pairs += [(layer.scale, p["bn"]["scale"]),
                              (layer.bias, p["bn"]["bias"]),
                              (layer.mean, s["mean"]), (layer.var, s["var"])]
                elif "bn" in p or s:
                    raise ValueError(f"{key}: unexpected BatchNorm state")
                for t, a in pairs:
                    a = np.array(a, np.float32)
                    if tuple(a.shape) != tuple(t.shape):
                        raise ValueError(f"{key}: shape {a.shape}, want "
                                         f"{tuple(t.shape)}")
                    t.copy_(torch.from_numpy(a))
        return self

    @torch.no_grad()
    def to_jax_params(self):
        """(params, bn_state) in the JAX package's pytree layout, as numpy
        float32 arrays."""
        def arr(t):
            return t.detach().cpu().numpy().copy()

        params = {"conv": [], "linear": []}
        state = {"conv": [], "linear": []}
        for mods, key in ((self.conv, "conv"), (self.fc, "linear")):
            for layer in mods:
                p = {"w": arr(layer.w), "b": arr(layer.b)}
                s = {}
                if layer.has_bn:
                    p["bn"] = {"scale": arr(layer.scale),
                               "bias": arr(layer.bias)}
                    s = {"mean": arr(layer.mean), "var": arr(layer.var)}
                params[key].append(p)
                state[key].append(s)
        return params, state
