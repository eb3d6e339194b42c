"""Detector building blocks in PyTorch (NCHW inside, explicit padding).

Conv + eval BatchNorm + SiLU (YOLOv5), Conv + eval BatchNorm + a chosen
activation named as torchvision's ``Conv2dNormActivation`` (SSDLite, the
Faster R-CNN FPN and box head), the frozen BatchNorm affine and GroupNorm
(ResNet-FPN, RetinaNet), convolutions and linear layers that run in their
input's dtype, the 5x5 stride-1 max pool and nearest 2x upsample (both also
on int8 maps) and the host-side letterbox. BatchNorm in eval mode is
computed as ``(x - mean) * rsqrt(var + eps) * scale + bias`` in the
activation dtype, the reference's formula; a bf16 serving pass runs it in
bf16 end to end. Outside autograd the norm and its activation are one
``ops/norm_act.py`` pass: on the card one kernel over the conv's output,
bit for bit the op sequence.
Every layer here casts its f32 weights to the input's dtype once
(``CastCache``), so a module serves f32 and bf16 inputs without a copy of
itself.

A module put in training mode (``module.train()``) normalises with batch
statistics instead (``bn_train``) and casts its weights with autograd
(``cast_params``), so f32 master weights get f32 gradients through a bf16
compute pass. Two norms never take batch statistics: a ``ConvNormAct``
built ``frozen`` (the Faster R-CNN FPN and box head, whose norms hold the
reference's conv biases as exact identities: only the bias trains) and
``FrozenBatchNorm2d`` (the ResNet body), whose gain, shift and statistics
are all trained by gradient, as the reference trains every leaf of its
parameter tree.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data import fastprep
from ..ops.norm_act import (  # noqa: F401  (re-exported)
    ACTIVATIONS, hardswish, norm_act, norm_act_plain, relu6,
)
from ..parallel.mesh import all_sum, world_size
from ..utils.profiling import span


class CastCache:
    """Copies of a module's f32 tensors in another dtype, rebuilt whenever a
    source tensor is replaced or changed in place (its version counter), so a
    bf16 pass casts each weight once instead of on every call."""

    def __init__(self):
        self._cache = {}

    def get(self, tensors, dtype):
        if dtype == tensors[0].dtype:
            return tensors
        stamp = tuple((id(t), t.data_ptr(), t._version) for t in tensors)
        hit = self._cache.get(dtype)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        out = [t.detach().to(dtype) for t in tensors]
        self._cache[dtype] = (stamp, out)
        return out


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator | None = None):
    """The reference's init, drawn from ``generator``: conv weights uniform
    in +-1/sqrt(fan_in) (torch's default conv init), conv biases zero,
    BatchNorm and GroupNorm identity."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.in_channels // m.groups * m.kernel_size[0] \
                * m.kernel_size[1]
            bound = math.sqrt(1.0 / fan_in)
            m.weight.copy_(torch.empty(m.weight.shape).uniform_(
                -bound, bound, generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


def cast_params(module: nn.Module, tensors, dtype):
    """``tensors`` in ``dtype``: the module's cached detached copies in eval
    mode, casts that carry gradients back to the f32 masters in training
    mode."""
    if module.training:
        return [t if t.dtype == dtype else t.to(dtype) for t in tensors]
    return module._cast.get(tensors, dtype)


def bn_train(y, bn: nn.BatchNorm2d, weight, bias):
    """Training-mode BatchNorm over NCHW ``y``: normalise with the batch
    mean and biased variance, then ``* weight + bias``, all in f32 whatever
    ``y``'s dtype (the output is cast back to it); update ``bn``'s running
    stats in place as ``(1 - m) * old + m * batch`` with the unbiased
    variance. The reference's ``bn_apply(train=True)``. Under several
    processes the batch is the global one: the moments are summed over the
    ranks (``CrossRankBatchNorm``)."""
    yf = y.to(torch.float32)
    if world_size() > 1:
        n = all_sum(float(y.numel() // y.shape[1]))
        out, mean, var = CrossRankBatchNorm.apply(yf, weight, bias, bn.eps,
                                                  n)
    else:
        mean = yf.mean(dim=(0, 2, 3))
        var = (yf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        n = y.numel() / mean.numel()
        out = None
    with torch.no_grad():
        m = bn.momentum
        unbiased = var * n / max(n - 1.0, 1.0)
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * unbiased)
    if out is None:
        out = (yf - mean[:, None, None]) \
            * torch.rsqrt(var + bn.eps)[:, None, None]
        out = out * weight[:, None, None] + bias[:, None, None]
    return out.to(y.dtype)


class CrossRankBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm over the batch of every rank together, the
    global batch that one process would see.

    Forward: each rank's per-channel sum and sum of squares (accumulated in
    f64, so ``E[x^2] - E[x]^2`` loses nothing to cancellation) are summed
    over the ranks in one all-reduce; the mean and biased variance follow.
    Backward: with ``xh`` the normalised input and ``dy`` the output
    gradient, the per-channel sums of ``dy`` and ``dy * xh`` are summed over
    the ranks in one all-reduce, and

        dx = weight * rsqrt(var + eps) * (dy - (sum dy + xh * sum dy*xh) / N)

    The weight's and bias's gradients stay this rank's part (the gradient
    reduction sums them). Returns (out f32, mean, var) of (B, C, H, W) f32
    ``y``; ``n`` is the global count per channel."""

    @staticmethod
    def forward(ctx, y, weight, bias, eps, n):
        dims = (0, 2, 3)
        sums = all_sum(torch.stack([y.sum(dims, dtype=torch.float64),
                                    y.square().sum(dims,
                                                   dtype=torch.float64)]))
        mean64 = sums[0] / n
        var64 = torch.clamp_min(sums[1] / n - mean64.square(), 0.0)
        mean, var = mean64.to(torch.float32), var64.to(torch.float32)
        inv = torch.rsqrt(var + eps)
        xh = (y - mean[:, None, None]) * inv[:, None, None]
        w = weight.to(torch.float32)
        out = xh * w[:, None, None] + bias.to(torch.float32)[:, None, None]
        ctx.save_for_backward(xh, w, inv)
        ctx.n = n
        ctx.dtypes = (weight.dtype, bias.dtype)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        xh, w, inv = ctx.saved_tensors
        dims = (0, 2, 3)
        dy = dout.to(torch.float32)
        dw = (dy * xh).sum(dims)
        db = dy.sum(dims)
        sums = all_sum(torch.stack([db.to(torch.float64),
                                    dw.to(torch.float64)]))
        s_dy = (sums[0] / ctx.n).to(torch.float32)
        s_dyxh = (sums[1] / ctx.n).to(torch.float32)
        dx = (dy - s_dy[:, None, None] - xh * s_dyxh[:, None, None]) \
            * (w * inv)[:, None, None]
        return dx, dw.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None, None


def running_stats(module: nn.Module) -> dict:
    """{buffer name: tensor} of every BatchNorm running mean and variance
    of ``module`` (the live buffers, not copies)."""
    return {k: v for k, v in module.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def conv_bn_train(x, conv: nn.Conv2d, bn: nn.BatchNorm2d, module):
    """conv(x) (no bias) in x's dtype, then training-mode BatchNorm with
    the affine in the compute dtype's rounding (``bn_train``)."""
    w, g, b = cast_params(module, [conv.weight, bn.weight, bn.bias],
                          x.dtype)
    y = F.conv2d(x, w, None, conv.stride, conv.padding, 1, conv.groups)
    return bn_train(y, bn, g, b)


def conv_bn(x, conv: nn.Conv2d, bn: nn.BatchNorm2d, module, act=None):
    """Eval (``conv_bn_eval``) or training (``conv_bn_train``) BatchNorm by
    ``module``'s mode, then ``act`` (a key of ``ACTIVATIONS``); a ``frozen``
    module always takes the eval form."""
    if module.training and not getattr(module, "frozen", False):
        return ACTIVATIONS[act](conv_bn_train(x, conv, bn, module))
    return conv_bn_eval(x, conv, bn, module, act)


def conv_bn_eval(x, conv: nn.Conv2d, bn: nn.BatchNorm2d, module, act=None):
    """conv(x) (no bias) then eval BatchNorm and ``act``, all in x's dtype
    (the weights cast by ``cast_params``: with autograd in training mode).
    Where no gradient is wanted (grad mode off, or nothing that requires
    one), the norm and activation are one ``norm_act`` pass: on the card a
    kernel over the conv's output in place; otherwise the plain ops."""
    w, g, b, m, v = cast_params(module, [conv.weight, bn.weight, bn.bias,
                                         bn.running_mean, bn.running_var],
                                x.dtype)
    y = F.conv2d(x, w, None, conv.stride, conv.padding, 1, conv.groups)
    if torch.is_grad_enabled() and (y.requires_grad or g.requires_grad
                                    or b.requires_grad):
        return norm_act_plain(y, m, v, g, b, bn.eps, act)
    return norm_act(y, m, v, g, b, bn.eps, act)


class ConvBN(nn.Module):
    """Conv2d (no bias) + eval BatchNorm + SiLU, ultralytics naming (``conv``,
    ``bn``) so state_dict keys match yolov5 checkpoints."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1,
                 p: int | None = None, eps: float = 1e-3,
                 momentum: float = 0.03):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, k // 2 if p is None else p,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=eps, momentum=momentum)
        self._cast = CastCache()

    def forward(self, x):
        return conv_bn(x, self.conv, self.bn, self, "silu")


class DtypeConv2d(nn.Conv2d):
    """nn.Conv2d that runs in its input's dtype (weight and bias cast once
    per dtype)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._cast = CastCache()

    def forward(self, x):
        if self.bias is None:
            (w,) = cast_params(self, [self.weight], x.dtype)
            return self._conv_forward(x, w, None)
        w, b = cast_params(self, [self.weight, self.bias], x.dtype)
        if self.training:
            # the reference adds the bias after the conv, in x's dtype
            return self._conv_forward(x, w, None) + b[:, None, None]
        return self._conv_forward(x, w, b)


class DtypeLinear(nn.Linear):
    """nn.Linear that runs in its input's dtype (weight and bias cast once
    per dtype)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._cast = CastCache()

    def forward(self, x):
        w, b = cast_params(self, [self.weight, self.bias], x.dtype)
        return F.linear(x, w, b)


class DtypeGroupNorm(nn.GroupNorm):
    """nn.GroupNorm that runs in its input's dtype."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._cast = CastCache()

    def forward(self, x):
        w, b = cast_params(self, [self.weight, self.bias], x.dtype)
        return F.group_norm(x, self.num_groups, w, b, self.eps)


class ConvNormAct(nn.Sequential):
    """Conv2d (no bias, padding k // 2, optional groups) + eval BatchNorm +
    activation ("relu", "relu6", "hardswish" or None), named as torchvision's
    ``Conv2dNormActivation``: ``0`` the conv, ``1`` the BatchNorm.

    ``frozen``: the norm is the reference's conv bias held as an exact
    identity (``load_jax_conv``): it never takes batch statistics, and of it
    only the bias trains (its weight does not require a gradient)."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 groups: int = 1, act: str | None = "relu",
                 eps: float = 1e-3, momentum: float = 0.03,
                 frozen: bool = False):
        super().__init__(
            nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups,
                      bias=False),
            nn.BatchNorm2d(cout, eps=eps, momentum=momentum))
        if act not in ACTIVATIONS:
            raise ValueError(f"unknown activation {act!r}")
        self.act = act
        self.frozen = frozen
        if frozen:
            self[1].weight.requires_grad_(False)
        self._cast = CastCache()

    def forward(self, x):
        return conv_bn(x, self[0], self[1], self, self.act)


@torch.no_grad()
def load_jax_conv(conv: nn.Conv2d, p, bn: nn.Module | None = None):
    """Copy the reference's conv ``p`` (HWIO kernel ``w``, bias ``b``) into
    ``conv``. Where torchvision's layout has no conv bias but a BatchNorm
    ``bn`` after the conv (the reference folds that norm into the conv),
    the norm becomes an exact identity that adds the bias: weight 1, mean
    0, var 1 - eps (f32), so that var + eps and its rsqrt are exactly 1 and
    the output is conv + bias, bit for bit."""
    conv.weight.copy_(torch.from_numpy(
        np.array(p["w"], dtype=np.float32)).permute(3, 2, 0, 1))
    b = torch.from_numpy(np.array(p["b"], dtype=np.float32))
    if bn is None:
        conv.bias.copy_(b)
        return
    var = np.float32(1.0) - np.float32(bn.eps)
    if var + np.float32(bn.eps) != np.float32(1.0):
        raise ValueError(f"no exact identity variance for eps {bn.eps}")
    bn.weight.fill_(1.0)
    bn.bias.copy_(b)
    bn.running_mean.zero_()
    bn.running_var.fill_(float(var))


def host_array(t: torch.Tensor) -> np.ndarray:
    """A detached f32 NumPy copy of ``t``."""
    return t.detach().cpu().to(torch.float32).numpy().copy()


@torch.no_grad()
def jax_conv(conv: nn.Conv2d, bn: nn.Module | None = None) -> dict:
    """The reference's conv {w: HWIO kernel, b: bias} of ``conv``: the
    inverse of ``load_jax_conv``. With ``bn`` the norm is folded in as the
    reference's importer folds it (``scale = g * rsqrt(v + eps)``, ``w *
    scale``, ``b - m * scale``, in f32), which an identity norm leaves
    bit for bit unchanged."""
    w = conv.weight.to(torch.float32)
    if bn is None:
        b = conv.bias
    else:
        scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        w = w * scale[:, None, None, None]
        b = bn.bias - bn.running_mean * scale
    return {"w": host_array(w.permute(2, 3, 1, 0)), "b": host_array(b)}


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics (never from the batch): ``x * scale +
    shift`` with ``scale = weight * rsqrt(var + eps)`` and ``shift = bias -
    mean * scale`` computed in f32 and cast to the input's dtype, the
    reference's frozen-BN affine.

    All four tensors are parameters: the reference's train step
    differentiates and updates its whole parameter tree, frozen-BN gain,
    shift, mean and variance included (torchvision's FrozenBatchNorm2d
    trains none of them). In training mode the affine follows the
    reference's mixed precision: gain and shift in the input's dtype, the
    statistics in f32, or in the input's dtype too where ``cast_stats`` is
    set (Faster R-CNN, whose reference casts every leaf). Outside autograd
    the eval affine is cached per dtype; under autograd it is recomputed on
    every call, so no graph outlives its step.

    Its state_dict keys are BatchNorm2d's (``num_batches_tracked``
    included, as in a torchvision model built without pretrained weights;
    ``cli/detect.py load_torchvision_state_dict`` fills the counter in for a
    checkpoint of torchvision's FrozenBatchNorm2d, which has none)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.cast_stats = False
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.running_mean = nn.Parameter(torch.zeros(c))
        self.running_var = nn.Parameter(torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self._affine = {}

    def affine(self, dtype):
        """(scale, shift) as (C, 1, 1) tensors in ``dtype``."""
        w, b, m, v = (self.weight, self.bias, self.running_mean,
                      self.running_var)
        if self.training and dtype != w.dtype:
            w, b = w.to(dtype), b.to(dtype)
            if self.cast_stats:
                m, v = m.to(dtype), v.to(dtype)
        scale = w * torch.rsqrt(v + self.eps)
        shift = b - m * scale
        return scale.to(dtype)[:, None, None], shift.to(dtype)[:, None, None]

    def forward(self, x):
        if self.training or (torch.is_grad_enabled()
                             and self.weight.requires_grad):
            scale, shift = self.affine(x.dtype)
            return x * scale + shift
        src = [self.weight, self.bias, self.running_mean, self.running_var]
        stamp = tuple((t.data_ptr(), t._version) for t in src)
        hit = self._affine.get(x.dtype)
        if hit is None or hit[0] != stamp:
            with torch.no_grad():
                hit = (stamp,) + self.affine(x.dtype)
            self._affine[x.dtype] = hit
        return x * hit[1] + hit[2]


def max_pool_same(x, k: int = 5):
    """k x k max pool, stride 1, SAME padding (implicit -inf padding). An
    integer map (the int8 walk: max commutes with the monotone quantizer)
    is pooled in f32, where its values are exact: ``max_pool2d`` has no
    int8 kernel on the card."""
    if x.is_floating_point():
        return F.max_pool2d(x, k, 1, k // 2)
    return F.max_pool2d(x.float(), k, 1, k // 2).to(x.dtype)


def upsample2x(x):
    """Nearest-neighbour x2 upsample (NCHW). An integer map (the int8 walk)
    is copied in f32, where its values are exact: ``interpolate`` has no
    integer kernel on the CPU."""
    if x.is_floating_point():
        return F.interpolate(x, scale_factor=2, mode="nearest")
    return F.interpolate(x.float(), scale_factor=2,
                         mode="nearest").to(x.dtype)


PAD_VALUE = 114 / 255  # the YOLOv5 letterbox's gray fill


def letterbox_batch(images, size: int = 640, out=None):
    """Resize-with-aspect + pad a batch of (H, W, 3) images to (size, size).

    Host side (ragged inputs), one native pass (``data/fastprep.py``);
    returns (B, size, size, 3) float32 (``out`` where given) plus per-image
    (ratio, dw, dh) for unmapping boxes. The YOLOv5 letterbox convention:
    symmetric padding, gray fill.
    """
    with span("prep.letterbox"):
        meta = np.zeros((len(images), 3), np.float32)
        places = []
        for i, img in enumerate(images):
            h, w = img.shape[:2]
            r = min(size / h, size / w)
            nh, nw = int(round(h * r)), int(round(w * r))
            dh, dw = (size - nh) // 2, (size - nw) // 2
            places.append((nh, nw, dh, dw))
            meta[i] = (r, dw, dh)
        return fastprep.letterbox(images, size, places, PAD_VALUE,
                                  out=out), meta
