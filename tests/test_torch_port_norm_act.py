"""Eval BatchNorm and its activation as one pass (``ops/norm_act.py``) on the
CPU: the plain version against the op sequence the conv blocks ran before it
(copied inline below), ``ConvBN`` and ``ConvNormAct`` against their former
forwards in eval (with and without autograd), training and frozen-training
modes, also after ``calibrate_bn`` rewrote the statistics in place, and the
CUDA wrapper's refusals, which it makes before it needs a card.

Tolerance: none. Outputs, gradients and running statistics are compared bit
for bit (NaN included), in f32 and bf16.
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from edgeml_tpu_torch.models.common import (
    ConvBN, ConvNormAct, cast_params, conv_bn_train,
)
from edgeml_tpu_torch.models.yolov5 import YoloV5, calibrate_bn
from edgeml_tpu_torch.ops.norm_act import (
    ACTIVATIONS, norm_act, norm_act_cuda, norm_act_plain,
)

torch.set_num_threads(1)

ACTS = [None, "relu", "relu6", "hardswish", "silu"]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# the activations as the conv blocks applied them before the fused pass
OLD_ACTS = {
    None: lambda x: x,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "hardswish": lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
    "silu": lambda x: x * torch.sigmoid(x),
}


def old_norm(y, m, v, g, b, eps):
    """``conv_bn_eval``'s norm before the fused pass."""
    inv = torch.rsqrt(v + torch.full((), eps, dtype=v.dtype,
                                     device=v.device))
    return (y - m[:, None, None]) * inv[:, None, None] * g[:, None, None] \
        + b[:, None, None]


def old_forward(mod, x):
    """``ConvBN.forward`` / ``ConvNormAct.forward`` before the fused pass."""
    if isinstance(mod, ConvBN):
        conv, bn, act = mod.conv, mod.bn, "silu"
    else:
        conv, bn, act = mod[0], mod[1], mod.act
    if mod.training and not getattr(mod, "frozen", False):
        return OLD_ACTS[act](conv_bn_train(x, conv, bn, mod))
    w, g, b, m, v = cast_params(mod, [conv.weight, bn.weight, bn.bias,
                                      bn.running_mean, bn.running_var],
                                x.dtype)
    y = F.conv2d(x, w, None, conv.stride, conv.padding, 1, conv.groups)
    return OLD_ACTS[act](old_norm(y, m, v, g, b, bn.eps))


def bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def assert_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(bits(got), bits(want))


def inputs(dtype, n=2, c=3, hw=64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn(n, c, hw, hw, generator=gen) * 4
    y[0, 0, 0, :6] = torch.tensor([float("nan"), float("inf"),
                                   -float("inf"), -3.0, 3.0, 0.0])
    m = torch.randn(c, generator=gen)
    v = torch.rand(c, generator=gen) * 2 + 0.01
    g = torch.randn(c, generator=gen)
    b = torch.randn(c, generator=gen)
    return [t.to(dtype) for t in (y, m, v, g, b)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ACTS)
def test_plain_is_the_former_sequence(act, dtype):
    y, m, v, g, b = inputs(DTYPES[dtype])
    want = OLD_ACTS[act](old_norm(y, m, v, g, b, 1e-3))
    assert_bits(norm_act_plain(y, m, v, g, b, 1e-3, act), want)
    assert_bits(norm_act(y, m, v, g, b, 1e-3, act), want)  # CPU: plain
    assert torch.isnan(want).any()  # the NaN went through


def test_activation_codes_cover_every_activation():
    from edgeml_tpu_torch.ops import norm_act as mod

    assert set(mod._ACT_CODES) == set(ACTIVATIONS) == set(ACTS)


MODULES = {
    "convbn": lambda: ConvBN(4, 6, 3),
    "relu": lambda: ConvNormAct(4, 6, 3, act="relu"),
    "relu6_dw": lambda: ConvNormAct(4, 4, 3, 2, groups=4, act="relu6"),
    "hardswish": lambda: ConvNormAct(4, 6, 1, act="hardswish"),
    "none_frozen": lambda: ConvNormAct(4, 6, 1, act=None, eps=1e-5,
                                       frozen=True),
    "relu_frozen": lambda: ConvNormAct(4, 6, 3, act="relu", eps=1e-5,
                                       frozen=True),
}


def seeded(kind, seed=1):
    gen = torch.Generator().manual_seed(seed)
    mod = MODULES[kind]()
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
        for name, buf in mod.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.1)
    return mod


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["eval_nograd", "eval_grad", "train"])
@pytest.mark.parametrize("kind", list(MODULES))
def test_blocks_unchanged(kind, mode, dtype):
    """Forward, gradients (input and every parameter) and running
    statistics of the new forward against the former one, on two copies of
    one module. ``train`` on a frozen module is its frozen training (the
    eval form under autograd)."""
    new = seeded(kind)
    old = copy.deepcopy(new)
    for mod in (new, old):
        mod.train(mode == "train")
    gen = torch.Generator().manual_seed(2)
    x0 = torch.randn(2, 4, 64, 64, generator=gen).to(DTYPES[dtype])
    if mode == "eval_nograd":
        with torch.no_grad():
            assert_bits(new(x0), old_forward(old, x0))
        return
    outs, grads = [], []
    for mod, fwd in ((new, new), (old, lambda x: old_forward(old, x))):
        x = x0.clone().requires_grad_(True)
        out = fwd(x)
        weight = torch.randn(out.shape, generator=torch.Generator()
                             .manual_seed(3)).to(out.dtype)
        (out * weight).float().sum().backward()
        outs.append(out.detach())
        grads.append([x.grad] + [p.grad for p in mod.parameters()])
    assert_bits(outs[0], outs[1])
    for gn, go in zip(*grads):
        assert (gn is None) == (go is None)
        if gn is not None:
            assert_bits(gn, go)
    # an eval bf16 pass reads detached cast copies: only x gets a gradient
    assert grads[0][0] is not None
    assert any(g is not None for g in grads[0][1:]) == (
        mode == "train" or dtype == "f32")
    for (_, bn), (_, bo) in zip(new.named_buffers(), old.named_buffers()):
        if bn.is_floating_point():
            assert_bits(bn, bo)


def test_eval_reads_statistics_calibrated_in_place():
    """After ``calibrate_bn`` rewrites every BatchNorm's statistics in place,
    each ``ConvBN`` in eval mode serves with the new ones, in f32 and in bf16
    (whose cast copies were made before the calibration)."""
    net = YoloV5(variant="n", num_classes=8, img_size=64,
                 generator=torch.Generator().manual_seed(5))
    blocks = [m for m in net.modules() if isinstance(m, ConvBN)]
    gen = torch.Generator().manual_seed(6)
    xs = {m: torch.randn(1, m.conv.in_channels, 16, 16, generator=gen)
          for m in blocks}
    with torch.no_grad():
        for m in blocks:  # fill the bf16 cast caches
            m(xs[m].to(torch.bfloat16))
    before = [m.bn.running_var.clone() for m in blocks]
    calibrate_bn(net, lambda i: torch.rand(
        2, 64, 64, 3, generator=torch.Generator().manual_seed(7)), iters=1)
    assert not net.training
    assert all(not torch.equal(m.bn.running_var, v)
               for m, v in zip(blocks, before))
    with torch.no_grad():
        for m in blocks:
            for dt in DTYPES.values():
                x = xs[m].to(dt)
                assert_bits(m(x), old_forward(m, x))


def test_cuda_wrapper_refusals():
    y, m, v, g, b = inputs(torch.float32, c=3, hw=8)
    with pytest.raises(TypeError, match="f32 or bf16"):
        norm_act_cuda(y.double(), m, v, g, b, 1e-3, "relu")
    with pytest.raises(ValueError, match="contiguous"):
        norm_act_cuda(y.transpose(2, 3), m, v, g, b, 1e-3, "relu")
    with pytest.raises(ValueError, match="N, C, H, W"):
        norm_act_cuda(y[0], m, v, g, b, 1e-3, "relu")
    with pytest.raises(ValueError, match="per-channel"):
        norm_act_cuda(y, m[:2], v, g, b, 1e-3, "relu")
    with pytest.raises(ValueError, match="per-channel"):
        norm_act_cuda(y, m, v.to(torch.bfloat16), g, b, 1e-3, "relu")
    with pytest.raises(ValueError, match="per-channel"):
        norm_act_cuda(y, m, v, torch.stack([g, g], 1)[:, 0], b, 1e-3,
                      "relu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        norm_act_cuda(y, m, v, g, b, 1e-3, "relu")
    with pytest.raises(ValueError, match="CUDA tensor"):  # layout accepted
        norm_act_cuda(y.to(memory_format=torch.channels_last), m, v, g, b,
                      1e-3, "relu")
    assert norm_act_cuda.launches == 0
    with pytest.raises(ValueError, match="unsupported device"):
        norm_act(*(t.to("meta") for t in (y, m, v, g, b)), 1e-3, "relu")
