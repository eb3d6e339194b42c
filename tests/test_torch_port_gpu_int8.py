"""int8 serving on a CUDA device: the int32 contraction (``torch._int_mm``
on the im2col, padded to its CUDA shape rules; the depthwise window sum)
against the same contraction on the CPU, the routing ops on int8 maps, and
YOLOv5n / SSDLite int8 serving (seeded weights, BatchNorm statistics taken
on the batch) from one quantized tree against the CPU's.

Marked ``gpu``; the ``cuda`` fixture skips every test where no CUDA device
is present (decided when the test runs, never at import). Run on the card
with

    python -m pytest tests/test_torch_port_gpu_int8.py -m gpu -q

Tolerances: the contractions and the routing ops bit for bit (exact
integer arithmetic). The serving walks from one tree: the CPU walk is
handed the card's int8 map at every emit after its own map is compared
with it, so each layer is held on its own input. A sigmoid (SiLU), a
hardswish or a squeeze-excite mean an ulp apart on a requantization
boundary moves an int8 value by one step: each map may differ by one step
in at most 0.1% of its values (a conv or an epilogue computed otherwise
would show by more), and the outputs from the card's last maps must agree
within the CPU suite's 1e-4 of each output's largest value.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from edgeml_tpu_torch.models import quant as tq
from edgeml_tpu_torch.models import quant_ssd as tqs
from edgeml_tpu_torch.models.common import (
    ConvBN, ConvNormAct, max_pool_same, upsample2x,
)
from edgeml_tpu_torch.models.ssdlite import SSDLite
from edgeml_tpu_torch.models.yolov5 import YoloV5

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _int8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


# (batch, size, cin, cout, kernel, stride, pad, groups), as on the CPU plus
# YOLOv5's stem and a wide 3x3 at serving-like widths
CASES = [
    (2, 9, 16, 24, 1, 1, 0, 1),
    (2, 9, 5, 7, 3, 1, 1, 1),
    (4, 64, 3, 16, 6, 2, 2, 1),
    (2, 10, 12, 9, 3, 2, 1, 1),
    (1, 3, 16, 16, 3, 2, 1, 1),
    (8, 20, 256, 256, 3, 1, 1, 1),
    (2, 9, 16, 16, 3, 1, 1, 16),
    (2, 10, 8, 8, 5, 2, 2, 8),
]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_int_conv_card_equals_cpu(cuda, case, monkeypatch):
    b, h, cin, cout, k, s, p, g = case
    rng = np.random.default_rng(1)
    x = _int8(rng, (b, cin, h, h))
    w = _int8(rng, (cout, cin // g, k, k))
    calls, orig = [], tq.int_matmul
    monkeypatch.setattr(tq, "int_matmul", lambda a, wmat: calls.append(
        (tuple(a.shape), tuple(wmat.shape))) or orig(a, wmat))
    got = tq.int_conv(x.to(cuda), w.to(cuda), s, p, groups=g)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.is_cuda
    assert len(calls) == (g == 1)
    want = tq.int_conv(x, w, s, p, groups=g)
    assert torch.equal(got.cpu(), want)


def test_int8_routing_ops_card_equal_cpu(cuda):
    x = _int8(np.random.default_rng(2), (2, 64, 20, 20))
    xl = x.contiguous(memory_format=torch.channels_last)
    for t in (x, xl):
        assert torch.equal(max_pool_same(t.to(cuda), 5).cpu(),
                           max_pool_same(t, 5))
        assert torch.equal(upsample2x(t.to(cuda)).cpu(), upsample2x(t))
    ref = F.max_pool2d(x.float(), 5, 1, 2).to(torch.int8)
    assert torch.equal(max_pool_same(x.to(cuda), 5).cpu(), ref)


@torch.no_grad()
def take_bn_stats(net, run):
    """Each BatchNorm's statistics set, layer by layer during ``run()``, to
    its conv's batch statistics (variances floored at 1e-3), as
    chip_smoke.py seeds its nets: activations keep their scale through the
    seeded trunk instead of decaying to nothing."""

    def hook(mod, args):
        conv, bn = (mod.conv, mod.bn) if isinstance(mod, ConvBN) \
            else (mod[0], mod[1])
        y = F.conv2d(args[0], conv.weight, None, conv.stride, conv.padding,
                     1, conv.groups)
        bn.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(
            y.var(dim=(0, 2, 3), unbiased=False).clamp_min(1e-3))

    hooks = [m.register_forward_pre_hook(hook) for m in net.modules()
             if isinstance(m, (ConvBN, ConvNormAct))]
    run()
    for h in hooks:
        h.remove()


class EmitLog:
    """The int8 maps a walk emits. Without ``card`` it records each map
    ({name: CPU copy}). With the card's record it compares each map it is
    given with the card's map of that name (values that differ, their count
    and the largest step) and hands the card's map on instead."""

    def __init__(self, card=None):
        self.card, self.maps, self.diffs = card, {}, []

    def __call__(self, name, q):
        if self.card is None:
            self.maps[name] = q.cpu()
            return q
        ref = self.card[name]
        d = (q.to(torch.int32) - ref.to(torch.int32)).abs()
        self.diffs.append((name, int((d > 0).sum()), d.numel(),
                           int(d.max())))
        return ref


def assert_walks_agree(card, cpu, got, want, n_maps):
    """card, cpu: the EmitLogs of the two walks; got, want: their
    outputs."""
    assert len(cpu.diffs) == len(card.maps) > n_maps
    for name, n, size, step in cpu.diffs:
        assert step <= 1 and n <= 1e-3 * size, (name, n, size, step)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), err


class _YoloWalk(tq.Q8Yolo):
    def _emit(self, name, y):
        return self.log(name, super()._emit(name, y))


class _SSDWalk(tqs._Q8Ctx):
    def _emit(self, name, y):
        q, name = super()._emit(name, y)
        return self.log(name, q), name


def test_yolo_int8_from_one_tree_card_vs_cpu(cuda):
    """YOLOv5n (80 classes) at 320 with seeded weights and BatchNorm
    statistics: the card's calibration, its tree served on the card and on
    the CPU."""
    net = YoloV5(num_classes=80, img_size=320,
                 generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).random((4, 320, 320, 3))
                         .astype(np.float32))
    take_bn_stats(net, lambda: net.predict(x))
    tree = tq.prepare_int8(net.to(cuda), lambda i: x.to(cuda), iters=1).tree
    cpu_net = YoloV5(num_classes=80, img_size=320)
    cpu_net.load_state_dict(net.state_dict())
    card = _YoloWalk(net, **tree)
    cpu = _YoloWalk(cpu_net, **tq.tree_to(tree, "cpu"))
    card.log = EmitLog()
    got = card.predict(x.to(cuda))
    cpu.log = EmitLog(card.log.maps)
    assert_walks_agree(card.log, cpu.log, got, cpu.predict(x), 50)


def test_ssd_int8_from_one_tree_card_vs_cpu(cuda):
    """SSDLite320 (91 classes) with seeded weights and BatchNorm statistics
    on the calibration batch: the card's calibration, its tree walked on the
    card and on the CPU."""
    net = SSDLite(num_classes=91, image_size=320,
                  generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (4, 320, 320, 3)).astype(np.float32))
    take_bn_stats(net, lambda: net(x))
    tree = tqs.prepare_int8_ssd(net.to(cuda), lambda i: x.to(cuda),
                                iters=1).tree
    cpu_net = SSDLite(num_classes=91, image_size=320)
    cpu_net.load_state_dict(net.state_dict())
    cpu_tree = tq.tree_to(tree, "cpu")

    def walk(n, t, xi, log):
        ctx = _SSDWalk(t["qparams"], t["se"], t["scales"])
        ctx.log = log
        with torch.no_grad():
            return tqs._ssd_walk(n, ctx, xi.permute(0, 3, 1, 2))

    card = EmitLog()
    got = walk(net, tree, x.to(cuda), card)
    cpu = EmitLog(card.maps)
    assert_walks_agree(card, cpu, got, walk(cpu_net, cpu_tree, x, cpu), 60)
