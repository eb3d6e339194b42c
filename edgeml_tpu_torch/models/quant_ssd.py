"""Post-training int8 quantization of the SSDLite320-MobileNetV3 trunk.

The reference package's ``models/quant_ssd.py``, in PyTorch: the scheme of
``models/quant.py`` over MobileNetV3, the SSDLite extras and the
depthwise-separable heads.

  * BatchNorm folded exactly (eps 1e-3, each norm's own);
  * weights per-output-channel symmetric (a depthwise kernel's output
    channel is its own k x k filter); activations per-tensor symmetric, the
    absmax over the calibration batches;
  * every conv has one input tensor (this family has no concat), so the
    input's activation scale goes into the dequantization factor, ``dq =
    s_w[cout] * s_in``;
  * epilogues: hardswish, ReLU or ReLU6 on the dequantized f32
    pre-activation, then a requantization at the output's calibrated scale;
  * squeeze-excite stays f32: it pools to a (C, 1, 1) vector, and its gate
    multiplies the depthwise conv's f32 output; the product gets its own
    scale;
  * inverted-residual adds run on dequantized values and requantize at the
    sum's own scale;
  * the head projections consume int8 maps with int8 weights and emit f32
    logits, so ``ssd_postprocess`` is unchanged.

Calibration and int8 serving share one traversal (``_ssd_walk``) driven by
two small contexts, so the scale table and the quantized dataflow cannot
drift apart. Emit-node names are the reference's: "in", "stem",
"b{i}/{expand,dw,se,project,sum}", "last", "x{j}/{reduce,dw,expand}",
"{cls,reg}{l}/{dw,proj}". The quantized state is a plain tree
(``Q8SSD.tree``): ``{"qparams": {name: QConv}, "se": {name: {"fc1": {"w",
"b"}, "fc2": {...}}}, "scales": {name: f32 scalar}}``; ``from_jax_q8_ssd``
carries the reference package's tree into it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import hardswish, relu6
from .mobilenetv3 import C4_BLOCK, hardsigmoid, v3_large_config
from .quant import (
    QConv, _fold_convbn, _host, _qconv_from_jax, _quantize_weight,
    _scales_from_jax, quantize_tensor,
)
from .ssdlite import SSDLite

_ACTS = {"HS": hardswish, "RE": torch.relu, "R6": relu6, None: None}


def _se_f32(x, p):
    """MobileNetV3 squeeze-excite on an f32 map, the reference's op order
    (each 1x1 conv, then its bias)."""
    s = x.mean(dim=(2, 3), keepdim=True)
    s = torch.relu(F.conv2d(s, p["fc1"]["w"]) + p["fc1"]["b"][:, None, None])
    s = F.conv2d(s, p["fc2"]["w"]) + p["fc2"]["b"][:, None, None]
    return x * hardsigmoid(s)


class _CalibCtx:
    """The f32 walk over BN-folded weights; records the absmax at every
    emit point. Tensors are f32 NCHW maps."""

    def __init__(self, fused, se_params, amax):
        self.fused = fused
        self.se_params = se_params
        self.amax = amax

    def names(self):
        return self.fused

    def rec(self, name, v):
        a = v.abs().amax()
        self.amax[name] = a if name not in self.amax \
            else torch.maximum(self.amax[name], a)
        return v

    def input(self, x):
        return self.rec("in", x)

    def conv(self, name, x, stride, act, groups=1, emit=True):
        w, b = self.fused[name]
        k = w.shape[-1]
        y = F.conv2d(x, w, None, stride, k // 2, 1, groups) + b[:, None, None]
        if act is not None:
            y = _ACTS[act](y)
        return self.rec(name, y) if emit else y

    def se(self, name, y):
        return self.rec(name, _se_f32(y, self.se_params[name]))

    def add(self, name, y, res):
        return self.rec(name, y + res)


class _Q8Ctx:
    """The int8 walk. Tensors are (int8 map, scale-table name) pairs, except
    where ``emit=False`` returns the f32 epilogue."""

    def __init__(self, qparams, se_params, scales):
        self.qparams = qparams
        self.se_params = se_params
        self.scales = scales

    def names(self):
        return self.qparams

    def _emit(self, name, y):
        return quantize_tensor(y, self.scales[name]), name

    def input(self, x):
        return self._emit("in", x)

    def conv(self, name, xq_n, stride, act, groups=1, emit=True):
        qp = self.qparams[name]
        y = qp(xq_n[0], stride, qp.w.shape[-1] // 2, groups)
        if act is not None:
            y = _ACTS[act](y)
        return self._emit(name, y) if emit else y

    def se(self, name, y):
        return self._emit(name, _se_f32(y, self.se_params[name]))

    def add(self, name, y, res):
        rq, rname = res
        return self._emit(name, y + rq.to(torch.float32) * self.scales[rname])


def _width(t):
    """Channel width of a walk tensor (f32 map or (int8 map, name) pair)."""
    return (t[0] if isinstance(t, tuple) else t).shape[1]


def _extra_mids(net: SSDLite):
    """Each extra block's reduced width (its depthwise conv's channels)."""
    return [blk[0][0].out_channels for blk in net.backbone.extra]


def _ssd_walk(net: SSDLite, ctx, x):
    """The SSDLite traversal that calibration and int8 serving share. ``x``:
    (B, 3, S, S) f32. Returns (cls_logits (B, A, C), reg (B, A, 4)) f32, the
    rows ordered as ``SSDLite.forward``'s."""
    x = ctx.input(x)
    x = ctx.conv("stem", x, 2, "HS")
    c4 = None
    for bi, (k, exp, out, use_se, act_n, stride) in enumerate(
            v3_large_config(net.reduced_tail)):
        inp = x
        if f"b{bi}/expand" in ctx.names():
            x = ctx.conv(f"b{bi}/expand", x, 1, act_n)
        if bi == C4_BLOCK:
            c4 = x  # the 672-channel expansion output, stride 16
        x = ctx.conv(f"b{bi}/dw", x, stride, act_n, groups=exp,
                     emit=not use_se)
        if use_se:
            x = ctx.se(f"b{bi}/se", x)
        has_res = stride == 1 and _width(inp) == out
        x = ctx.conv(f"b{bi}/project", x, 1, None, emit=not has_res)
        if has_res:
            x = ctx.add(f"b{bi}/sum", x, inp)
    x = ctx.conv("last", x, 1, "HS")
    feats = [c4, x]
    for j, mid in enumerate(_extra_mids(net)):
        x = ctx.conv(f"x{j}/reduce", x, 1, "R6")
        x = ctx.conv(f"x{j}/dw", x, 2, "R6", groups=mid)
        x = ctx.conv(f"x{j}/expand", x, 1, "R6")
        feats.append(x)

    def head(prefix, cols):
        outs = []
        for li, f in enumerate(feats):
            ch = net.feature_channels[li]
            h = ctx.conv(f"{prefix}{li}/dw", f, 1, "R6", groups=ch)
            h = ctx.conv(f"{prefix}{li}/proj", h, 1, None, emit=False)
            outs.append(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1, cols))
        return torch.cat(outs, 1)

    return head("cls", net.num_classes), head("reg", 4)


class Q8SSD:
    """The quantized SSDLite state (the counterpart of ``quant.Q8Yolo``)."""

    def __init__(self, net: SSDLite, qparams, se, scales):
        self.net = net
        self.qparams = qparams
        self.se = se
        self.scales = scales

    @property
    def tree(self):
        return {"qparams": self.qparams, "se": self.se, "scales": self.scales}

    @torch.no_grad()
    def apply(self, x):
        """x (B, S, S, 3) f32 normalised -> (cls_logits, reg) f32, the
        ``SSDLite.forward`` contract (feeds ``ssd_postprocess``)."""
        ctx = _Q8Ctx(self.qparams, self.se, self.scales)
        return _ssd_walk(self.net, ctx, x.permute(0, 3, 1, 2))


def _fold_ssd(net: SSDLite):
    """({name: (w, b)} of every conv of the walk, BatchNorm folded; {name:
    squeeze-excite fc tree})."""
    fused, se = {}, {}

    def cna(name, mod):
        fused[name] = _fold_convbn(mod[0], mod[1])

    def fc(conv):
        return {"w": conv.weight.detach(), "b": conv.bias.detach()}

    for where, part, kind, mod in net._backbone_units():
        name = where if part is None else f"b{where}/{part}"
        if kind == "se":
            se[name] = {"fc1": fc(mod.fc1), "fc2": fc(mod.fc2)}
        else:
            cna(name, mod)
    for j, blk in enumerate(net.backbone.extra):
        for part, unit in zip(("reduce", "dw", "expand"), blk):
            cna(f"x{j}/{part}", unit)
    for prefix, head in (("cls", net.head.classification_head),
                         ("reg", net.head.regression_head)):
        for li, mod in enumerate(head.module_list):
            cna(f"{prefix}{li}/dw", mod[0])
            fused[f"{prefix}{li}/proj"] = (
                mod[1].weight.detach().to(torch.float32),
                mod[1].bias.detach().to(torch.float32))
    return fused, se


def _input_nodes(net: SSDLite, fused):
    """{conv name: its input's emit-node name}, by replaying ``_ssd_walk``'s
    order symbolically (every conv of this family has one input). Asserts
    that every conv of ``fused`` is bound."""
    nodes = {}
    prev, width = "in", None

    def step(name, cout):
        nonlocal prev, width
        nodes[name] = prev
        prev, width = name, cout

    step("stem", 16)
    c4_node = None
    for bi, (k, exp, out, use_se, act_n, stride) in enumerate(
            v3_large_config(net.reduced_tail)):
        block_w = width
        if f"b{bi}/expand" in fused:
            step(f"b{bi}/expand", exp)
        if bi == C4_BLOCK:
            c4_node = prev
        nodes[f"b{bi}/dw"] = prev
        prev = f"b{bi}/se" if use_se else f"b{bi}/dw"  # dw emit or post-SE
        nodes[f"b{bi}/project"] = prev
        prev = f"b{bi}/sum" if (stride == 1 and block_w == out) \
            else f"b{bi}/project"
        width = out
    step("last", net.c5_channels)
    feat_nodes = [c4_node, "last"]
    for j, mid in enumerate(_extra_mids(net)):
        step(f"x{j}/reduce", mid)
        step(f"x{j}/dw", mid)
        step(f"x{j}/expand", 2 * mid)
        feat_nodes.append(f"x{j}/expand")
    for prefix in ("cls", "reg"):
        for li, fn_node in enumerate(feat_nodes):
            nodes[f"{prefix}{li}/dw"] = fn_node
            nodes[f"{prefix}{li}/proj"] = f"{prefix}{li}/dw"
    missing = set(fused) - set(nodes)
    assert not missing, f"unbound convs: {sorted(missing)}"
    return nodes


@torch.no_grad()
def prepare_int8_ssd(net: SSDLite, images_fn, iters: int = 4):
    """A Q8SSD of ``net``'s weights, on their device (``prepare_int8``'s
    protocol: ``images_fn(i)`` is the i-th (B, S, S, 3) f32 normalised
    calibration batch on the net's device; TF32 off on a CUDA device)."""
    fused, se = _fold_ssd(net)
    amax = {}
    for i in range(iters):
        _ssd_walk(net, _CalibCtx(fused, se, amax),
                  images_fn(i).permute(0, 3, 1, 2))
    scales = {k: torch.clamp_min(v, 1e-6) / 127.0 for k, v in amax.items()}
    in_node = _input_nodes(net, fused)
    qparams = {}
    for name, (w, b) in fused.items():
        wq, wscale = _quantize_weight(w)
        qparams[name] = QConv(wq, wscale * scales[in_node[name]],
                              b.to(torch.float32))
    return Q8SSD(net, qparams, se, scales)


def q8_ssd_apply(net: SSDLite, tree, x):
    """int8 serving over a quantized tree (``Q8SSD.tree``), the
    ``SSDLite.forward`` contract in f32."""
    return Q8SSD(net, **tree).apply(x)


def from_jax_q8_ssd(tree):
    """The reference package's ``Q8SSD.tree`` (NumPy arrays) in this
    module's layout (OIHW kernels, (cout,) factors, 0-d scales), on the
    CPU."""

    def fc(p):
        return {"w": _host(p["w"], np.float32).permute(3, 2, 0, 1)
                .contiguous(),
                "b": _host(p["b"], np.float32)}

    return {"qparams": {k: _qconv_from_jax(p)
                        for k, p in tree["qparams"].items()},
            "se": {k: {"fc1": fc(p["fc1"]), "fc2": fc(p["fc2"])}
                   for k, p in tree["se"].items()},
            "scales": _scales_from_jax(tree["scales"])}
