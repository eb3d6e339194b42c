"""Post-training int8 quantization of the YOLOv5 serving trunk.

The reference package's ``models/quant.py``, in PyTorch. Symmetric
post-training quantization (PTQ):

  * BatchNorm is folded exactly into each conv's weight and bias first, so
    the quantized walk applies no norm: each layer is an int8 x int8 ->
    int32 contraction, then the f32 epilogue ``acc * dq + b``, SiLU, and a
    requantization to int8 at the output's own scale.
  * Weights: per-output-channel symmetric scales (absmax / 127). Where a
    conv's input is a concat of tensors with different activation scales,
    the per-group input scales are multiplied into the f32 weights before
    they are quantized (exact), so one contraction serves the whole concat
    and ``dq`` is the weight scale alone.
  * Activations: per-tensor symmetric scales, the absmax of every producer's
    output over the calibration batches. Producers emit int8 from their own
    epilogue; the nearest upsample and the max pool run on int8 directly
    (both commute with the monotone quantizer).
  * C3 shortcut adds run on dequantized values inside the adding conv's
    epilogue and requantize at the sum's own scale.
  * The detect head's 1x1 convs consume the int8 maps with int8 weights;
    their logits are dequantized to f32 for the sigmoid and box decode
    (``YoloV5.decode_level_split``), so the output contract is
    ``YoloV5.predict``'s.

The contraction: a dense conv is an im2col (a strided ``unfold`` view,
copied once into a matrix) times the packed weight matrix through
``torch._int_mm``, whose CUDA form takes more than 16 rows and a depth and
width that are multiples of 8: the matrices are padded with zero rows and
columns, which add nothing to an integer sum. A depthwise conv (SSDLite,
``models/quant_ssd.py``) is an int32 multiply-and-sum over its k x k window
views. Both are exact integer sums, equal to the reference's
``conv_general_dilated(..., preferred_element_type=int32)`` bit for bit.
``F.conv2d`` is not used on int8: it returns int8 and wraps around. A shape
``_int_mm`` refuses raises with the shape; nothing falls back to a float
conv.

Activations are NCHW tensors, kept in channels-last memory by the
contraction (its output is the (B * H * W, C) matrix), so a 1x1 conv's
im2col is a view. The quantized state is a plain tree (``Q8Yolo.tree``):
``{"qparams": {name: QConv}, "scales": {name: f32 scalar}, "detect":
[QConv] * 3}``; ``from_jax_q8`` carries the reference package's tree into
it. Accuracy is a measured knob, not a contract (the tests pin the drift).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .common import max_pool_same
from .yolov5 import HEAD_STAGES, STRIDES, YoloV5

# torch._int_mm's CUDA checks: more than 16 rows, depth and width multiples
# of 8 (the packed weight is passed transposed, as a column-major view)
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def silu(x):
    return x * torch.sigmoid(x)


@torch.no_grad()
def _fold_convbn(conv, bn):
    """Exact BatchNorm fold: (w OIHW, b) f32 such that ``conv(x, w) + b`` is
    the eval conv + norm (no norm op left in the walk)."""
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    return (conv.weight.detach() * scale[:, None, None, None],
            bn.bias - bn.running_mean * scale)


def quantize_tensor(x, scale):
    """Symmetric int8: round half to even, clip to +-127."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _quantize_weight(w, in_scales=None, in_groups=None):
    """Per-output-channel symmetric int8 weights of an OIHW f32 kernel.

    ``in_scales`` / ``in_groups``: per-input-channel-group activation scales
    multiplied into the f32 weights before quantization (exact), so a concat
    input with different scales needs one contraction; ``in_groups`` are
    (start, stop) input-channel ranges. Returns (int8 weights, f32 scale per
    output channel)."""
    w = w.to(torch.float32)
    if in_scales is not None:
        w = torch.cat([w[:, lo:hi] * s
                       for (lo, hi), s in zip(in_groups, in_scales)], 1)
    amax = w.abs().amax(dim=(1, 2, 3))
    wscale = torch.clamp_min(amax, 1e-12) / 127.0
    return quantize_tensor(w, wscale[:, None, None, None]), wscale


def pack_weight(w):
    """The (N, K) int8 matrix of an OIHW int8 kernel for ``_int_mm``: a row
    per output channel, columns in the im2col's (cin, kh, kw) order, zero
    padded to multiples of INT_MM_ALIGN."""
    cout = w.shape[0]
    k = w[0].numel()
    mat = w.reshape(cout, k)
    n_p, k_p = _round_up(cout, INT_MM_ALIGN), _round_up(k, INT_MM_ALIGN)
    if (n_p, k_p) == (cout, k):
        return mat.contiguous()
    out = w.new_zeros(n_p, k_p)
    out[:cout, :k] = mat
    return out


def int_matmul(a, wmat):
    """(M, K) int8 x (N, K)^T int8 -> (M, N) int32 through ``torch._int_mm``
    (exact); a shape the library refuses raises with the shapes."""
    try:
        return torch._int_mm(a, wmat.t())
    except RuntimeError as e:
        raise RuntimeError(
            f"torch._int_mm refused {tuple(a.shape)} x "
            f"{tuple(wmat.shape[::-1])} int8 on {a.device}: {e}") from e


def im2col(xq, k: int, stride: int, pad: int, k_cols: int):
    """The (M, k_cols) int8 patch matrix of NCHW ``xq`` (M = B * Ho * Wo
    rows, at least INT_MM_MIN_ROWS; columns (cin, kh, kw), zero padded to
    ``k_cols``) and (B, Ho, Wo). One copy of the ``unfold`` view; none for a
    1x1 stride-1 conv over a channels-last map."""
    b, c = xq.shape[:2]
    if pad:
        xq = F.pad(xq, (pad, pad, pad, pad))
    cols = xq.unfold(2, k, stride).unfold(3, k, stride)  # (B, C, Ho, Wo, k, k)
    ho, wo = cols.shape[2:4]
    m, kk = b * ho * wo, c * k * k
    cols = cols.permute(0, 2, 3, 1, 4, 5)
    m_p = max(m, INT_MM_MIN_ROWS)
    if (m_p, k_cols) == (m, kk):
        return cols.reshape(m, kk), (b, ho, wo)
    out = xq.new_empty(m_p, k_cols)
    out[m:].zero_()
    out[:m, kk:].zero_()
    out.as_strided((b, ho, wo, c, k, k),
                   (ho * wo * k_cols, wo * k_cols, k_cols, k * k, k, 1)
                   ).copy_(cols)
    return out, (b, ho, wo)


def _int_conv_depthwise(xq, w, stride: int, pad: int):
    """Depthwise (groups == channels) int8 conv as an int32 multiply-and-sum
    over the k x k window views of the padded input."""
    b, c, h, wd = xq.shape
    k = w.shape[-1]
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    xp = F.pad(xq.to(torch.int32), (pad, pad, pad, pad))
    wi = w.to(torch.int32)[:, 0]  # (C, k, k)
    span_h, span_w = stride * (ho - 1) + 1, stride * (wo - 1) + 1
    acc = None
    for i in range(k):
        for j in range(k):
            tap = xp[:, :, i:i + span_h:stride, j:j + span_w:stride] \
                * wi[:, i, j, None, None]
            acc = tap if acc is None else acc.add_(tap)
    return acc


def int_conv(xq, w, stride: int, pad: int, groups: int = 1, wmat=None):
    """int8 x int8 -> int32 convolution of NCHW ``xq`` with the OIHW int8
    kernel ``w`` (square, symmetric zero padding): dense (``groups`` 1,
    through ``int_matmul`` with ``wmat = pack_weight(w)``, packed here when
    not given) or depthwise (``groups`` == channels). Returns (B, cout, Ho,
    Wo) int32, channels-last in memory for a dense conv."""
    if groups != 1:
        if not (groups == xq.shape[1] == w.shape[0] and w.shape[1] == 1):
            raise ValueError(f"int_conv: groups {groups} on {tuple(xq.shape)}"
                             f" x {tuple(w.shape)} is neither dense nor "
                             f"depthwise")
        return _int_conv_depthwise(xq, w, stride, pad)
    if w.shape[1] != xq.shape[1]:
        raise ValueError(f"int_conv: {tuple(xq.shape)} input for a "
                         f"{tuple(w.shape)} kernel")
    if wmat is None:
        wmat = pack_weight(w)
    cout, k = w.shape[0], w.shape[-1]
    cols, (b, ho, wo) = im2col(xq, k, stride, pad, wmat.shape[1])
    acc = int_matmul(cols, wmat)
    return acc[:b * ho * wo, :cout].view(b, ho, wo, cout).permute(0, 3, 1, 2)


class QConv:
    """One quantized convolution (the reference's ``_qconv``): the int8 OIHW
    kernel ``w``, the f32 per-output-channel dequantization factor ``dq``
    (weight scale times the input's activation scale where that is not in
    the weights) and the f32 bias ``b``; ``wmat`` is the kernel packed for
    ``int_matmul``."""

    def __init__(self, w, dq, b):
        self.w = w
        self.dq = dq
        self.b = b
        self.wmat = pack_weight(w)

    def to(self, device):
        return QConv(self.w.to(device), self.dq.to(device), self.b.to(device))

    def __call__(self, xq, stride: int, pad: int, groups: int = 1):
        """The f32 pre-activation ``int_conv(xq) * dq + b``."""
        acc = int_conv(xq, self.w, stride, pad, groups, self.wmat)
        return acc.to(torch.float32) * self.dq[:, None, None] \
            + self.b[:, None, None]


def tree_to(tree, device):
    """A quantized tree (dicts and lists of QConv and tensors) on
    ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


# ---------------------------------------------------------------------------
# The quantized walks traverse the layer graph through YoloV5.walk, the one
# traversal the float trunk uses too. Node names: "l{idx}" for a layer's
# output, "l{idx}/cv1" etc. inside C3 and SPPF blocks, "l{idx}/m{j}/sum"
# for shortcut sums, "in" for the input image.
# ---------------------------------------------------------------------------


def _calibrate_walk(net: YoloV5, fused, x, amax):
    """One f32 pass over the BN-folded weights, recording the absmax of
    every activation into ``amax`` (name -> scalar tensor, a running max).
    ``x``: (B, 3, S, S) f32. Returns the three head inputs."""

    def rec(name, v):
        a = v.abs().amax()
        amax[name] = a if name not in amax else torch.maximum(amax[name], a)
        return v

    def convbn(name, xi, pad, stride):
        w, b = fused[name]
        return rec(name, silu(F.conv2d(xi, w, None, stride, pad)
                              + b[:, None, None]))

    def conv_fn(name, xi, kw):
        return convbn(name, xi, kw.get("p", kw["k"] // 2), kw["s"])

    def c3_fn(name, xi, kw):
        y1 = convbn(f"{name}/cv1", xi, 0, 1)
        y2 = convbn(f"{name}/cv2", xi, 0, 1)
        for j in range(kw["n"]):
            b1 = convbn(f"{name}/m{j}/cv1", y1, 0, 1)
            b2 = convbn(f"{name}/m{j}/cv2", b1, 1, 1)
            y1 = rec(f"{name}/m{j}/sum", y1 + b2) if kw["shortcut"] else b2
        return convbn(f"{name}/cv3", torch.cat([y1, y2], 1), 0, 1)

    def sppf_fn(name, xi, kw):
        y = convbn(f"{name}/cv1", xi, 0, 1)
        p1 = max_pool_same(y, 5)
        p2 = max_pool_same(p1, 5)
        p3 = max_pool_same(p2, 5)
        return convbn(f"{name}/cv2", torch.cat([y, p1, p2, p3], 1), 0, 1)

    rec("in", x)
    feats, _ = net.walk(x, conv_fn, c3_fn, sppf_fn)
    return feats


class Q8Yolo:
    """The quantized state and the int8 serving walk. ``qparams``: {node
    name: QConv}; ``scales``: {node name: f32 activation scale}; ``detect``:
    the three head QConvs."""

    def __init__(self, net: YoloV5, qparams, scales, detect):
        self.net = net
        self.qparams = qparams
        self.scales = scales
        self.detect = detect

    @property
    def tree(self):
        return {"qparams": self.qparams, "scales": self.scales,
                "detect": self.detect}

    def _emit(self, name, y):
        """Requantize a producer's f32 epilogue at its own scale."""
        return quantize_tensor(y, self.scales[name])

    def _convbn_q(self, name, xq, pad, stride, emit=True):
        y = silu(self.qparams[name](xq, stride, pad))
        return self._emit(name, y) if emit else y

    def _c3_q(self, name, xq, n, shortcut):
        y1 = self._convbn_q(f"{name}/cv1", xq, 0, 1)
        y2 = self._convbn_q(f"{name}/cv2", xq, 0, 1)
        for j in range(n):
            b1 = self._convbn_q(f"{name}/m{j}/cv1", y1, 0, 1)
            if shortcut:
                # the dequantized add in cv2's epilogue, requantized at the
                # sum's own scale
                b2 = self._convbn_q(f"{name}/m{j}/cv2", b1, 1, 1, emit=False)
                s1 = self.scales[f"{name}/cv1" if j == 0
                                 else f"{name}/m{j - 1}/sum"]
                y1 = self._emit(f"{name}/m{j}/sum",
                                y1.to(torch.float32) * s1 + b2)
            else:
                y1 = self._convbn_q(f"{name}/m{j}/cv2", b1, 1, 1)
        return self._convbn_q(f"{name}/cv3", torch.cat([y1, y2], 1), 0, 1)

    def _sppf_q(self, name, xq):
        y = self._convbn_q(f"{name}/cv1", xq, 0, 1)
        p1 = max_pool_same(y, 5)
        p2 = max_pool_same(p1, 5)
        p3 = max_pool_same(p2, 5)
        return self._convbn_q(f"{name}/cv2", torch.cat([y, p1, p2, p3], 1),
                              0, 1)

    def trunk(self, x):
        """x: (B, S, S, 3) f32 in [0, 1]. Returns the three int8 head inputs
        (NCHW), through ``YoloV5.walk``."""
        xq = quantize_tensor(x.permute(0, 3, 1, 2), self.scales["in"])
        feats, _ = self.net.walk(
            xq,
            lambda name, xi, kw: self._convbn_q(
                name, xi, kw.get("p", kw["k"] // 2), kw["s"]),
            lambda name, xi, kw: self._c3_q(name, xi, kw["n"],
                                            kw["shortcut"]),
            lambda name, xi, kw: self._sppf_q(name, xi),
        )
        return feats

    @torch.no_grad()
    def predict(self, x, score_dtype=None):
        """The int8 serving path, ``YoloV5.predict``'s contract: (obj (B,
        N), xywh (B, N, 4) f32, cls (B, N, nc)).

        ``score_dtype`` (torch.bfloat16) casts the dequantized obj/cls
        logits before the sigmoid, the int8 analogue of bf16 serving's
        score path (it keys the bf16 NMS tail); box logits stay f32."""
        net = self.net
        na, no = net.na, net.no
        objs, xywhs, clss = [], [], []
        for f, head, stride, anchors in zip(self.trunk(x), self.detect,
                                            STRIDES, net.anchors):
            h = head(f, 1, 0)  # (B, na * no, H, W) f32, channels last
            b, _, hh, ww = h.shape
            h = h.permute(0, 2, 3, 1).reshape(b, hh, ww, na, no)
            h_obj, h_cls = h[..., 4], h[..., 5:]
            if score_dtype is not None:
                h_obj, h_cls = h_obj.to(score_dtype), h_cls.to(score_dtype)
            o, xw, cl = net.decode_level_split(
                h[..., 0:2], h[..., 2:4], h_obj, h_cls, stride, anchors)
            objs.append(o)
            xywhs.append(xw)
            clss.append(cl)
        return torch.cat(objs, 1), torch.cat(xywhs, 1), torch.cat(clss, 1)


def _fold_yolo(net: YoloV5):
    """{node name: (w, b)} of every conv of the trunk, BatchNorm folded."""
    fused = {}
    for idx, kind, _, kw in net.layers():
        name, mod = f"l{idx}", net.model[idx]
        if kind == "conv":
            fused[name] = _fold_convbn(mod.conv, mod.bn)
        elif kind in ("c3", "sppf"):
            for cv in ("cv1", "cv2", "cv3")[:3 if kind == "c3" else 2]:
                sub = getattr(mod, cv)
                fused[f"{name}/{cv}"] = _fold_convbn(sub.conv, sub.bn)
            for j in range(kw.get("n", 0)):
                for cv in ("cv1", "cv2"):
                    sub = getattr(mod.m[j], cv)
                    fused[f"{name}/m{j}/{cv}"] = _fold_convbn(sub.conv, sub.bn)
    return fused


@torch.no_grad()
def prepare_int8(net: YoloV5, images_fn, iters: int = 4):
    """A Q8Yolo of ``net``'s weights, on their device.

    ``images_fn(i)``: the i-th (B, S, S, 3) f32 calibration batch on the
    net's device. BatchNorm is folded exactly; each activation scale is the
    absmax over the ``iters`` batches / 127. On a CUDA device the caller
    turns TF32 off (``device.exact_f32_cuda``): the f32 calibration pass
    sets the scales."""
    fused = _fold_yolo(net)
    amax = {}
    for i in range(iters):
        _calibrate_walk(net, fused, images_fn(i).permute(0, 3, 1, 2), amax)
    scales = {k: torch.clamp_min(v, 1e-6) / 127.0 for k, v in amax.items()}

    table = {idx: (kind, src, kw) for idx, kind, src, kw in net.layers()}

    def out_node(i):
        """Scale-table name of layer i's output (its last conv)."""
        kind = table[i][0]
        return {"c3": f"l{i}/cv3", "sppf": f"l{i}/cv2"}.get(kind, f"l{i}")

    def input_nodes(idx):
        """The producer nodes of layer idx's input, in channel order (up
        and concat layers resolved to their producers)."""

        def resolve(i):
            kind, src, _ = table[i]
            if kind == "concat":
                return resolve(i - 1 if src[0] == -1 else src[0]) \
                    + resolve(src[1])
            if kind == "up":
                return resolve(i - 1)
            return [out_node(i)]

        if idx == 0:
            return ["in"]
        # every conv/c3/sppf of the table reads the previous layer; a variant
        # that does not would need resolve() extended, so fail loudly
        assert table[idx][1] == -1, (idx, table[idx])
        return resolve(idx - 1)

    def node_width(node):
        if node == "in":
            return 3
        return table[int(node[1:].split("/")[0])][2]["cout"]

    qparams = {}

    def qw(name, nodes, widths):
        w, b = fused[name]
        groups, scl, lo = [], [], 0
        for node, width in zip(nodes, widths):
            groups.append((lo, lo + width))
            scl.append(scales[node])
            lo += width
        assert lo == w.shape[1], (name, lo, tuple(w.shape))
        wq, wscale = _quantize_weight(w, scl, groups)
        qparams[name] = QConv(wq, wscale, b.to(torch.float32))

    for idx, kind, _, kw in net.layers():
        name = f"l{idx}"
        if kind == "conv":
            nodes = input_nodes(idx)
            qw(name, nodes, [node_width(n) for n in nodes])
        elif kind == "c3":
            nodes = input_nodes(idx)
            widths = [node_width(n) for n in nodes]
            qw(f"{name}/cv1", nodes, widths)
            qw(f"{name}/cv2", nodes, widths)
            ch = fused[f"{name}/cv1"][0].shape[0]
            sc = kw["shortcut"]
            for j in range(kw["n"]):
                y1 = f"{name}/cv1" if j == 0 else \
                    f"{name}/m{j - 1}/sum" if sc else f"{name}/m{j - 1}/cv2"
                qw(f"{name}/m{j}/cv1", [y1], [ch])
                qw(f"{name}/m{j}/cv2", [f"{name}/m{j}/cv1"], [ch])
            n = kw["n"]
            y1 = f"{name}/cv1" if n == 0 else \
                f"{name}/m{n - 1}/sum" if sc else f"{name}/m{n - 1}/cv2"
            qw(f"{name}/cv3", [y1, f"{name}/cv2"], [ch, ch])
        elif kind == "sppf":
            nodes = input_nodes(idx)
            qw(f"{name}/cv1", nodes, [node_width(n) for n in nodes])
            ch = fused[f"{name}/cv1"][0].shape[0]
            # y, p1, p2, p3 share cv1's scale (the max pool keeps it)
            qw(f"{name}/cv2", [f"{name}/cv1"] * 4, [ch] * 4)

    detect = []
    for stage, conv in zip(HEAD_STAGES, net.model[24].m):
        w = conv.weight.detach()
        wq, wscale = _quantize_weight(w, [scales[out_node(stage)]],
                                      [(0, w.shape[1])])
        detect.append(QConv(wq, wscale, conv.bias.detach().to(torch.float32)))
    return Q8Yolo(net, qparams, scales, detect)


def q8_predict(net: YoloV5, tree, x, score_dtype=None):
    """int8 serving over a quantized tree (``Q8Yolo.tree``), ``predict``'s
    contract; ``score_dtype`` as in ``Q8Yolo.predict``."""
    return Q8Yolo(net, **tree).predict(x, score_dtype=score_dtype)


def _host(a, dtype=None):
    """A CPU tensor copy of an array (NumPy or anything ``np.array``
    takes)."""
    return torch.from_numpy(np.array(a, dtype=dtype))


def _qconv_from_jax(p):
    """A QConv of the reference's {"w": HWIO int8, "dq": (1, 1, 1, cout),
    "b": (cout,)}."""
    return QConv(_host(p["w"], np.int8).permute(3, 2, 0, 1).contiguous(),
                 _host(p["dq"], np.float32).reshape(-1),
                 _host(p["b"], np.float32))


def _scales_from_jax(scales):
    return {k: _host(v, np.float32).reshape(()) for k, v in scales.items()}


def from_jax_q8(tree):
    """The reference package's ``Q8Yolo.tree`` (NumPy arrays) in this
    module's layout: OIHW int8 kernels, (cout,) dequantization factors, 0-d
    f32 scales, on the CPU."""
    return {"qparams": {k: _qconv_from_jax(p)
                        for k, p in tree["qparams"].items()},
            "scales": _scales_from_jax(tree["scales"]),
            "detect": [_qconv_from_jax(p) for p in tree["detect"]]}
