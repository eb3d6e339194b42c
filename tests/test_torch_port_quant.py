"""The port's int8 YOLOv5 serving (``models/quant.py``) against the JAX
package's ``models/quant.py``, on the CPU at 64 px, 8 classes, YOLOv5n.

Tolerances and why:
  * BatchNorm fold: 1e-6 of each output's largest value. The two packages
    evaluate ``rsqrt`` to within an ulp of each other, nothing else.
  * ``quantize_tensor`` and the concat-absorbed weights: bit for bit, the
    same f32 operations on the same inputs.
  * The int32 contraction (im2col and ``torch._int_mm``, or the depthwise
    window sum) against ``conv_general_dilated(..., preferred_element_type=
    int32)``: bit for bit. Integer sums are exact in any order.
  * Serving the JAX package's own quantized tree (carried by
    ``from_jax_q8``): the int8 head inputs may differ by +-1 where an f32
    epilogue value (SiLU of ``acc * dq + b``, one ulp apart between the two
    frameworks' sigmoids) lands on a rounding boundary, in at most 0.1% of
    the elements; none by more. Obj/cls within 2e-3 with f32 scores; with
    bf16 scores within one bf16 ulp of a value in [0.5, 1) (2^-8): the two
    frameworks round a bf16 sigmoid from f32 values an ulp apart. Boxes
    within 0.05 px on average.
  * ``prepare_int8`` run by each package on the same weights and images:
    scales within 5e-5 relative (the f32 calibration convs sum in other
    orders through 24 layers: 1.45e-5 at most here), int8 weights +-1 apart in at most 0.1% of their entries (a
    weight scaled by an input scale that moved by 1e-6 crosses a rounding
    boundary).
  * The port's own int8 against its own f32: the JAX package's drift
    bounds (``tests/test_quant.py``), which hold PTQ noise, not parity.
  * ``fuse_convbn``: 1e-6 of each leaf's largest value (the rsqrt).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models import quant as jq
from edgeml_tpu.models.yolov5 import fuse_convbn as jax_fuse_convbn
from edgeml_tpu_torch.models import quant as tq
from edgeml_tpu_torch.models.common import ConvBN
from edgeml_tpu_torch.models.yolov5 import fuse_convbn

from test_torch_port_yolov5 import carried

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -8  # one bf16 ulp in [0.5, 1)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _oihw(w_hwio):
    return _t(w_hwio).permute(3, 2, 0, 1).contiguous()


def test_fold_convbn_matches_jax():
    rng = _rng(0)
    p = {"w": rng.normal(0, 0.1, (3, 3, 8, 16)).astype(np.float32),
         "g": rng.uniform(0.5, 1.5, 16).astype(np.float32),
         "b": rng.normal(0, 0.1, 16).astype(np.float32)}
    s = {"m": rng.normal(0, 0.2, 16).astype(np.float32),
         "v": rng.uniform(0.5, 2.0, 16).astype(np.float32)}
    mod = ConvBN(8, 16, 3)
    with torch.no_grad():
        mod.conv.weight.copy_(_oihw(p["w"]))
        mod.bn.weight.copy_(_t(p["g"]))
        mod.bn.bias.copy_(_t(p["b"]))
        mod.bn.running_mean.copy_(_t(s["m"]))
        mod.bn.running_var.copy_(_t(s["v"]))
    jw, jb = (np.asarray(a) for a in jq._fold_convbn(p, s))
    w, b = tq._fold_convbn(mod.conv, mod.bn)
    w = w.permute(2, 3, 1, 0).numpy()
    assert np.abs(w - jw).max() <= 1e-6 * np.abs(jw).max()
    assert np.abs(b.detach().numpy() - jb).max() <= 1e-6 * np.abs(jb).max()


def test_quantize_tensor_bit_equal():
    """Random values, exact half-way ties (round half to even) and values
    past the clip, at one scale."""
    rng = _rng(1)
    scale = np.float32(0.0371)
    ties = (np.arange(-130, 130) + 0.5).astype(np.float32) * scale
    x = np.concatenate([rng.normal(0, 3, 4000).astype(np.float32), ties,
                        np.float32([9.0, -9.0, 0.0])])
    want = np.asarray(jq.quantize_tensor(jnp.asarray(x), scale))
    got = tq.quantize_tensor(_t(x), torch.tensor(scale)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)


def test_quantize_weight_absorbed_bit_equal():
    """A conv over a concat of two groups with different input scales:
    the absorbed int8 weights and the per-channel scales bit for bit."""
    rng = _rng(2)
    w = rng.normal(0, 0.3, (3, 3, 12, 16)).astype(np.float32)
    scales = [np.float32(0.0787), np.float32(0.00041)]
    groups = [(0, 4), (4, 12)]
    jwq, jws = jq._quantize_weight(jnp.asarray(w),
                                   [jnp.float32(s) for s in scales], groups)
    wq, ws = tq._quantize_weight(_oihw(w), [torch.tensor(s) for s in scales],
                                 groups)
    np.testing.assert_array_equal(wq.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))


# (batch, size, cin, cout, kernel, stride, pad, groups): 1x1, 3x3 with the
# depth (45 -> 48) and width (7 -> 8) padded, the 6x6-s2 stem (108 -> 112),
# 3x3 stride 2, fewer than 17 rows (4), depthwise 3x3 and 5x5-s2
CONV_CASES = [
    (2, 9, 16, 24, 1, 1, 0, 1),
    (2, 9, 5, 7, 3, 1, 1, 1),
    (2, 16, 3, 8, 6, 2, 2, 1),
    (2, 10, 12, 9, 3, 2, 1, 1),
    (1, 3, 16, 16, 3, 2, 1, 1),
    (2, 9, 16, 16, 3, 1, 1, 16),
    (2, 10, 8, 8, 5, 2, 2, 8),
]


def record_int_matmul(monkeypatch):
    """Replace ``int_matmul`` with a recorder of its operands' shapes."""
    calls, orig = [], tq.int_matmul

    def record(a, wmat):
        calls.append((tuple(a.shape), tuple(wmat.shape)))
        return orig(a, wmat)

    monkeypatch.setattr(tq, "int_matmul", record)
    return calls


def assert_int_mm_shapes(calls, dense):
    """One contraction for a dense conv, in ``_int_mm``'s CUDA shape rules
    (more than 16 rows, depth and width multiples of 8); none for a
    depthwise conv."""
    assert len(calls) == (1 if dense else 0)
    for (m, k), (n, k2) in calls:
        assert k == k2 and m >= 17 and k % 8 == 0 and n % 8 == 0


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "x".join(map(str, c)))
def test_int_conv_bit_equal_jax(case, monkeypatch):
    b, h, cin, cout, k, s, p, g = case
    calls = record_int_matmul(monkeypatch)
    rng = _rng(3)
    x = rng.integers(-127, 128, (b, h, h, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin // g, cout)).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w, (s, s), ((p, p), (p, p)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=g,
        preferred_element_type=jnp.int32))
    got = tq.int_conv(_t(x).permute(0, 3, 1, 2), _oihw(w), s, p, groups=g)
    assert got.dtype == torch.int32
    assert_int_mm_shapes(calls, g == 1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # the dequantizing epilogue: the reference's op order, bit for bit
    dq = rng.uniform(1e-4, 1e-2, cout).astype(np.float32)
    bias = rng.normal(0, 1, cout).astype(np.float32)
    if g == 1:
        jy = np.asarray(jq._qconv(x, w, dq[None, None, None], bias, s, p))
        y = tq.QConv(_oihw(w), _t(dq), _t(bias))(
            _t(x).permute(0, 3, 1, 2), s, p)
        np.testing.assert_array_equal(y.permute(0, 2, 3, 1).numpy(), jy)


def test_int_matmul_raises_with_the_shape():
    """A contraction the library refuses raises with its shapes; nothing
    falls back to a float product."""
    with pytest.raises(RuntimeError, match=r"refused \(17, 8\) x \(8, 8\)"):
        tq.int_matmul(torch.zeros(17, 8, dtype=torch.int32),
                      torch.zeros(8, 8, dtype=torch.int8))


@pytest.fixture(scope="module")
def q8():
    """A carried YOLOv5n (BatchNorm statistics from the test batch), the
    JAX package's prepare_int8 on that batch, and its serving outputs (one
    jitted program: trunk, f32-score and bf16-score predict)."""
    x = _rng(4).random((4, 64, 64, 3)).astype(np.float32)
    jnet, params, stats, net = carried(5, x)
    jq8 = jq.prepare_int8(jnet, params, stats, lambda i: jnp.asarray(x),
                          iters=1)

    def serve(tree, xi):
        bundle = jq.Q8Yolo(jnet, tree["qparams"], tree["scales"],
                           tree["detect"])
        return (bundle.trunk(xi), bundle.predict(xi),
                bundle.predict(xi, score_dtype=jnp.bfloat16))

    feats, pred, pred_bf16 = jax.jit(serve)(jq8.tree, jnp.asarray(x))
    tree = jax.tree_util.tree_map(np.asarray, jq8.tree)
    return dict(x=x, jnet=jnet, params=params, stats=stats, net=net,
                tree=tree, feats=feats, pred={None: pred, "bf16": pred_bf16})


def test_from_jax_q8_trunk_matches_jax(q8):
    port = tq.Q8Yolo(q8["net"], **tq.from_jax_q8(q8["tree"]))
    feats = port.trunk(_t(q8["x"]))
    assert [tuple(f.shape) for f in feats] == [
        (4, 64, 8, 8), (4, 128, 4, 4), (4, 256, 2, 2)]
    flips = total = 0
    for got, want in zip(feats, q8["feats"]):
        assert got.dtype == torch.int8
        d = np.abs(got.permute(0, 2, 3, 1).numpy().astype(np.int32)
                   - np.asarray(want).astype(np.int32))
        assert d.max() <= 1, f"a head input differs by {d.max()}"
        flips += int((d > 0).sum())
        total += d.size
    assert flips <= 1e-3 * total, f"{flips} requantization flips of {total}"


@pytest.mark.parametrize("score", [None, "bf16"])
def test_from_jax_q8_predict_matches_jax(q8, score):
    tree = tq.from_jax_q8(q8["tree"])
    sdt = torch.bfloat16 if score else None
    obj, xywh, cls = tq.q8_predict(q8["net"], tree, _t(q8["x"]),
                                   score_dtype=sdt)
    jobj, jxywh, jcls = (np.asarray(a.astype(jnp.float32))
                         for a in q8["pred"][score])
    assert obj.dtype == cls.dtype == (sdt or torch.float32)
    assert xywh.dtype == torch.float32
    tol = BF16_ULP if score else 2e-3
    assert np.abs(obj.float().numpy() - jobj).max() <= tol
    assert np.abs(cls.float().numpy() - jcls).max() <= tol
    assert np.abs(xywh.numpy() - jxywh).mean() < 0.05
    assert np.std(jobj) > 0.05  # a real workload: scores spread


def test_prepare_int8_matches_jax(q8):
    """Each package's prepare_int8 from the same weights, statistics and
    calibration batch: the same scale table, the same int8 weights up to
    +-1 flips, the same biases."""
    port = tq.prepare_int8(q8["net"], lambda i: _t(q8["x"]), iters=1)
    want = q8["tree"]
    assert sorted(port.scales) == sorted(want["scales"])
    rel = max(abs(float(port.scales[k]) - float(v)) / float(v)
              for k, v in want["scales"].items())
    assert rel <= 5e-5, rel
    pairs = [(port.qparams[k], v) for k, v in want["qparams"].items()]
    pairs += list(zip(port.detect, want["detect"]))
    assert sorted(port.qparams) == sorted(want["qparams"])
    flips = total = 0
    for got, p in pairs:
        d = np.abs(got.w.permute(2, 3, 1, 0).numpy().astype(np.int32)
                   - p["w"].astype(np.int32))
        assert d.max() <= 1
        flips += int((d > 0).sum())
        total += d.size
        # dq is the absorbed weights' scale: it moves with the input scales
        np.testing.assert_allclose(got.dq.numpy(), p["dq"].reshape(-1),
                                   rtol=5e-5, atol=0)
        np.testing.assert_allclose(got.b.numpy(), p["b"], rtol=0,
                                   atol=1e-6 * np.abs(p["b"]).max())
    assert flips <= 1e-3 * total, f"{flips} weight flips of {total}"


@pytest.fixture(scope="module")
def own(q8):
    """The port's own int8 and f32 serving outputs of the carried net."""
    net, x = q8["net"], _t(q8["x"])
    bundle = tq.prepare_int8(net, lambda i: x, iters=1)
    return dict(f32=net.predict(x), q8=bundle.predict(x),
                q8_bf16=bundle.predict(x, score_dtype=torch.bfloat16))


def test_own_int8_drift_against_f32(own):
    """The JAX package's drift bounds for int8 against f32
    (tests/test_quant.py test_q8_predict_contract_and_drift)."""
    obj, xywh, cls = (a.numpy() for a in own["f32"])
    qobj, qxywh, qcls = (a.numpy() for a in own["q8"])
    assert qobj.shape == obj.shape and qcls.shape == cls.shape
    assert qxywh.shape == xywh.shape and qxywh.dtype == np.float32
    assert np.abs(qobj - obj).mean() < 0.10
    assert np.abs(qcls - cls).mean() < 0.10
    assert np.abs(qxywh[..., :2] - xywh[..., :2]).mean() < 3.0
    best_f = cls.max(-1) * obj
    best_q = qcls.max(-1) * qobj
    for b in range(len(obj)):
        top_f = np.argsort(-best_f[b])[:32]
        top_q = np.argsort(-best_q[b])[:32]
        floor_f = np.sort(best_f[b])[-32]
        floor_q = np.sort(best_q[b])[-32]
        assert (best_q[b][top_f] < floor_q - 0.05).sum() <= 8, b
        assert (best_f[b][top_q] < floor_f - 0.05).sum() <= 8, b


def test_own_int8_bf16_scores(own):
    """bf16 scores behind the int8 trunk (tests/test_quant.py
    test_q8_predict_bf16_scores): obj/cls in bf16, boxes f32 and bit-equal
    to the f32-score path, scores within bf16 rounding of it."""
    obj, xywh, cls = own["q8"]
    bobj, bxywh, bcls = own["q8_bf16"]
    assert bobj.dtype == bcls.dtype == torch.bfloat16
    assert bxywh.dtype == torch.float32
    assert torch.equal(bxywh, xywh)
    assert float((bobj.float() - obj).abs().max()) < 0.02
    assert float((bcls.float() - cls).abs().max()) < 0.02


def test_fuse_convbn_matches_jax(q8):
    """fuse_convbn on the carried net against the JAX package's on its
    trees: every leaf within 1e-6 of its largest value."""
    want_p, want_s = jax_fuse_convbn(q8["params"], q8["stats"])
    got_p, got_s = fuse_convbn(q8["net"]).to_jax_params()
    got = jax.tree_util.tree_leaves((got_p, got_s))
    want = jax.tree_util.tree_leaves((want_p, want_s))
    assert len(got) == len(want) > 100
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
    # the original net is left as it was
    np.testing.assert_array_equal(
        q8["net"].model[0].bn.running_var.numpy(),
        np.asarray(q8["stats"]["l0"]["v"]))
