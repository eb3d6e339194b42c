"""The port's int8 SSDLite serving (``models/quant_ssd.py``) against the JAX
package's ``models/quant_ssd.py``, on the CPU at 64 px, 8 classes
(background included): the fold, the calibration, the weights and the
serving walk, emit point by emit point.

The parity net is the JAX package's init carried into the port, with
BatchNorm statistics taken layer by layer on the test batch and 28 noise
images (variances floored at 1e-2: the 1x1 levels have little) and head
biases spread from the seed, so every layer carries signal.

Tolerances and why:
  * BatchNorm fold: 1e-6 of each folded tensor's largest value (``rsqrt``
    an ulp apart); the squeeze-excite weights and the input-node table
    exactly.
  * Serving the JAX package's own quantized tree (``from_jax_q8_ssd``):
    every emitted int8 map equal except for +-1 flips in at most 0.1% of
    its elements (an f32 epilogue value an ulp apart on a rounding
    boundary: XLA fuses the compiled walk's activations; one flip in 1.6
    million here), and the f32 logits within 1e-3 of their largest value.
    On a net whose statistics come from 4 images such a flip cascades
    through the ill-conditioned 1x1 levels, the JAX package's compiled walk
    against its own op-by-op walk too (2.7% of the emitted values, up to 91
    steps), so the parity net takes its statistics from 32.
  * ``prepare_int8_ssd`` run by each package on the same weights and
    images: the scale tables key by key within SCALE_TOL relative, and the
    int8 weights +-1 apart in at most 0.1% of their entries. A scale is one
    element's absmax of an f32 map; the two calibration walks sum in other
    orders and the JAX package's jitted walk fuses its activations, and on
    the 1x1 maps of the deep levels that moves a scale by up to 1e-2 of
    itself on a net whose statistics come from 4 images, 2e-5 on this one
    (32 images).
  * The port's own int8 against its own f32, on the JAX package's own
    workload (its init, random images): the contract of
    ``tests/test_quant_ssd.py``: shapes, f32 logits, drift below 0.15 of
    the largest logit, correlation above 0.99.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from edgeml_tpu.models import quant_ssd as jq
from edgeml_tpu.models.ssdlite import SSDLite as JaxSSDLite
from edgeml_tpu_torch.models import quant_ssd as tq
from edgeml_tpu_torch.models.common import ConvNormAct
from edgeml_tpu_torch.models.infer import IMAGENET_MEAN, IMAGENET_STD
from edgeml_tpu_torch.models.ssd_loss import ssd_postprocess
from edgeml_tpu_torch.models.ssdlite import SSDLite

torch.set_num_threads(1)

SIZE, NC = 64, 8
FLOOR_VAR = 1e-2
SCALE_TOL = 1e-4


def _numpy_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), t)


def _t(a):
    return torch.from_numpy(np.array(a))


def carried_ssd(seed, calib):
    """The JAX package's init(PRNGKey(seed)) carried into the port, with
    each BatchNorm's statistics set, layer by layer, to its conv's batch
    statistics on ``calib`` and 28 seeded noise images (variances floored
    at FLOOR_VAR; fewer images leave the 1x1 levels' statistics so noisy
    that they amplify f32 rounding) and the head projections' biases spread
    from the seed. Returns (JAX net, its params and stats trees of the same
    weights, the port's net)."""
    jnet = JaxSSDLite(num_classes=NC, image_size=SIZE)
    params, stats = jnet.init(jax.random.PRNGKey(seed))
    net = SSDLite(num_classes=NC, image_size=SIZE)
    net.from_jax_params(_numpy_tree(params), _numpy_tree(stats))

    def take_stats(mod, args):
        conv, bn = mod[0], mod[1]
        y = F.conv2d(args[0], conv.weight, None, conv.stride, conv.padding,
                     1, conv.groups)
        bn.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(
            y.var(dim=(0, 2, 3), unbiased=False).clamp_min(FLOOR_VAR))

    hooks = [m.register_forward_pre_hook(take_stats)
             for m in net.modules() if isinstance(m, ConvNormAct)]
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        net(_t(np.concatenate([calib, normalised_batch(seed + 100, 28)])))
        for hook in hooks:
            hook.remove()
        for head, scale in ((net.head.classification_head, 1.5),
                            (net.head.regression_head, 0.5)):
            for mod in head.module_list:
                mod[1].bias.copy_(_t(rng.normal(0, scale, mod[1].bias.shape)
                                     .astype(np.float32)))
    params, stats = jax.tree_util.tree_map(jnp.asarray, net.to_jax_params())
    return jnet, params, stats, net


def normalised_batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return ((rng.random((b, SIZE, SIZE, 3)).astype(np.float32)
             - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


class _JaxRecorder(jq._Q8Ctx):
    """The JAX package's int8 context, recording each emitted map."""

    def __init__(self, *args, record):
        super().__init__(*args)
        self.record = record

    def _emit(self, name, y):
        out = super()._emit(name, y)
        self.record[name] = out[0]
        return out


class _PortRecorder(tq._Q8Ctx):
    """The port's int8 context, recording each emitted map as NHWC."""

    def __init__(self, *args, record):
        super().__init__(*args)
        self.record = record

    def _emit(self, name, y):
        out = super()._emit(name, y)
        self.record[name] = out[0].permute(0, 2, 3, 1).numpy()
        return out


@pytest.fixture(scope="module")
def q8():
    """The carried net, the JAX package's prepare_int8_ssd on the test
    batch, and its int8 walk of that batch (jitted) with every emitted map
    recorded."""
    x = normalised_batch(6)
    jnet, params, stats, net = carried_ssd(7, x)
    jq8 = jq.prepare_int8_ssd(jnet, params, stats, lambda i: jnp.asarray(x),
                              iters=1)

    def walk(tree, xi):
        record = {}
        ctx = _JaxRecorder(tree["qparams"], tree["se"], tree["scales"],
                           record=record)
        return record, jq._ssd_walk(jnet, ctx, xi)

    emits, (cls, reg) = jax.jit(walk)(jq8.tree, jnp.asarray(x))
    return dict(x=x, jnet=jnet, params=params, stats=stats, net=net,
                tree=_numpy_tree(jq8.tree), emits=_numpy_tree(emits),
                cls=np.asarray(cls), reg=np.asarray(reg))


def test_fold_ssd_matches_jax(q8):
    """The folded weights and biases key by key, the squeeze-excite weights
    and the input-node table."""
    want, want_se = jq._fold_ssd(q8["jnet"], q8["params"], q8["stats"])
    got, got_se = tq._fold_ssd(q8["net"])
    assert sorted(got) == sorted(want)
    for name, (jw, jb) in want.items():
        w, b = got[name]
        jw, jb = np.asarray(jw), np.asarray(jb)
        w = w.permute(2, 3, 1, 0).numpy()
        assert w.shape == jw.shape, name
        assert np.abs(w - jw).max() <= 1e-6 * np.abs(jw).max(), name
        assert np.abs(b.numpy() - jb).max() <= 1e-6 * np.abs(jb).max(), name
    assert sorted(got_se) == sorted(want_se)
    for name, p in want_se.items():
        for fc in ("fc1", "fc2"):
            np.testing.assert_array_equal(
                got_se[name][fc]["w"].permute(2, 3, 1, 0).numpy(),
                np.asarray(p[fc]["w"]))
            np.testing.assert_array_equal(got_se[name][fc]["b"].numpy(),
                                          np.asarray(p[fc]["b"]))
    assert tq._input_nodes(q8["net"], got) == \
        jq._input_nodes(q8["jnet"], want)


def test_from_jax_q8_ssd_walk_matches_jax(q8):
    """The port's walk on the JAX package's tree: each emitted int8 map and
    the logits."""
    port = tq.from_jax_q8_ssd(q8["tree"])
    record = {}
    ctx = _PortRecorder(port["qparams"], port["se"], port["scales"],
                        record=record)
    with torch.no_grad():
        cls, reg = tq._ssd_walk(q8["net"], ctx, _t(q8["x"]).permute(0, 3, 1, 2))
    assert sorted(record) == sorted(q8["emits"]) and len(record) > 60
    flips = 0
    for name, want in q8["emits"].items():
        got = record[name]
        assert got.dtype == np.int8 and got.shape == want.shape, name
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1, (name, int(d.max()))
        assert (d > 0).sum() <= 1e-3 * d.size, \
            f"{name}: {(d > 0).sum()} requantization flips of {d.size}"
        flips += int((d > 0).sum())
    for got, want in ((cls, q8["cls"]), (reg, q8["reg"])):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        err = np.abs(got.numpy() - want).max()
        assert err <= 1e-3 * np.abs(want).max(), (err, flips)
    assert np.std(q8["cls"]) > 0.5  # a real workload: logits spread
    # the functional entry serves the same tree to the same logits
    fc, fr = tq.q8_ssd_apply(q8["net"], port, _t(q8["x"]))
    assert torch.equal(fc, cls) and torch.equal(fr, reg)


def test_prepare_int8_ssd_matches_jax(q8):
    port = tq.prepare_int8_ssd(q8["net"], lambda i: _t(q8["x"]), iters=1)
    want = q8["tree"]
    assert sorted(port.scales) == sorted(want["scales"])
    for name, v in want["scales"].items():
        rel = abs(float(port.scales[name]) - float(v)) / float(v)
        assert rel <= SCALE_TOL, (name, rel)
    assert sorted(port.qparams) == sorted(want["qparams"])
    flips = total = 0
    for name, p in want["qparams"].items():
        got = port.qparams[name]
        d = np.abs(got.w.permute(2, 3, 1, 0).numpy().astype(np.int32)
                   - p["w"].astype(np.int32))
        assert d.max() <= 1, name
        flips += int((d > 0).sum())
        total += d.size
        np.testing.assert_allclose(got.dq.numpy(), p["dq"].reshape(-1),
                                   rtol=SCALE_TOL, atol=0, err_msg=name)
    assert flips <= 1e-3 * total, f"{flips} weight flips of {total}"


def test_own_int8_ssd_contract_and_drift():
    """The port's own int8 against its own f32 on the workload of
    tests/test_quant_ssd.py test_q8_ssd_output_contract (the JAX package's
    init, two random calibration batches, a third batch served)."""
    jnet = JaxSSDLite(num_classes=NC, image_size=SIZE)
    params, stats = jnet.init(jax.random.PRNGKey(0))
    net = SSDLite(num_classes=NC, image_size=SIZE)
    net.from_jax_params(_numpy_tree(params), _numpy_tree(stats))
    rng = np.random.default_rng(5)
    calib = [_t(rng.random((2, SIZE, SIZE, 3)).astype(np.float32))
             for _ in range(2)]
    bundle = tq.prepare_int8_ssd(net, lambda i: calib[i], iters=2)
    x = _t(np.random.default_rng(9).random((2, SIZE, SIZE, 3))
           .astype(np.float32))
    with torch.no_grad():
        cls_f, reg_f = net(x)
    cls_q, reg_q = bundle.apply(x)
    assert cls_q.shape == cls_f.shape and reg_q.shape == reg_f.shape
    assert cls_q.dtype == reg_q.dtype == torch.float32
    cf, cq = cls_f.numpy(), cls_q.numpy()
    rel = np.abs(cf - cq).max() / max(1e-6, np.abs(cf).max())
    assert rel < 0.15, f"cls logit drift {rel}"
    assert np.corrcoef(cf.ravel(), cq.ravel())[0, 1] > 0.99


def test_own_int8_ssd_postprocess(q8):
    """The carried net's int8 logits through ssd_postprocess: finite
    detections, some kept."""
    net, x = q8["net"], _t(q8["x"])
    cls_q, reg_q = tq.prepare_int8_ssd(net, lambda i: x, iters=1).apply(x)
    dets, valid = ssd_postprocess(net, cls_q, reg_q, net.anchors("cpu"),
                                  score_thresh=0.01, nms_thresh=0.55)
    assert torch.isfinite(dets).all() and int(valid.sum()) > 0
