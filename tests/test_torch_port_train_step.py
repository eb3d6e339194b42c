"""The port's training step against the JAX package's: the LR schedule, the
optimisers (SGD, nesterov SGD with the weights-only decay mask, AdamW) over
three steps of YOLOv5n (4 classes, 64 px), batch 2, weights carried from
the JAX init; the EMA, ``pad_targets`` and one bf16 step. SSDLite's steps,
held differently for the reasons given there:
``test_torch_port_train_step_ssd.py``.

The JAX side: its forward, loss and gradient (the body of its train step)
compiled once per family, and its optax chain (``make_optimizer``) jitted
per optimiser. The same JAX function compiled a second time with XLA's
backend optimisations off sums in other orders: how far the JAX package
moves from itself under that (its "own spread") is the scale the port is
held to. At 64 px the deepest BatchNorms normalise few values (YOLOv5n's
2x2 maps: 8 at batch 2), so a step's float rounding grows from step to
step.

Tolerances (measured values are printed):
  * ``lr_at``, ``yolo_recipe_config``, ``pad_targets``: equal.
  * the port's optimiser on the JAX step's own gradients, three steps of
    each optimiser over the YOLOv5n tree: 1e-6 of each tensor's largest
    |value| (XLA contracts the update's multiply-add into one FMA; the
    port rounds twice).
  * three steps end to end (YOLOv5n with each optimiser): each step's
    loss within 1e-5 relative or 10x the JAX package's own spread at that
    step, whichever is larger; each parameter and statistics tensor within
    1e-5 of its largest |value| or 10x its own spread.
  * the EMA after five updates: 1e-6 of each tensor's largest |value|.
  * one bf16 step against f32 (the port alone, batch 8): loss 2e-2
    relative, the update's cosine with the f32 update at least 0.8 (0.90
    measured). At batch 2 the 2x2 BatchNorms see 8 values and bf16
    rounding there turns the step: the JAX package's own bf16 step has a
    cosine of 0.66 with its f32 step at batch 2.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from edgeml_tpu.models import engine as jengine
from edgeml_tpu.models import train as jtrain
from edgeml_tpu.models.loss import yolo_loss as jax_yolo_loss
from edgeml_tpu.models.ssd_loss import ssd_loss as jax_ssd_loss
from edgeml_tpu.models.ssdlite import SSDLite as JaxSSDLite, default_boxes
from edgeml_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from edgeml_tpu_torch.models import train as ttrain
from edgeml_tpu_torch.models.engine import make_family_train_step
from edgeml_tpu_torch.models.yolov5 import YoloV5

torch.set_num_threads(1)

CONFIGS = {
    "sgd": jtrain.TrainConfig(lr=0.02, momentum=0.9, weight_decay=1e-4),
    "nesterov_masked": jtrain.TrainConfig(
        lr=0.01, momentum=0.937, weight_decay=5e-4, nesterov=True,
        decay_mask="weights"),
    "adamw": jtrain.TrainConfig(opt="adamw", lr=1e-3, weight_decay=5e-2),
}
LOSS_TOL = 1e-5
TREE_TOL = 1e-5
SPREAD_FACTOR = 10.0
LRS = (0.02, 0.01, 0.015)
OPT_LRS = {"sgd": LRS, "nesterov_masked": LRS, "adamw": (1e-3, 5e-4, 8e-4)}
_REFS = {}
O0 = {"xla_backend_optimization_level": 0,
      "xla_llvm_disable_expensive_passes": True}


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _batch(seed, b=2, t=5, nc=4, s=64):
    rng = np.random.default_rng(seed)
    x = rng.random((b, s, s, 3)).astype(np.float32)
    tg = np.zeros((b, t, 5), np.float32)
    tg[..., 0] = rng.integers(0, nc, (b, t))
    tg[..., 1:3] = rng.uniform(0.2, 0.8, (b, t, 2))
    tg[..., 3:5] = rng.uniform(0.1, 0.5, (b, t, 2))
    valid = np.ones((b, t), bool)
    valid[1, -1] = False
    return x, tg, valid


def _port_cfg(cfg):
    return ttrain.TrainConfig(**dataclasses.asdict(cfg))


def _jax_grad_fn(family):
    """(net, params, stats, jitted (params, stats, x, tg, valid) -> (loss,
    new_stats, grads)): the JAX package's step body."""
    if family == "yolo":
        net = JaxYoloV5(variant="n", num_classes=4, img_size=64)

        def lf(p, s, x, tg, v):
            heads, ns, _ = net.apply(p, s, x, train=True)
            total, _ = jax_yolo_loss(net, heads, tg, v)
            return total, ns
    else:
        net = JaxSSDLite(num_classes=9, image_size=64)
        anchors = jnp.asarray(default_boxes(64, net.feature_sizes))

        def lf(p, s, x, tg, v):
            boxes, cls = jengine._to_xyxy_px(tg, 64)
            (cl, rg), ns = net.apply(p, s, x, train=True)
            total, _ = jax_ssd_loss(net, cl, rg, anchors, boxes, cls, v)
            return total, ns

    params, stats = net.init(jax.random.PRNGKey(7))

    def fn(p, s, x, tg, v):
        (loss, ns), g = jax.value_and_grad(lf, has_aux=True)(p, s, x, tg, v)
        return loss, ns, g

    return net, params, stats, jax.jit(fn)


def _jax_update(cfg):
    """The JAX package's update: its optax chain, then lr times the
    update added to the params (its train step's tail), jitted."""
    opt = jtrain.make_optimizer(cfg)

    @jax.jit
    def update(g, state, params, lr):
        u, state = opt.update(g, state, params)
        u = jax.tree_util.tree_map(lambda a: a * lr, u)
        return optax.apply_updates(params, u), state

    return opt, update


def _jax_run(fn, params, stats, opt, update, lrs, batches):
    state = opt.init(params)
    losses = []
    for (x, tg, v), lr in zip(batches, lrs):
        loss, stats, g = fn(params, stats, x, tg, v)
        params, state = update(g, state, params, lr)
        losses.append(float(loss))
    return losses, (_np(params), _np(stats))


def reference():
    """The JAX package's YOLOv5n runs, computed once a process."""
    if _REFS:
        return _REFS
    net, params, stats, fn = _jax_grad_fn("yolo")
    batches = [tuple(jnp.asarray(a) for a in _batch(s)) for s in range(3)]
    fn_o0 = fn.lower(params, stats, *batches[0]).compile(
        compiler_options=O0)
    runs = {}
    for name in CONFIGS:
        opt, update = _jax_update(CONFIGS[name])
        runs[name] = [_jax_run(f, params, stats, opt, update, OPT_LRS[name],
                               batches) for f in (fn, fn_o0)]
    _REFS.update(
        params=_np(params), stats=_np(stats),
        batches=[tuple(np.array(a) for a in b) for b in batches], runs=runs,
        fn=fn)
    return _REFS


def _port_net(ref):
    return YoloV5("n", 4, 64).from_jax_params(ref["params"], ref["stats"])


def _tree_err(got, want, floor=0.0):
    errs = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - b).max()
                           / max(floor, float(np.abs(b).max()), 1e-30)),
        got, want)
    return max(jax.tree_util.tree_leaves(errs))


def _leaf_errs(got, want):
    """Per tensor: largest |difference| over the tensor's largest |value|."""
    return [float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))
            for a, b in zip(jax.tree_util.tree_leaves(got),
                            jax.tree_util.tree_leaves(want))]


def check_three_steps(family_ref, name):
    """The port's three steps of ``name`` against the JAX package's."""
    net = _port_net(family_ref)
    opt, step = make_family_train_step(net, _port_cfg(CONFIGS[name]))
    losses = []
    for (x, tg, v), lr in zip(family_ref["batches"], OPT_LRS[name]):
        loss, parts = step(torch.from_numpy(x), torch.from_numpy(tg),
                           torch.from_numpy(v), lr)
        assert set(parts) and all(torch.isfinite(p) for p in parts.values())
        losses.append(float(loss))
    (want_l, want_t), (own_l, own_t) = family_ref["runs"][name]
    for k, (got, want, own) in enumerate(zip(losses, want_l, own_l)):
        err, spread = abs(got - want) / want, abs(own - want) / want
        print(f"yolo {name} step {k}: loss {err:.2e} (own {spread:.2e})")
        assert err <= max(LOSS_TOL, SPREAD_FACTOR * spread)
    errs = _leaf_errs(net.to_jax_params(), want_t)
    spreads = _leaf_errs(own_t, want_t)
    worst = max(e / max(TREE_TOL, SPREAD_FACTOR * o)
                for e, o in zip(errs, spreads))
    print(f"yolo {name}: tensors {max(errs):.2e} (own {max(spreads):.2e}),"
          f" worst share of the bound {worst:.2f}")
    assert worst <= 1.0
    # the weights did move
    assert max(_leaf_errs(net.to_jax_params()[0], family_ref["params"])) \
        > 1e-3


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_steps_match_jax(name):
    check_three_steps(reference(), name)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_optimizer_on_jax_gradients_matches_optax(name):
    """The port's optimiser fed the JAX step's own gradients: three steps
    of optax's chain."""
    family_ref = reference()
    cfg = CONFIGS[name]
    params, stats = family_ref["params"], family_ref["stats"]
    opt, update = _jax_update(cfg)
    state = opt.init(params)
    net = _port_net(family_ref)
    topt = ttrain.make_optimizer(_port_cfg(cfg), net)
    carrier = YoloV5("n", 4, 64)
    for (x, tg, v), lr in zip(family_ref["batches"], OPT_LRS[name]):
        _, _, g = family_ref["fn"](params, stats, x, tg, v)
        carrier.from_jax_params(_np(g), stats)
        topt.step([p.detach().clone() for p in carrier.parameters()], lr)
        params, state = update(g, state, params, lr)
    err = max(_leaf_errs(net.to_jax_params()[0], _np(params)))
    print(f"{name}: optimiser alone {err:.2e}")
    assert err < 1e-6


@pytest.mark.parametrize("cfg", [
    jtrain.TrainConfig(),
    jtrain.TrainConfig(lr_scheduler="cosineannealinglr", lrf=0.05,
                       warmup_iters=7),
    jtrain.yolo_recipe_config(epochs=20),
    jtrain.TrainConfig(lr_steps=(1, 3), lr_gamma=0.5, warmup_iters=3),
])
def test_lr_at_equal(cfg):
    pcfg = _port_cfg(cfg)
    for spe in (1, 5, 40):
        for epoch in range(0, min(cfg.epochs, 25)):
            for it in (0, 1, 2, spe // 2, spe - 1):
                assert ttrain.lr_at(pcfg, epoch, it, spe) == \
                    jtrain.lr_at(cfg, epoch, it, spe)


def test_yolo_recipe_config_equal():
    for e in (3, 300):
        assert dataclasses.asdict(ttrain.yolo_recipe_config(e)) == \
            dataclasses.asdict(jtrain.yolo_recipe_config(e))
    assert dataclasses.asdict(ttrain.TrainConfig()) == \
        dataclasses.asdict(jtrain.TrainConfig())


def test_decay_mask_weights_only():
    net = YoloV5("n", 4, 64)
    opt = ttrain.make_optimizer(ttrain.yolo_recipe_config(), net)
    decayed = {n for n, d in zip(opt.names, opt.decay) if d}
    assert decayed and all(n.endswith("conv.weight") or
                           n.startswith("model.24.m.") and
                           n.endswith("weight") for n in decayed)
    assert "model.0.bn.weight" not in decayed
    assert "model.24.m.0.bias" not in decayed
    opt = ttrain.make_optimizer(ttrain.TrainConfig(), net)
    assert all(opt.decay)
    with pytest.raises(RuntimeError, match="decay_mask"):
        ttrain.make_optimizer(ttrain.TrainConfig(decay_mask="odd"), net)
    with pytest.raises(RuntimeError, match="optimizer"):
        ttrain.make_optimizer(ttrain.TrainConfig(opt="lion"), net)


def test_ema_after_n_updates_matches_jax():
    jnet = JaxYoloV5(variant="n", num_classes=4, img_size=64)
    p0, s0 = jnet.init(jax.random.PRNGKey(3))
    net = YoloV5("n", 4, 64).from_jax_params(_np(p0), _np(s0))
    ema = ttrain.ModelEMA(net)
    update = jtrain.make_ema_update()
    tree = {"params": p0, "stats": s0}
    rng = np.random.default_rng(4)
    for n in range(1, 6):
        live = jax.tree_util.tree_map(
            lambda a: a + jnp.asarray(rng.normal(0, 0.1, a.shape),
                                      jnp.float32), tree)
        net.from_jax_params(_np(live["params"]), _np(live["stats"]))
        ema.update(net)
        tree = update(tree, live, float(n))
    assert ema.n_updates == 5
    got = ema.module.to_jax_params()
    err = _tree_err(got, (_np(tree["params"]), _np(tree["stats"])))
    print(f"ema err {err:.2e}")
    assert err < 1e-6
    assert not ema.module.training
    assert not any(p.requires_grad for p in ema.module.parameters())


def test_pad_targets_exact():
    rng = np.random.default_rng(5)
    labs = [rng.random((k, 5)).astype(np.float32) for k in (0, 3, 7, 1)]
    for maxt in (1, 4, 8):
        got = ttrain.pad_targets(labs, maxt)
        want = jtrain.pad_targets(labs, maxt)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_one_bf16_step_close_to_f32():
    jnet = JaxYoloV5(variant="n", num_classes=4, img_size=64)
    p0, s0 = jnet.init(jax.random.PRNGKey(9))
    x, tg, v = (torch.from_numpy(a) for a in _batch(11, b=8))
    out = {}
    for dt in (None, torch.bfloat16):
        net = YoloV5("n", 4, 64).from_jax_params(_np(p0), _np(s0))
        opt, step = make_family_train_step(net, ttrain.TrainConfig(),
                                           dtype=dt)
        loss, _ = step(x, tg, v, 0.02)
        assert loss.dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in net.parameters())
        out[dt] = (float(loss), jax.tree_util.tree_leaves(
            net.to_jax_params()[0]))
    (l32, t32), (l16, t16) = out[None], out[torch.bfloat16]
    p0 = jax.tree_util.tree_leaves(_np(p0))
    l_err = abs(l16 - l32) / l32
    d32 = np.concatenate([(b - a).ravel() for a, b in zip(p0, t32)])
    d16 = np.concatenate([(b - a).ravel() for a, b in zip(p0, t16)])
    cos = float(d32 @ d16 / np.linalg.norm(d32) / np.linalg.norm(d16))
    print(f"bf16 step: loss {l_err:.2e} update cosine {cos:.3f}")
    assert l_err < 2e-2
    assert cos >= 0.8
