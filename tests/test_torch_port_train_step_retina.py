"""The port's RetinaNet training step against the JAX package's: two SGD
steps of RetinaNet-ResNet50-FPN-v2 (6 classes + background, 128 px, batch
2, full width), the weights carried from the JAX init with the frozen
BatchNorm statistics, the GroupNorm affines, the head biases and the tower
conv biases spread from a seed.

Each step starts from the JAX package's own state before it (parameters
and momentum), so each comparison holds one step's rounding. The step is
held per leaf of the JAX package's parameter tree, the frozen-BN gain,
shift, mean and variance and the tower conv biases included, and as a
whole, at fixed limits (the measured values are printed):

  * the loss: 1e-5 relative;
  * each leaf's gradient: the norm of its difference over the norm of the
    JAX gradient of that leaf, at most GRAD_LEAF_TOL for every leaf and
    GRAD_MEDIAN_TOL for the median leaf;
  * the update (new parameters less the old), every tensor at once: the
    norm of the difference within UPDATE_NORM_TOL of the norm of the JAX
    update.

Measured on the CPU, both packages f32: loss 1.9e-7 and 6.1e-8; leaf
gradients median 6.2e-5 and 8.6e-7, worst 1.6e-3 (step 0: one block's
conv1 and its frozen BN, where the forward's rounding puts a
pre-activation on the other side of its ReLU than the JAX package's) and
1.8e-6; the update 1.9e-5 and 5.8e-7. The JAX package against itself
compiled with XLA's backend optimisations off: worst leaf 2.0e-6, but
the two packages' convolutions sum in other orders through 50 layers.

Then the trained leaf set: the port's optimiser holds exactly the leaves
of the JAX tree, and no norm of the model takes batch statistics. And
one bf16 step (the port alone, the same state): loss within 2e-2 of the
f32 step's and its update's cosine with the f32 update at least
BF16_COSINE (3.4e-4 and 0.99965 measured).
"""

import copy
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models import engine as jengine
from edgeml_tpu.models.retinanet import (
    RetinaNet as JaxRetinaNet, retina_anchors, retina_loss,
)
from edgeml_tpu_torch.models.engine import make_family_train_step
from edgeml_tpu_torch.models.retinanet import RetinaNet
from test_torch_port_retinanet import _spread
from test_torch_port_train_step import (
    CONFIGS, LOSS_TOL, _jax_update, _np, _port_cfg,
)

torch.set_num_threads(1)

SIZE, NC = 128, 7  # 6 classes + background
LRS = (0.02, 0.01)
GRAD_LEAF_TOL = 1e-2
GRAD_MEDIAN_TOL = 5e-4
UPDATE_NORM_TOL = 2e-4
BF16_COSINE = 0.995
_REF = {}


def frozen_batch(seed, b=2, t=5, s=SIZE, nc=NC - 1):
    """Normalised images and [cls, x, y, w, h] rows (the last of image 1
    padding)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, s, s, 3)).astype(np.float32)
    tg = np.zeros((b, t, 5), np.float32)
    tg[..., 0] = rng.integers(0, nc, (b, t))
    tg[..., 1:3] = rng.uniform(0.25, 0.75, (b, t, 2))
    tg[..., 3:5] = rng.uniform(0.15, 0.5, (b, t, 2))
    valid = np.ones((b, t), bool)
    valid[1, -1] = False
    return x, tg, valid


def _trace(state):
    """The momentum tree of optax's SGD chain state."""
    return next(s.trace for s in state if hasattr(s, "trace"))


def jax_reference(grad_fn, params, keys=None):
    """Per step of the JAX package's SGD steps from ``params``: the state
    before it, its batch and lr, its loss, gradients and new parameters."""
    opt, update = _jax_update(CONFIGS["sgd"])
    state = opt.init(params)
    steps = []
    for k, lr in enumerate(LRS):
        batch = frozen_batch(k)
        args = [jnp.asarray(a) for a in batch]
        if keys is not None:
            args.append(keys[k])
        loss, g = grad_fn(params, *args)
        new_p, new_state = update(g, state, params, lr)
        steps.append(dict(params=_np(params), trace=_np(_trace(state)),
                          batch=batch, lr=lr, loss=float(loss), grads=_np(g),
                          new=_np(new_p)))
        params, state = new_p, new_state
    return steps


def retina_reference():
    if _REF:
        return _REF
    jnet = JaxRetinaNet(num_classes=NC, image_size=SIZE)
    rng = np.random.default_rng(7)
    params = _spread(jnet.init(jax.random.PRNGKey(7)), rng)
    for tower in ("cls_tower", "reg_tower"):
        params[tower] = [dict(layer, b=jnp.asarray(
            rng.normal(0, 0.2, 256), jnp.float32)) for layer in params[tower]]
    anchors = jnp.asarray(retina_anchors(SIZE))

    @jax.jit
    def grad_fn(p, x, tg, v):
        def lf(p):
            boxes, cls = jengine._to_xyxy_px(tg, SIZE)
            cl, rg = jnet.apply(p, x)
            return retina_loss(jnet, cl, rg, anchors, boxes, cls, v)[0]

        return jax.value_and_grad(lf)(p)

    _REF["steps"] = jax_reference(grad_fn, params)
    return _REF


def leaves(tree):
    return [np.asarray(a, np.float64) for a in jax.tree_util.tree_leaves(tree)]


def leaf_paths(tree):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def trained(net):
    return [p for p in net.parameters() if p.requires_grad]


def as_tree(net, tensors):
    """``tensors`` (one per trained parameter, in the optimiser's order) in
    the JAX package's tree layout, through a copy of ``net``."""
    carrier = copy.deepcopy(net)
    with torch.no_grad():
        for p, t in zip(trained(carrier), tensors):
            p.copy_(t)
    return carrier.to_jax_params()[0]


def port_step(make_net, ref, dtype=None, draws=None):
    """The port's step from the JAX state ``ref``: (loss, gradient tree,
    new parameter tree)."""
    net = make_net().from_jax_params(ref["params"])
    opt, step = make_family_train_step(net, _port_cfg(CONFIGS["sgd"]),
                                       dtype=dtype)
    opt.trace = [p.detach().clone() for p in
                 trained(make_net().from_jax_params(ref["trace"]))]
    if draws is not None:
        step.draw_fn = lambda *a: draws
    x, tg, v = (torch.from_numpy(a) for a in ref["batch"])
    net.train()
    total, _ = step.loss(step.forward(x), tg, v)
    grads = step.grads(total)
    opt.step(grads, ref["lr"])
    return float(total.detach()), as_tree(net, grads), \
        net.to_jax_params()[0]


def check_step(tag, make_net, ref, draws=None):
    """Hold one port step against the JAX step ``ref`` (see the module
    docstring); returns the port's update as one vector."""
    loss, grads, new = port_step(make_net, ref, draws=draws)
    assert leaf_paths(grads) == leaf_paths(ref["grads"])
    l_err = abs(loss - ref["loss"]) / ref["loss"]
    errs = {path: float(np.linalg.norm(a - b)
                        / max(np.linalg.norm(b), 1e-30))
            for path, a, b in zip(leaf_paths(grads), leaves(grads),
                                  leaves(ref["grads"]))}
    worst_path = max(errs, key=errs.get)
    worst, median = errs[worst_path], float(np.median(list(errs.values())))
    upd = [a - p for a, p in zip(leaves(new), leaves(ref["params"]))]
    want = [a - p for a, p in zip(leaves(ref["new"]), leaves(ref["params"]))]
    u_err = float(np.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(upd, want))
                          / sum((b ** 2).sum() for b in want)))
    print(f"{tag}: loss {l_err:.2e}; leaf gradients: median {median:.2e}, "
          f"worst {worst:.2e} ({worst_path}); update norm {u_err:.2e}")
    assert l_err <= LOSS_TOL
    assert median <= GRAD_MEDIAN_TOL
    assert worst <= GRAD_LEAF_TOL, worst_path
    assert u_err <= UPDATE_NORM_TOL
    return np.concatenate([u.ravel() for u in upd])


def _retina_net():
    return RetinaNet(num_classes=NC, image_size=SIZE)


@pytest.mark.parametrize("k", range(len(LRS)))
def test_sgd_steps_match_jax(k):
    ref = retina_reference()["steps"][k]
    check_step(f"retina step {k}", _retina_net, ref)


def test_trained_leaves_are_the_jax_tree():
    """The optimiser's tensors are the JAX tree's leaves one to one (the
    frozen-BN g/b/m/v and the tower biases among them), and training mode
    changes no norm's statistics."""
    ref = retina_reference()["steps"][0]
    net = _retina_net().from_jax_params(ref["params"])
    opt, step = make_family_train_step(net, _port_cfg(CONFIGS["sgd"]))
    n_leaves = len(jax.tree_util.tree_leaves(ref["params"]))
    assert len(opt.params) == n_leaves == len(list(net.parameters()))
    paths = leaf_paths(as_tree(net, opt.params))
    assert paths == leaf_paths(ref["params"])
    assert sum("['m']" in p or "['v']" in p for p in paths) == 2 * 53
    assert sum(re.search(r"tower'\]\[\d\]\['b'\]$", p) is not None
               for p in paths) == 8
    check_no_batch_statistics(net, step, ref["batch"])


def check_no_batch_statistics(net, step, batch):
    """The training forward equals the eval forward within 1e-5 of each
    output's largest value (no norm normalises with the batch; training
    mode adds the conv biases after the conv, as the reference does, where
    serving fuses them), and a step at lr 0 leaves every state_dict tensor
    as it was (no norm updates statistics)."""
    x = torch.from_numpy(batch[0])
    with torch.no_grad():
        net.eval()
        want = step.forward(x)
        net.train()
        got = step.forward(x)
    flat = lambda o: [t for t in jax.tree_util.tree_leaves(
        o, is_leaf=torch.is_tensor) if torch.is_tensor(t)]
    for a, b in zip(flat(got), flat(want), strict=True):
        assert torch.allclose(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    step(*(torch.from_numpy(a) for a in batch), 0.0)
    after = net.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_bf16_step_cosine():
    ref = retina_reference()["steps"][0]
    f32 = port_step(_retina_net, ref)
    bf16 = port_step(_retina_net, ref, dtype=torch.bfloat16)
    upd = [np.concatenate([(a - p).ravel() for a, p in zip(
        leaves(r[2]), leaves(ref["params"]))]) for r in (f32, bf16)]
    cos = float(upd[0] @ upd[1] / np.linalg.norm(upd[0])
                / np.linalg.norm(upd[1]))
    l_err = abs(bf16[0] - f32[0]) / f32[0]
    print(f"retina bf16: loss {l_err:.2e}, update cosine {cos:.5f}")
    assert cos >= BF16_COSINE and l_err <= 2e-2
