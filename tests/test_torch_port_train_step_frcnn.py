"""The port's Faster R-CNN training step against the JAX package's: two SGD
steps of Faster R-CNN-ResNet50-FPN-v2 (6 classes + background, 128 px,
``rpn_post_nms`` 64, batch 2, full width), the weights carried from the
JAX init with the frozen BatchNorm statistics and every bias spread from a
seed (``test_torch_port_faster_rcnn._spread``), each step's sampling draws
the JAX package's own (``test_torch_port_rcnn_loss.jax_draws``).

Held as ``test_torch_port_train_step_retina.py`` holds RetinaNet's step:
each step from the JAX package's state before it, the loss 1e-5 relative,
each leaf's gradient (the frozen-BN g/b/m/v, and the FPN's and box head's
conv biases, which the port keeps in identity norms) and the whole update
at that file's fixed limits.

Measured on the CPU, both packages f32: loss 8.0e-8 and 0; leaf gradients
median 2.3e-6 and 1.3e-5, worst 1.3e-5 and 9.8e-5 (the first box-head
conv); the update 4.5e-6 and 5.0e-6.

Then the trained leaf set (the optimiser holds exactly the JAX tree's
leaves; the identity norms' weights and statistics are not trained and do
not move; no norm takes batch statistics) and one bf16 step's cosine with
the f32 step (loss 4.0e-3, cosine 0.99991 measured).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edgeml_tpu.models.faster_rcnn as jfr
from edgeml_tpu.models import engine as jengine
from edgeml_tpu.models.rcnn_loss import faster_rcnn_loss
from edgeml_tpu_torch.models.engine import make_family_train_step
from edgeml_tpu_torch.models.faster_rcnn import FasterRCNN
from test_torch_port_faster_rcnn import _spread
from test_torch_port_rcnn_loss import N_ANCHORS, jax_draws
from test_torch_port_train_step import CONFIGS, _port_cfg
from test_torch_port_train_step_retina import (
    BF16_COSINE, as_tree, check_no_batch_statistics, check_step,
    jax_reference, leaf_paths, leaves, port_step,
)

torch.set_num_threads(1)

SIZE, NC, POST, T = 128, 7, 64, 5
KEYS = [jax.random.PRNGKey(100 + k) for k in range(2)]
_REF = {}


def frcnn_reference():
    if _REF:
        return _REF
    jnet = jfr.FasterRCNN(num_classes=NC, image_size=SIZE, rpn_post_nms=POST)
    params = _spread(jnet.init(jax.random.PRNGKey(9)),
                     np.random.default_rng(9))
    anchors = [jnp.asarray(a) for a in jfr.rpn_anchors(SIZE)]

    @jax.jit
    def grad_fn(p, x, tg, v, key):
        def lf(p):
            boxes, cls = jengine._to_xyxy_px(tg, SIZE)
            return faster_rcnn_loss(jnet, key, p, x, anchors, boxes, cls,
                                    v)[0]

        return jax.value_and_grad(lf)(p)

    _REF["steps"] = jax_reference(grad_fn, params, KEYS)
    return _REF


def _frcnn_net():
    return FasterRCNN(num_classes=NC, image_size=SIZE, rpn_post_nms=POST)


def _draws(k):
    return jax_draws(KEYS[k], 2, N_ANCHORS, POST + T)


@pytest.mark.parametrize("k", range(2))
def test_sgd_steps_match_jax(k):
    ref = frcnn_reference()["steps"][k]
    check_step(f"faster_rcnn step {k}", _frcnn_net, ref, draws=_draws(k))


def test_trained_leaves_are_the_jax_tree():
    ref = frcnn_reference()["steps"][0]
    net = _frcnn_net().from_jax_params(ref["params"])
    opt, step = make_family_train_step(net, _port_cfg(CONFIGS["sgd"]))
    step.draw_fn = lambda *a: _draws(0)
    n_leaves = len(jax.tree_util.tree_leaves(ref["params"]))
    identity = [m[1] for m in net.modules()
                if getattr(m, "frozen", False)]
    assert len(identity) == 8 + 4  # the FPN's and the box head's
    assert len(opt.params) == n_leaves \
        == len(list(net.parameters())) - len(identity)
    assert not any(bn.weight.requires_grad for bn in identity)
    paths = leaf_paths(as_tree(net, opt.params))
    assert paths == leaf_paths(ref["params"])
    assert sum("['m']" in p or "['v']" in p for p in paths) == 2 * 53
    assert sum(re.search(r"(fpn_\w+|convs)'\]\[\d\]\['b'\]$", p) is not None
               for p in paths) == 12
    check_no_batch_statistics(net, step, ref["batch"])


def test_bf16_step_cosine():
    ref = frcnn_reference()["steps"][0]
    runs = [port_step(_frcnn_net, ref, dtype=dt, draws=_draws(0))
            for dt in (None, torch.bfloat16)]
    upd = [np.concatenate([(a - p).ravel() for a, p in zip(
        leaves(r[2]), leaves(ref["params"]))]) for r in runs]
    cos = float(upd[0] @ upd[1] / np.linalg.norm(upd[0])
                / np.linalg.norm(upd[1]))
    l_err = abs(runs[1][0] - runs[0][0]) / runs[0][0]
    print(f"faster_rcnn bf16: loss {l_err:.2e}, update cosine {cos:.5f}")
    assert cos >= BF16_COSINE and l_err <= 2e-2
