"""Training support of the frozen-norm families (RetinaNet, Faster R-CNN)
in the port, against the JAX package where it has a counterpart:

  * ``to_jax_params``: the JAX package's tree layout, and the round trip
    through ``from_jax_params`` exact both ways (tower conv biases, the
    box head's and FPN's conv biases, the fc's (H, W, C) flatten);
  * the frozen BatchNorm affine under mixed precision: in training mode
    gain and shift in bf16 with the statistics f32 (RetinaNet: the JAX
    package's ``amp_cast`` keeps ``m``/``v``), or all four in bf16 (Faster
    R-CNN, whose JAX loss casts every leaf), against the JAX package's
    ``_frozen_bn`` on the same cast leaves;
  * the affine cache: under autograd each call builds its own graph, and an
    update in place is seen by the next call;
  * the EMA and checkpoints: no statistics tree, the EMA over every
    parameter, the frozen statistics included.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import edgeml_tpu.models.faster_rcnn as jfr
from edgeml_tpu.models.resnet import _frozen_bn
from edgeml_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from edgeml_tpu.models.train import amp_cast
from edgeml_tpu_torch.models import train as ttrain
from edgeml_tpu_torch.models.common import FrozenBatchNorm2d
from edgeml_tpu_torch.models.faster_rcnn import FasterRCNN
from edgeml_tpu_torch.models.retinanet import RetinaNet
from test_torch_port_faster_rcnn import _spread as frcnn_spread
from test_torch_port_retinanet import _numpy_tree
from test_torch_port_retinanet import _spread as retina_spread

torch.set_num_threads(1)


def retina_params():
    rng = np.random.default_rng(3)
    p = retina_spread(JaxRetinaNet(num_classes=7, image_size=128).init(
        jax.random.PRNGKey(3)), rng)
    for tower in ("cls_tower", "reg_tower"):
        p[tower] = [dict(layer, b=jnp.asarray(rng.normal(0, 0.2, 256),
                                              jnp.float32))
                    for layer in p[tower]]
    return _numpy_tree(p)


def frcnn_params():
    return _numpy_tree(frcnn_spread(jfr.FasterRCNN(
        num_classes=7, image_size=128).init(jax.random.PRNGKey(4)),
        np.random.default_rng(4)))


FAMILIES = {
    "retinanet": (lambda: RetinaNet(num_classes=7, image_size=128),
                  retina_params),
    "faster_rcnn": (lambda: FasterRCNN(num_classes=7, image_size=128),
                    frcnn_params),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_to_jax_params_round_trip(family):
    make, params_fn = FAMILIES[family]
    want = params_fn()
    net = make().from_jax_params(want)
    got, stats = net.to_jax_params()
    assert stats is None
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == np.float32 and a.shape == np.shape(b)
        np.testing.assert_array_equal(a, np.asarray(b))
    again = make().from_jax_params(got)
    for (k, a), b in zip(net.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)  # the tower biases too (not in state_dict)


def _bn_case(seed, c=24):
    rng = np.random.default_rng(seed)
    p = {"g": rng.uniform(0.5, 1.5, c), "b": rng.normal(0, 0.3, c),
         "m": rng.normal(0, 0.5, c), "v": rng.uniform(0.3, 3.0, c)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(0, 2, (2, 5, 5, c)).astype(np.float32)
    bn = FrozenBatchNorm2d(c)
    with torch.no_grad():
        for name, key in (("weight", "g"), ("bias", "b"),
                          ("running_mean", "m"), ("running_var", "v")):
            getattr(bn, name).copy_(torch.from_numpy(p[key]))
    return p, x, bn


@pytest.mark.parametrize("cast_stats", [False, True])
def test_frozen_bn_amp_matches_jax(cast_stats):
    """bf16 training: RetinaNet's amp_cast keeps m/v f32; Faster R-CNN's
    loss casts every leaf (cast_stats). The affine is the f32 formula on
    those leaves; the output within 2 bf16 roundings (2^-7 of the largest)
    of the JAX package's ``_frozen_bn`` on the same leaves, whose XLA
    program may keep f32 between its bf16 ops. f32, training and eval: the
    f32 affine, 1e-6."""
    p, x, bn = _bn_case(int(cast_stats))
    bn.cast_stats = cast_stats
    bf = torch.bfloat16
    g, b, m, v = (torch.from_numpy(p[k]) for k in "gbmv")
    g, b = g.to(bf), b.to(bf)
    if cast_stats:
        m, v = m.to(bf), v.to(bf)
    scale = g * torch.rsqrt(v + bn.eps)
    bn.train()
    got_scale, got_shift = (t.detach()[:, 0, 0] for t in bn.affine(bf))
    assert got_scale.dtype == bf
    assert torch.equal(got_scale, scale.to(bf))
    assert torch.equal(got_shift, (b - m * scale).to(bf))

    jp = {k: jnp.asarray(a) for k, a in p.items()}
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp) \
        if cast_stats else amp_cast({"bn": jp}, jnp.bfloat16)["bn"]
    assert (jp["m"].dtype == jnp.bfloat16) == cast_stats
    want = np.asarray(_frozen_bn(jnp.asarray(x, jnp.bfloat16), jp).astype(
        jnp.float32))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = bn(xt.to(bf)).detach().float().permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())
    f32 = np.asarray(_frozen_bn(jnp.asarray(x), {k: jnp.asarray(a) for k, a
                                                 in p.items()}))
    for mode in (True, False):
        bn.train(mode)
        with torch.no_grad():
            got = bn(xt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, f32, rtol=0,
                                   atol=1e-6 * np.abs(f32).max())


def test_frozen_bn_no_graph_across_steps():
    """Training mode: each call differentiates its own affine, and sees an
    in-place update of the statistics (no cached tensor with a graph).
    Eval mode outside autograd: cached, and rebuilt after an update."""
    _, x, bn = _bn_case(5)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    bn.train()
    for _ in range(2):
        out = bn(xt).sum()
        g = torch.autograd.grad(out, [bn.weight, bn.running_mean,
                                      bn.running_var])
        assert all(torch.isfinite(t).all() and t.abs().sum() > 0 for t in g)
        with torch.no_grad():
            bn.running_mean.add_(0.5)
    assert not bn._affine
    bn.eval()
    with torch.no_grad():
        a = bn(xt)
        assert len(bn._affine) == 1
        bn.running_var.mul_(2.0)
        b = bn(xt)
    assert not torch.equal(a, b)
    scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    shift = bn.bias - bn.running_mean * scale
    assert torch.equal(b, xt * scale[:, None, None] + shift[:, None, None])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_ema_and_checkpoint(family, tmp_path):
    make, params_fn = FAMILIES[family]
    net = make().from_jax_params(params_fn())
    cfg = ttrain.TrainConfig()
    opt = ttrain.make_optimizer(cfg, net)
    ema = ttrain.ModelEMA(net)
    with torch.no_grad():
        for p in opt.params:
            p.add_(0.01)
    ema.update(net)
    bn = net.backbone.body.bn1
    shadow = ema.module.backbone.body.bn1
    assert not torch.equal(shadow.running_var, bn.running_var)
    assert not torch.equal(shadow.running_var, bn.running_var - 0.01)
    path = os.path.join(tmp_path, "ck.pth")
    ttrain.save_checkpoint(path, net, opt, cfg, 3, ema=ema)
    params, stats, opt_state, payload = ttrain.load_checkpoint(path)
    assert stats is None and payload["model"]["stats"] is None
    assert set(payload["ema"]) == {"params", "n_updates"}
    assert int(payload["ema"]["n_updates"]) == 1
    assert set(opt_state["trace"]) == {n for n, p in net.named_parameters()
                                       if p.requires_grad}
    back = ttrain.load_jax_tree(make(), params, stats)
    for a, b in zip(back.parameters(), net.parameters()):
        assert torch.equal(a, b)
    shadow_net = ttrain.load_jax_tree(make(), payload["ema"]["params"])
    for a, b in zip(shadow_net.parameters(), ema.module.parameters()):
        assert torch.equal(a, b)
