"""``calibrate_bn`` on the port's YoloV5 against the JAX package's on the
same carried weights and batches, at ``iters`` 1 (one batch's exact
statistics) and 3 (three batches pooled in (E[x], E[x^2])), on the CPU.

Tolerance: each BatchNorm's calibrated mean and variance within 1e-4 of
that tree's largest value, all leaves at once (measured below 1e-5). The
two trunks agree to float rounding, and inverting the momentum update
(``old + (new - old) / 0.03``) scales the rounding of ``new`` by 33.
Beyond JAX: the net's mode and weights come back as they were, and the
statistics at ``iters`` 1 are the batch's own, the pre-norm activations'
mean and unbiased variance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from edgeml_tpu.models.yolov5 import calibrate_bn as jax_calibrate_bn
from edgeml_tpu_torch.models.common import ConvBN
from edgeml_tpu_torch.models.yolov5 import YoloV5, calibrate_bn

torch.set_num_threads(1)

SIZE, NC = 64, 8
TOL = 1e-4


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def nets():
    jnet = JaxYoloV5(variant="n", num_classes=NC, img_size=SIZE)
    params, stats = jnet.init(jax.random.PRNGKey(4))
    host = jax.tree_util.tree_map(np.asarray, (params, stats))
    rng = np.random.default_rng(4)
    batches = [rng.random((4, SIZE, SIZE, 3)).astype(np.float32)
               for _ in range(3)]
    return jnet, params, stats, host, batches


@pytest.mark.parametrize("iters", [1, 3])
def test_calibrate_bn_matches_jax(nets, iters):
    jnet, params, stats, host, batches = nets
    want = jax_calibrate_bn(jnet, params, stats,
                            lambda i: jnp.asarray(batches[i]), iters=iters)
    net = YoloV5(variant="n", num_classes=NC, img_size=SIZE)
    net.from_jax_params(*host)
    net.eval()
    before = {k: v.clone() for k, v in net.state_dict().items()
              if not k.endswith(("running_mean", "running_var"))}
    calibrate_bn(net, lambda i: torch.from_numpy(batches[i]), iters=iters)
    assert not net.training
    for k, v in before.items():  # only the statistics moved
        assert torch.equal(net.state_dict()[k], v), k
    got = _leaves(net.to_jax_params()[1])
    ref = _leaves(want)
    assert len(got) == len(ref) > 100
    scale = max(float(np.abs(r).max()) for r in ref)
    err = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
    assert err <= TOL * scale, (err, scale)
    # calibration moved the statistics far from the init's (0, 1)
    assert max(float(np.abs(g).max()) for g in got[::2]) > 0.1


def test_single_batch_is_the_batch_statistics(nets):
    *_, host, batches = nets
    net = YoloV5(variant="n", num_classes=NC, img_size=SIZE)
    net.from_jax_params(*host)
    want = {}

    def take(mod, args, out):
        y = torch.nn.functional.conv2d(args[0], mod.conv.weight, None,
                                       mod.conv.stride, mod.conv.padding)
        want[mod] = (y.mean(dim=(0, 2, 3)), y.var(dim=(0, 2, 3)))

    x = torch.from_numpy(batches[0])
    mods = [m for m in net.modules() if isinstance(m, ConvBN)]
    hooks = [m.register_forward_hook(take) for m in mods]
    with torch.no_grad():
        net.train()
        net.train_forward(x)  # the hooks read the same train-mode pass
    for h in hooks:
        h.remove()
    net.from_jax_params(*host)  # undo that pass's statistics update
    calibrate_bn(net, lambda i: x, iters=1)
    for m in mods:
        mean, var = want[m]
        scale = float(var.abs().max())
        assert float((m.bn.running_mean - mean).abs().max()) <= TOL * max(
            float(mean.abs().max()), 1.0)
        assert float((m.bn.running_var - var).abs().max()) <= TOL * scale
