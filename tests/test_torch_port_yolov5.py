"""The port's YoloV5 against the JAX package's, on carried weights.

Tolerances and why:
  * f32 predict: obj and cls within 1e-4 (sigmoid space), xywh within
    1e-3 px + 1e-5 relative. The two conv stacks sum in different orders
    (XLA's and PyTorch's CPU convolutions), so outputs agree to float
    rounding, not bit for bit; a box side is up to 4 x anchor (~1500 px) and
    moves ~450 px per unit of head logit, so logit rounding of ~4e-6 shows
    as ~2e-3 px on the largest boxes.
  * ultralytics import: raw heads within 1e-5 of the torch oracle — the same
    PyTorch convolutions on the same weights; only the BatchNorm formula is
    evaluated in another order.
  * bf16 predict against f32 on the same module: scores within 0.1 (sigmoid
    space); box coordinates within 0.5 px at the median, 2 px at the 90th
    percentile and 64 px at most (a large-anchor box side moves ~450 px per
    logit unit, and this small calibrated net amplifies rounding). bf16 keeps 8
    mantissa bits through ~60 layers and has no exactness contract.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from edgeml_tpu_torch.models.yolov5 import DEFAULT_ANCHORS, YoloV5

torch.set_num_threads(1)


def _numpy_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), t)


def carried(seed, calib, variant="n", nc=8, size=64):
    """JAX net.init(PRNGKey(seed)) -> from_jax_params, with BatchNorm stats
    calibrated on ``calib`` plus seeded noise images (the reference's
    calibrate_bn; at 64 px the deepest stages see 2x2 maps, so the stats only
    fit the batch they were taken on and the tests run on that batch) and detect biases spread from
    the seed, so every layer carries signal and the scores spread instead of
    sitting at their bias constants."""
    from edgeml_tpu.models.yolov5 import calibrate_bn

    jnet = JaxYoloV5(variant=variant, num_classes=nc, img_size=size)
    params, stats = jnet.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    extra = rng.random((8,) + calib.shape[1:]).astype(np.float32)
    batch = jnp.asarray(np.concatenate([calib, extra]))
    stats = calibrate_bn(jnet, params, stats, lambda i: batch, iters=1)
    params = dict(params)
    params["detect"] = [
        {"w": d["w"], "b": jnp.asarray(
            np.asarray(d["b"]) + rng.normal(0, 1.0, d["b"].shape),
            jnp.float32)}
        for d in params["detect"]
    ]
    net = YoloV5(variant=variant, num_classes=nc, img_size=size)
    net.from_jax_params(_numpy_tree(params), _numpy_tree(stats))
    return jnet, params, stats, net


def test_predict_f32_matches_jax():
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    jnet, params, stats, net = carried(0, x)
    jo, jx, jc = (np.asarray(a) for a in
                  jnet.predict(params, stats, jnp.asarray(x)))
    to, tx, tc = (a.numpy() for a in net.predict(torch.from_numpy(x)))
    n = (8 * 8 + 4 * 4 + 2 * 2) * 3
    assert to.shape == jo.shape == (2, n)
    assert tx.shape == jx.shape == (2, n, 4) and tx.dtype == np.float32
    assert tc.shape == jc.shape == (2, n, 8)
    np.testing.assert_allclose(to, jo, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tc, jc, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tx, jx, atol=1e-3, rtol=1e-5)
    # the carried weights make a real workload: scores spread, not constant
    assert np.std(jo) > 0.05


def test_predict_rows_follow_level_h_w_anchor_order():
    """Row r of level 0 is cell (r // 3 // W, r // 3 % W), anchor r % 3:
    with zero-input heads the decoded centre is the cell centre."""
    net = YoloV5(variant="n", num_classes=8, img_size=64,
                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for conv in net.model[24].m:
            conv.weight.zero_()
            conv.bias.zero_()
    _, xywh, _ = net.predict(torch.zeros(1, 64, 64, 3))
    xy = xywh[0, :8 * 8 * 3, :2].reshape(8, 8, 3, 2)
    cy, cx = torch.meshgrid(torch.arange(8.0), torch.arange(8.0),
                            indexing="ij")
    want = (torch.stack([cx, cy], -1)[:, :, None, :] + 0.5) * 8
    torch.testing.assert_close(xy, want.expand(8, 8, 3, 2), rtol=0, atol=0)
    wh = xywh[0, :3, 2:]
    torch.testing.assert_close(
        wh, torch.tensor(DEFAULT_ANCHORS[0], dtype=torch.float32),
        rtol=0, atol=0)


def test_predict_bf16_close_to_f32():
    xn = np.random.default_rng(2).random((2, 64, 64, 3)).astype(np.float32)
    _, _, _, net = carried(3, xn)
    x = torch.from_numpy(xn)
    o32, x32, c32 = net.predict(x)
    o16, x16, c16 = net.predict(x, dtype=torch.bfloat16)
    assert o16.dtype == c16.dtype == torch.bfloat16
    assert x16.dtype == torch.float32  # box geometry stays f32
    assert (o16.float() - o32).abs().max() < 0.1
    assert (c16.float() - c32).abs().max() < 0.1
    box_err = (x16 - x32).abs().flatten()
    assert torch.quantile(box_err, 0.5) < 0.5
    assert torch.quantile(box_err, 0.9) < 2.0
    assert box_err.max() < 64.0
    # the cast copies are cached and follow in-place weight changes
    with torch.no_grad():
        net.model[0].bn.bias.add_(1.0)
    o16b, _, _ = net.predict(x, dtype=torch.bfloat16)
    assert not torch.equal(o16b, o16)


def test_seeded_init_is_reproducible():
    a = YoloV5(generator=torch.Generator().manual_seed(5), num_classes=8,
               img_size=64)
    b = YoloV5(generator=torch.Generator().manual_seed(5), num_classes=8,
               img_size=64)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def _oracle():
    """tests/test_torch_parity.py's ultralytics-layout torch YOLOv5 oracle
    with random weights and BatchNorm stats (imported, not copied)."""
    import torch.nn as nn
    from test_torch_parity import _TorchYoloV5, _randomize_bn_stats

    spec = JaxYoloV5(variant="n", num_classes=8, img_size=64)
    tm = _TorchYoloV5(spec).eval()
    g = torch.Generator().manual_seed(5)
    _randomize_bn_stats(tm, g)
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.05)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    return tm, g


def test_ultralytics_import_matches_oracle_heads():
    tm, g = _oracle()
    net = YoloV5(variant="n", num_classes=8, img_size=64)
    net.load_ultralytics_state_dict(tm.state_dict())
    x = torch.rand(2, 3, 64, 64, generator=g)
    with torch.no_grad():
        ref = tm(x)
        got = net.raw_heads(x.permute(0, 2, 3, 1))
    for ours, theirs in zip(got, ref):
        b, _, hh, ww = theirs.shape
        r = theirs.reshape(b, 3, 13, hh, ww).permute(0, 3, 4, 1, 2)
        torch.testing.assert_close(ours, r, atol=1e-5, rtol=0)


def test_ultralytics_import_rescales_anchors():
    tm, _ = _oracle()
    sd = tm.state_dict()
    # a checkpoint with its own anchors (grid units), keys without "model."
    sd = {k.replace("model.", "", 1): v for k, v in sd.items()}
    sd["24.anchors"] = sd["24.anchors"] * 2.0
    net = YoloV5(variant="n", num_classes=8, img_size=64)
    net.load_ultralytics_state_dict(sd)
    got = np.asarray(net.anchors, np.float32)
    np.testing.assert_allclose(got, 2.0 * np.asarray(DEFAULT_ANCHORS,
                                                      np.float32), rtol=1e-6)


def test_ultralytics_import_rejects_wrong_shape():
    tm, _ = _oracle()
    sd = dict(tm.state_dict())
    sd["model.0.conv.weight"] = torch.zeros(1, 1, 1, 1)
    with pytest.raises(ValueError, match="model.0.conv.weight"):
        YoloV5(variant="n", num_classes=8, img_size=64) \
            .load_ultralytics_state_dict(sd)
