"""The port's RetinaNet-ResNet50-FPN-v2 against the JAX package's.

Small sizes: image_size 128 (P3..P7 at 16/8/4/2/1, 3,069 anchors — above
RETINA_PRE = 2048, so the raw-logit tail runs), 7 classes, carried weights
(``from_jax_params``) with the frozen BatchNorm statistics and affine,
GroupNorm affine and head biases spread from a seed.

Tolerances and why:
  * anchors: none — the same NumPy code.
  * FPN levels and head outputs (cls logits, box deltas), f32: 1e-4
    relative to each output's largest magnitude. XLA's and PyTorch's CPU
    convolutions sum in different orders through 50+ layers; they agree to
    ~1e-5 relative here.
  * ``retina_postprocess`` on seeded head outputs, f32 and bf16 logits:
    the same rows, class ids equal, conf within 1e-5, boxes within 1e-4 px.
    Sigmoid and exp may differ in the last bit between the frameworks; the
    seed puts the scores on a grid 4e-5 apart (in bf16, distinct values are
    far apart and equal ones tie to the lower index on both sides), and the
    decoded boxes are checked to be equal, or their same-class IoUs to lie
    more than 1e-6 from the threshold, so no decision can flip.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from edgeml_tpu.models.retinanet import retina_anchors as jax_retina_anchors
from edgeml_tpu.models.retinanet import \
    retina_postprocess as jax_retina_postprocess
from edgeml_tpu_torch.models.retinanet import (
    RETINA_PRE, RetinaNet, retina_anchors, retina_postprocess,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, NC = 128, 7
A = 3069  # (16^2 + 8^2 + 4^2 + 2^2 + 1) * 9


def _numpy_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), t)


def _spread(params, rng):
    """Random frozen-BN statistics/affines, GroupNorm affines and head
    biases (tower conv biases stay zero: torchvision has none there)."""

    def bn(p):
        c = p["g"].shape
        return dict(p, g=rng.uniform(0.5, 1.5, c), b=rng.normal(0, 0.1, c),
                    m=rng.normal(0, 0.1, c), v=rng.uniform(0.5, 2.0, c))

    bb = dict(params["backbone"])
    bb["stem"] = bn(bb["stem"])
    bb["stages"] = [[{k: bn(v) for k, v in blk.items()} for blk in stage]
                    for stage in bb["stages"]]
    out = dict(params, backbone=bb)
    for tower in ("cls_tower", "reg_tower"):
        out[tower] = [dict(layer, gn={
            "g": rng.uniform(0.5, 1.5, 256), "b": rng.normal(0, 0.1, 256)})
            for layer in params[tower]]
    for key in ("cls_out", "reg_out"):
        b = np.asarray(params[key]["b"])
        out[key] = dict(params[key], b=b + rng.normal(0, 0.5, b.shape))
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), out)


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(5)
    jnet = JaxRetinaNet(num_classes=NC, image_size=SIZE)
    params = _spread(jnet.init(jax.random.PRNGKey(5)), rng)
    net = RetinaNet(num_classes=NC, image_size=SIZE)
    net.from_jax_params(_numpy_tree(params))
    x = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    feats = jax.jit(jnet.backbone.apply)(params["backbone"], jnp.asarray(x))
    cls, reg = jax.jit(jnet.apply)(params, jnp.asarray(x))
    return dict(jnet=jnet, params=params, net=net, x=x,
                feats=[np.asarray(f) for f in feats], cls=np.asarray(cls),
                reg=np.asarray(reg))


def _close(got, want, rel):
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def test_anchors_match_jax():
    for size in (640, SIZE):
        np.testing.assert_array_equal(retina_anchors(size),
                                      jax_retina_anchors(size))
    assert retina_anchors(640).shape == (76725, 4)
    assert retina_anchors(SIZE).shape == (A, 4)


def test_fpn_matches_jax(model):
    """ResNet50 (frozen BN) + FPN + P6/P7, f32: all five levels."""
    with torch.no_grad():
        feats = model["net"].backbone(
            torch.from_numpy(model["x"]).permute(0, 3, 1, 2))
    assert [tuple(f.shape[2:]) for f in feats] == [(16, 16), (8, 8), (4, 4),
                                                   (2, 2), (1, 1)]
    for got, want in zip(feats, model["feats"]):
        _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-4)


def test_heads_match_jax(model):
    with torch.no_grad():
        c, r = model["net"](torch.from_numpy(model["x"]))
    assert c.shape == (2, A, NC) and r.shape == (2, A, 4)
    assert np.std(model["cls"]) > 0.3 and np.std(model["reg"]) > 0.1
    _close(c.numpy(), model["cls"], 1e-4)
    _close(r.numpy(), model["reg"], 1e-4)


def _iou_gap(boxes, thr):
    """Smallest |iou - thr| over all pairs of each image's boxes."""
    gap = np.inf
    for b in boxes.astype(np.float64):
        lo = np.maximum(b[:, None, :2], b[None, :, :2])
        hi = np.minimum(b[:, None, 2:], b[None, :, 2:])
        inter = np.prod(np.clip(hi - lo, 0, None), -1)
        area = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
        iou = inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-12)
        gap = min(gap, np.abs(iou[np.triu_indices(len(b), 1)] - thr).min())
    return gap


@pytest.mark.parametrize("bf16", [False, True])
def test_retina_postprocess_matches_jax(bf16):
    """Seeded head outputs (B = 2, 3,069 anchors, 7 classes) through the raw
    tail: the top 2048 boxes, K = 2048 real candidates, same rows as JAX."""
    rng = np.random.default_rng(21)
    b = 2
    grid = np.linspace(0.06, 0.95, A * NC)
    probs = np.stack([rng.permutation(grid).reshape(A, NC)
                      for _ in range(b)])
    logits = np.log(probs / (1 - probs)).astype(np.float32)
    reg = np.concatenate([rng.normal(0, 0.3, (b, A, 2)),
                          rng.normal(-1.0, 0.3, (b, A, 2))], -1
                         ).astype(np.float32)
    anchors = retina_anchors(SIZE)
    thr = 0.5
    jnet = JaxRetinaNet(num_classes=NC, image_size=SIZE)
    if bf16:
        jl = jnp.asarray(logits, jnp.bfloat16)
        tl = torch.from_numpy(logits).to(torch.bfloat16)
    else:
        jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    d_ref, v_ref = jax_retina_postprocess(
        jnet, jl, jnp.asarray(reg), jnp.asarray(anchors), score_thresh=0.05,
        nms_thresh=thr)
    d_ref, v_ref = np.asarray(d_ref), np.asarray(v_ref)
    net = RetinaNet(num_classes=NC, image_size=SIZE)
    d, v = retina_postprocess(net, tl, torch.from_numpy(reg),
                              torch.from_numpy(anchors), score_thresh=0.05,
                              nms_thresh=thr)
    d, v = d.numpy(), v.numpy()
    want_boxes = np.asarray(jnp.clip(
        jnet.decode_boxes(jnp.asarray(reg), jnp.asarray(anchors)), 0, SIZE))
    got_boxes = torch.clamp(net.decode_boxes(
        torch.from_numpy(reg), torch.from_numpy(anchors)), 0, SIZE).numpy()
    if not np.array_equal(got_boxes, want_boxes):
        np.testing.assert_allclose(got_boxes, want_boxes, atol=1e-4, rtol=0)
        assert _iou_gap(want_boxes, thr) > 1e-6
    assert RETINA_PRE == 2048 and A > RETINA_PRE
    assert v_ref.sum(1).min() > 100
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(d[..., 5], d_ref[..., 5])
    np.testing.assert_allclose(d[..., 4], d_ref[..., 4], atol=1e-5, rtol=0)
    np.testing.assert_allclose(d[..., :4], d_ref[..., :4], atol=1e-4, rtol=0)


def test_state_dict_layout_is_torchvision():
    """Keys and shapes equal torchvision's retinanet_resnet50_fpn_v2 (91
    classes), in order; a state_dict of zeros in that layout loads strictly,
    and through the CLI's loader so does one without BatchNorm counters
    (torchvision's FrozenBatchNorm2d has none)."""
    from edgeml_tpu_torch.cli.detect import load_torchvision_state_dict

    path = os.path.join(REPO, "tests/fixtures/manifests/retinanet.json")
    with open(path) as f:
        manifest = [(k, tuple(s)) for k, s in json.load(f)]
    net = RetinaNet(num_classes=91)
    got = [(k, tuple(v.shape)) for k, v in net.state_dict().items()]
    assert got == manifest
    zeros = {k: torch.zeros(s, dtype=torch.long if k.endswith(
        "num_batches_tracked") else torch.float32) for k, s in manifest}
    net.load_state_dict(zeros, strict=True)
    assert all(float(v.abs().sum()) == 0 for v in net.state_dict().values())
    frozen = {k: v + 1 for k, v in zeros.items()
              if not k.endswith("num_batches_tracked")}
    load_torchvision_state_dict(net, frozen)
    assert float(net.backbone.body.bn1.running_var[0]) == 1.0


def test_from_jax_params_refuses_tower_bias(model):
    params = dict(model["params"])
    tower = [dict(layer) for layer in params["cls_tower"]]
    tower[2]["b"] = jnp.full((256,), 0.1)
    params["cls_tower"] = tower
    with pytest.raises(ValueError, match="bias"):
        RetinaNet(num_classes=NC, image_size=SIZE).from_jax_params(
            _numpy_tree(params))
