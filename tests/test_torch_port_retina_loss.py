"""The port's RetinaNet training loss against the JAX package's:
``retina_match`` (0.5 / 0.4 with low-quality matches), ``encode_boxes`` and
``retina_loss`` (sigmoid focal + smooth-L1, each over the foreground
count), batch 2, on seeded head outputs over the 3,069 anchors of a 128 px
image, 6 classes + background, 1-based labels as the engine passes them.

Tolerances: the matcher exact (its low-quality test is an ``iou ==
gt_best`` equality, so one rounding difference in the IoU would move a
match); encoded deltas 1e-6 of the largest; both loss parts and the total
within 1e-5 relative; the gradients with respect to the heads within 1e-5
of the largest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models import retinanet as jretina
from edgeml_tpu_torch.models import retinanet as tretina
from edgeml_tpu_torch.models.engine import _to_xyxy_px

torch.set_num_threads(1)

SIZE, NC = 128, 7  # 6 classes + background
A = 3069
REL = 1e-5


def retina_targets(seed, b=2, t=6):
    """Normalised [cls, x, y, w, h] rows (the last two of image 1 padding,
    one box small enough to be matched only through the low-quality rule,
    one pair of near-equal boxes) -> pixel xyxy boxes, 1-based classes and
    validity, as the engine converts them."""
    rng = np.random.default_rng(seed)
    tg = np.zeros((b, t, 5), np.float32)
    tg[..., 0] = rng.integers(0, NC - 1, (b, t))
    tg[..., 1:3] = rng.uniform(0.15, 0.85, (b, t, 2))
    tg[..., 3:5] = rng.uniform(0.1, 0.6, (b, t, 2))
    tg[:, 0, 3:5] = 0.06  # about 8 px: below every anchor's 0.4 IoU
    tg[:, 2, 1:5] = tg[:, 1, 1:5] * np.float32(1.02)
    valid = np.ones((b, t), bool)
    valid[1, -2:] = False
    boxes, cls = _to_xyxy_px(torch.from_numpy(tg), SIZE)
    return boxes.numpy(), cls.numpy(), valid


def head_outputs(seed, b=2):
    rng = np.random.default_rng(seed)
    cls = rng.normal(-3.0, 2.0, (b, A, NC)).astype(np.float32)
    reg = rng.normal(0, 0.4, (b, A, 4)).astype(np.float32)
    return cls, reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_retina_match_exact(seed):
    boxes, _, valid = retina_targets(seed)
    anchors = tretina.retina_anchors(SIZE)
    want = np.stack([np.asarray(jretina.retina_match(
        jnp.asarray(anchors), jnp.asarray(boxes[i]), jnp.asarray(valid[i])))
        for i in range(len(boxes))])
    got = tretina.retina_match(torch.from_numpy(anchors),
                               torch.from_numpy(boxes),
                               torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    for v in (-2, -1):
        assert (want == v).any()
    assert (want >= 0).sum() > 10
    # the low-quality rule matches anchors below 0.5 IoU in each image:
    # the small box's best anchors
    iou = np.asarray(jax.vmap(lambda b: jretina.box_iou_safe(
        b, jnp.asarray(anchors)))(jnp.asarray(boxes)))
    iou = np.where(valid[:, :, None], iou, -1.0)
    assert (iou[:, 0].max(1) < 0.4).all()
    assert ((want >= 0) & (iou.max(1) < 0.5)).any(1).all()
    # the RPN's thresholds (0.7 / 0.3), as rcnn_loss uses the matcher
    want = np.stack([np.asarray(jretina.retina_match(
        jnp.asarray(anchors), jnp.asarray(boxes[i]), jnp.asarray(valid[i]),
        hi=0.7, lo=0.3)) for i in range(len(boxes))])
    got = tretina.retina_match(torch.from_numpy(anchors),
                               torch.from_numpy(boxes),
                               torch.from_numpy(valid), hi=0.7,
                               lo=0.3).numpy()
    np.testing.assert_array_equal(got, want)


def test_encode_boxes_matches_jax():
    boxes, _, _ = retina_targets(3)
    anchors = tretina.retina_anchors(SIZE)
    idx = np.random.default_rng(3).integers(0, 6, (2, A))
    gt = np.take_along_axis(boxes, idx[..., None], 1)
    gt[0, :5] = [10, 10, 10, 30]  # zero width: the 1e-6 floor
    want = np.asarray(jretina.RetinaNet.encode_boxes(jnp.asarray(gt),
                                                     jnp.asarray(anchors)))
    got = tretina.RetinaNet.encode_boxes(torch.from_numpy(gt),
                                         torch.from_numpy(anchors)).numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(),
                               rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_retina_loss_matches_jax(seed):
    boxes, cls, valid = retina_targets(seed)
    cl, rg = head_outputs(seed + 10)
    anchors = tretina.retina_anchors(SIZE)
    jnet = jretina.RetinaNet(num_classes=NC, image_size=SIZE)

    def lf(c, r):
        return jretina.retina_loss(jnet, c, r, jnp.asarray(anchors),
                                   jnp.asarray(boxes), jnp.asarray(cls),
                                   jnp.asarray(valid))

    (want, wparts), (wgc, wgr) = jax.jit(jax.value_and_grad(
        lf, argnums=(0, 1), has_aux=True))(jnp.asarray(cl), jnp.asarray(rg))
    net = tretina.RetinaNet(num_classes=NC, image_size=SIZE)
    tc = torch.from_numpy(cl).requires_grad_(True)
    tr = torch.from_numpy(rg).requires_grad_(True)
    total, parts = tretina.retina_loss(
        net, tc, tr, torch.from_numpy(anchors), torch.from_numpy(boxes),
        torch.from_numpy(cls), torch.from_numpy(valid))
    gc, gr = torch.autograd.grad(total, (tc, tr))
    assert set(parts) == set(wparts) == {"classification",
                                         "bbox_regression"}
    for k in parts:
        w = float(wparts[k])
        assert w > 0.01
        assert abs(float(parts[k].detach()) - w) <= REL * w, k
    assert abs(float(total.detach()) - float(want)) <= REL * float(want)
    for g, w in ((gc, wgc), (gr, wgr)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=REL * np.abs(w).max(),
                                   rtol=0)
