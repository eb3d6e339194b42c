"""The port's training losses against the JAX package's: ``yolo_loss``
(YOLOv5n, 4 classes, 64 px: heads of 8x8, 4x4 and 2x2 cells), the SSD
matcher ``match_anchors`` and ``ssd_loss`` (SSDLite at 64 px: 144 default
boxes, 9 classes with background), batch 2, on seeded inputs.

Tolerances: the losses and each part within 1e-5 relative; gradients with
respect to the heads within 1e-5 of the largest; the matcher, the
objectness scatter's duplicate cells and the hard-negative ranks exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models import loss as jloss
from edgeml_tpu.models import ssd_loss as jssd
from edgeml_tpu.models.ssdlite import SSDLite as JaxSSDLite, default_boxes
from edgeml_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from edgeml_tpu_torch.models import loss as tloss
from edgeml_tpu_torch.models import ssd_loss as tssd
from edgeml_tpu_torch.models.ssdlite import SSDLite
from edgeml_tpu_torch.models.yolov5 import YoloV5

torch.set_num_threads(1)

REL = 1e-5


def yolo_inputs(seed, b=2, t=6, nc=4):
    """Heads for 64 px and targets with two rows sharing their cells (the
    scatter's duplicates) and padding rows."""
    rng = np.random.default_rng(seed)
    heads = [rng.normal(0, 1.5, (b, g, g, 3, nc + 5)).astype(np.float32)
             for g in (8, 4, 2)]
    tg = np.zeros((b, t, 5), np.float32)
    tg[..., 0] = rng.integers(0, nc, (b, t))
    tg[..., 1:3] = rng.uniform(0.1, 0.9, (b, t, 2))
    tg[..., 3:5] = rng.uniform(0.05, 0.6, (b, t, 2))
    tg[:, 1, 1:3] = tg[:, 0, 1:3] + 0.001  # the same cells as row 0
    tg[:, 1, 3:5] = tg[:, 0, 3:5] * 1.1
    valid = np.ones((b, t), bool)
    valid[:, -2:] = False
    return heads, tg, valid


@pytest.fixture(scope="module")
def yolo_ref():
    jnet = JaxYoloV5(variant="n", num_classes=4, img_size=64)
    heads, tg, valid = yolo_inputs(0)

    def total(h, t, v):
        return jloss.yolo_loss(jnet, h, t, v)

    vg = jax.jit(jax.value_and_grad(total, has_aux=True))
    (tot, parts), grads = vg([jnp.asarray(h) for h in heads],
                             jnp.asarray(tg), jnp.asarray(valid))
    return dict(heads=heads, tg=tg, valid=valid, total=float(tot),
                parts={k: float(v) for k, v in parts.items()},
                grads=[np.asarray(g) for g in grads])


def test_yolo_loss_and_gradient_match_jax(yolo_ref):
    net = YoloV5("n", 4, 64)
    heads = [torch.tensor(h, requires_grad=True) for h in yolo_ref["heads"]]
    tot, parts = tloss.yolo_loss(net, heads, torch.from_numpy(yolo_ref["tg"]),
                                 torch.from_numpy(yolo_ref["valid"]))
    assert abs(float(tot.detach()) - yolo_ref["total"]) \
        <= REL * abs(yolo_ref["total"])
    for k, v in yolo_ref["parts"].items():
        assert v > 0 and abs(float(parts[k].detach()) - v) <= REL * abs(v), k
    grads = torch.autograd.grad(tot, heads)
    big = max(np.abs(g).max() for g in yolo_ref["grads"])
    for got, want in zip(grads, yolo_ref["grads"]):
        assert float(np.abs(got.numpy() - want).max()) <= REL * big


def test_yolo_objectness_scatter_takes_the_max_on_duplicate_cells():
    """Two candidates on one (image, cell, anchor): the target is the larger
    IoU, whatever their order; the JAX package's loss agrees."""
    net = YoloV5("n", 4, 64)
    heads, tg, valid = yolo_inputs(1, t=2)
    valid[:] = True
    tg[:, 1] = tg[:, 0]
    tg[:, 1, 3:5] *= 1.2  # the same cells and anchors, another IoU
    tg_swapped = tg[:, ::-1].copy()
    th = [torch.from_numpy(h) for h in heads]
    a = tloss.yolo_loss(net, th, torch.from_numpy(tg),
                        torch.from_numpy(valid))[1]["obj"]
    b = tloss.yolo_loss(net, th, torch.from_numpy(tg_swapped),
                        torch.from_numpy(valid))[1]["obj"]
    assert float(a) == float(b)
    jnet = JaxYoloV5(variant="n", num_classes=4, img_size=64)
    j = jloss.yolo_loss(jnet, [jnp.asarray(h) for h in heads],
                        jnp.asarray(tg), jnp.asarray(valid))[1]["obj"]
    assert abs(float(a) - float(j)) <= REL * abs(float(j))
    # one row alone scores another objectness: the duplicates did meet
    c = tloss.yolo_loss(net, th, torch.from_numpy(tg[:, :1]),
                        torch.from_numpy(valid[:, :1]))[1]["obj"]
    assert float(c) != float(a)


def test_bce_and_ciou_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 4, 1000).astype(np.float32)
    y = rng.random(1000).astype(np.float32)
    np.testing.assert_allclose(
        tloss.bce_logits(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jloss._bce(jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-6, atol=1e-7)
    b1 = np.concatenate([rng.uniform(0, 8, (500, 2)),
                         rng.uniform(0.1, 4, (500, 2))], 1).astype(np.float32)
    b2 = np.concatenate([b1[:, :2] + rng.normal(0, 0.5, (500, 2)),
                         rng.uniform(0.1, 4, (500, 2))], 1).astype(np.float32)
    np.testing.assert_allclose(
        tloss.ciou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy(),
        np.asarray(jloss._ciou(jnp.asarray(b1), jnp.asarray(b2))),
        rtol=0, atol=2e-6)


# ---- SSD ---------------------------------------------------------------

ANCHORS = default_boxes(64, (4, 2, 1, 1, 1, 1))  # (144, 4)


def match_cases():
    """GT boxes (B=3, M=5, xyxy px) and validity covering the traps: two
    valid GTs whose best anchor is the same; a valid GT whose best anchor is
    anchor 0, with padding (best anchor 0 too) after it; a GT equally close
    to two anchors; an image with no valid GT."""
    rng = np.random.default_rng(3)
    gt = np.zeros((3, 5, 4), np.float32)
    valid = np.zeros((3, 5), bool)
    a = ANCHORS
    gt[0, 0] = a[40] + np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    gt[0, 1] = a[40] + np.array([-0.5, -0.5, -0.5, -0.5], np.float32)
    gt[0, 2] = np.array([2, 2, 5, 5], np.float32)  # best anchor 0, IoU < .5
    gt[0, 3] = np.array([10, 12, 40, 50], np.float32)
    valid[0, :4] = True
    # ties: a box between two anchors of one cell, IoU equal to both
    gt[1, 0] = (a[6] + a[12]) / 2
    gt[1, 1:3] = rng.uniform(0, 64, (2, 4))
    gt[1, 1:3, 2:] = np.maximum(gt[1, 1:3, 2:], gt[1, 1:3, :2] + 4)
    valid[1, :3] = True
    return gt, valid


@pytest.fixture(scope="module")
def match_ref():
    gt, valid = match_cases()
    f = jax.jit(jax.vmap(jssd.match_anchors, (None, 0, 0)))
    return gt, valid, np.asarray(f(jnp.asarray(ANCHORS), jnp.asarray(gt),
                                   jnp.asarray(valid)))


def test_match_anchors_exact(match_ref):
    gt, valid, want = match_ref
    got = tssd.match_anchors(torch.from_numpy(ANCHORS), torch.from_numpy(gt),
                             torch.from_numpy(valid))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the traps did occur: the shared anchor went to the later GT, the
    # padding after GT 2 wiped its claim on anchor 0, image 2 is background
    assert want[0, 40] == 1 and want[0, 0] == -1 and (want[0] != 2).all()
    assert (want[2] == -1).all()


def ssd_inputs(seed, b=2, m=4, c=9, ties=True):
    rng = np.random.default_rng(seed)
    cl = rng.normal(0, 1, (b, len(ANCHORS), c)).astype(np.float32)
    if ties:  # whole blocks of anchors with the same CE
        cl[:, 60:120] = cl[:, 60:61]
        cl[:, 130:] = 0.0
    rg = rng.normal(0, 0.5, (b, len(ANCHORS), 4)).astype(np.float32)
    gb = np.zeros((b, m, 4), np.float32)
    xy = rng.uniform(4, 40, (b, m, 2))
    wh = rng.uniform(8, 40, (b, m, 2))
    gb[..., :2], gb[..., 2:] = xy, np.minimum(xy + wh, 64)
    gc = rng.integers(1, c, (b, m)).astype(np.int32)
    gv = np.ones((b, m), bool)
    gv[1, -1] = False
    return cl, rg, gb, gc, gv


@pytest.fixture(scope="module")
def ssd_ref():
    jnet = JaxSSDLite(num_classes=9, image_size=64)
    cl, rg, gb, gc, gv = ssd_inputs(4)

    def total(cl, rg):
        return jssd.ssd_loss(jnet, cl, rg, jnp.asarray(ANCHORS),
                             jnp.asarray(gb), jnp.asarray(gc),
                             jnp.asarray(gv))

    vg = jax.jit(jax.value_and_grad(total, argnums=(0, 1), has_aux=True))
    (tot, parts), (g_cl, g_rg) = vg(jnp.asarray(cl), jnp.asarray(rg))
    return dict(inp=(cl, rg, gb, gc, gv), total=float(tot),
                parts={k: float(v) for k, v in parts.items()},
                grads=(np.asarray(g_cl), np.asarray(g_rg)))


def test_ssd_loss_and_gradient_match_jax_with_tied_ce(ssd_ref):
    cl, rg, gb, gc, gv = ssd_ref["inp"]
    net = SSDLite(9, 64)
    tcl = torch.tensor(cl, requires_grad=True)
    trg = torch.tensor(rg, requires_grad=True)
    tot, parts = tssd.ssd_loss(net, tcl, trg, torch.from_numpy(ANCHORS),
                               torch.from_numpy(gb), torch.from_numpy(gc),
                               torch.from_numpy(gv))
    assert abs(float(tot.detach()) - ssd_ref["total"]) \
        <= REL * ssd_ref["total"]
    for k, v in ssd_ref["parts"].items():
        assert v > 0 and abs(float(parts[k].detach()) - v) <= REL * v, k
    grads = torch.autograd.grad(tot, (tcl, trg))
    for got, want in zip(grads, ssd_ref["grads"]):
        assert float(np.abs(got.numpy() - want).max()) \
            <= REL * np.abs(want).max()
    # the gradient reaches exactly the anchors the JAX package kept: on
    # tied CE, the first ones in anchor order
    kept_t = grads[0].abs().sum(-1) > 0
    kept_j = np.abs(ssd_ref["grads"][0]).sum(-1) > 0
    np.testing.assert_array_equal(kept_t.numpy(), kept_j)


def test_hard_negative_ranks_exact_on_ties():
    """The mask of ``hard_negatives`` against the JAX package's expression
    (stable ascending argsort of -CE, foreground at -inf), on CE with long
    runs of equal values."""
    rng = np.random.default_rng(5)
    ce = np.round(rng.random((4, 144)) * 4) / 4  # five distinct values
    ce = ce.astype(np.float32)
    fg = rng.random((4, 144)) < 0.05
    fg[3] = False

    def jax_mask(ce, fg):
        neg_ce = jnp.where(fg, -jnp.inf, ce)
        order = jnp.argsort(-neg_ce)
        rank = jnp.zeros_like(order).at[order].set(
            jnp.arange(order.shape[0]))
        return rank < 3 * jnp.sum(fg)

    want = np.asarray(jax.vmap(jax_mask)(jnp.asarray(ce), jnp.asarray(fg)))
    got = tssd.hard_negatives(torch.from_numpy(ce), torch.from_numpy(fg))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0].sum() == 3 * fg[0].sum() and not want[3].any()


def test_encode_inverts_decode():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(ANCHORS)
    reg = torch.from_numpy(rng.normal(0, 0.5, (144, 4)).astype(np.float32))
    boxes = SSDLite.decode_boxes(reg, a)
    back = SSDLite.encode_boxes(boxes, a)
    assert float((back - reg).abs().max()) < 1e-4
    j = JaxSSDLite.encode_boxes(jnp.asarray(boxes.numpy()),
                                jnp.asarray(ANCHORS))
    np.testing.assert_allclose(back.numpy(), np.asarray(j), rtol=0,
                               atol=1e-6)
