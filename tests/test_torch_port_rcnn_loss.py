"""The port's Faster R-CNN training loss against the JAX package's, with the
JAX package's own sampling draws injected (``jax_draws``): per image
``jax.random.split(key, 2 * b)``, then for the RPN (key 2i, n = the anchor
count) and the RoI head (key 2i + 1, n = P + M) ``kp, kn =
jax.random.split(k)`` and ``jax.random.uniform(kp, (n,))`` /
``uniform(kn, (n,))``.

Small sizes: 128 px (4,092 RPN anchors), 6 classes + background,
``rpn_post_nms`` 64, batch 2, carried weights with the frozen BatchNorm
statistics and every bias spread from a seed (``test_torch_port_faster_rcnn
._spread``).

Tolerances: ``_sample_balanced``, the RPN's matches and sample and the RoI
head's matches, sample, matched GT and labels exactly equal (they are
decisions); the four loss parts and the total within 1e-5 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import edgeml_tpu.models.faster_rcnn as jfr
from edgeml_tpu.models import rcnn_loss as jrl
from edgeml_tpu.models.retinanet import retina_match as jax_retina_match
from edgeml_tpu.ops.metrics import box_iou_safe as jax_box_iou_safe
from edgeml_tpu_torch.models import rcnn_loss as trl
from edgeml_tpu_torch.models.faster_rcnn import FasterRCNN, rpn_anchors
from test_torch_port_faster_rcnn import _numpy_tree, _spread

torch.set_num_threads(1)

SIZE, NC, POST = 128, 7, 64
N_ANCHORS = 4092
REL = 1e-5


def jax_draws(key, b, n_rpn, n_roi):
    """The uniform draws the JAX package's ``faster_rcnn_loss`` makes from
    ``key``, as the port's ``Draws``."""
    keys = jax.random.split(key, 2 * b)
    out = [[], [], [], []]
    for i in range(b):
        for j, (k, n) in enumerate(((keys[2 * i], n_rpn),
                                    (keys[2 * i + 1], n_roi))):
            kp, kn = jax.random.split(k)
            out[2 * j].append(np.asarray(jax.random.uniform(kp, (n,))))
            out[2 * j + 1].append(np.asarray(jax.random.uniform(kn, (n,))))
    return trl.Draws(*(torch.from_numpy(np.stack(o)) for o in out))


def gt_targets(seed, b=2, t=5, size=SIZE):
    """Pixel xyxy GT boxes, 1-based classes and validity (the last row of
    image 1 padding)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.2, 0.8, (b, t, 2)) * size
    wh = rng.uniform(0.12, 0.6, (b, t, 2)) * size
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    cls = rng.integers(1, NC, (b, t)).astype(np.int32)
    valid = np.ones((b, t), bool)
    valid[1, -1] = False
    boxes[1, -1] = 0.0
    cls[1, -1] = 1
    return boxes, cls, valid


def _jax_sample(key, pos, neg, n, frac):
    idx, w, pw = jrl._sample_balanced(key, jnp.asarray(pos),
                                      jnp.asarray(neg), n, frac)
    return np.asarray(idx), np.asarray(w), np.asarray(pw)


@pytest.mark.parametrize("n,n_pos,num,frac", [
    (4092, 40, 256, 0.5),  # the RPN: fewer positives than its 128 slots
    (4092, 300, 256, 0.5),  # more than enough of both
    (69, 9, 512, 0.25),  # the RoI head at 128 px: n below both widths
    (1064, 200, 512, 0.25)])  # 1000 proposals + 64 GT, more than 128 pos
def test_sample_balanced_matches_jax(n, n_pos, num, frac):
    rng = np.random.default_rng(n + n_pos)
    cls = np.full(n, 2)  # 0 positive, 1 negative, 2 neither
    cls[rng.choice(n, n_pos, replace=False)] = 0
    rest = np.nonzero(cls == 2)[0]
    cls[rng.choice(rest, len(rest) * 2 // 3, replace=False)] = 1
    pos, neg = cls == 0, cls == 1
    key = jax.random.PRNGKey(n_pos)
    want = _jax_sample(key, pos, neg, num, frac)
    kp, kn = jax.random.split(key)
    u_pos = torch.from_numpy(np.array(jax.random.uniform(kp, (n,))))
    u_neg = torch.from_numpy(np.array(jax.random.uniform(kn, (n,))))
    got = trl._sample_balanced(torch.from_numpy(pos)[None],
                               torch.from_numpy(neg)[None], u_pos[None],
                               u_neg[None], num, frac)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), w)
    assert want[1].sum() < len(want[1]) or n_pos >= num * frac


def test_rpn_sample_matches_jax():
    boxes, _, valid = gt_targets(0)
    anchors = np.concatenate(rpn_anchors(SIZE))
    assert len(anchors) == N_ANCHORS
    key = jax.random.PRNGKey(3)
    draws = jax_draws(key, 2, N_ANCHORS, 8)
    got = trl.rpn_sample(torch.from_numpy(anchors), torch.from_numpy(boxes),
                         torch.from_numpy(valid), draws.rpn_pos,
                         draws.rpn_neg)
    keys = jax.random.split(key, 4)
    for i in range(2):
        match = np.asarray(jax_retina_match(
            jnp.asarray(anchors), jnp.asarray(boxes[i]),
            jnp.asarray(valid[i]), hi=0.7, lo=0.3))
        want = (match,) + _jax_sample(keys[2 * i], match >= 0, match == -1,
                                      256, 0.5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), w)
        assert 0 < (match >= 0).sum() < 128 and (match == -2).any()


def jax_roi_sample(key, props, pvalid, gt_boxes, gt_cls, gt_valid):
    """The sampling lines of the JAX package's ``roi_head_loss``."""
    boxes = jnp.concatenate([props, gt_boxes])
    bvalid = jnp.concatenate([pvalid, gt_valid])
    iou = jax_box_iou_safe(gt_boxes, boxes)
    iou = jnp.where(gt_valid[:, None] & bvalid[None, :], iou, -1.0)
    best_gt = jnp.argmax(iou, axis=0)
    best_iou = jnp.max(iou, axis=0)
    matched = best_iou >= 0.5
    pos = matched & bvalid
    neg = (~matched) & bvalid & (best_iou >= 0.0)
    idx, w, pos_w = jrl._sample_balanced(key, pos, neg, 512, 0.25)
    midx = best_gt[idx]
    labels = jnp.where(pos[idx], gt_cls[midx], 0)
    return tuple(np.asarray(a) for a in (best_gt, idx, w, pos_w, boxes[idx],
                                         midx, labels))


@pytest.mark.parametrize("n_props", [POST, 1000])
def test_roi_sample_matches_jax(n_props):
    """Proposals jittered around the GT (so some match at 0.5) and spread
    over the image, the last few invalid, plus the GT rows."""
    boxes, cls, valid = gt_targets(1)
    rng = np.random.default_rng(n_props)
    props = np.zeros((2, n_props, 4), np.float32)
    pvalid = np.ones((2, n_props), bool)
    for i in range(2):
        near = boxes[i][rng.integers(0, 4, n_props // 2)]
        near = near + rng.normal(0, 6.0, near.shape)
        c = rng.uniform(0, SIZE, (n_props - n_props // 2, 2))
        wh = rng.uniform(4, 80, c.shape)
        far = np.concatenate([c - wh / 2, c + wh / 2], 1)
        props[i] = np.clip(np.concatenate([near, far]), 0, SIZE)
        pvalid[i, -5:] = False
        props[i, -5:] = 0.0
    key = jax.random.PRNGKey(n_props)
    n_roi = n_props + boxes.shape[1]
    draws = jax_draws(key, 2, 8, n_roi)
    got = trl.roi_sample(*(torch.from_numpy(a) for a in (
        props, pvalid, boxes, cls, valid)), draws.roi_pos, draws.roi_neg)
    keys = jax.random.split(key, 4)
    for i in range(2):
        want = jax_roi_sample(keys[2 * i + 1], *(jnp.asarray(a[i]) for a in (
            props, pvalid, boxes, cls, valid)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), w)
        assert 0 < want[3].sum() <= 128  # positives (all 128 slots at 1000)
        assert (want[6] > 0).any() and (want[6] == 0).any()


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(9)
    jnet = jfr.FasterRCNN(num_classes=NC, image_size=SIZE,
                          rpn_post_nms=POST)
    params = _spread(jnet.init(jax.random.PRNGKey(9)), rng)
    net = FasterRCNN(num_classes=NC, image_size=SIZE, rpn_post_nms=POST)
    net.from_jax_params(_numpy_tree(params))
    x = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    return dict(jnet=jnet, params=params, net=net, x=x)


@pytest.mark.parametrize("seed", [0, 1])
def test_faster_rcnn_loss_matches_jax(model, seed):
    """Both stages end to end in f32 from the same weights and images, the
    JAX package's draws injected: the four parts."""
    boxes, cls, valid = gt_targets(seed + 4)
    jnet, params, net = model["jnet"], model["params"], model["net"]
    anchors = [jnp.asarray(a) for a in jfr.rpn_anchors(SIZE)]
    key = jax.random.PRNGKey(seed)
    want, wparts = jax.jit(lambda p, x, k: jrl.faster_rcnn_loss(
        jnet, k, p, x, anchors, jnp.asarray(boxes), jnp.asarray(cls),
        jnp.asarray(valid)))(params, jnp.asarray(model["x"]), key)
    draws = jax_draws(key, 2, N_ANCHORS, POST + boxes.shape[1])
    with torch.no_grad():
        feats, objs, regs = trl.rcnn_forward(net, torch.from_numpy(
            model["x"]))
        total, parts = trl.faster_rcnn_loss(
            net, feats, objs, regs, torch.from_numpy(boxes),
            torch.from_numpy(cls), torch.from_numpy(valid), draws)
    assert set(parts) == set(wparts) == {"rpn_obj", "rpn_reg", "cls", "reg"}
    errs = {k: abs(float(parts[k]) - float(wparts[k])) / float(wparts[k])
            for k in parts}
    print(f"seed {seed}: " + ", ".join(f"{k} {float(wparts[k]):.5f} rel "
                                       f"{e:.2e}" for k, e in errs.items()))
    for k, e in errs.items():
        assert float(wparts[k]) > 0 and e <= REL, k
    assert abs(float(total) - float(want)) <= REL * float(want)
