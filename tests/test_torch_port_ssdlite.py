"""The port's SSDLite320-MobileNetV3-Large against the JAX package's.

Small sizes: image_size 160 (six levels 10/5/3/2/1/1, 840 default boxes),
5 classes (background included), carried weights (``from_jax_params``) with
BatchNorm statistics calibrated on the test batch and spread head biases,
so every layer carries signal.

Tolerances and why:
  * default boxes and feature sizes: none — the same NumPy code.
  * head outputs (cls logits, box deltas), f32: 1e-4 absolute on outputs
    of unit scale. XLA's and PyTorch's CPU convolutions sum in different
    orders; the two agree to ~3e-5 here (~3e-6 in softmax scores).
  * ``ssd_postprocess`` on seeded head outputs: the same rows, class ids
    equal, conf within 1e-5, boxes within 1e-4 px. The softmax and exp of
    the two frameworks may differ in the last bit; the seed puts the pair
    scores on a grid 5.6e-5 apart and keeps every same-class IoU of the
    candidates more than 1e-5 away from the threshold (checked), so no
    decision can flip.
  * ``run_detection`` end to end (5 ragged images, a class map): the same
    rows per file, classes equal, conf within 1e-5, xywh within 1e-4
    (normalised). The square resizes agree to 2e-6 (tests/test_loader.py)
    and the scores to ~3e-6; the confidence gate, the pair scores and the
    same-class IoUs are checked to be separated by more than 1e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models.infer import run_detection as jax_run_detection
from edgeml_tpu.models.ssd_loss import ssd_postprocess as jax_ssd_postprocess
from edgeml_tpu.models.ssdlite import SSDLite as JaxSSDLite
from edgeml_tpu.models.ssdlite import default_boxes as jax_default_boxes
from edgeml_tpu_torch.models.infer import run_detection, square_batch
from edgeml_tpu_torch.models.ssd_loss import ssd_postprocess
from edgeml_tpu_torch.models.ssdlite import SSDLite, default_boxes
from edgeml_tpu_torch.ops import nms as tnms
from edgeml_tpu_torch.ops.nms_fused import greedy_keep_mask_fused

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, NC = 160, 5
FLOOR_VAR = 1e-2
SHAPES = [(120, 90), (90, 160), (160, 160), (75, 100), (200, 150)]


def _numpy_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), t)


def ragged_images(seed):
    """Smooth-ish images (coarse random field + noise), values in [0, 1]."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in SHAPES:
        coarse = rng.random((h // 16 + 1, w // 16 + 1, 3))
        img = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w]
        out.append(np.clip(img + rng.normal(0, 0.05, (h, w, 3)), 0, 1)
                   .astype(np.float32))
    return out


def carried(seed, calib):
    """JAX init(PRNGKey(seed)) with BatchNorm statistics taken on ``calib``
    plus 11 seeded noise images (one train-mode pass; the running-stat
    update is inverted to the batch statistics; variances floored at
    FLOOR_VAR, since the 1x1 levels have little and would amplify rounding)
    and head-projection biases spread from the seed, carried into the port
    with from_jax_params."""
    jnet = JaxSSDLite(num_classes=NC, image_size=SIZE)
    params, stats = jnet.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    extra = rng.normal(0, 1, (11,) + calib.shape[1:]).astype(np.float32)
    _, new = jax.jit(lambda p, s, x: jnet.apply(p, s, x, train=True))(
        params, stats, jnp.asarray(np.concatenate([calib, extra])))
    mom = 0.01
    batch = jax.tree_util.tree_map(
        lambda n, o: (np.asarray(n, np.float64)
                      - (1 - mom) * np.asarray(o, np.float64)) / mom,
        new, stats)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(
            np.maximum(a, FLOOR_VAR) if path[-1].key == "v" else a,
            jnp.float32), batch)
    params = dict(params)
    for key, scale in (("cls_head", 1.5), ("reg_head", 0.5)):
        params[key] = [
            dict(hp, proj={"w": hp["proj"]["w"], "b": jnp.asarray(
                rng.normal(0, scale, hp["proj"]["b"].shape), jnp.float32)})
            for hp in params[key]]
    net = SSDLite(num_classes=NC, image_size=SIZE)
    net.from_jax_params(_numpy_tree(params), _numpy_tree(stats))
    return jnet, params, stats, net


@pytest.fixture(scope="module")
def model():
    """The carried model and one JAX forward of the test batch (the
    square-resized, normalised ragged images)."""
    imgs = ragged_images(0)
    x = square_batch(imgs, SIZE)
    jnet, params, stats, net = carried(3, x)
    (jc, jr), _ = jax.jit(lambda p, s, x: jnet.apply(p, s, x))(
        params, stats, jnp.asarray(x))
    return dict(imgs=imgs, x=x, jnet=jnet, params=params, stats=stats,
                net=net, cls=np.asarray(jc), reg=np.asarray(jr))


def test_default_boxes_match_jax():
    for size in (320, 160):
        net = JaxSSDLite(image_size=size)
        assert SSDLite(image_size=size).feature_sizes == net.feature_sizes
        np.testing.assert_array_equal(
            default_boxes(size, net.feature_sizes),
            jax_default_boxes(size, net.feature_sizes))
    assert SSDLite().feature_sizes == (20, 10, 5, 3, 2, 1)
    assert default_boxes().shape == (3234, 4)


def test_heads_match_jax(model):
    """SSDLite f32 forward (MobileNetV3 trunk, extras, both heads) on
    carried weights: cls logits and box deltas within 1e-4."""
    with torch.no_grad():
        c, r = model["net"](torch.from_numpy(model["x"]))
    assert c.shape == (5, 840, NC) and r.shape == (5, 840, 4)
    assert np.std(model["cls"]) > 0.5 and np.std(model["reg"]) > 0.1
    np.testing.assert_allclose(c.numpy(), model["cls"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(r.numpy(), model["reg"], atol=1e-4, rtol=0)


def _candidate_iou_gap(boxes, scores, conf, thr):
    """Smallest |iou - thr| over same-class pairs of all candidates above
    the gate (boxes (B, A, 4) xyxy, scores (B, A, C))."""
    gap = np.inf
    for bx, sc in zip(boxes.astype(np.float64), scores):
        for c in range(sc.shape[1]):
            b = bx[sc[:, c] > conf]
            if len(b) < 2:
                continue
            lo = np.maximum(b[:, None, :2], b[None, :, :2])
            hi = np.minimum(b[:, None, 2:], b[None, :, 2:])
            inter = np.prod(np.clip(hi - lo, 0, None), -1)
            area = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), -1)
            iou = inter / np.maximum(area[:, None] + area[None, :] - inter,
                                     1e-12)
            iu = np.triu_indices(len(b), 1)
            gap = min(gap, np.abs(iou[iu] - thr).min())
    return gap


def _compare_dets(got, want, box_atol):
    (d, v), (d_ref, v_ref) = got, want
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(d[..., 5], d_ref[..., 5])
    np.testing.assert_allclose(d[..., 4], d_ref[..., 4], atol=1e-5, rtol=0)
    np.testing.assert_allclose(d[..., :4], d_ref[..., :4], atol=box_atol,
                               rtol=0)


def test_ssd_postprocess_matches_jax():
    """Seeded head outputs (B = 2, 840 boxes, 4 foreground classes): the
    pair scores are a shuffled grid, so K = 2048 real candidates enter the
    suppressor, and the rows equal JAX's."""
    rng = np.random.default_rng(12)
    b, a, c = 2, 840, NC
    grid = np.linspace(0.01, 0.2, a * (c - 1))
    probs = np.stack([rng.permutation(grid).reshape(a, c - 1)
                      for _ in range(b)])
    probs = np.concatenate([1.0 - probs.sum(-1, keepdims=True), probs], -1)
    logits = np.log(probs).astype(np.float32)
    reg = rng.normal(0, 1.0, (b, a, 4)).astype(np.float32)
    jnet = JaxSSDLite(num_classes=NC, image_size=SIZE)
    anchors = jax_default_boxes(SIZE, jnet.feature_sizes)
    thr = 0.55
    d_ref, v_ref = jax_ssd_postprocess(
        jnet, jnp.asarray(logits), jnp.asarray(reg), jnp.asarray(anchors),
        score_thresh=0.001, nms_thresh=thr)
    d_ref, v_ref = np.asarray(d_ref), np.asarray(v_ref)
    net = SSDLite(num_classes=NC, image_size=SIZE)
    d, v = ssd_postprocess(net, torch.from_numpy(logits),
                           torch.from_numpy(reg), torch.from_numpy(anchors),
                           score_thresh=0.001, nms_thresh=thr)
    boxes = np.asarray(jnp.clip(jnet.decode_boxes(jnp.asarray(reg),
                                                  jnp.asarray(anchors)),
                                0.0, SIZE))
    assert _candidate_iou_gap(boxes, probs[..., 1:], 0.001, thr) > 1e-5
    assert 100 < v_ref.sum(1).min()
    _compare_dets((d.numpy(), v.numpy()), (d_ref, v_ref), 1e-4)
    # K = 2048 real candidates per image, and the suppressor removes some
    xywh = np.concatenate([(boxes[..., :2] + boxes[..., 2:]) / 2,
                           boxes[..., 2:] - boxes[..., :2]], -1)
    cand, top, ci = tnms.candidates(
        torch.ones(b, a), torch.from_numpy(xywh),
        torch.from_numpy(probs[..., 1:].astype(np.float32)), 0.001, 2048)
    kept = greedy_keep_mask_fused(cand + ci[..., None] * tnms.MAX_WH, top,
                                  thr)
    assert top.shape == (b, 2048) and bool((top > 0).all())
    assert int(kept.sum(1).max()) < 2048
    # the classes are 1-based on valid rows, 0 on the zero rows
    assert d.numpy()[..., 5][v.numpy()].min() >= 1
    assert not d.numpy()[~v.numpy()].any()


def test_run_detection_matches_jax(model, tmp_path):
    """The slice end to end: JAX run_detection and the port's
    run_detection(device="cpu") with a class map, on 5 ragged images."""
    imgs = model["imgs"]
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, im in enumerate(imgs):
        np.save(img_dir / f"im{i}.npy", im)
    conf, iou = 0.735, 0.55
    probs = np.asarray(jax.nn.softmax(jnp.asarray(model["cls"]), -1))[..., 1:]
    above = probs[probs > conf]
    assert 100 < above.size < 1000
    margin = 1e-5
    assert np.abs(probs - conf).min() > margin
    for p in probs:
        s = np.sort(p[p > conf])
        assert np.diff(s).min() > margin
    boxes = np.asarray(jnp.clip(model["jnet"].decode_boxes(
        jnp.asarray(model["reg"]),
        jnp.asarray(default_boxes(SIZE, model["net"].feature_sizes))),
        0.0, SIZE))
    assert _candidate_iou_gap(boxes, probs, conf, iou) > margin
    class_map = {1: 0, 2: 1, 3: -1, 4: 2}
    kw = dict(conf_thres=conf, iou_thres=iou, class_map=class_map)
    # one batch of 5 on the JAX side (its eager forward compiles per shape);
    # batches of 2 with a padded tail on the port's: rows do not depend on
    # the batch an image rides in
    jax_run_detection(model["jnet"], model["params"], model["stats"],
                      str(img_dir), str(tmp_path / "jax"), batch_size=5, **kw)
    run_detection(model["net"], str(img_dir), str(tmp_path / "port"),
                  batch_size=2, device="cpu", **kw)
    rows = 0
    for i in range(len(imgs)):
        want = np.load(tmp_path / "jax" / f"im{i}.npy")
        got = np.load(tmp_path / "port" / f"im{i}.npy")
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        np.testing.assert_allclose(got[:, 5], want[:, 5], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got[:, 1:5], want[:, 1:5], atol=1e-4,
                                   rtol=0)
        assert set(np.unique(got[:, 0])) <= {0.0, 1.0, 2.0}
        rows += got.shape[0]
    assert rows > 20


def test_state_dict_layout_is_torchvision():
    """Keys and shapes equal torchvision's ssdlite320_mobilenet_v3_large
    (reduced tail, 91 classes), in order; a state_dict of zeros in that
    layout loads strictly."""
    with open(os.path.join(REPO, "tests/fixtures/manifests/ssd.json")) as f:
        manifest = [(k, tuple(s)) for k, s in json.load(f)]
    net = SSDLite(num_classes=91, reduced_tail=True)
    got = [(k, tuple(v.shape)) for k, v in net.state_dict().items()]
    assert got == manifest
    zeros = {k: torch.zeros(s, dtype=torch.long if k.endswith(
        "num_batches_tracked") else torch.float32) for k, s in manifest}
    net.load_state_dict(zeros, strict=True)
    assert all(float(v.abs().sum()) == 0 for v in net.state_dict().values())
    # the full tail: the last conv is 160 -> 960
    full = SSDLite(num_classes=91).state_dict()
    assert tuple(full["backbone.features.1.3.0.weight"].shape) == \
        (960, 160, 1, 1)


def test_cli_loads_torchvision_state_dict(tmp_path):
    """The detect CLI's loader: an .npz torchvision state_dict with the
    reduced tail is sniffed (the (480, 80, 1, 1) weight) and loaded by key,
    strictly."""
    from edgeml_tpu_torch.cli.detect import load_detector

    src = SSDLite(num_classes=91, reduced_tail=True,
                  generator=torch.Generator().manual_seed(4))
    sd = {k: v.numpy() for k, v in src.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    path = tmp_path / "ssd.npz"
    np.savez(path, **sd)
    net = load_detector("ssd", str(path), 91)
    assert net.reduced_tail
    for k, v in src.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k
