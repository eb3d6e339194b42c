"""The port's Faster R-CNN-ResNet50-FPN-v2 against the JAX package's.

Small sizes: image 128 (P2..P5 at 32/16/8/4 and the pooled level at 2;
4,092 anchors, so per-level top-k widths 1000, 768, 192, 48, 12), 6 classes
(background included), 64 RPN proposals, 16 detections; carried weights
(``from_jax_params``) with the frozen BatchNorm statistics and every bias
spread from a seed.

Tolerances and why:
  * anchors: none, the same NumPy code.
  * box decode: 1e-6 relative, 1e-4 px. ``exp`` differs in the last bit
    between XLA's and PyTorch's CPU kernels.
  * FPN levels and RPN head outputs, f32: 1e-4 of each output's largest
    magnitude (convolutions sum in different orders through 50+ layers).
  * proposals on seeded RPN outputs: the same rows (valid masks equal),
    boxes 1e-4 px; the logits lie on a grid far apart against the float
    error, and the decoded candidates are equal or their IoUs lie more than
    1e-6 from the threshold, so no decision can flip.
  * ``roi_align_fpn``: 1e-6 absolute with ``pyr_dtype=None`` against the
    JAX function's strict f32 form run op by op (1e-4 against its compiled
    program, which XLA rewrites); within bf16 rounding (4e-2 absolute on
    unit-scale features) for the serving form (bf16 pyramid and weighting),
    where XLA and PyTorch round the bf16 products at other places.
  * box head, f32: 1e-4 of each output's largest magnitude.
  * ``detect`` end to end, strict f32 (``ROI_PYR = None`` on both sides, set
    and restored): the same rows, class ids equal, conf 1e-5, boxes 1e-4 px.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import edgeml_tpu.models.faster_rcnn as jfr
from edgeml_tpu_torch.models import faster_rcnn as tfr
from edgeml_tpu_torch.models.faster_rcnn import FasterRCNN, rpn_anchors

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, NC, POST, DETS = 128, 6, 64, 16
LEVEL_A = (3072, 768, 192, 48, 12)


def _numpy_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), t)


def _spread(params, rng):
    """Random frozen-BN statistics and affines in the body, and every bias
    (FPN, RPN, box head) spread from the seed."""

    def bn(p):
        c = p["g"].shape
        return dict(p, g=rng.uniform(0.5, 1.5, c), b=rng.normal(0, 0.1, c),
                    m=rng.normal(0, 0.1, c), v=rng.uniform(0.5, 2.0, c))

    def bias(p, std):
        return dict(p, b=rng.normal(0, std, np.shape(p["b"])))

    bb = dict(params["backbone"])
    bb["stem"] = bn(bb["stem"])
    bb["stages"] = [[{k: bn(v) for k, v in blk.items()} for blk in stage]
                    for stage in bb["stages"]]
    for key in ("fpn_lateral", "fpn_output"):
        bb[key] = [bias(p, 0.1) for p in bb[key]]
    rpn = {k: bias(p, 0.1) for k, p in params["rpn"].items()}
    rpn["cls"] = bias(params["rpn"]["cls"], 1.0)
    bh = dict(params["box_head"])
    bh["convs"] = [bias(p, 0.1) for p in bh["convs"]]
    bh["fc"] = bias(bh["fc"], 0.1)
    bh["cls"] = bias(bh["cls"], 1.0)
    bh["reg"] = bias(bh["reg"], 0.1)
    out = dict(params, backbone=bb, rpn=rpn, box_head=bh)
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), out)


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(9)
    jnet = jfr.FasterRCNN(num_classes=NC, image_size=SIZE,
                          rpn_post_nms=POST, detections_per_img=DETS)
    params = _spread(jnet.init(jax.random.PRNGKey(9)), rng)
    net = FasterRCNN(num_classes=NC, image_size=SIZE, rpn_post_nms=POST,
                     detections_per_img=DETS)
    net.from_jax_params(_numpy_tree(params))
    x = rng.normal(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    feats = jax.jit(jnet.backbone.apply)(params["backbone"], jnp.asarray(x))
    rpn = jax.jit(jnet.run_rpn)(params, feats)
    return dict(jnet=jnet, params=params, net=net, x=x,
                feats=[np.asarray(f) for f in feats],
                rpn=[(np.asarray(c), np.asarray(r)) for c, r in rpn])


def _close(got, want, rel):
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _iou_gap(boxes, valid, thr):
    """Smallest |iou - thr| over the pairs of valid boxes of each row."""
    gap = np.inf
    for b, v in zip(boxes.astype(np.float64), valid):
        b = b[v]
        lo = np.maximum(b[:, None, :2], b[None, :, :2])
        hi = np.minimum(b[:, None, 2:], b[None, :, 2:])
        inter = np.prod(np.clip(hi - lo, 0, None), -1)
        area = np.prod(b[:, 2:] - b[:, :2], -1)
        iou = inter / (area[:, None] + area[None, :] - inter)
        gap = min(gap, np.abs(iou[np.triu_indices(len(b), 1)] - thr).min())
    return gap


def test_anchors_match_jax():
    for size in (640, SIZE):
        got, want = rpn_anchors(size), jfr.rpn_anchors(size)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert tuple(len(a) for a in rpn_anchors(SIZE)) == LEVEL_A
    assert sum(len(a) for a in rpn_anchors(640)) == 102300


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0),
                                     (10.0, 10.0, 5.0, 5.0)])
def test_decode_matches_jax(weights):
    rng = np.random.default_rng(1)
    anc = np.concatenate([rng.uniform(0, 300, (4000, 2)),
                          rng.uniform(320, 640, (4000, 2))], 1).astype(
        np.float32)
    reg = rng.normal(0, 0.5, (4000, 4)).astype(np.float32)
    reg[:5, 2:] = 9.0  # beyond the log(1000 / 16) clip
    want = np.asarray(jfr._decode(jnp.asarray(reg), jnp.asarray(anc),
                                  weights))
    got = tfr.decode(torch.from_numpy(reg), torch.from_numpy(anc),
                     weights).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_fpn_and_rpn_head_match_jax(model):
    """ResNet50 (frozen BN) + FPN (BatchNorm carried as an exact identity)
    + the pooled level, and the RPN head on each level, f32."""
    net = model["net"]
    with torch.no_grad():
        feats = net.features(torch.from_numpy(model["x"]))
        objs, regs = net.run_rpn(feats)
    assert [tuple(f.shape[2:]) for f in feats] == [(32, 32), (16, 16),
                                                   (8, 8), (4, 4), (2, 2)]
    for got, want in zip(feats, model["feats"]):
        _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-4)
    for o, r, (wc, wr), a in zip(objs, regs, model["rpn"], LEVEL_A):
        assert o.shape == (2, a) and r.shape == (2, a, 4)
        _close(o.numpy(), wc, 1e-4)
        _close(r.numpy(), wr, 1e-4)


def test_identity_norms_are_exact(model):
    """Every carried BatchNorm of the FPN and the box head has var + eps ==
    1 and rsqrt 1 in f32, so conv + norm is conv + bias bit for bit."""
    net = model["net"]
    mods = list(net.backbone.fpn.inner_blocks) \
        + list(net.backbone.fpn.layer_blocks) \
        + list(net.roi_heads.box_head[:4])
    assert len(mods) == 12
    for m in mods:
        bn = m[1]
        v = bn.running_var + torch.full((), bn.eps)
        assert torch.equal(v, torch.ones_like(v))
        assert torch.equal(torch.rsqrt(v), torch.ones_like(v))
        x = torch.randn(1, m[0].in_channels, 3, 3,
                        generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            y = m(x)
            conv = torch.nn.functional.conv2d(
                x, m[0].weight, None, padding=m[0].padding) \
                + bn.bias[:, None, None]  # the reference's conv, then + b
        assert torch.equal(y, torch.relu(conv) if m.act else conv)


def _seeded_rpn_outputs(seed):
    """RPN outputs whose decisions are far apart: per image the logits are
    a permutation of a grid 2e-3 apart, deltas moderate."""
    rng = np.random.default_rng(seed)
    total = sum(LEVEL_A)
    objs, regs = [], []
    grid = np.linspace(-4.0, 4.0, total)
    flat = np.stack([rng.permutation(grid) for _ in range(2)]).astype(
        np.float32)
    reg = rng.normal(0, 0.3, (2, total, 4)).astype(np.float32)
    start = 0
    for a in LEVEL_A:
        objs.append(flat[:, start:start + a])
        regs.append(reg[:, start:start + a])
        start += a
    return objs, regs


@pytest.mark.parametrize("seed", [3, 4])
def test_proposals_match_jax(model, seed):
    """Per-level top-k, decode, clip, degenerate filter, the sequential
    suppressor over all (image, level) segments at IoU 0.7, global top 64:
    the same proposals as the JAX vmap of its per-image selection."""
    objs, regs = _seeded_rpn_outputs(seed)
    jnet = model["jnet"]
    anchors = [jnp.asarray(a) for a in jfr.rpn_anchors(SIZE)]
    prop_fn = jnet.proposals(None, anchors)
    want_b, want_v = jax.vmap(prop_fn)(
        [(jnp.asarray(o), jnp.asarray(r)) for o, r in zip(objs, regs)])
    want_b, want_v = np.asarray(want_b), np.asarray(want_v)
    got_b, got_v = model["net"].proposals(
        [torch.from_numpy(o) for o in objs],
        [torch.from_numpy(r) for r in regs])
    assert got_b.shape == (2, POST, 4) and got_v.dtype == torch.bool
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_allclose(got_b.numpy(), want_b, atol=1e-4, rtol=0)
    assert want_v.sum() == 2 * POST
    # each level's decoded candidates are equal, or their IoUs sit far
    # from the threshold against the float error
    for o, r, anc in zip(objs, regs, jfr.rpn_anchors(SIZE)):
        idx = np.argsort(-o, axis=1, kind="stable")[:, :min(1000, len(anc))]
        rows = np.take_along_axis(r, idx[..., None], 1)
        boxes = tfr.decode(torch.from_numpy(rows), torch.from_numpy(anc[idx]),
                           tfr.RPN_WEIGHTS).clamp(0, SIZE).numpy()
        want = np.clip(np.asarray(jfr._decode(
            jnp.asarray(rows), jnp.asarray(anc[idx]), tfr.RPN_WEIGHTS)),
            0, SIZE)
        if not np.array_equal(boxes, want):
            ok = (boxes[..., 2] - boxes[..., 0] > 1e-3) \
                & (boxes[..., 3] - boxes[..., 1] > 1e-3)
            assert _iou_gap(boxes, ok, 0.7) > 1e-6


def _roi_case(seed, n=73, ch=16):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((s, s, ch)).astype(np.float32)
             for s in (160, 80, 40, 20)]
    c = rng.uniform(0, 640, (n, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(600), (n, 2)))
    b = np.concatenate([np.maximum(c - wh / 2, 0),
                        np.minimum(c + wh / 2, 640)], 1).astype(np.float32)
    b[-3:] = 0.0  # zero rows (invalid proposals)
    b[0] = [600, 600, 640, 640]  # edge-hugging (clamped corners)
    return feats, b


def test_roi_align_matches_jax_f32():
    """Strict f32: 1e-6 against the JAX function run op by op, whose
    arithmetic is the written one (only the 4-sample mean sums in another
    order). XLA's compiled program rewrites it: ``h / 7`` becomes
    ``h * f32(1/7)`` and ``y1 + py * bin`` one fused multiply-add, which
    moves sample coordinates by an ulp and bilinear outputs by ~5e-5 on
    unit-scale features; against that program, 1e-4."""
    feats, boxes = _roi_case(7)
    jfeats, jboxes = [jnp.asarray(f) for f in feats], jnp.asarray(boxes)
    with jax.disable_jit():
        want = np.asarray(jfr.roi_align_fpn(jfeats, jboxes, 640))
    got = tfr.roi_align_fpn([torch.from_numpy(f) for f in feats],
                            torch.from_numpy(boxes))
    assert got.shape == (73, 7, 7, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    compiled = np.asarray(jfr.roi_align_fpn(jfeats, jboxes, 640))
    np.testing.assert_allclose(got.numpy(), compiled, atol=1e-4, rtol=0)


def test_roi_align_matches_jax_bf16_pyramid():
    feats, boxes = _roi_case(13)
    want = np.asarray(jfr.roi_align_fpn(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), 640,
        pyr_dtype=jnp.bfloat16)).astype(np.float32)
    got = tfr.roi_align_fpn([torch.from_numpy(f) for f in feats],
                            torch.from_numpy(boxes), pyr_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    f32 = tfr.roi_align_fpn([torch.from_numpy(f) for f in feats],
                            torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got.float().numpy(), want, atol=4e-2, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), f32, atol=4e-2, rtol=0)
    assert np.abs(got.float().numpy() - f32).max() > 0


def test_box_head_matches_jax(model):
    """RoIAlign (strict f32) + the box head of one image's proposals."""
    rng = np.random.default_rng(5)
    c = rng.uniform(0, SIZE, (40, 2))
    wh = rng.uniform(4, 120, (40, 2))
    boxes = np.concatenate([np.maximum(c - wh / 2, 0),
                            np.minimum(c + wh / 2, SIZE)], 1).astype(
        np.float32)
    jnet, params = model["jnet"], model["params"]
    feats = [jnp.asarray(f[0]) for f in model["feats"][:4]]
    wc, wr = jnet.run_box_head(params, feats, jnp.asarray(boxes))
    net = model["net"]
    tfeats = [torch.from_numpy(f[:1].copy()).permute(0, 3, 1, 2)
              for f in model["feats"][:4]]
    with torch.no_grad():
        pooled = net.roi_align(tfeats, torch.from_numpy(boxes)[None])
        cls, reg = net.box_head(pooled)
    assert cls.shape == (40, NC) and reg.shape == (40, NC, 4)
    _close(cls.numpy(), np.asarray(wc), 1e-4)
    _close(reg.numpy(), np.asarray(wr), 1e-4)


def test_detect_matches_jax(model, monkeypatch):
    """End to end, strict f32 on both sides: the same detections."""
    jnet, params = model["jnet"], model["params"]
    anchors = [jnp.asarray(a) for a in jfr.rpn_anchors(SIZE)]
    prev = jfr.ROI_PYR
    try:
        jfr.ROI_PYR = None
        d_ref, v_ref = jax.jit(
            lambda p, x: jnet.detect(p, x, anchors, score_thresh=0.05,
                                     nms_thresh=0.5))(
            params, jnp.asarray(model["x"]))
        d_ref, v_ref = np.asarray(d_ref), np.asarray(v_ref)
    finally:
        jfr.ROI_PYR = prev
    monkeypatch.setattr(tfr, "ROI_PYR", None)
    d, v = model["net"].detect(torch.from_numpy(model["x"]),
                               score_thresh=0.05, nms_thresh=0.5)
    d, v = d.numpy(), v.numpy()
    assert d.shape == (2, DETS, 6) and v_ref.sum() >= 8
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(d[..., 5], d_ref[..., 5])
    np.testing.assert_allclose(d[..., 4], d_ref[..., 4], atol=1e-5, rtol=0)
    np.testing.assert_allclose(d[..., :4], d_ref[..., :4], atol=1e-4, rtol=0)
    assert np.all(d[v][:, 5] >= 1)


def test_detect_serving_defaults_run(model):
    """The serving form (bf16 pyramid under f32) and bf16 serving give
    finite detections of the same shape."""
    x = torch.from_numpy(model["x"])
    for dtype in (None, torch.bfloat16):
        d, v = model["net"].detect(x, dtype=dtype)
        assert d.shape == (2, DETS, 6) and d.dtype == torch.float32
        assert torch.isfinite(d).all() and int(v.sum()) > 0


def test_state_dict_layout_is_torchvision():
    """Keys and shapes equal torchvision's fasterrcnn_resnet50_fpn_v2 (91
    classes), in order; a state_dict of random values in that layout loads
    strictly, and through the CLI's loader so does one without BatchNorm
    counters."""
    from edgeml_tpu_torch.cli.detect import load_torchvision_state_dict

    path = os.path.join(REPO, "tests/fixtures/manifests/faster_rcnn.json")
    with open(path) as f:
        manifest = [(k, tuple(s)) for k, s in json.load(f)]
    net = FasterRCNN(num_classes=91)
    got = [(k, tuple(v.shape)) for k, v in net.state_dict().items()]
    assert got == manifest and len(manifest) == 404
    g = torch.Generator().manual_seed(0)
    rand = {k: torch.zeros(s, dtype=torch.long)
            if k.endswith("num_batches_tracked")
            else torch.rand(s, generator=g) for k, s in manifest}
    net.load_state_dict(rand, strict=True)
    assert torch.equal(net.roi_heads.box_head[5].weight,
                       rand["roi_heads.box_head.5.weight"])
    frozen = {k: v + 1 for k, v in rand.items()
              if not k.endswith("num_batches_tracked")}
    load_torchvision_state_dict(net, frozen)
    assert torch.equal(net.rpn.head.bbox_pred.bias,
                       rand["rpn.head.bbox_pred.bias"] + 1)


def test_run_detection_on_cpu_with_class_map(model, tmp_path):
    """run_detection serves Faster R-CNN on the CPU (asked for) from an image
    directory to per-image files, classes renamed by the map."""
    from edgeml_tpu_torch.models.infer import run_detection

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(2)
    for i in range(3):
        np.save(img_dir / f"im{i}.npy",
                (rng.random((100, 80 + 20 * i, 3)) * 255).astype(np.uint8))
    class_map = {c: c - 1 for c in range(1, NC)}
    run_detection(model["net"], str(img_dir), str(tmp_path / "out"),
                  batch_size=2, conf_thres=0.05, iou_thres=0.5,
                  class_map=class_map, device="cpu")
    for i in range(3):
        a = np.load(tmp_path / "out" / f"im{i}.npy")
        assert a.shape[1] == 6 and a.shape[0] > 0
        assert np.all((a[:, 0] >= 0) & (a[:, 0] < NC - 1))
        assert np.all((a[:, 1:5] >= 0) & (a[:, 1:5] <= 1))
        assert np.all(np.diff(a[:, 5]) <= 0) and np.all(a[:, 5] > 0.05)
