"""The port's training engine and meters against the JAX package's:
``evaluate`` (YOLOv5n, 4 classes, 64 px letterbox; SSDLite, 8 classes +
background, 64 px square resize) on ragged images with weights carried from
the JAX init, ``_to_xyxy_px``, ``make_detector``, ``train_one_epoch`` and
the meters.

Tolerances: each AP within 3e-5 (the mAP core's) for YOLOv5n; 1e-4 for
SSDLite, whose JAX evaluation resizes with ``jax.image.resize`` where the
port (and the JAX package's own loader) evaluates the same taps natively,
within 3e-5 a pixel; ``_to_xyxy_px`` exact; the meters' numbers and text
equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models import engine as jengine
from edgeml_tpu.models.ssdlite import SSDLite as JaxSSDLite
from edgeml_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from edgeml_tpu.parallel import meters as jmeters
from edgeml_tpu_torch.models import engine as tengine
from edgeml_tpu_torch.models.ssdlite import SSDLite
from edgeml_tpu_torch.models.train import TrainConfig
from edgeml_tpu_torch.models.yolov5 import YoloV5
from edgeml_tpu_torch.parallel import meters as tmeters

torch.set_num_threads(1)

AP_TOL = {"yolo": 3e-5, "ssd": 1e-4}


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _images(seed, n=6):
    """Ragged images with bright rectangles on a dark background."""
    rng = np.random.default_rng(seed)
    images = []
    for i in range(n):
        h, w = [(48, 64), (64, 40), (64, 64)][i % 3]
        img = rng.random((h, w, 3)).astype(np.float32) * 0.2
        for _ in range(int(rng.integers(1, 4))):
            bw, bh = rng.uniform(0.2, 0.5, 2)
            x, y = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2,
                                                                1 - bh / 2)
            img[int((y - bh / 2) * h):int((y + bh / 2) * h),
                int((x - bw / 2) * w):int((x + bw / 2) * w)] = rng.random(3)
        images.append(img)
    return images


def _gt_from_detections(net, images, family, k=3):
    """GT rows from the net's own top-k detections, nudged: random weights
    detect nothing real, so the GT is what they see (as a strong detector's
    rows label a weak one's), and the APs are neither 0 nor 1."""
    from edgeml_tpu_torch.models.common import letterbox_batch
    from edgeml_tpu_torch.models.infer import (
        _detect_generic, detect_batch, square_batch,
    )

    net.eval()
    if family == "yolo":
        lb, meta = letterbox_batch(images, net.img_size)
        hw = np.array([im.shape[:2] for im in images], np.float32)
        dets, valid = detect_batch(net, torch.from_numpy(lb),
                                   torch.from_numpy(meta),
                                   torch.from_numpy(hw), 0.001, 0.5)
    else:
        dets, valid = _detect_generic(
            net, torch.from_numpy(square_batch(images, net.image_size)),
            0.001, 0.5)
    rng = np.random.default_rng(7)
    gts = []
    for d, v in zip(dets.numpy(), valid.numpy()):
        rows = d[v][:k, :5].copy()
        rows[:, 1:5] *= rng.uniform(0.97, 1.03, rows[:, 1:5].shape)
        gts.append(rows.astype(np.float32))
    return gts


@pytest.mark.parametrize("family", ["yolo", "ssd"])
def test_evaluate_matches_jax(family):
    images = _images(1, n=4 if family == "ssd" else 6)
    if family == "yolo":
        jnet = JaxYoloV5(variant="n", num_classes=4, img_size=64)
        net = YoloV5("n", 4, 64)
    else:
        jnet = JaxSSDLite(num_classes=9, image_size=64)
        net = SSDLite(9, 64)
    params, stats = jnet.init(jax.random.PRNGKey(2))
    if family == "yolo":  # spread the scores off their bias constants
        params = dict(params)
        rng = np.random.default_rng(3)
        params["detect"] = [
            {"w": d["w"], "b": d["b"] + jnp.asarray(
                rng.normal(0, 2.0, d["b"].shape), jnp.float32)}
            for d in params["detect"]]
    net.from_jax_params(_np(params), _np(stats))
    gts = _gt_from_detections(net, images, family)
    net.train()  # evaluate serves in eval mode and restores the mode
    kw = dict(batch_size=4, conf_thres=0.001, iou_thres=0.5)
    got = tengine.evaluate(net, images, gts, **kw)
    assert net.training
    want = jengine.evaluate(jnet, params, stats, images, gts, **kw)
    for k in ("map", "map50", "map75"):
        assert abs(got[k] - want[k]) <= AP_TOL[family], (k, got[k], want[k])
    np.testing.assert_allclose(got["per_iou"], want["per_iou"], rtol=0,
                               atol=AP_TOL[family])
    assert 0 < want["map50"] < 1  # a real workload


def test_to_xyxy_px_exact():
    rng = np.random.default_rng(4)
    tg = rng.random((2, 5, 5)).astype(np.float32)
    tg[..., 0] = rng.integers(0, 20, (2, 5))
    for size in (64, 320):
        gb, gc = tengine._to_xyxy_px(torch.from_numpy(tg), size)
        jb, jc = jengine._to_xyxy_px(jnp.asarray(tg), size)
        np.testing.assert_array_equal(gb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(jc))


def test_make_detector_families():
    g = torch.Generator().manual_seed(0)
    y = tengine.make_detector("yolov5s", 20, 128, generator=g)
    assert isinstance(y, YoloV5) and y.variant == "s" and y.img_size == 128
    assert y.num_classes == 20
    s = tengine.make_detector("ssd", 20, 640)
    assert isinstance(s, SSDLite) and s.num_classes == 21
    assert s.image_size == 320 and not s.reduced_tail
    for name in ("retinanet", "faster_rcnn"):
        with pytest.raises(RuntimeError, match="not yet ported"):
            tengine.make_detector(name, 20, 64)
    with pytest.raises(RuntimeError, match="unknown"):
        tengine.make_detector("vgg", 20, 64)


def test_train_one_epoch_logs_and_trains():
    net = YoloV5("n", 4, 64, generator=torch.Generator().manual_seed(1))
    opt, step = tengine.make_family_train_step(net, TrainConfig(lr=0.01))
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        tg = np.zeros((2, 3, 5), np.float32)
        tg[..., 1:3] = rng.uniform(0.3, 0.7, (2, 3, 2))
        tg[..., 3:5] = 0.3
        batches.append((torch.from_numpy(rng.random((2, 64, 64, 3)).astype(
            np.float32)), torch.from_numpy(tg), torch.ones(2, 3,
                                                           dtype=torch.bool)))
    before = net.model[0].conv.weight.detach().clone()
    hooked = []
    logger = tengine.train_one_epoch(step, batches, 0, lambda it: 0.01,
                                     print_freq=1,
                                     after_step=lambda: hooked.append(1))
    assert logger.meters["loss"].count == 3 and len(hooked) == 3
    assert np.isfinite(logger.meters["loss"].global_avg)
    assert logger.meters["lr"].value == 0.01
    for k in ("step_time", "data_time", "box", "obj", "cls"):
        assert logger.meters[k].count == 3, k
    assert not torch.equal(before, net.model[0].conv.weight)


def test_meters_equal_jax(capsys):
    vals = [3.0, 1.5, 2.25, 7.0, 0.5]
    t, j = tmeters.SmoothedValue(window_size=3), \
        jmeters.SmoothedValue(window_size=3)
    for i, v in enumerate(vals):
        t.update(v, n=i + 1)
        j.update(v, n=i + 1)
    for attr in ("median", "avg", "global_avg", "max", "value", "count",
                 "total"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert str(t) == str(j)
    t.synchronize_between_processes()  # one process: a no-op
    assert t.count == j.count
    tl, jl = tmeters.MetricLogger(), jmeters.MetricLogger()
    for v in vals:
        tl.update(loss=v, lr=0.1)
        jl.update(loss=v, lr=0.1)
    assert str(tl) == str(jl)
    assert tl.loss.global_avg == jl.loss.global_avg
    assert list(tl.log_every(range(4), 2, "H")) == list(range(4))
    out = capsys.readouterr().out
    assert "H\t[0/4]" in out and "H Total time" in out
