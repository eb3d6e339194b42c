"""int8 ``evaluate`` against the JAX package's: the training engine's
``evaluate(..., q8=)`` serves an int8 post-training-quantized trunk, so
that int8's accuracy change reads as a dataset mAP.

Each family's JAX tree is calibrated by the JAX package (``prepare_int8``
/ ``prepare_int8_ssd``, one batch), carried into the port
(``quant.from_jax_q8`` / ``quant_ssd.from_jax_q8_ssd``) and served by both
packages' ``evaluate`` over the same images against the same GT rows (the
f32 net's own detections, nudged, as ``test_torch_port_engine.py`` makes
them: the APs then measure int8 against f32 and are neither 0 nor 1):

  * YOLOv5n, 4 classes, 64-px letterbox, the JAX init with the detect
    biases spread from a seed, on 6 ragged images;
  * SSDLite, 7 classes + background, 64 px, the carried net of
    ``test_torch_port_quant_ssd.py`` (BatchNorm statistics from the
    calibration batch), on 4 square 64-px images: the JAX package's
    ``evaluate`` resizes with ``jax.image.resize`` where the port resizes
    natively (within 3e-5 a pixel, ``test_torch_port_engine.py``), and a
    square image at the net's size is resized by neither.

Tolerance: each of ``map``, ``map50``, ``map75`` and every ``per_iou``
entry within 3e-5 of the JAX package's (the mAP core's). And ``q8`` with
any other family raises ``ValueError``, as the JAX package's does.
Measured: int8 ``map50`` 0.517861 in both packages against f32's 0.517871
(YOLOv5n), 0.902500 in both against 0.968125 (SSDLite). About 110 s on
one thread, some 95 s of it the JAX package's compiles (its int8
calibrations and SSDLite's int8 ``evaluate``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.models import engine as jengine
from edgeml_tpu.models.common import letterbox_batch as jax_letterbox
from edgeml_tpu.models.quant import prepare_int8 as jax_prepare_int8
from edgeml_tpu.models.quant_ssd import prepare_int8_ssd as jax_prepare_ssd
from edgeml_tpu.models.yolov5 import YoloV5 as JaxYoloV5
from edgeml_tpu_torch.models import engine as tengine
from edgeml_tpu_torch.models.infer import square_batch
from edgeml_tpu_torch.models.quant import from_jax_q8
from edgeml_tpu_torch.models.quant_ssd import from_jax_q8_ssd
from edgeml_tpu_torch.models.retinanet import RetinaNet
from edgeml_tpu_torch.models.yolov5 import YoloV5

from test_torch_port_engine import _gt_from_detections, _images, _np
from test_torch_port_quant_ssd import carried_ssd

torch.set_num_threads(1)

AP_TOL = 3e-5
KW = dict(batch_size=4, conf_thres=0.001, iou_thres=0.5)


def _yolo():
    images = _images(1, n=6)
    jnet = JaxYoloV5(variant="n", num_classes=4, img_size=64)
    params, stats = jnet.init(jax.random.PRNGKey(2))
    params = dict(params)
    rng = np.random.default_rng(3)  # spread the scores off their biases
    params["detect"] = [
        {"w": d["w"], "b": d["b"] + jnp.asarray(
            rng.normal(0, 2.0, d["b"].shape), jnp.float32)}
        for d in params["detect"]]
    net = YoloV5("n", 4, 64)
    net.from_jax_params(_np(params), _np(stats))
    calib, _ = jax_letterbox(images[:4], 64)
    tree = jax_prepare_int8(jnet, params, stats,
                            lambda i: jnp.asarray(calib), iters=1).tree
    return images, jnet, params, stats, net, tree, from_jax_q8(_np(tree))


def _ssd():
    rng = np.random.default_rng(4)
    images = [rng.random((64, 64, 3)).astype(np.float32) * 0.3
              for _ in range(4)]
    for im in images:  # a bright rectangle each
        y, x = rng.integers(8, 40, 2)
        im[y:y + 20, x:x + 16] = rng.random(3)
    x = square_batch(images, 64)
    jnet, params, stats, net = carried_ssd(11, x)
    tree = jax_prepare_ssd(jnet, params, stats, lambda i: jnp.asarray(x),
                           iters=1).tree
    return images, jnet, params, stats, net, tree, from_jax_q8_ssd(_np(tree))


@pytest.mark.parametrize("family", ["yolo", "ssd"])
def test_evaluate_int8_matches_jax(family):
    images, jnet, params, stats, net, jtree, tree = \
        {"yolo": _yolo, "ssd": _ssd}[family]()
    gts = _gt_from_detections(net, images, family)
    net.train()  # evaluate serves in eval mode and restores the mode
    got = tengine.evaluate(net, images, gts, q8=tree, **KW)
    assert net.training
    want = jengine.evaluate(jnet, params, stats, images, gts, q8=jtree,
                            **KW)
    f32 = tengine.evaluate(net, images, gts, **KW)
    print(f"{family} int8 map50 {got['map50']:.6f} (JAX {want['map50']:.6f})"
          f", f32 {f32['map50']:.6f}")
    for k in ("map", "map50", "map75"):
        assert abs(got[k] - want[k]) <= AP_TOL, (k, got[k], want[k])
    np.testing.assert_allclose(got["per_iou"], want["per_iou"], rtol=0,
                               atol=AP_TOL)
    # a real workload: int8 moves the APs off f32's, and off 0 and 1
    assert 0 < want["map50"] < 1
    assert got["map"] != f32["map"]


def test_evaluate_int8_refuses_other_families():
    net = RetinaNet(num_classes=3, image_size=64)
    with pytest.raises(ValueError, match="YOLO and SSDLite only"):
        tengine.evaluate(net, _images(1, n=1), [np.zeros((0, 5))],
                         q8={"any": torch.zeros(1)})
