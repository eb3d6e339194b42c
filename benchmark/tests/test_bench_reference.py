"""The frozen reference against the program at a tiny size on the CPU:
the same weights and pixels give the same rows; its FLOP counts against
the published ones."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness, images
from benchmark.compare import compare
from benchmark.reference import common, faster_rcnn, yolov5
from benchmark.tests.conftest import SHAPES, TINY


def tiny_inputs(seed, n=4):
    gen = torch.Generator().manual_seed(seed)
    pixels = images.make(gen, n, SHAPES, "cpu")
    return [p.astype(np.float32) / 255.0 for p in pixels], gen


@pytest.mark.parametrize("shape", [(480, 640, 480, 640), (640, 427, 427, 285),
                                   (500, 375, 640, 480), (50, 38, 64, 49)])
def test_resize_is_the_programs_bit_for_bit(shape):
    from edgeml_tpu_torch.data.loader import resize_bilinear

    h, w, oh, ow = shape
    img = np.random.default_rng(0).random((h, w, 3), dtype=np.float32)
    got = common.resize(torch.from_numpy(img), oh, ow).numpy()
    assert np.array_equal(got, resize_bilinear(img, oh, ow))


@pytest.mark.parametrize("family", ["yolov5", "faster_rcnn"])
def test_reference_rows_match_the_program(family):
    from benchmark.families import faster_rcnn as ffr
    from benchmark.families import yolov5 as fy

    fam = {"yolov5": fy, "faster_rcnn": ffr}[family]
    cfg = TINY[family]
    frames, gen = tiny_inputs(7)
    sd = fam.reference.seeded_state(cfg, gen, torch.device("cpu"), frames)
    net = fam.program(cfg, sd, torch.device("cpu"))
    prog = [fam.step(net, cfg, fam.prep(cfg, f), torch.device("cpu")) for f in frames]
    ref = []
    for f in frames:  # batch 1, as the program served them
        ref += fam.reference.detect(sd, cfg, [f], torch.device("cpu"))
    numbers = compare(prog, ref, [f.shape[:2] for f in frames])
    assert numbers["ref_rows"] >= 1
    assert numbers["unpaired"] == 0.0
    assert numbers["conf_gap"] <= 1e-6 and numbers["box_gap_px"] <= 1e-3


def test_program_refuses_a_structure_the_reference_lacks():
    from benchmark.families import yolov5 as fy

    cfg = TINY["yolov5"]
    frames, gen = tiny_inputs(3)
    sd = yolov5.seeded_state(cfg, gen, torch.device("cpu"), frames)
    sd.pop("model.23.cv3.bn.running_var")
    with pytest.raises(ValueError, match="keys differ"):
        fy.program(cfg, sd, torch.device("cpu"))


def test_yolov5_flops_match_the_published_counts():
    """ultralytics' table at 640: YOLOv5n 4.5, YOLOv5s 16.5, YOLOv5m 49.0
    GFLOPs (2 per multiply-add)."""
    cfg = harness.load_json(harness.HERE, "configs", "yolov5n-640.json")
    for (d, w), published in (((0.33, 0.25), 4.5), ((0.33, 0.50), 16.5), ((0.67, 0.75), 49.0)):
        f = yolov5.flops(dict(cfg, depth_multiple=d, width_multiple=w))
        assert abs((f["conv"] + f["linear"]) / 1e9 / published - 1) < 0.01


def test_faster_rcnn_flops_per_roi_by_hand():
    """Box head per proposal: four 3x3 256->256 convs on 7x7, the fc
    12544->1024, and the predictors 1024->91 and 1024->364."""
    cfg = harness.load_json(harness.HERE, "configs", "frcnn-r50-fpn-v2-640.json")
    f = faster_rcnn.flops(cfg)
    assert f["roi"]["conv"] == 2 * 4 * 49 * 256 * 256 * 9
    assert f["roi"]["linear"] == 2 * (12544 * 1024 + 1024 * 91 + 1024 * 364)
    assert 180e9 < f["trunk"]["conv"] < 210e9


def test_configs_state_what_the_reference_reads():
    for name in ("yolov5n-640", "frcnn-r50-fpn-v2-640"):
        cfg = json.load(open(os.path.join(harness.HERE, "configs", name + ".json")))
        mod = {"yolov5": yolov5, "faster_rcnn": faster_rcnn}[cfg["family"]]
        assert mod.param_shapes(cfg)
