"""Shared fixtures of the benchmark's own tests (run with ``python -m pytest
benchmark/tests``; the card's tests are marked ``gpu`` and skip without
one)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SHAPES = [[48, 64], [64, 43], [64, 64], [50, 38]]
ANCHORS = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]]
TINY = {
    "yolov5": {"family": "yolov5", "nc": 3, "depth_multiple": 0.33, "width_multiple": 0.25,
               "anchors": ANCHORS, "img_size": 64, "conf_thres": 0.001, "iou_thres": 0.6,
               "max_det": 300, "max_cand": 1024},
    "faster_rcnn": {"family": "faster_rcnn", "num_classes": 4, "image_size": 64,
                    "pre_nms_top_n": 1000, "post_nms_top_n": 32, "rpn_nms_thresh": 0.7,
                    "nms_top_n": 2048, "detections_per_img": 100, "conf_thres": 0.001,
                    "iou_thres": 0.6},
}
MIXES = {
    "dir": {"generator": "directory", "images": 8, "shapes": SHAPES, "batch_size": 4,
            "jpeg_quality": 90, "calib_images": 4, "trace_passes": 1},
    "frame": {"generator": "frames", "images": 8, "shapes": SHAPES, "calib_images": 4,
              "warmup_frames": 2, "trace_frames": 2, "check_frames": 4},
}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_cell(monkeypatch):
    """Point the harness at a tiny configuration and mix on the CPU:
    returns a function (family, mix kind) -> workload name, the name of
    the family's cell of that mix, so that the run reports what
    ``BENCHMARK.json`` lists for the cell."""
    from benchmark import harness

    def use(family, kind, limits=None):
        cell = {"yolov5": "yolov5n-640", "faster_rcnn": "frcnn-r50-fpn-v2-640"}[family]
        mix = "dir-b16" if kind == "dir" else "frame-b1"
        lim = limits or harness.load_json(harness.HERE, "limits", f"{cell}.{mix}.json")
        monkeypatch.setattr(harness, "cell_spec", lambda name, manifest: (
            {"name": name, "chips": 1}, dict(TINY[family]), dict(MIXES[kind]), lim))
        return f"{cell}.{mix}"

    return use
