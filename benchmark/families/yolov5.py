"""YOLOv5 (ultralytics v6.0+) served by ``edgeml_tpu_torch.models``."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.families._load import load_by_key
from benchmark.reference import yolov5 as reference


def program(cfg, sd, device):
    """The port's YoloV5 for ``cfg`` on ``device``, holding ``sd``."""
    import inspect

    from edgeml_tpu_torch.models.infer import detect_batch
    from edgeml_tpu_torch.models.yolov5 import YOLOV5_VARIANTS, YoloV5
    from edgeml_tpu_torch.ops.nms import nms_split_batch

    fixed = {"max_det": inspect.signature(detect_batch).parameters["max_det"].default,
             "max_cand": inspect.signature(nms_split_batch).parameters["max_cand"].default}
    for k, v in fixed.items():
        if cfg[k] != v:
            raise ValueError(f"{k}: the port serves {v}, the configuration states {cfg[k]}")
    dw = (cfg["depth_multiple"], cfg["width_multiple"])
    variant = [k for k, v in YOLOV5_VARIANTS.items() if v == dw]
    if not variant:
        raise ValueError(f"the port has no YOLOv5 variant with multiples {dw}")
    anchors = tuple(tuple(tuple(a[i:i + 2]) for i in range(0, len(a), 2))
                    for a in cfg["anchors"])
    with torch.device(device):
        net = YoloV5(variant[0], num_classes=cfg["nc"], img_size=cfg["img_size"],
                     anchors=anchors)
    return load_by_key(net, sd).eval()


def serve_kwargs(cfg):
    """``run_detection`` keywords of the configuration."""
    return dict(conf_thres=cfg["conf_thres"], iou_thres=cfg["iou_thres"],
                img_size=cfg["img_size"])


def prep(cfg, frame):
    """Host side of one frame: the letterbox, its (ratio, dw, dh) and the
    frame's (h, w)."""
    from edgeml_tpu_torch.models.common import letterbox_batch

    lb, meta = letterbox_batch([frame], cfg["img_size"])
    return lb, meta, np.array([frame.shape[:2]], np.float32)


def step(net, cfg, prepped, device):
    """Device side of one frame: ``detect_batch`` at batch 1 and its rows on
    the host, (n, 6) [cls, x, y, w, h, conf]."""
    from edgeml_tpu_torch.models.infer import detect_batch

    lb, meta, hw = prepped
    dets, valid = detect_batch(net, torch.from_numpy(lb).to(device),
                               torch.from_numpy(meta).to(device),
                               torch.from_numpy(hw).to(device),
                               cfg["conf_thres"], cfg["iou_thres"])
    return dets[0][valid[0]].cpu().numpy()


def request_flops(sd, cfg, images, groups, device):
    """For each list of served image indices in ``groups`` (indices into
    ``images``, repeats counted), the {"conv", "linear"} model FLOPs of
    serving them."""
    f = reference.flops(cfg)
    return [{k: v * len(served) for k, v in f.items()} for served in groups]
