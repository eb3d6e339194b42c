"""RetinaNet-ResNet50-FPN-v2 served by ``edgeml_tpu_torch.models``."""

from __future__ import annotations

import torch

from benchmark.families._load import load_by_key
from benchmark.reference import retinanet as reference


def program(cfg, sd, device):
    """The port's RetinaNet for ``cfg`` on ``device``, holding ``sd``. The
    port fixes the prefilter's width and the rows an image keeps; a
    configuration that states others raises."""
    from edgeml_tpu_torch.models import retinanet as rn

    fixed = {"prefilter_top_n": rn.RETINA_PRE, "detections_per_img": rn.RETINA_MAX_DET}
    for k, v in fixed.items():
        if cfg[k] != v:
            raise ValueError(f"{k}: the port serves {v}, the configuration states {cfg[k]}")
    with torch.device(device):
        net = rn.RetinaNet(num_classes=cfg["num_classes"], image_size=cfg["image_size"])
    return load_by_key(net, sd).eval()


def serve_kwargs(cfg):
    """``run_detection`` keywords of the configuration."""
    return dict(conf_thres=cfg["conf_thres"], iou_thres=cfg["iou_thres"])


def prep(cfg, frame):
    """Host side of one frame: the square resize and normalisation."""
    from edgeml_tpu_torch.models.infer import square_batch

    return square_batch([frame], cfg["image_size"])


def step(net, cfg, prepped, device):
    """Device side of one frame: the detector and its tail, as
    ``run_detection`` serves a batch, and the rows on the host."""
    from edgeml_tpu_torch.models.infer import _detect_generic

    dets, valid = _detect_generic(net, torch.from_numpy(prepped).to(device),
                                  cfg["conf_thres"], cfg["iou_thres"])
    return dets[0][valid[0]].cpu().numpy()


def request_flops(sd, cfg, images, groups, device):
    """For each list of served image indices in ``groups`` (repeats
    counted), the model FLOPs of serving them, as the reference counts
    them: {"conv", "linear"} of the whole model, and "head", the towers'
    and output convs' part of them."""
    f = reference.flops(cfg)
    one = {k: f["trunk"][k] + f["head"][k] for k in ("conv", "linear")}
    one["head"] = f["head"]["conv"] + f["head"]["linear"]
    return [{k: v * len(served) for k, v in one.items()} for served in groups]
