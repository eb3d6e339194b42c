"""Faster R-CNN-ResNet50-FPN-v2 served by ``edgeml_tpu_torch.models``."""

from __future__ import annotations

import torch

from benchmark.families._load import load_by_key
from benchmark.reference import faster_rcnn as reference


def program(cfg, sd, device):
    """The port's FasterRCNN for ``cfg`` on ``device``, holding ``sd``. The
    port fixes some serving constants; a configuration that states others
    raises."""
    import inspect

    from edgeml_tpu_torch.models import faster_rcnn as fr
    from edgeml_tpu_torch.ops.nms import nms_rows

    fixed = {"pre_nms_top_n": fr.PRE_NMS, "rpn_nms_thresh": fr.RPN_NMS_THRESH,
             "nms_top_n": inspect.signature(nms_rows).parameters["max_cand"].default}
    for k, v in fixed.items():
        if cfg[k] != v:
            raise ValueError(f"{k}: the port serves {v}, the configuration states {cfg[k]}")
    with torch.device(device):
        net = fr.FasterRCNN(num_classes=cfg["num_classes"], image_size=cfg["image_size"],
                            rpn_post_nms=cfg["post_nms_top_n"],
                            detections_per_img=cfg["detections_per_img"])
    return load_by_key(net, sd).eval()


def serve_kwargs(cfg):
    """``run_detection`` keywords of the configuration."""
    return dict(conf_thres=cfg["conf_thres"], iou_thres=cfg["iou_thres"])


def prep(cfg, frame):
    """Host side of one frame: the square resize and normalisation."""
    from edgeml_tpu_torch.models.infer import square_batch

    return square_batch([frame], cfg["image_size"])


def step(net, cfg, prepped, device):
    """Device side of one frame: the detector and its normalisation, as
    ``run_detection`` serves a batch, and the rows on the host."""
    from edgeml_tpu_torch.models.infer import _detect_generic

    dets, valid = _detect_generic(net, torch.from_numpy(prepped).to(device),
                                  cfg["conf_thres"], cfg["iou_thres"])
    return dets[0][valid[0]].cpu().numpy()


def request_flops(sd, cfg, images, groups, device, block=16):
    """For each list of served image indices in ``groups`` (indices into
    ``images``, repeats counted), the {"conv", "linear"} model FLOPs of
    serving them: the trunk of each image, and the box head of each
    proposal that the image keeps after the RPN's NMS, as the reference
    counts them."""
    f = reference.flops(cfg)
    uniq = sorted(set(i for served in groups for i in served))
    kept = {}
    for s in range(0, len(uniq), block):
        part = uniq[s:s + block]
        for i, k in zip(part, reference.kept_proposals(sd, cfg, [images[i] for i in part],
                                                       device)):
            kept[i] = int(k)
    out = []
    for served in groups:
        rois = sum(kept[i] for i in served)
        out.append({k: f["trunk"][k] * len(served) + f["roi"][k] * rois
                    for k in ("conv", "linear")})
    return out
