"""SSD postprocessing: softmax scores, decode, class-aware NMS.

Serving semantics of torchvision's SSD, as the reference implements them
(its ``ssd_postprocess``): softmax over the class logits with the background
column dropped, the box deltas decoded onto the default boxes and clipped to
the image, then the exact batched NMS with every box's objectness 1 and at
most 2048 candidates per image. The loss and the anchor matcher belong to
training and are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.nms import nms_split_batch

MAX_CAND = 2048


def ssd_nms_inputs(net, cls_logits, reg, anchors):
    """The split NMS inputs of SSD serving: (obj (B, A) ones, xywh (B, A, 4)
    pixel xywh-center f32, scores (B, A, C - 1) softmax without background).
    """
    scores = torch.softmax(cls_logits, dim=-1)[..., 1:]
    boxes = net.decode_boxes(reg, anchors)
    boxes = torch.clamp(boxes, 0.0, float(net.image_size))
    # the candidates are rebuilt as xyxy from xywh inside the NMS: the same
    # round trip as the reference, so the suppressor sees the same bits
    xywh = torch.cat([(boxes[..., :2] + boxes[..., 2:4]) * 0.5,
                      boxes[..., 2:4] - boxes[..., :2]], dim=-1)
    obj = torch.ones(scores.shape[:2], dtype=scores.dtype,
                     device=scores.device)
    return obj, xywh, scores


@torch.no_grad()
def ssd_postprocess(net, cls_logits, reg, anchors,
                    score_thresh: float = 0.001, nms_thresh: float = 0.55,
                    max_det: int = 300):
    """Decode + score + class-aware NMS.

    :param net: the SSDLite module (its ``decode_boxes`` and ``image_size``).
    :param cls_logits: (B, A, C) f32; reg: (B, A, 4) f32; anchors: (A, 4).
    :return: (dets (B, max_det, 6) [x1, y1, x2, y2, score, cls_id], valid
        (B, max_det)); cls_id keeps the model's label space (background
        dropped, ids start at 1).
    """
    dets, valid = nms_split_batch(
        *ssd_nms_inputs(net, cls_logits, reg, anchors),
        conf_thres=score_thresh, iou_thres=nms_thresh, max_det=max_det,
        max_cand=MAX_CAND, multi_label=True)
    # class ids: the NMS counts from 0 over the background-dropped columns
    dets[..., 5] += valid.to(dets.dtype)
    return dets, valid
