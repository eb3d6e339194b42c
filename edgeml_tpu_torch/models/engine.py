"""Family-generic training and evaluation engine.

The reference package's ``models/engine.py`` for the two edge detectors
(YOLOv5 and SSDLite320): a detector by family name, one train step per
family (forward, loss, backward and update in one call, lr an argument),
``train_one_epoch`` with the MetricLogger, and ``evaluate``, which serves
in-memory images through the port's serving path (the suppressor and
row-gather kernels on a CUDA device) into ``eval_coco.DetectionEvaluator``.
RetinaNet and Faster R-CNN training are not yet ported.

Target protocol: every family consumes the padded (B, MAXT, 5) normalised
[cls, x, y, w, h] rows and validity that ``pad_targets`` makes; SSDLite
trains on pixel xyxy boxes with 1-based labels, converted inside its step.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..parallel.meters import MetricLogger
from .loss import yolo_loss
from .ssd_loss import ssd_loss
from .ssdlite import SSDLite
from .train import TrainConfig, make_optimizer
from .yolov5 import YoloV5


def make_detector(name: str, num_classes: int, img_size: int,
                  generator: torch.Generator | None = None):
    """The training model of a family name, seeded from ``generator``:
    ``yolov5{n,s,m,l,x}`` at ``img_size``, or ``ssd`` (SSDLite with
    num_classes + 1 classes at min(img_size, 320), the full MobileNet
    tail)."""
    if name.startswith("yolov5"):
        return YoloV5(variant=name.replace("yolov5", "") or "n",
                      num_classes=num_classes, img_size=img_size,
                      generator=generator)
    if name == "ssd":
        return SSDLite(num_classes=num_classes + 1,
                       image_size=min(img_size, 320), reduced_tail=False,
                       generator=generator)
    if name in ("retinanet", "faster_rcnn"):
        raise RuntimeError(f"training '{name}' is not yet ported "
                           f"(yolov5* and ssd are)")
    raise RuntimeError(f"unknown detector family '{name}'")


def _to_xyxy_px(targets, size):
    """(B, T, 5) normalised [cls, x, y, w, h] -> (boxes xyxy pixels,
    1-based classes)."""
    cls = targets[..., 0].to(torch.int32) + 1
    cx, cy, w, h = (targets[..., i] * size for i in (1, 2, 3, 4))
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return boxes, cls


class TrainStep:
    """One training step of a family: ``step(images, targets, valid, lr)
    -> (loss, parts)`` runs the training forward (``forward``), the loss
    (``loss``), the gradients of the parameters and the optimiser's update,
    and leaves the new weights and BatchNorm statistics in the net.

    dtype: optional compute dtype (torch.bfloat16) for the forward and
    backward; master weights, gradients, optimiser state, BatchNorm
    statistics and the loss stay f32."""

    def __init__(self, net, opt, dtype=None):
        self.net, self.opt, self.dtype = net, opt, dtype
        if isinstance(net, YoloV5):
            self.loss = self._yolo_loss
        elif isinstance(net, SSDLite):
            self.loss = self._ssd_loss
        else:
            raise RuntimeError(f"no train step for {type(net).__name__}")

    def forward(self, images):
        return self.net.train_forward(images, self.dtype)[0]

    def _yolo_loss(self, heads, targets, valid):
        return yolo_loss(self.net, heads, targets, valid)

    def _ssd_loss(self, out, targets, valid):
        boxes, cls = _to_xyxy_px(targets, self.net.image_size)
        return ssd_loss(self.net, out[0], out[1],
                        self.net.anchors(targets.device), boxes, cls, valid)

    def grads(self, total):
        return torch.autograd.grad(total, self.opt.params)

    def __call__(self, images, targets, valid, lr):
        self.net.train()
        total, parts = self.loss(self.forward(images), targets, valid)
        self.opt.step(self.grads(total), lr)
        return total.detach(), {k: v.detach() for k, v in parts.items()}


def make_family_train_step(net, cfg: TrainConfig, dtype=None):
    """(optimizer, step) for ``net``'s family; see ``TrainStep``."""
    opt = make_optimizer(cfg, net)
    return opt, TrainStep(net, opt, dtype)


@torch.no_grad()
def evaluate(net, images, gt_rows, batch_size: int = 8,
             conf_thres: float = 0.05, iou_thres: float = 0.5, dtype=None):
    """Detect over in-memory images and score against GT rows (normalised
    [cls, x, y, w, h] per image): the evaluator's AP summary dict.

    Serves through the port's serving path on the net's device: YOLOv5
    letterboxed (``infer.detect_batch``), SSDLite square-resized and
    normalised (``infer._detect_generic``); the last batch is padded with
    its last image. The net is left in the mode it came in."""
    from ..eval_coco import DetectionEvaluator
    from .common import letterbox_batch
    from .infer import _detect_generic, detect_batch, square_batch

    dev = next(net.parameters()).device
    was_training = net.training
    net.eval()
    ev = DetectionEvaluator(device=dev)
    is_yolo = isinstance(net, YoloV5)
    try:
        for s in range(0, len(images), batch_size):
            chunk = list(images[s : s + batch_size])
            chunk_p = chunk + [chunk[-1]] * (batch_size - len(chunk))
            if is_yolo:
                hw = np.array([im.shape[:2] for im in chunk_p], np.float32)
                lb, meta = letterbox_batch(chunk_p, net.img_size)
                dets, valid = detect_batch(
                    net, torch.from_numpy(lb).to(dev),
                    torch.from_numpy(meta).to(dev),
                    torch.from_numpy(hw).to(dev), conf_thres, iou_thres,
                    dtype=dtype)
            else:
                dets, valid = _detect_generic(
                    net, torch.from_numpy(square_batch(
                        chunk_p, net.image_size)).to(dev),
                    conf_thres, iou_thres, dtype=dtype)
            dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
            det_batch, gt_batch = [], []
            for bi in range(len(chunk)):
                rows = dets[bi][valid[bi]]  # (cls, x, y, w, h, conf)
                xy, wh = rows[:, 1:3], rows[:, 3:5]
                det_batch.append(
                    (rows[:, 0], np.concatenate([xy - wh / 2, xy + wh / 2],
                                                1), rows[:, 5]))
                g = np.asarray(gt_rows[s + bi], np.float32).reshape(-1, 5)
                gxy, gwh = g[:, 1:3], g[:, 3:5]
                gt_batch.append(
                    (g[:, 0], np.concatenate([gxy - gwh / 2, gxy + gwh / 2],
                                             1)))
            ev.update(det_batch, gt_batch)
    finally:
        net.train(was_training)
    ev.synchronize_between_processes()
    return ev.summarize()


def train_one_epoch(step, batches, epoch, lr_fn, print_freq: int = 100,
                    after_step=None):
    """The epoch loop with the MetricLogger: ``batches`` yields (images,
    targets, valid) tensors on the net's device (give it a length for the
    logger to print progress); ``lr_fn(it)`` gives the warmup-aware
    learning rate; ``after_step()`` runs after each update (the EMA).
    Records per step the loss and its parts, the lr, ``step_time`` (the
    step, the hook and the loss's read-back, s) and ``data_time`` (the wait
    for the batch, s). Returns the logger."""
    logger = MetricLogger()
    end = time.perf_counter()
    for it, (images, targets, valid) in enumerate(
            logger.log_every(batches, print_freq, f"Epoch: [{epoch}]")):
        t0 = time.perf_counter()
        lr = lr_fn(it)
        loss, parts = step(images, targets, valid, lr)
        if after_step is not None:
            after_step()
        loss = float(loss)
        if not np.isfinite(loss):
            raise FloatingPointError(f"Loss is {loss}, stopping training")
        logger.update(loss=loss, lr=lr, step_time=time.perf_counter() - t0,
                      data_time=t0 - end,
                      **{k: float(v) for k, v in parts.items()})
        end = time.perf_counter()
    return logger
