"""Family-generic training and evaluation engine.

The reference package's ``models/engine.py`` for its four families
(YOLOv5, SSDLite320, and the ResNet50-FPN-v2 RetinaNet and Faster R-CNN): a
detector by family name, one train step per family (forward, loss,
backward and update in one call, lr an argument), ``train_one_epoch`` with
the MetricLogger, and ``evaluate``, which serves in-memory images through
the port's serving path (the suppressor and row-gather kernels on a CUDA
device) into ``eval_coco.DetectionEvaluator``.

Target protocol: every family consumes the padded (B, MAXT, 5) normalised
[cls, x, y, w, h] rows and validity that ``pad_targets`` makes; SSDLite,
RetinaNet and Faster R-CNN train on pixel xyxy boxes with 1-based labels
(``num_classes + 1`` columns), converted inside their steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..parallel.mesh import all_sum, shard_along
from ..parallel.meters import MetricLogger
from .faster_rcnn import PRE_NMS, FasterRCNN
from .loss import yolo_loss
from .rcnn_loss import faster_rcnn_loss, rcnn_forward, uniform_draws
from .retinanet import RetinaNet, retina_loss
from .ssd_loss import ssd_loss
from .ssdlite import SSDLite
from .train import TrainConfig, make_optimizer
from .yolov5 import YoloV5


def make_detector(name: str, num_classes: int, img_size: int,
                  generator: torch.Generator | None = None):
    """The training model of a family name, seeded from ``generator``:
    ``yolov5{n,s,m,l,x}`` at ``img_size``, ``ssd`` (SSDLite with
    num_classes + 1 classes at min(img_size, 320), the full MobileNet
    tail), or ``retinanet`` / ``faster_rcnn`` with num_classes + 1 classes
    at ``img_size``."""
    if name.startswith("yolov5"):
        return YoloV5(variant=name.replace("yolov5", "") or "n",
                      num_classes=num_classes, img_size=img_size,
                      generator=generator)
    if name == "ssd":
        return SSDLite(num_classes=num_classes + 1,
                       image_size=min(img_size, 320), reduced_tail=False,
                       generator=generator)
    if name == "retinanet":
        return RetinaNet(num_classes=num_classes + 1, image_size=img_size,
                         generator=generator)
    if name == "faster_rcnn":
        return FasterRCNN(num_classes=num_classes + 1, image_size=img_size,
                          generator=generator)
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
    (``loss``), the gradients of the trained parameters and the
    optimiser's update, and leaves the new weights (and YOLOv5's and
    SSDLite's BatchNorm statistics) in the net.

    dtype: optional compute dtype (torch.bfloat16) for the forward and
    backward; master weights, gradients, optimiser state, BatchNorm
    statistics and the loss stay f32. Each module casts its own f32
    weights with autograd (the reference's ``amp_cast``); RetinaNet's
    frozen statistics stay f32, Faster R-CNN's are cast with the rest, as
    the reference's two steps cast them. RetinaNet's logits and Faster
    R-CNN's RPN and box-head outputs go back to f32 before any decision.

    Faster R-CNN: ``forward`` is the trunk and the RPN head
    (``rcnn_forward``); ``loss`` the proposals, the two samplings, the
    RoIAlign and box head and the four losses (``faster_rcnn_loss``),
    drawing its sampling ranks with ``draw_fn(b, n_rpn, n_roi, device)``
    for the ``b`` images of the global batch: by default from one
    ``torch.Generator`` on the net's device seeded with ``seed``; a caller
    may replace it to inject draws.

    Under several processes, every family: each rank passes its rows of
    one global batch and the step equals the one-process step on the whole
    batch. YOLOv5's and SSDLite's BatchNorms take the global batch's
    moments (``common.CrossRankBatchNorm``); RetinaNet's and Faster
    R-CNN's norms are frozen and take no batch statistics, so they need
    none. The losses divide by global counts (YOLOv5, SSDLite) or by the
    global batch size (RetinaNet, Faster R-CNN, whose other normalisers are
    per image). Faster R-CNN draws for the whole global batch, the same
    stream on every rank as in one process, and keeps its rows of the draw
    (``shard_along``): its images' block. Every rank must therefore pad its
    targets to the same width (the train CLI's ``--max-targets``), which
    fixes the draws' shape. The gradients are summed over the ranks (each
    rank's loss is its share of the global one, so the sum is the
    whole-batch gradient), and the loss and parts returned are the global
    ones, equal on every rank."""

    def __init__(self, net, opt, dtype=None, seed: int = 0):
        self.net, self.opt, self.dtype = net, opt, dtype
        if isinstance(net, YoloV5):
            self.loss = self._yolo_loss
        elif isinstance(net, SSDLite):
            self.loss = self._ssd_loss
        elif isinstance(net, RetinaNet):
            self.loss = self._retina_loss
        elif isinstance(net, FasterRCNN):
            self.loss = self._rcnn_loss
            self.seed = seed
            self.generator = None
            self.draw_fn = self._draws
        else:
            raise RuntimeError(f"no train step for {type(net).__name__}")

    def forward(self, images):
        if isinstance(self.net, RetinaNet):
            return self.net(images if self.dtype is None
                            else images.to(self.dtype))
        if isinstance(self.net, FasterRCNN):
            return rcnn_forward(self.net, images, self.dtype)
        return self.net.train_forward(images, self.dtype)[0]

    def _yolo_loss(self, heads, targets, valid):
        return yolo_loss(self.net, heads, targets, valid)

    def _ssd_loss(self, out, targets, valid):
        boxes, cls = _to_xyxy_px(targets, self.net.image_size)
        return ssd_loss(self.net, out[0], out[1],
                        self.net.anchors(targets.device), boxes, cls, valid)

    def _retina_loss(self, out, targets, valid):
        boxes, cls = _to_xyxy_px(targets, self.net.image_size)
        return retina_loss(self.net, out[0].to(torch.float32),
                           out[1].to(torch.float32),
                           self.net.anchors(targets.device), boxes, cls,
                           valid)

    def _draws(self, b, n_rpn, n_roi, device):
        if self.generator is None or self.generator.device != device:
            self.generator = torch.Generator(device=device).manual_seed(
                self.seed)
        return uniform_draws(self.generator, b, n_rpn, n_roi, device)

    def _rcnn_loss(self, out, targets, valid):
        feats, objs, regs = out
        net = self.net
        boxes, cls = _to_xyxy_px(targets, net.image_size)
        n_rpn = sum(o.shape[1] for o in objs)
        n_roi = min(net.rpn_post_nms, sum(min(PRE_NMS, o.shape[1])
                                          for o in objs)) + boxes.shape[1]
        draws = self.draw_fn(all_sum(boxes.shape[0]), n_rpn, n_roi,
                             boxes.device)
        draws = type(draws)(*(shard_along(d) for d in draws))
        return faster_rcnn_loss(net, feats, objs, regs, boxes, cls, valid,
                                draws, self.dtype)

    def grads(self, total):
        return all_sum(list(torch.autograd.grad(total, self.opt.params)))

    def __call__(self, images, targets, valid, lr):
        self.net.train()
        total, parts = self.loss(self.forward(images), targets, valid)
        self.opt.step(self.grads(total), lr)
        names = list(parts)
        out = all_sum([total.detach()] + [parts[k].detach() for k in names])
        return out[0], dict(zip(names, out[1:]))


def make_family_train_step(net, cfg: TrainConfig, dtype=None, seed: int = 0):
    """(optimizer, step) for ``net``'s family; see ``TrainStep``."""
    opt = make_optimizer(cfg, net)
    return opt, TrainStep(net, opt, dtype, seed)


@torch.no_grad()
def evaluate(net, images, gt_rows, batch_size: int = 8,
             conf_thres: float = 0.05, iou_thres: float = 0.5, dtype=None,
             q8=None):
    """Detect over in-memory images and score against GT rows (normalised
    [cls, x, y, w, h] per image): the evaluator's AP summary dict.

    Serves through the port's serving path on the net's device: YOLOv5
    letterboxed (``infer.detect_batch``), SSDLite, RetinaNet and Faster
    R-CNN square-resized and normalised (``infer._detect_generic``, their
    ``detect`` tails); the last batch is padded with its last image. The
    net is left in the mode it came in. Under several processes each rank
    passes its own images and the summary covers every rank's, merged in
    rank order (``DetectionEvaluator.synchronize_between_processes``).

    dtype / q8 are the serving knobs: bfloat16 compute, or an int8
    post-training-quantized trunk (``quant.Q8Yolo.tree`` for YOLOv5,
    ``quant_ssd.Q8SSD.tree`` for SSDLite, moved to the net's device), so
    that int8's accuracy change reads as a dataset mAP."""
    from ..eval_coco import DetectionEvaluator
    from .common import letterbox_batch
    from .infer import _detect_generic, detect_batch, square_batch
    from .quant import tree_to

    if q8 is not None and not isinstance(net, (YoloV5, SSDLite)):
        raise ValueError(
            "int8 (q8) evaluation is implemented for YOLO and SSDLite only")
    dev = next(net.parameters()).device
    if q8 is not None:
        q8 = tree_to(q8, dev)
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
                    dtype=dtype, q8=q8)
            else:
                dets, valid = _detect_generic(
                    net, torch.from_numpy(square_batch(
                        chunk_p, net.image_size)).to(dev),
                    conf_thres, iou_thres, dtype=dtype, q8=q8)
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
