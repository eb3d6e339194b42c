"""Detection evaluator: a COCO-style AP summary of accumulated detections.

The port of the JAX package's ``eval_coco.py``. Per-image detections and
ground truth accumulate on the host; ``summarize()`` scores them in one of
two styles:

  * style="greedy" (default, the throughput path): greedy highest-IoU
    matching, the yolov5 convention of the rest of the package, by
    ``data/io.py _batched_correct`` at the ten COCO IoU thresholds, then ONE
    evaluation of the detection pool by the mAP core (``ops/map_kernel.py``)
    on the device. No crowd handling or area/maxDets breakdowns. The APs on
    the card equal the CPU's bit for bit, as the mAP core's do.
  * style="coco" (the exactness path): full COCOeval semantics for bbox,
    segm and keypoints on the host (``coco_matching.evaluate_coco``).

Under several processes each rank accumulates its own images and
``synchronize_between_processes`` gathers every rank's, in rank order,
before ``summarize``; in one process it is a no-op.
"""

from __future__ import annotations

import numpy as np
import torch

from .coco_matching import evaluate_coco
from .data.io import _batched_correct
from .device import resolve_device
from .ops.map_kernel import build_pool, map_per_threshold
from .parallel.mesh import allgather_object, world_size

COCO_IOUV = np.round(np.linspace(0.5, 0.95, 10), 2)


class DetectionEvaluator:
    """Accumulate (detections, ground truth) per image; summarize dataset
    AP.

    :param device: where style="greedy" matches and scores: the CUDA device
        unless "cpu" is asked for (resolved when the evaluator is built).
    """

    def __init__(self, iouv=None, style: str = "greedy",
                 iou_type: str = "bbox", device=None):
        assert style in ("greedy", "coco"), style
        assert iou_type in ("bbox", "segm", "keypoints"), iou_type
        if iou_type != "bbox" and style != "coco":
            raise ValueError(
                f"{iou_type} evaluation runs through the COCOeval-parity "
                "path; construct with style='coco'")
        self.iouv = np.asarray(iouv if iouv is not None else COCO_IOUV)
        self.style = style
        self.iou_type = iou_type
        self.device = resolve_device(device) if style == "greedy" else None
        self.dets = []  # per image: (cls (n,), xyxy (n, 4), conf (n,)[, masks])
        self.gts = []  # per image: (cls (m,), xyxy (m, 4)[, iscrowd][, masks])

    def update(self, detections, ground_truths):
        """Add a batch. detections: iterable of (cls, boxes xyxy, conf);
        ground_truths: iterable of (cls, boxes xyxy) or (cls, boxes xyxy,
        iscrowd); the crowd flag counts only in style="coco". With
        iou_type="segm", detections carry a 4th element and ground truths a
        4th element after iscrowd: per-instance masks as an (n, H, W) bool
        array or a list of COCO RLE dicts. With iou_type="keypoints", the
        4th elements are (n, K, 3) keypoint arrays and ground truths may
        append (m,) object areas. Coordinates must share one frame;
        style="coco" area ranges assume pixels."""

        def store(t, n_std):
            t = tuple(t)
            # masks may be lists of RLE dicts: payloads past the standard
            # array fields are kept as they are
            return tuple(np.asarray(x) for x in t[:n_std]) + t[n_std:]

        for d, g in zip(detections, ground_truths):
            self.dets.append(store(d, 3))
            self.gts.append(store(g, 3))

    def synchronize_between_processes(self):
        """Gather every process's accumulated images, ordered by rank, before
        summarizing: a no-op for one process. Payloads may be ragged (each
        rank's image count differs)."""
        if world_size() == 1:
            return
        gathered = allgather_object((self.dets, self.gts))
        self.dets = [d for dets, _ in gathered for d in dets]
        self.gts = [g for _, gts in gathered for g in gts]

    def summarize(self, verbose: bool = True) -> dict:
        """Returns {'map': AP@[.5:.95], 'map50': AP@.5, 'map75': AP@.75,
        ...}; style="coco" adds the area-range and maxDets stats (COCOeval's
        12)."""
        if self.style == "coco":
            return self._summarize_coco(verbose)
        det_list = [
            (c.astype(int), b.reshape(-1, 4), s) if len(c) else ()
            for c, b, s in self.dets
        ]
        gt_list = [
            (g[0].astype(int), g[1].reshape(-1, 4)) if len(g[0]) else ()
            for g in self.gts  # g may carry an iscrowd flag (coco style only)
        ]
        t = len(self.iouv)
        tp = _batched_correct(det_list, gt_list, self.iouv, self.device)
        none = (np.zeros((0, t), bool), np.array([]), np.array([]))
        weak = [(c, d[2], d[0]) if len(d) else none
                for d, c in zip(det_list, tp)]
        labels = [g[0] if len(g) else np.array([]) for g in gt_list]
        pool = build_pool(weak, [none] * len(weak), labels,
                          device=self.device)
        n = pool.num_images
        ones = torch.ones((1, n), dtype=torch.bool, device=self.device)
        zeros = torch.zeros((1, n), dtype=torch.bool, device=self.device)
        # one evaluation: the (C, T) AP matrix reduced per threshold
        aps = map_per_threshold(pool, ones, zeros, ones)[0].cpu().numpy()
        result = {
            "map": float(np.nanmean(aps)),
            "map50": float(aps[0]),
            "map75": float(aps[5]) if len(aps) > 5 else float("nan"),
            "per_iou": aps,
        }
        if verbose:
            self._print_summary(result)
        return result

    def _summarize_coco(self, verbose: bool) -> dict:
        result = evaluate_coco(self.dets, self.gts, iouv=self.iouv,
                               iou_type=self.iou_type)
        if verbose:
            self._print_summary(result)
            lines = [
                f"Average Precision (AP) @[ area={name:>6s} ] = {result[k]:.3f}"
                for name in ("small", "medium", "large")
                if (k := f"map_{name}") in result
            ] + [
                f"Average Recall    (AR) @[ maxDets={k.split('_')[1]:>3s} ] "
                f"= {result[k]:.3f}"
                for k in result
                if k.startswith("mar_") and k.split("_")[1].isdigit()
            ]
            print("\n".join(lines))
        return result

    @staticmethod
    def _print_summary(result):
        print(
            f"Average Precision (AP) @[ IoU=0.50:0.95 ] = {result['map']:.3f}\n"
            f"Average Precision (AP) @[ IoU=0.50      ] = {result['map50']:.3f}\n"
            f"Average Precision (AP) @[ IoU=0.75      ] = {result['map75']:.3f}"
        )
