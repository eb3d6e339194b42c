"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``edgeml_tpu_torch/csrc`` (one nvcc per
source, in parallel), holds each kernel against its plain PyTorch version,
then drives the port's main paths at full published width (random weights
from a seed) from an image directory to per-image detection files and checks
what comes out:

  * YOLOv5n serving (80 classes, 640x640 letterbox) in f32 and bf16, through
    the monolithic suppressor kernel (K = 1024, a cluster of 4 blocks per
    image); then the strong detector (YOLOv5m) through the same code on one
    batch;
  * SSDLite320-MobileNetV3-Large serving (91 classes, COCO -> 80 class map)
    in f32 and bf16, through the blocked suppressor kernel (K = 2048, the
    same banded kernel as a cluster of 8);
  * RetinaNet-ResNet50-FPN-v2 serving (91 classes, 640) in f32, through the
    blocked kernel, and one device-resident batch timed in f32 and bf16;
  * Faster R-CNN-ResNet50-FPN-v2 serving (91 classes, 640, 1000 proposals,
    100 detections) in f32 (traced), through the sequential suppressor
    kernel (RPN proposals, all images and levels in one launch; the loop's
    answer in its sorted form, a cluster of 4 blocks per segment), the row
    gathers and the blocked kernel (final NMS, K = 2048); one
    device-resident batch timed stage by stage in f32 and bf16; its
    proposal and final tails rerun with the plain versions;
  * every family's f32 heads (and Faster R-CNN's RoIAlign and box head on
    the same inputs) against the CPU's, each output within 1e-4 of its
    largest value, and run_detection's files on four images against a CPU
    run, row for row within the card's stated file tolerance;
  * the reward path on ``bench.py``'s synthetic workload (a copy of its
    generator): ORIE at E = 1000 over N = 2048 and 5000 images (mAP@0.5)
    and 2048 (mAP@0.5:0.95), held against the port's CPU path, seeded and
    batch-independent; ``test_map`` on the 5000-image pool; the reward and
    test CLIs end to end on YOLO-format files;
  * the estimator path (every family card against CPU, the SGD kernel, the
    offline chain of CLIs);
  * the hidden-stage path: ``dump_features`` of a seeded YOLOv5n over the
    256 images (stages 9, 17, 20 and 23, 840 MB of maps) with four images
    against a CPU run, ``roi_resize_batch`` on the card against the CPU
    (max bit-equal, avg 1e-6) with its time against its bytes bound, the
    chain detection -> labels -> reward -> split -> regression (the CNN on
    stage 23 RoI-pooled to 8) -> test through the CLIs, the label CLI on a
    synthetic 5,000-image COCO tree and a VOC tree, and the COCO evaluator
    (greedy card against CPU bit for bit, and the COCOeval style);
  * training: YOLOv5n (80 classes, 640) and SSDLite320 (21 classes) at
    batch 32, f32 and bf16 (one step against the CPU's from the same
    weights, the step's stages timed, 30 steps on a fixed batch with the
    loss falling), the train CLI over the 256 images with seeded labels
    (--preset yolo --augment yolo --ema) to a checkpoint the detect CLI
    serves, and the training engine's ``evaluate`` on the card against the
    CPU through the suppressor and gather kernels, whose launches there
    the kernel record carries as ``train_eval_launches``;
  * training of the frozen-norm families: RetinaNet and Faster R-CNN
    (ResNet-50-FPN-v2, 21 classes, 640, batch 4), f32 and bf16 (one step
    against the CPU's at 256 from the same weights and sampling draws,
    every loss part and the update held to recorded limits with a TF32
    control; the step's stages timed; 20 steps on a fixed batch with the
    loss falling; Faster R-CNN's proposals in the step, kernel against
    plain, and its kernels' launches a step), and the train CLI of each to
    a checkpoint the detect CLI serves and ``evaluate`` runs through the
    kernels (their launches added to ``train_eval_launches``; the
    sequential suppressor's and the gather's records gain their launches a
    train step and their times at the step's shapes beside their bounds).

Before the serving paths, each kernel is held against its plain version
bit for bit and timed (``kernel_ms`` looped, ``device_ms`` from a CUDA
graph, ``host_us`` the wrapper's host cost): the monolithic and the blocked
suppressor on fuzz regimes and edge cases (one image to 200, all-invalid
images, holes, thr = 0, < 0 and 1, exact IoU ties, ragged K), the
sequential suppressor at the RPN's shape and on its own edge cases (sticky
picks, thr >= 1, thr < 0, a NaN thr, caps of 0, 1 and 7, dead segments,
ragged K) and above K = 1024 (its literal-loop kernel at K = 1025 to
12,000), the batched suppressor's K > 2048 route (the global fixpoint on the
card, equal to the CPU's), and the row gather against ``torch.gather``
(times the scale) at YOLOv5's and Faster R-CNN's shapes. The YOLOv5, SSDLite and RetinaNet tails
run the row-gather kernel too.

Each path's launch counts are set to 0 just before it runs and read just
after. Every phase prints one line; any failure exits non-zero. The last
lines are the kernels' JSON record, the card's name and power limit as
nvidia-smi reports them, and the result:

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

``python3 chip_smoke.py --kernels-only`` stops after the kernel phases (the
build and every kernel against its plain version, with their times), then
times the monolithic and the sequential suppressor on the inputs their main
paths give them (the YOLOv5n tail and the Faster R-CNN RPN segments, from
the serving phases' seeds), and prints ``{"ok": true, "kernels_only":
true}`` instead of the result: the quick loop while a kernel is being
worked on, and the run that compares a parent commit's kernels (its tree
with this script) with the change's in one call.

Imports torch, numpy, the standard library and ``edgeml_tpu_torch`` only.
Scratch files go to ``.smoke_tmp/`` beside this script and are removed.
"""

import contextlib
import copy
import io
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_F32_OPS = 67e12  # non-tensor f32 FLOP/s, H100 SXM data sheet
H100_BYTES = 3.35e12  # HBM3 bytes/s
OPS_PER_PAIR = 15  # IoU + compare per (suppressor, target) pair, as in the kernel
OPS_PER_BOX = 5  # area per box
# sequential suppressor, per live candidate per step: IoU + compare (15) and
# the argmax's compare and select (2)
OPS_PER_LIVE = 17
BATCH = 64
N_IMAGES = 256
RETINA_BATCH = 16
RETINA_IMAGES = 64
BLOCKED_KS = (1280, 1536, 2048)
SHAPES = [(480, 640), (640, 427), (640, 640), (500, 375)]
SEQ_SEGMENTS = 80  # 16 images x 5 RPN levels
SEQ_K = 1000  # proposals per level entering the RPN suppressor
FRCNN_BATCH = 16
FRCNN_IMAGES = 64


def line(tag, **kw):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, iters, warmup=2):
    """Mean device milliseconds of fn() over iters launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, reps=5):
    """Device milliseconds of one fn() with the host out of the way: iters
    calls are captured into one CUDA graph (fn must be warm: built, its
    inputs resident) and the graph is replayed reps times between two
    events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def host_us(fn, iters=200, reps=5):
    """Host microseconds the caller spends in one fn(): the wall clock
    around a loop with no synchronisation inside (checks, allocation and
    the launch call; the device runs behind), the least of reps loops (the
    host's cores are shared: a neighbour's burst lengthens a loop, nothing
    shortens one)."""
    import torch

    for _ in range(3):
        fn()
    best = math.inf
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / iters * 1e6


def gflop_per_image(net, x):
    """Forward GFLOP (2 per multiply-add) of one image through ``net``, as
    torch's FlopCounterMode counts them from the shapes."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        net(x[:1])
    return fc.get_total_flops() / 1e9


def suppressor_bound_ms(boxes, scores):
    """Least time for the greedy mask on these inputs: each input byte read
    once and each output byte written once over the HBM rate, against the
    f32 operations the data needs (every pair of valid candidates, plus box
    areas) over the non-tensor f32 rate. Returns (ms, "bytes"|"operations")."""
    b, k, _ = boxes.shape
    v = (scores > 0).sum(dim=1).double()
    pairs = float((v * (v - 1) / 2).sum())
    ops = OPS_PER_PAIR * pairs + OPS_PER_BOX * b * k
    nbytes = b * k * 16 + b * k + b * k  # f32 boxes + bool valid + bool out
    t_ops, t_bytes = ops / H100_F32_OPS, nbytes / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def fuzz(seed, b, k, spread, ncls, max_wh):
    """Fuzz regimes of the reference's suppressor tests: sorted scores with
    a gated-out tail, class offsets applied."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(20, 20 + spread, (b, k, 2)).astype(np.float32)
    wh = rng.uniform(30, 150, (b, k, 2)).astype(np.float32)
    scores = np.sort(rng.random((b, k)).astype(np.float32),
                     axis=-1)[:, ::-1].copy()
    scores[scores < 0.05] = 0.0
    cls = rng.integers(0, ncls, (b, k)).astype(np.float32)
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], axis=-1)
    return (boxes + cls[..., None] * np.float32(max_wh)).astype(np.float32), \
        scores


def seq_candidates(seed, s, k, regime):
    """Unsorted candidates of positive area over s segments for the
    sequential suppressor: dense RPN-like overlap, sparse boxes, or tie
    clusters of sigmoid scores saturated to exactly 1.0; a fifth dead."""
    rng = np.random.default_rng(seed)
    spread = {"dense": 120.0, "sparse": 2000.0, "ties": 300.0}[regime]
    c = rng.uniform(0, spread, (s, k, 2))
    wh = rng.uniform(8, 150, (s, k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if regime == "ties":
        logits = rng.choice([30.0, 30.0, 2.0, 0.5, -3.0], (s, k))
        scores = (1 / (1 + np.exp(-logits))).astype(np.float32)
    else:
        scores = rng.random((s, k)).astype(np.float32)
    scores[rng.random((s, k)) < 0.2] = 0.0
    return boxes, scores


def seq_bound_ms(boxes, scores, picks, thr):
    """Least time for the sequential suppressor on these inputs: the bytes
    (boxes and scores read once, kept and picks written once) over the HBM
    rate, against the f32 operations this data needs over the non-tensor
    f32 rate: OPS_PER_LIVE for every (step, candidate still live at that
    step) and the areas. A candidate is live from step 0 up to the step
    that picks or suppresses it. Returns (ms, "bytes"|"operations", live
    pairs, picks, most picks of a segment)."""
    import torch

    s_, k = scores.shape
    p = picks.shape[1]
    n_picks = (picks >= 0).sum(dim=1)
    pb = boxes.gather(1, picks.clamp_min(0).long()[..., None].expand(
        s_, p, 4))  # (S, P, 4)
    x1, y1, x2, y2 = (boxes[:, None, :, i] for i in range(4))
    area = (x2 - x1) * (y2 - y1)
    px1, py1, px2, py2 = (pb[:, :, None, i] for i in range(4))
    parea = (px2 - px1) * (py2 - py1)
    inter = torch.clamp_min(torch.minimum(px2, x2) - torch.maximum(px1, x1),
                            0) * torch.clamp_min(
        torch.minimum(py2, y2) - torch.maximum(py1, y1), 0)
    iou = inter / torch.clamp_min(parea + area - inter, 1e-12)
    step = torch.arange(p, device=boxes.device)
    lane = torch.arange(k, device=boxes.device)
    done = (step[None, :] < n_picks[:, None])[..., None]  # (S, P, 1)
    hit = ((iou > thr) | (picks.long()[..., None] == lane)) & done
    # live steps: up to and including the first hit, else every step
    first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + 1,
                        n_picks[:, None].expand(s_, k))
    live = float(torch.where(scores > 0, first, 0).sum())
    ops = OPS_PER_LIVE * live + OPS_PER_BOX * s_ * k
    nbytes = s_ * k * (16 + 4 + 1) + s_ * p * 4
    t_ops, t_bytes = ops / H100_F32_OPS, nbytes / H100_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", int(live),
            int(n_picks.sum()), int(n_picks.max()))


def gather_bound_ms(src, idx, scale, out):
    """Least time for the row gather: the distinct source rows (and scales)
    it needs and the indices read once, the output written once, over the
    HBM rate (a multiply per element at most: bytes bound it)."""
    import torch

    b = idx.shape[0]
    rows = sum(int(torch.unique(idx[i]).numel()) for i in range(b))
    nbytes = rows * src.shape[2] * src.element_size() \
        + idx.numel() * idx.element_size() \
        + out.numel() * out.element_size() \
        + (0 if scale is None else rows * scale.element_size())
    return nbytes / H100_BYTES * 1e3, "bytes"


def seeded_yolov5(variant, seed, calib, device):
    """YOLOv5 (80 classes, 640) at full width with weights from a seeded
    generator, BatchNorm statistics taken from one calibration batch (so
    activations stay near unit scale through the random trunk) and
    detect-head weights and biases spread from the seed, so that many candidates pass conf_thres 0.001 and
    overlapping same-class boxes really get suppressed."""
    import torch
    import torch.nn.functional as F

    from edgeml_tpu_torch.models.common import ConvBN
    from edgeml_tpu_torch.models.yolov5 import YoloV5

    g = torch.Generator().manual_seed(seed)
    net = YoloV5(variant=variant, num_classes=80, img_size=640,
                 generator=g).to(device)

    def take_stats(mod, args):
        (x,) = args
        y = F.conv2d(x, mod.conv.weight, None, mod.conv.stride,
                     mod.conv.padding)
        mod.bn.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        mod.bn.running_var.copy_(y.var(dim=(0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(take_stats)
             for m in net.modules() if isinstance(m, ConvBN)]
    with torch.no_grad():
        net.predict(calib)
    for h in hooks:
        h.remove()
    na, no = net.na, net.no
    with torch.no_grad():
        for conv in net.model[24].m:
            conv.weight.mul_(3.0)
            b = torch.zeros(na, no)
            b[:, 0:4] = torch.randn(na, 4, generator=g) * 0.5
            b[:, 4] = torch.empty(na).uniform_(-3.5, -0.5, generator=g)
            b[:, 5:] = torch.empty(na, no - 5).uniform_(-5.0, -1.0,
                                                        generator=g)
            conv.bias.copy_(b.reshape(-1).to(device))
    return net


def seeded_ssdlite(seed, calib, device):
    """SSDLite320-MobileNetV3-Large (full tail, 91 classes, 320) at full
    width with weights from a seeded generator, BatchNorm statistics taken
    from one calibration batch, and head biases spread from the seed (a few
    dominant classes, so overlapping same-class candidates get
    suppressed)."""
    import torch
    import torch.nn.functional as F

    from edgeml_tpu_torch.models.common import ConvNormAct
    from edgeml_tpu_torch.models.ssdlite import SSDLite

    g = torch.Generator().manual_seed(seed)
    net = SSDLite(num_classes=91, image_size=320, generator=g).to(device)

    def take_stats(mod, args):
        (x,) = args
        conv, bn = mod[0], mod[1]
        y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding, 1,
                     conv.groups)
        bn.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(
            y.var(dim=(0, 2, 3), unbiased=False).clamp_min(1e-3))

    hooks = [m.register_forward_pre_hook(take_stats)
             for m in net.modules() if isinstance(m, ConvNormAct)]
    with torch.no_grad():
        net(calib)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        cls_bias = torch.empty(91).uniform_(-4.0, 2.0, generator=g)
        for mod in net.head.classification_head.module_list:
            mod[1].bias.copy_(cls_bias.repeat(6).to(device))
        for mod in net.head.regression_head.module_list:
            mod[1].bias.copy_((torch.randn(24, generator=g) * 0.3).to(device))
    return net


def seeded_retinanet(seed, calib, device):
    """RetinaNet-ResNet50-FPN-v2 (91 classes, 640) at full width with
    weights from a seeded generator, frozen BatchNorm statistics taken from
    one calibration batch, and class-logit biases spread around the
    focal-loss prior per class."""
    import torch

    from edgeml_tpu_torch.models.common import FrozenBatchNorm2d
    from edgeml_tpu_torch.models.retinanet import RetinaNet

    g = torch.Generator().manual_seed(seed)
    net = RetinaNet(num_classes=91, image_size=640, generator=g).to(device)

    def take_stats(mod, args):
        (x,) = args
        mod.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.running_var.copy_(
            x.var(dim=(0, 2, 3), unbiased=False).clamp_min(1e-3))

    hooks = [m.register_forward_pre_hook(take_stats)
             for m in net.modules() if isinstance(m, FrozenBatchNorm2d)]
    with torch.no_grad():
        net(calib)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        prior = -math.log((1 - 0.01) / 0.01)
        cls_bias = prior + torch.empty(91).uniform_(-2.0, 2.0, generator=g)
        net.head.classification_head.cls_logits.bias.copy_(
            cls_bias.repeat(9).to(device))
        net.head.regression_head.bbox_reg.bias.copy_(
            (torch.randn(36, generator=g) * 0.2).to(device))
    return net


def seeded_faster_rcnn(seed, calib, device):
    """Faster R-CNN-ResNet50-FPN-v2 (91 classes, 640, 1000 proposals, 100
    detections) at full width with weights from a seeded generator, the
    BatchNorm statistics of the body, the FPN and the box head taken from
    one calibration batch (so activations stay near unit scale and the RPN
    proposals and box scores are real), and the box predictor's biases
    spread from the seed."""
    import torch
    import torch.nn.functional as F

    from edgeml_tpu_torch.models.common import ConvNormAct, FrozenBatchNorm2d
    from edgeml_tpu_torch.models.faster_rcnn import FasterRCNN

    g = torch.Generator().manual_seed(seed)
    net = FasterRCNN(num_classes=91, image_size=640, generator=g).to(device)

    def set_stats(bn, y):
        bn.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(
            y.var(dim=(0, 2, 3), unbiased=False).clamp_min(1e-3))

    def frozen_stats(mod, args):
        set_stats(mod, args[0])

    def conv_norm_stats(mod, args):
        conv = mod[0]
        set_stats(mod[1], F.conv2d(args[0], conv.weight, None, conv.stride,
                                   conv.padding, 1, conv.groups))

    hooks = [m.register_forward_pre_hook(frozen_stats)
             for m in net.modules() if isinstance(m, FrozenBatchNorm2d)]
    hooks += [m.register_forward_pre_hook(conv_norm_stats)
              for m in net.modules() if isinstance(m, ConvNormAct)]
    net.detect(calib)
    for h in hooks:
        h.remove()
    with torch.no_grad():
        pred = net.roi_heads.box_predictor
        pred.cls_score.bias.copy_(
            torch.empty(91).uniform_(-2.0, 2.0, generator=g).to(device))
        pred.bbox_pred.bias.copy_(
            (torch.randn(364, generator=g) * 0.1).to(device))
    return net


class plain_kernels:
    """Within the block, the Faster R-CNN path and the NMS tail call the
    plain versions instead of the kernels (module attributes swapped and
    restored), so one run of each can be compared on the same inputs."""

    def __enter__(self):
        from edgeml_tpu_torch.models import faster_rcnn as tfr
        from edgeml_tpu_torch.ops import nms
        from edgeml_tpu_torch.ops.gather import gather_rows_plain
        from edgeml_tpu_torch.ops.nms_fused import (
            MAX_K, greedy_keep_mask_blocked_plain, greedy_keep_mask_plain,
        )
        from edgeml_tpu_torch.ops.nms_seq import suppress_mask_seq_plain

        def fused_plain(boxes, scores, iou_thres):
            if boxes.shape[1] <= MAX_K:
                return greedy_keep_mask_plain(boxes, scores, iou_thres)
            return greedy_keep_mask_blocked_plain(boxes, scores, iou_thres)

        self.saved = []
        for mod, name, fn in ((tfr, "gather_rows", gather_rows_plain),
                              (tfr, "suppress_mask_seq",
                               suppress_mask_seq_plain),
                              (nms, "gather_rows", gather_rows_plain),
                              (nms, "greedy_keep_mask_fused", fused_plain)):
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def make_images(img_dir, seed, n=N_IMAGES):
    rng = np.random.default_rng(seed)
    os.makedirs(img_dir)
    shapes = []
    for i in range(n):
        h, w = SHAPES[i % len(SHAPES)]
        # smooth-ish content: a coarse random field upsampled, plus noise
        coarse = rng.random((h // 32 + 1, w // 32 + 1, 3))
        img = np.repeat(np.repeat(coarse, 32, 0), 32, 1)[:h, :w]
        img = np.clip(img * 200 + rng.normal(0, 20, (h, w, 3)), 0, 255)
        np.save(os.path.join(img_dir, f"img{i:04d}.npy"), img.astype(np.uint8))
        shapes.append((h, w))
    return shapes


def check_files(out_dir, shapes, nc, conf_thres):
    n_rows = 0
    for i in range(len(shapes)):
        path = os.path.join(out_dir, f"img{i:04d}.npy")
        if not os.path.isfile(path):
            fail(f"missing detection file {path}")
        rows = np.load(path)
        if rows.ndim != 2 or rows.shape[1] != 6 or rows.dtype != np.float32:
            fail(f"{path}: bad rows {rows.shape} {rows.dtype}")
        if not np.isfinite(rows).all():
            fail(f"{path}: non-finite values")
        cls = rows[:, 0]
        if np.any(cls != np.round(cls)) or np.any((cls < 0) | (cls >= nc)):
            fail(f"{path}: class out of range")
        if np.any((rows[:, 1:5] < 0) | (rows[:, 1:5] > 1)):
            fail(f"{path}: xywh outside [0, 1]")
        if np.any(np.diff(rows[:, 5]) > 0) or np.any(rows[:, 5] <= conf_thres):
            fail(f"{path}: conf not descending above the threshold")
        n_rows += rows.shape[0]
    if len(os.listdir(out_dir)) != len(shapes):
        fail(f"{out_dir}: {len(os.listdir(out_dir))} files for "
             f"{len(shapes)} images")
    return n_rows


CPU_SUITE_TOL = 1e-4  # the CPU tests' bound: 1e-4 of each output's max
# Faster R-CNN's RPN outputs on the card: 1.41e-4 of the smallest output's
# largest value at batch 1 and 1.49e-4 at batch 16 on an NVIDIA H100 (f32
# convolutions summed in another order than the CPU's through ResNet-50 and
# the FPN, whichever algorithm cuDNN picks, or with cuDNN off), so the card
# holds them to 3e-4 (PERF.md, "Card tolerances")
FRCNN_RPN_CARD_TOL = 3e-4


def outputs_vs_cpu(tag, got, ref, old_abs=None, tol=CPU_SUITE_TOL, **kw):
    """The card's outputs against the CPU's on the same input: each
    output's largest absolute error over its largest absolute value must
    stay below tol (the CPU suite's bound unless the card's own is stated),
    and (old_abs) below the absolute bound the check had before. Prints
    both errors; returns the relative one."""
    errs, rels = [], []
    for a, b in zip(got, ref):
        a, b = a.float().cpu(), b.float().cpu()
        e = float((a - b).abs().max())
        m = float(b.abs().max())
        errs.append(e)
        rels.append(e / m if m > 0 else e)
    err, rel = max(errs), max(rels)
    line(tag, outputs=len(errs), max_abs_err=f"{err:.3e}",
         max_rel_err=f"{rel:.3e}",
         tol=f"{tol:g} x each output's max"
         + ("" if old_abs is None else f" and {old_abs:g} abs"), **kw)
    if not (rel < tol and (old_abs is None or err < old_abs)):
        fail(f"{tag}: the card's f32 outputs disagree with the CPU's "
             f"(relative {rel:.3e}, absolute {err:.3e})")
    return rel


# run_detection's files, card against CPU. The CPU suite's "same rows, conf
# 1e-5, boxes 1e-4 px" does not hold on the card: heads that differ by
# 1e-5 to 1.5e-4 of their largest values reorder near-equal confidences and
# flip decisions at the conf threshold, the NMS IoU threshold and the
# max_det cut (PERF.md, "Card tolerances"). So rows are paired by class,
# conf within FILE_PAIR_CONF and box within FILE_PAIR_PX, and the paired
# rows' conf and box errors and the share of rows left unpaired are held to
# the card's tolerances below.
FILE_PAIR_CONF = 1e-3
FILE_PAIR_PX = 1.0
FILE_CONF_TOL = 1e-4
FILE_BOX_TOL_PX = 0.1
FILE_UNPAIRED_TOL = 0.05


def pair_rows(a, b, hw):
    """Pair the rows of two detection files (cls, x, y, w, h, conf;
    normalised xywh of an image of size hw) one to one: each row of a, in
    order, takes the unpaired row of b of its class with the least box
    error in pixels, if its conf is within FILE_PAIR_CONF and its box
    within FILE_PAIR_PX. Returns (pairs, max conf error, max box error in
    pixels over the pairs)."""
    h, w = hw
    scale = np.array([w, h, w, h], np.float64)
    free = np.ones(len(b), bool)
    pairs, conf_err, box_err = 0, 0.0, 0.0
    for row in a:
        cand = np.nonzero(free & (b[:, 0] == row[0])
                          & (np.abs(b[:, 5] - row[5]) <= FILE_PAIR_CONF))[0]
        if cand.size == 0:
            continue
        px = (np.abs(b[cand, 1:5] - row[1:5]) * scale).max(axis=1)
        j = int(np.argmin(px))
        if px[j] > FILE_PAIR_PX:
            continue
        free[cand[j]] = False
        pairs += 1
        conf_err = max(conf_err, float(abs(b[cand[j], 5] - row[5])))
        box_err = max(box_err, float(px[j]))
    return pairs, conf_err, box_err


def files_vs_cpu(tag, net, img_dir, shapes, tmp, n_img=4, **kw):
    """run_detection over the first n_img images on the card and on the CPU
    (a copy of the net): files written for the same images, with the same
    rows up to the card's rounding (see FILE_* above). Prints how many
    images have the very same rows in the same order, the rows paired, and
    the paired rows' largest conf and box errors."""
    names = sorted(os.listdir(img_dir))[:n_img]
    sub = os.path.join(tmp, f"{tag}_images")
    os.makedirs(sub)
    for n in names:
        shutil.copy(os.path.join(img_dir, n), sub)
    out_g, out_c = (os.path.join(tmp, f"{tag}_{d}") for d in ("card", "cpu"))
    run_detection_on(net, sub, out_g, "cuda", **kw)
    run_detection_on(copy.deepcopy(net).cpu(), sub, out_c, "cpu", **kw)
    same = rows = unpaired = 0
    conf_err = box_err = 0.0
    for i, n in enumerate(names):
        a = np.load(os.path.join(out_g, n))
        b = np.load(os.path.join(out_c, n))
        if a.shape == b.shape and np.array_equal(a[:, 0], b[:, 0]) and \
                np.abs(a[:, 5] - b[:, 5]).max(initial=0) <= FILE_CONF_TOL:
            same += 1
        pairs, ce, be = pair_rows(a, b, shapes[i])
        rows += max(len(a), len(b))
        unpaired += max(len(a), len(b)) - pairs
        conf_err, box_err = max(conf_err, ce), max(box_err, be)
    share = unpaired / max(rows, 1)
    line(f"{tag}_files_vs_cpu", images=n_img, same_rows_images=same,
         rows=rows, unpaired=unpaired, unpaired_share=f"{share:.4f}",
         max_conf_err=f"{conf_err:.3e}", max_box_err_px=f"{box_err:.3e}",
         tol=f"unpaired {FILE_UNPAIRED_TOL:g}, conf {FILE_CONF_TOL:g}, "
             f"box {FILE_BOX_TOL_PX:g} px")
    if not (rows > 0 and share <= FILE_UNPAIRED_TOL
            and conf_err <= FILE_CONF_TOL and box_err <= FILE_BOX_TOL_PX):
        fail(f"{tag}: run_detection's files on the card disagree with the "
             f"CPU's")


def run_detection_on(net, img_dir, out_dir, device, **kw):
    from edgeml_tpu_torch.models.infer import run_detection

    run_detection(net, img_dir, out_dir, device=device, **kw)


def main(kernels_only=False):
    import torch

    start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    from edgeml_tpu_torch import _build
    from edgeml_tpu_torch.models.infer import exact_f32_cuda
    from edgeml_tpu_torch.ops import nms
    from edgeml_tpu_torch.ops.nms_fused import (
        greedy_keep_mask_cuda, greedy_keep_mask_fused, greedy_keep_mask_plain,
    )

    dev = torch.device("cuda")
    exact_f32_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- phase 1: device and build (one nvcc per source, in parallel) -----
    t0 = time.perf_counter()
    _build.build(["nms_fused", "nms_blocked", "nms_seq", "gather_rows",
                  "sgd_scan"])
    build_s = time.perf_counter() - t0
    line("device", name=repr(kind), count=count, smi=repr(smi),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc_build_s=f"{build_s:.2f}")

    # ---- phase 2: monolithic kernel against its plain version, K=1024 -----
    occupancy("nms_fused", 4)
    for seed, spread, ncls in [(0, 80.0, 1), (1, 300.0, 4), (2, 2000.0, 80)]:
        for thr in (0.6, 0.45):
            off, sc = fuzz(seed, 128, 1024, spread, ncls, nms.MAX_WH)
            boxes = torch.from_numpy(off).to(dev)
            scores = torch.from_numpy(sc).to(dev)
            got = greedy_keep_mask_fused(boxes, scores, thr)
            torch.cuda.synchronize()
            want = greedy_keep_mask_plain(boxes, scores, thr)
            if not torch.equal(got, want):
                fail(f"kernel != plain (seed {seed}, thr {thr}): "
                     f"{int((got != want).sum())} entries differ")
            valid = (scores > 0).contiguous()

            def run():
                return greedy_keep_mask_cuda(boxes, valid, thr)

            k_ms = cuda_ms(lambda: greedy_keep_mask_fused(boxes, scores, thr),
                           20)
            p_ms = cuda_ms(lambda: greedy_keep_mask_plain(boxes, scores, thr),
                           3, warmup=1)
            bound, by = suppressor_bound_ms(boxes, scores)
            line("kernel_vs_plain", regime=f"{seed}/{spread}/{ncls}",
                 thr=thr, batch=128, equal=True, kept=int(got.sum()),
                 valid=int((scores > 0).sum()), kernel_ms=f"{k_ms:.4f}",
                 device_ms=f"{device_ms(run):.4f}",
                 host_us=f"{host_us(run, 50):.1f}", plain_ms=f"{p_ms:.3f}",
                 bound_ms=f"{bound:.4f}", bound_by=by)
    fused_edge_phase(dev)

    blocked_phase(dev)
    torch.cuda.empty_cache()

    seq_phase(dev)
    large_k_route_phase(dev)
    gather_record = gather_phase(dev)
    torch.cuda.empty_cache()
    if kernels_only:
        mainpath_kernel_phase(dev)
        print(smi, flush=True)
        print(json.dumps({"ok": True, "kernels_only": True}), flush=True)
        return

    tmp = os.path.join(ROOT, ".smoke_tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        img_dir = os.path.join(tmp, "images")
        shapes = make_images(img_dir, seed=0)
        records = [serving_phases(dev, tmp, img_dir, shapes),
                   ssd_phases(dev, tmp, img_dir, shapes)]
        resize_phase(dev, tmp, img_dir)
        retina_phases(dev, tmp, img_dir, shapes)
        records += frcnn_phases(dev, tmp, img_dir, shapes, gather_record)
        reward_phases(dev, tmp)
        records.append(estimator_phases(dev, tmp))
        hidden_phases(dev, tmp, img_dir)
        train_launches = train_phases(dev, tmp, img_dir, shapes)
        frozen_launches, step_fields = frozen_train_phases(dev, tmp, img_dir,
                                                           shapes)
        for rec in records:
            rec["train_eval_launches"] = train_launches.get(rec["name"], 0) \
                + frozen_launches.get(rec["name"], 0)
            rec.update(step_fields.get(rec["name"], {}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line("wall", script_s=f"{time.perf_counter() - start:.1f}")
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


def occupancy(name, blocks):
    """Print how many clusters of a suppressor kernel the card holds at
    once."""
    from edgeml_tpu_torch.ops import nms_fused

    n = nms_fused.max_active_clusters(name) \
        if hasattr(nms_fused, "max_active_clusters") else "not queried"
    line("occupancy", kernel=name, blocks_per_cluster=blocks,
         max_active_clusters=n)


def fused_edge_phase(dev):
    """Phase 2, equality only: the monolithic kernel against the global and
    the blocked plain versions on one image and on 200 (more than the card
    holds clusters at once), an all-invalid image, invalid holes and whole
    invalid leading bands, thr = 0.0, -0.5 and 1.0, IoUs exactly at the
    threshold, and ragged K (1, 33, 257)."""
    import torch

    from edgeml_tpu_torch.ops import nms
    from edgeml_tpu_torch.ops.nms_fused import (
        greedy_keep_mask_blocked_plain, greedy_keep_mask_cuda,
        greedy_keep_mask_fused, greedy_keep_mask_plain,
    )

    cases = []
    for b in (1, 200):
        cases.append((f"batch{b}", *fuzz(b, b, 1024, 300.0, 4, nms.MAX_WH),
                      0.6))
    off, sc = fuzz(7, 16, 1024, 300.0, 4, nms.MAX_WH)
    sc[0] = 0.0  # an all-invalid image
    sc[1, 200:300] = 0.0  # a hole across the first band's edge
    sc[2, 5] = 0.0
    sc[3, :600] = 0.0  # the first two bands invalid
    sc[4, 1:] = 0.0  # one valid candidate
    for thr in (0.6, 0.0, -0.5, 1.0):
        cases.append(("holes", off, sc, thr))
    rng = np.random.default_rng(5)
    xy = rng.integers(0, 24, (16, 1024, 2))
    grid = np.concatenate([xy, xy + rng.integers(1, 13, xy.shape)],
                          axis=-1).astype(np.float32)
    for thr in (0.6, float(np.float32(1) / np.float32(3))):
        cases.append(("ties", grid, fuzz(5, 16, 1024, 300.0, 1,
                                         nms.MAX_WH)[1], thr))
    for k in (1, 33, 257):
        cases.append((f"k{k}", *fuzz(k, 16, k, 300.0, 4, nms.MAX_WH), 0.6))
    for tag, off, sc, thr in cases:
        boxes = torch.from_numpy(off).to(dev)
        scores = torch.from_numpy(sc).to(dev)
        before = greedy_keep_mask_cuda.launches
        got = greedy_keep_mask_fused(boxes, scores, thr)
        torch.cuda.synchronize()
        if greedy_keep_mask_cuda.launches != before + 1:
            fail(f"fused edge {tag}: the monolithic kernel did not launch")
        if not (torch.equal(got, greedy_keep_mask_plain(boxes, scores, thr))
                and torch.equal(got, greedy_keep_mask_blocked_plain(
                    boxes, scores, thr))):
            fail(f"monolithic kernel != plain ({tag}, thr {thr})")
        line("kernel_vs_plain", regime=tag, thr=thr, batch=scores.shape[0],
             k=scores.shape[1], equal=True, kept=int(got.sum()),
             valid=int((scores > 0).sum()))


def blocked_case(dev, tag, off, sc, thr, timed=True, check_global=False):
    """One case of phase 2b: the blocked kernel through the entry point
    against the blocked plain version on the same inputs, bit for bit, and
    (timed) its looped, device-only and host times."""
    import torch

    from edgeml_tpu_torch.ops.nms_fused import (
        greedy_keep_mask_blocked_cuda, greedy_keep_mask_blocked_plain,
        greedy_keep_mask_fused, greedy_keep_mask_plain,
    )

    boxes = torch.from_numpy(off).to(dev)
    scores = torch.from_numpy(sc).to(dev)
    b, k = scores.shape
    before = greedy_keep_mask_blocked_cuda.launches
    got = greedy_keep_mask_fused(boxes, scores, thr)
    torch.cuda.synchronize()
    if greedy_keep_mask_blocked_cuda.launches != before + 1:
        fail(f"{tag}: K = {k} did not launch the blocked kernel")
    want = greedy_keep_mask_blocked_plain(boxes, scores, thr)
    if not torch.equal(got, want):
        fail(f"blocked kernel != plain ({tag}, B {b}, K {k}, thr {thr}): "
             f"{int((got != want).sum())} entries differ")
    if check_global and not torch.equal(
            got, greedy_keep_mask_plain(boxes, scores, thr)):
        fail(f"blocked kernel != global plain ({tag})")
    kw = {}
    if timed:
        valid = (scores > 0).contiguous()

        def run():
            return greedy_keep_mask_blocked_cuda(boxes, valid, thr)

        k_ms = cuda_ms(lambda: greedy_keep_mask_fused(boxes, scores, thr), 20)
        p_ms = cuda_ms(lambda: greedy_keep_mask_blocked_plain(boxes, scores,
                                                              thr), 3,
                       warmup=1)
        bound, by = suppressor_bound_ms(boxes, scores)
        kw = dict(kernel_ms=f"{k_ms:.4f}", device_ms=f"{device_ms(run):.4f}",
                  host_us=f"{host_us(run, 50):.1f}", plain_ms=f"{p_ms:.3f}",
                  bound_ms=f"{bound:.4f}", bound_by=by)
    line("blocked_vs_plain", k=k, regime=tag, thr=thr, batch=b, equal=True,
         kept=int(got.sum()), valid=int((scores > 0).sum()), **kw)


def blocked_phase(dev):
    """Phase 2b: the blocked kernel against its plain versions. Timed: B =
    64 at three K, three regimes and two thresholds, and B = 16 (the
    RetinaNet / Faster R-CNN batch) at K = 2048. Equality only: B = 1 and
    B = 200 (more images than the card holds at once), an all-invalid
    image, invalid holes inside the valid prefix, thr = 0.0 and a negative
    threshold, IoUs exactly at the threshold, and ragged last bands and
    words (K = 1025, 1537, 2047)."""
    from edgeml_tpu_torch.ops import nms

    occupancy("nms_blocked", 8)
    regimes = [(0, 80.0, 1), (1, 300.0, 4), (2, 2000.0, 80)]
    for k in BLOCKED_KS:
        for seed, spread, ncls in regimes:
            for thr in (0.6, 0.45):
                off, sc = fuzz(seed + k, BATCH, k, spread, ncls, nms.MAX_WH)
                blocked_case(dev, f"{seed}/{spread}/{ncls}", off, sc, thr,
                             check_global=k == 2048)
    for seed, spread, ncls in regimes:
        off, sc = fuzz(seed + 16, RETINA_BATCH, 2048, spread, ncls,
                       nms.MAX_WH)
        blocked_case(dev, f"{seed}/{spread}/{ncls}", off, sc, 0.6)
    for b in (1, 200):
        off, sc = fuzz(b, b, 2048, 300.0, 4, nms.MAX_WH)
        blocked_case(dev, f"batch{b}", off, sc, 0.6, timed=False)
    off, sc = fuzz(7, RETINA_BATCH, 2048, 300.0, 4, nms.MAX_WH)
    sc[0] = 0.0  # an all-invalid image
    sc[1, 100:300] = 0.0  # a hole across the first band's edge
    sc[2, 5] = 0.0
    sc[2, 1000:1100] = 0.0
    sc[3, :600] = 0.0  # the first two bands invalid
    sc[4, 1:] = 0.0  # one valid candidate
    blocked_case(dev, "holes", off, sc, 0.6, timed=False, check_global=True)
    for thr in (0.0, -0.5):
        # thr = 0: any overlap suppresses; below 0 disjoint pairs do too
        blocked_case(dev, "holes", off, sc, thr, timed=False,
                     check_global=True)
    # integer-cornered boxes of one class on a small grid: many pairs have
    # exactly the threshold's IoU (0.6f = 6/10, 1/3), which must not suppress
    rng = np.random.default_rng(5)
    xy = rng.integers(0, 24, (RETINA_BATCH, 2048, 2))
    grid = np.concatenate([xy, xy + rng.integers(1, 13, xy.shape)],
                          axis=-1).astype(np.float32)
    _, sc = fuzz(5, RETINA_BATCH, 2048, 300.0, 1, nms.MAX_WH)
    for thr in (0.6, float(np.float32(1) / np.float32(3))):
        blocked_case(dev, "ties", grid, sc, thr, timed=False,
                     check_global=True)
    for k in (1025, 1537, 2047):
        for seed, spread, ncls in regimes[:2]:
            off, sc = fuzz(seed + k, RETINA_BATCH, k, spread, ncls,
                           nms.MAX_WH)
            blocked_case(dev, f"{seed}/{spread}/{ncls}", off, sc, 0.6,
                         timed=False, check_global=True)


def _wrappers():
    from edgeml_tpu_torch.ops.gather import gather_rows_cuda
    from edgeml_tpu_torch.ops.nms_fused import (
        greedy_keep_mask_blocked_cuda, greedy_keep_mask_cuda,
    )
    from edgeml_tpu_torch.ops.nms_seq import suppress_mask_seq_cuda
    from edgeml_tpu_torch.ops.sgd import sgd_fit_cuda

    return (greedy_keep_mask_cuda, greedy_keep_mask_blocked_cuda,
            suppress_mask_seq_cuda, gather_rows_cuda, sgd_fit_cuda)


def reset_counts():
    for w in _wrappers():
        w.launches = 0


def counts():
    """(monolithic, blocked, sequential, gather) kernel launches since
    reset_counts(): the detection kernels."""
    return tuple(w.launches for w in _wrappers()[:4])


def sgd_launches():
    """SGD scan kernel launches since reset_counts()."""
    return _wrappers()[4].launches


def traced(tag, run):
    """Run ``run()`` under torch.profiler: wall, device-busy time, idle
    share and the largest device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    line(tag, wall_ms=f"{wall_ms:.1f}", device_busy_ms=f"{busy_ms:.1f}",
         idle_share=f"{1 - busy_ms / wall_ms:.3f}",
         top=repr([(e.key[:40], round(e.self_device_time_total / 1e3, 1))
                   for e in top]))
    if busy_ms <= 0:
        fail(f"{tag}: the profiler saw no device time in the traced run")


def serving_phases(dev, tmp, img_dir, shapes):
    """Phases 3-5: YOLOv5n serving in f32 and bf16, a traced run, the kernel
    and plain tails on the same trunk outputs, and YOLOv5m. Returns the
    monolithic suppressor kernel's JSON record."""
    import torch

    from edgeml_tpu_torch.data.loader import decode_image
    from edgeml_tpu_torch.models.common import letterbox_batch
    from edgeml_tpu_torch.models.infer import (
        _nms_unmap, detect_batch, run_detection,
    )
    from edgeml_tpu_torch.ops import nms
    from edgeml_tpu_torch.ops.nms_fused import (
        greedy_keep_mask_cuda, greedy_keep_mask_plain,
    )

    names = sorted(os.listdir(img_dir))
    first = [decode_image(os.path.join(img_dir, n)) for n in names[:BATCH]]
    lb, meta = letterbox_batch(first, 640)
    hw = np.array([im.shape[:2] for im in first], np.float32)
    x = torch.from_numpy(lb).to(dev)
    meta_t = torch.from_numpy(meta).to(dev)
    hw_t = torch.from_numpy(hw).to(dev)
    net = seeded_yolov5("n", 1, x[:16], dev)
    conf, iou = 0.001, 0.6

    # a small-input reference: the card's f32 trunk against the CPU's
    cpu_net = copy.deepcopy(net).cpu()
    ref = cpu_net.predict(x[:2].cpu())
    got = net.predict(x[:2])
    err_s = max(float((a.cpu() - b).abs().max())
                for a, b in zip(got[::2], ref[::2]))
    err_b = float((got[1].cpu() - ref[1]).abs().max())
    outputs_vs_cpu("trunk_vs_cpu", got, ref, images=2,
                   max_score_err=f"{err_s:.3e}", max_box_err_px=f"{err_b:.3e}",
                   old_tol="scores 1e-3, boxes 0.5 px")
    if not (err_s < 1e-3 and err_b < 0.5):
        fail("f32 trunk on the card disagrees with the CPU")
    del cpu_net, ref

    # warm-up: cuDNN algorithm choice and the first launches
    for dtype in (None, torch.bfloat16):
        detect_batch(net, x, meta_t, hw_t, conf, iou, dtype=dtype)
    torch.cuda.synchronize()

    # host side of one batch, one thread (run_detection spreads decode and
    # letterbox over 4 worker threads; the rest runs on the main thread)
    t0 = time.perf_counter()
    imgs = [decode_image(os.path.join(img_dir, n)) for n in names[:BATCH]]
    t1 = time.perf_counter()
    lb2, _ = letterbox_batch(imgs, 640)
    t2 = time.perf_counter()
    x2 = torch.from_numpy(lb2).to(dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    dets, valid = detect_batch(net, x2, meta_t, hw_t, conf, iou)
    dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
    t4 = time.perf_counter()
    save_dir = os.path.join(tmp, "save_probe")
    os.makedirs(save_dir)
    for bi in range(BATCH):
        np.save(os.path.join(save_dir, f"{bi}.npy"), dets[bi][valid[bi]])
    t5 = time.perf_counter()
    del x2, imgs, lb2
    line("host_batch_f32", batch=BATCH, decode_ms=f"{(t1 - t0) * 1e3:.1f}",
         letterbox_ms=f"{(t2 - t1) * 1e3:.1f}",
         h2d_ms=f"{(t3 - t2) * 1e3:.1f}",
         device_and_d2h_ms=f"{(t4 - t3) * 1e3:.1f}",
         save_ms=f"{(t5 - t4) * 1e3:.1f}")

    runs = {}
    n_batches = math.ceil(N_IMAGES / BATCH)
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        out_dir = os.path.join(tmp, f"dets_{label}")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        run_detection(net, img_dir, out_dir, batch_size=BATCH,
                      conf_thres=conf, iou_thres=iou, dtype=dtype,
                      device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, blocked, seq, gathers = counts()
        if (launches, blocked, seq, gathers) != (n_batches, 0, 0,
                                                 3 * n_batches):
            fail(f"{label}: kernels launched {launches} + {blocked} + {seq} "
                 f"+ {gathers} times for {n_batches} batches (want "
                 f"{n_batches} + 0 + 0 + {3 * n_batches})")
        # scores are compared with the threshold in their own dtype
        conf_t = float(torch.tensor(conf, dtype=dtype or torch.float32))
        n_rows = check_files(out_dir, shapes, 80, conf_t)
        peak = torch.cuda.max_memory_allocated() / 2**30
        dev_ms = cuda_ms(lambda: detect_batch(net, x, meta_t, hw_t, conf, iou,
                                              dtype=dtype), 10)
        pred = net.predict(x, dtype=dtype)
        trunk_ms = cuda_ms(lambda: net.predict(x, dtype=dtype), 10)
        tail_ms = cuda_ms(lambda: _nms_unmap(pred, meta_t, hw_t, conf, iou),
                          10)
        runs[label] = launches
        line(f"serve_{label}", images=N_IMAGES, batch=BATCH, files=N_IMAGES,
             rows=n_rows, launches=launches, e2e_img_s=f"{N_IMAGES / wall:.1f}",
             device_img_s=f"{BATCH / dev_ms * 1e3:.1f}",
             device_batch_ms=f"{dev_ms:.3f}", trunk_ms=f"{trunk_ms:.3f}",
             tail_ms=f"{tail_ms:.3f}", peak_gib=f"{peak:.2f}")

    # a separate traced f32 run: device busy time by kernel and idle share
    traced("trace_f32", lambda: run_detection(
        net, img_dir, os.path.join(tmp, "dets_traced"), batch_size=BATCH,
        conf_thres=conf, iou_thres=iou, device="cuda"))
    files_vs_cpu("yolov5n", net, img_dir, shapes, tmp, batch_size=4,
                 conf_thres=conf, iou_thres=iou)

    # the same trunk outputs through the kernel tail and the plain tail
    obj, xywh, cls = net.predict(x)
    cand, top, ci = nms.candidates(obj, xywh, cls, conf, 1024)
    off = (cand + ci[..., None] * nms.MAX_WH).contiguous()
    d_k, v_k = nms._emit_batch(cand, top, ci, iou, 300)
    kept_k = greedy_keep_mask_cuda(off, (top > 0).contiguous(), iou)
    kept_p = greedy_keep_mask_plain(off, top, iou)
    d_p, v_p = nms._compact(cand, top, ci, kept_p, 300)
    if not (torch.equal(d_k, d_p) and torch.equal(v_k, v_p)):
        fail("kernel tail and plain tail disagree on the same trunk outputs")
    n_valid = int((top > 0).sum())
    n_kept = int(kept_p.sum())
    if not (n_valid >= BATCH * 256 and n_kept < n_valid):
        fail(f"degenerate workload: {n_valid} candidates, {n_kept} kept")
    err = int((kept_k.int() - kept_p.int()).abs().max())
    valid = (top > 0).contiguous()

    def run():
        return greedy_keep_mask_cuda(off, valid, iou)

    k_ms = cuda_ms(run, 50)
    p_ms = cuda_ms(lambda: greedy_keep_mask_plain(off, top, iou), 5,
                   warmup=1)
    bound, by = suppressor_bound_ms(off, top)
    line("tail_kernel_vs_plain", batch=BATCH, k=1024, dets_equal=True,
         candidates=n_valid, kept=n_kept, rows=int(v_k.sum()),
         kernel_ms=f"{k_ms:.4f}", device_ms=f"{device_ms(run):.4f}",
         host_us=f"{host_us(run, 50):.1f}", plain_ms=f"{p_ms:.3f}",
         bound_ms=f"{bound:.4f}", bound_by=by)
    del net, pred, obj, xywh, cls

    # the strong detector through the same code: one device-resident batch
    net_m = seeded_yolov5("m", 2, x[:16], dev)
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        dets, valid = detect_batch(net_m, x, meta_t, hw_t, conf, iou,
                                   dtype=dtype)
        if not (torch.isfinite(dets).all() and int(valid.sum()) > 0):
            fail(f"yolov5m {label}: no finite detections")
        dev_ms = cuda_ms(lambda: detect_batch(net_m, x, meta_t, hw_t, conf,
                                              iou, dtype=dtype), 5)
        line(f"yolov5m_{label}", batch=BATCH, rows=int(valid.sum()),
             device_batch_ms=f"{dev_ms:.3f}",
             device_img_s=f"{BATCH / dev_ms * 1e3:.1f}")
    return {
        "name": "nms_fused_greedy_keep",
        "route": "cuda",
        "source": "edgeml_tpu_torch/csrc/nms_fused.cu",
        "replaces": "edgeml_tpu/ops/nms_fused.py:35",
        "launches": runs["f32"],
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }


def blocked_tail_check(tag, obj, xywh, scores, conf, iou):
    """The same head outputs through the blocked kernel's tail and the
    plain tail: dets bit-equal, every image with K = 2048 real candidates,
    some suppressed. Returns (max_abs_err, kernel ms, plain ms, bound ms,
    bound_by) of the suppressor at this shape."""
    import torch

    from edgeml_tpu_torch.ops import nms
    from edgeml_tpu_torch.ops.nms_fused import (
        greedy_keep_mask_blocked_cuda, greedy_keep_mask_blocked_plain,
    )

    cand, top, ci = nms.candidates(obj, xywh, scores, conf, 2048)
    if top.shape[1] != 2048 or not bool((top > 0).all()):
        fail(f"{tag}: not every image has K = 2048 real candidates")
    off = (cand + ci[..., None] * nms.MAX_WH).contiguous()
    valid = (top > 0).contiguous()
    d_k, v_k = nms._emit_batch(cand, top, ci, iou, 300)
    kept_k = greedy_keep_mask_blocked_cuda(off, valid, iou)
    kept_p = greedy_keep_mask_blocked_plain(off, top, iou)
    d_p, v_p = nms._compact(cand, top, ci, kept_p, 300)
    if not (torch.equal(d_k, d_p) and torch.equal(v_k, v_p)
            and torch.equal(kept_k, kept_p)):
        fail(f"{tag}: kernel tail and plain tail disagree on the same head "
             f"outputs")
    n_valid = int(valid.sum())
    n_kept = int(kept_p.sum())
    if n_kept >= n_valid:
        fail(f"{tag}: degenerate workload, nothing suppressed")
    err = int((kept_k.int() - kept_p.int()).abs().max())
    k_ms = cuda_ms(lambda: greedy_keep_mask_blocked_cuda(off, valid, iou), 50)
    p_ms = cuda_ms(lambda: greedy_keep_mask_blocked_plain(off, top, iou), 3,
                   warmup=1)
    bound, by = suppressor_bound_ms(off, top)
    line(tag, batch=top.shape[0], k=2048, dets_equal=True,
         candidates=n_valid, kept=n_kept, rows=int(v_k.sum()),
         kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.3f}",
         bound_ms=f"{bound:.4f}", bound_by=by)
    return err, k_ms, p_ms, bound, by


def ssd_phases(dev, tmp, img_dir, shapes):
    """Phases 6-7: SSDLite320 serving in f32 and bf16 with the COCO -> 80
    class map, a traced run, and the blocked kernel's tail against the
    plain tail on the same head outputs. Returns the blocked kernel's JSON
    record."""
    import torch

    from edgeml_tpu_torch.data.coco_labelmap import coco_to_yolov5
    from edgeml_tpu_torch.data.loader import decode_image
    from edgeml_tpu_torch.models.infer import (
        _detect_generic, map_classes, run_detection, square_batch,
    )
    from edgeml_tpu_torch.models.ssd_loss import (
        ssd_nms_inputs, ssd_postprocess,
    )

    names = sorted(os.listdir(img_dir))
    first = [decode_image(os.path.join(img_dir, n)) for n in names[:BATCH]]
    x = torch.from_numpy(square_batch(first, 320)).to(dev)
    net = seeded_ssdlite(3, x[:16], dev)
    anchors = net.anchors(dev)
    conf, iou = 0.001, 0.6

    # a small-input reference: the card's f32 heads against the CPU's
    cpu_net = copy.deepcopy(net).cpu()
    with torch.no_grad():
        ref = cpu_net(x[:2].cpu())
        got = net(x[:2])
    outputs_vs_cpu("ssd_heads_vs_cpu", got, ref, old_abs=1e-3, images=2)
    del cpu_net, ref

    for dtype in (None, torch.bfloat16):  # warm-up
        _detect_generic(net, x, conf, iou, dtype=dtype)
    torch.cuda.synchronize()

    # host side of one batch, one thread (run_detection spreads decode and
    # resize over 4 worker threads; the rest runs on the main thread)
    t0 = time.perf_counter()
    imgs = [decode_image(os.path.join(img_dir, n)) for n in names[:BATCH]]
    t1 = time.perf_counter()
    arr = square_batch(imgs, 320)
    t2 = time.perf_counter()
    x2 = torch.from_numpy(arr).to(dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    dets, valid = _detect_generic(net, x2, conf, iou)
    dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
    t4 = time.perf_counter()
    save_dir = os.path.join(tmp, "ssd_save_probe")
    os.makedirs(save_dir)
    for bi in range(BATCH):
        np.save(os.path.join(save_dir, f"{bi}.npy"),
                map_classes(dets[bi][valid[bi]], coco_to_yolov5))
    t5 = time.perf_counter()
    del x2, imgs, arr
    line("ssd_host_batch_f32", batch=BATCH,
         decode_ms=f"{(t1 - t0) * 1e3:.1f}",
         resize_ms=f"{(t2 - t1) * 1e3:.1f}", h2d_ms=f"{(t3 - t2) * 1e3:.1f}",
         device_and_d2h_ms=f"{(t4 - t3) * 1e3:.1f}",
         save_ms=f"{(t5 - t4) * 1e3:.1f}")

    n_batches = math.ceil(N_IMAGES / BATCH)
    launches = {}
    gflop = gflop_per_image(net, x)
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        out_dir = os.path.join(tmp, f"ssd_{label}")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        run_detection(net, img_dir, out_dir, batch_size=BATCH,
                      conf_thres=conf, iou_thres=iou,
                      class_map=coco_to_yolov5, dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mono, blocked, seq, gathers = counts()
        if (mono, blocked, seq, gathers) != (0, n_batches, 0,
                                             3 * n_batches):
            fail(f"ssd {label}: kernels launched {mono} + {blocked} + {seq} "
                 f"+ {gathers} times for {n_batches} batches")
        launches[label] = blocked
        n_rows = check_files(out_dir, shapes, 80, conf)
        peak = torch.cuda.max_memory_allocated() / 2**30
        xd = x if dtype is None else x.to(dtype)
        dev_ms = cuda_ms(lambda: _detect_generic(net, x, conf, iou,
                                                 dtype=dtype), 10)
        with torch.no_grad():
            trunk_ms = cuda_ms(lambda: net(xd), 10)
            c, r = net(xd)
        c, r = c.to(torch.float32), r.to(torch.float32)
        tail_ms = cuda_ms(lambda: ssd_postprocess(net, c, r, anchors, conf,
                                                  iou), 10)
        line(f"ssd_serve_{label}", images=N_IMAGES, batch=BATCH,
             files=N_IMAGES, rows=n_rows, launches=blocked,
             e2e_img_s=f"{N_IMAGES / wall:.1f}",
             device_img_s=f"{BATCH / dev_ms * 1e3:.1f}",
             device_batch_ms=f"{dev_ms:.3f}", trunk_ms=f"{trunk_ms:.3f}",
             trunk_gflop_per_img=f"{gflop:.3f}",
             trunk_tflop_s=f"{gflop * BATCH / trunk_ms:.2f}",
             tail_ms=f"{tail_ms:.3f}", peak_gib=f"{peak:.2f}")

    traced("ssd_trace_f32", lambda: run_detection(
        net, img_dir, os.path.join(tmp, "ssd_traced"), batch_size=BATCH,
        conf_thres=conf, iou_thres=iou, class_map=coco_to_yolov5,
        device="cuda"))
    files_vs_cpu("ssd", net, img_dir, shapes, tmp, batch_size=4,
                 conf_thres=conf, iou_thres=iou, class_map=coco_to_yolov5)

    with torch.no_grad():
        c, r = net(x)
    err, k_ms, p_ms, bound, by = blocked_tail_check(
        "ssd_tail_kernel_vs_plain", *ssd_nms_inputs(net, c, r, anchors),
        conf, iou)
    return {
        "name": "nms_blocked_greedy_keep",
        "route": "cuda",
        "source": "edgeml_tpu_torch/csrc/nms_blocked.cu",
        "replaces": "edgeml_tpu/ops/nms_fused.py:81",
        "launches": launches["f32"],
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }


def retina_phases(dev, tmp, img_dir, shapes):
    """Phase 8: RetinaNet-ResNet50-FPN-v2 serving over RETINA_IMAGES images
    in f32, one device-resident batch timed in f32 and bf16, and the blocked
    kernel's tail against the plain tail on the same head outputs."""
    import torch

    from edgeml_tpu_torch.data.coco_labelmap import coco_to_yolov5
    from edgeml_tpu_torch.data.loader import decode_image
    from edgeml_tpu_torch.models.infer import (
        _detect_generic, run_detection, square_batch,
    )
    from edgeml_tpu_torch.models.retinanet import (
        retina_nms_inputs, retina_postprocess,
    )

    names = sorted(os.listdir(img_dir))[:RETINA_IMAGES]
    sub_dir = os.path.join(tmp, "images_retina")
    os.makedirs(sub_dir)
    for n in names:
        shutil.copy(os.path.join(img_dir, n), sub_dir)
    first = [decode_image(os.path.join(img_dir, n))
             for n in names[:RETINA_BATCH]]
    x = torch.from_numpy(square_batch(first, 640)).to(dev)
    net = seeded_retinanet(4, x, dev)
    anchors = net.anchors(dev)
    conf, iou = 0.001, 0.6

    cpu_net = copy.deepcopy(net).cpu()
    with torch.no_grad():
        ref = cpu_net(x[:1].cpu())
        got = net(x[:1])
    outputs_vs_cpu("retina_heads_vs_cpu", got, ref, images=1,
                   old_abs=1e-3 * max(float(t.abs().max()) for t in ref))
    del cpu_net, ref

    _detect_generic(net, x, conf, iou)  # warm-up
    torch.cuda.synchronize()
    n_batches = math.ceil(RETINA_IMAGES / RETINA_BATCH)
    out_dir = os.path.join(tmp, "retina_f32")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run_detection(net, sub_dir, out_dir, batch_size=RETINA_BATCH,
                  conf_thres=conf, iou_thres=iou, class_map=coco_to_yolov5,
                  device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mono, blocked, seq, gathers = counts()
    if (mono, blocked, seq, gathers) != (0, n_batches, 0, 3 * n_batches):
        fail(f"retinanet: kernels launched {mono} + {blocked} + {seq} + "
             f"{gathers} times for {n_batches} batches")
    n_rows = check_files(out_dir, shapes[:RETINA_IMAGES], 80, conf)
    peak = torch.cuda.max_memory_allocated() / 2**30
    line("retina_serve_f32", images=RETINA_IMAGES, batch=RETINA_BATCH,
         files=RETINA_IMAGES, rows=n_rows, launches=blocked,
         e2e_img_s=f"{RETINA_IMAGES / wall:.1f}", peak_gib=f"{peak:.2f}")
    files_vs_cpu("retina", net, img_dir, shapes, tmp, batch_size=4,
                 conf_thres=conf, iou_thres=iou, class_map=coco_to_yolov5)

    gflop = gflop_per_image(net, x)
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        dets, valid = _detect_generic(net, x, conf, iou, dtype=dtype)
        if not (torch.isfinite(dets).all() and int(valid.sum()) > 0):
            fail(f"retinanet {label}: no finite detections")
        xd = x if dtype is None else x.to(dtype)
        dev_ms = cuda_ms(lambda: _detect_generic(net, x, conf, iou,
                                                 dtype=dtype), 5)
        with torch.no_grad():
            trunk_ms = cuda_ms(lambda: net(xd), 5)
            c, r = net(xd)
        tail_ms = cuda_ms(lambda: retina_postprocess(net, c, r, anchors,
                                                     conf, iou), 10)
        line(f"retina_device_{label}", batch=RETINA_BATCH,
             rows=int(valid.sum()), device_batch_ms=f"{dev_ms:.3f}",
             device_img_s=f"{RETINA_BATCH / dev_ms * 1e3:.1f}",
             trunk_ms=f"{trunk_ms:.3f}", trunk_gflop_per_img=f"{gflop:.3f}",
             trunk_tflop_s=f"{gflop * RETINA_BATCH / trunk_ms:.2f}",
             tail_ms=f"{tail_ms:.3f}")

    with torch.no_grad():
        c, r = net(x)
    blocked_tail_check("retina_tail_kernel_vs_plain",
                       *retina_nms_inputs(net, c, r, anchors, conf), conf,
                       iou)


def yolo_tail_inputs(net, x, conf):
    """The monolithic suppressor's inputs on the YOLOv5 main path for the
    letterboxed batch x: class-offset boxes (B, 1024, 4) and scores."""
    from edgeml_tpu_torch.ops import nms

    obj, xywh, cls = net.predict(x)
    cand, top, ci = nms.candidates(obj, xywh, cls, conf, 1024)
    return (cand + ci[..., None] * nms.MAX_WH).contiguous(), top


def rpn_segments(net, x):
    """The sequential suppressor's arguments (boxes, scores, thr, max_keep)
    on the Faster R-CNN main path for the batch x, recorded at the call."""
    import torch

    from edgeml_tpu_torch.models import faster_rcnn as tfr

    seen = {}
    real = tfr.suppress_mask_seq

    def recording(*args):
        seen["args"] = args
        return real(*args)

    tfr.suppress_mask_seq = recording
    try:
        with torch.no_grad():
            net.proposals(*net.run_rpn(net.features(x)))
    finally:
        tfr.suppress_mask_seq = real
    return seen["args"]


def mainpath_kernel_phase(dev):
    """Phase 2e (``--kernels-only``): the monolithic and the sequential
    suppressor on the inputs their main paths give them, from the same
    seeds as the serving phases (YOLOv5n tail, B = 64, K = 1024; Faster
    R-CNN RPN segments of one batch of 16), each against its plain version,
    with its looped, device-only and host times."""
    import torch

    from edgeml_tpu_torch.data.loader import decode_image
    from edgeml_tpu_torch.models.common import letterbox_batch
    from edgeml_tpu_torch.models.infer import square_batch
    from edgeml_tpu_torch.ops.nms_fused import (
        greedy_keep_mask_cuda, greedy_keep_mask_plain,
    )
    from edgeml_tpu_torch.ops.nms_seq import (
        suppress_mask_seq_cuda, suppress_mask_seq_plain,
    )

    tmp = os.path.join(ROOT, ".smoke_tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        img_dir = os.path.join(tmp, "images")
        make_images(img_dir, seed=0, n=BATCH)
        names = sorted(os.listdir(img_dir))
        imgs = [decode_image(os.path.join(img_dir, n)) for n in names]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    x = torch.from_numpy(letterbox_batch(imgs, 640)[0]).to(dev)
    net = seeded_yolov5("n", 1, x[:16], dev)
    with torch.no_grad():
        off, top = yolo_tail_inputs(net, x, 0.001)
    del net, x
    valid = (top > 0).contiguous()

    def fused():
        return greedy_keep_mask_cuda(off, valid, 0.6)

    got = fused()
    if not torch.equal(got, greedy_keep_mask_plain(off, top, 0.6)):
        fail("YOLOv5n tail: monolithic kernel != plain")
    bound, by = suppressor_bound_ms(off, top)
    line("mainpath_kernel", kernel="nms_fused", shape="yolov5n_tail",
         batch=BATCH, k=1024, equal=True, candidates=int(valid.sum()),
         kept=int(got.sum()), kernel_ms=f"{cuda_ms(fused, 50):.4f}",
         device_ms=f"{device_ms(fused):.4f}",
         host_us=f"{host_us(fused, 50):.1f}", bound_ms=f"{bound:.4f}",
         bound_by=by)
    del off, top, valid, got

    x = torch.from_numpy(square_batch(imgs[:FRCNN_BATCH], 640)).to(dev)
    net = seeded_faster_rcnn(5, x, dev)
    boxes, scores, thr, max_keep = rpn_segments(net, x)
    del net, x
    torch.cuda.empty_cache()

    def seq():
        return suppress_mask_seq_cuda(boxes, scores, thr, max_keep)

    kept, picks = seq()
    p_kept, p_picks = suppress_mask_seq_plain(boxes, scores, thr, max_keep)
    if not (torch.equal(kept, p_kept) and torch.equal(picks, p_picks)):
        fail("Faster R-CNN RPN segments: sequential kernel != plain")
    bound, by, live, n_picks, most = seq_bound_ms(boxes, scores, picks, thr)
    line("mainpath_kernel", kernel="nms_seq", shape="frcnn_rpn",
         segments=scores.shape[0], k=scores.shape[1], thr=thr, equal=True,
         candidates=int((scores > 0).sum()), picks=n_picks, most_picks=most,
         kernel_ms=f"{cuda_ms(seq, 20):.4f}", device_ms=f"{device_ms(seq):.4f}",
         host_us=f"{host_us(seq, 50):.1f}", bound_ms=f"{bound:.4f}",
         bound_by=by)


def seq_phase(dev):
    """Phase 2c: the sequential suppressor against its plain version and
    the fixpoint ``suppress_mask`` at the RPN's shape (80 segments = 16
    images x 5 levels, K = 1000) in three regimes, at IoU 0.7 and 0.5."""
    import torch

    from edgeml_tpu_torch.ops import nms
    from edgeml_tpu_torch.ops.nms_seq import (
        suppress_mask_seq, suppress_mask_seq_cuda, suppress_mask_seq_plain,
    )

    occupancy("nms_seq", 4)
    for ri, regime in enumerate(("dense", "sparse", "ties")):
        bx, sc = seq_candidates(ri, SEQ_SEGMENTS, SEQ_K, regime)
        boxes = torch.from_numpy(bx).to(dev)
        scores = torch.from_numpy(sc).to(dev)
        for thr in (0.7, 0.5):
            before = suppress_mask_seq_cuda.launches
            kept, picks = suppress_mask_seq(boxes, scores, thr, SEQ_K)
            torch.cuda.synchronize()
            if suppress_mask_seq_cuda.launches != before + 1:
                fail("the sequential suppressor kernel did not launch")
            p_kept, p_picks = suppress_mask_seq_plain(boxes, scores, thr,
                                                      SEQ_K)
            if not (torch.equal(kept, p_kept) and torch.equal(picks,
                                                              p_picks)):
                fail(f"sequential kernel != plain ({regime}, thr {thr}): "
                     f"{int((kept != p_kept).sum())} mask entries, "
                     f"{int((picks != p_picks).sum())} picks differ")
            if not torch.equal(kept, nms.suppress_mask(boxes, scores, thr,
                                                       SEQ_K)):
                fail(f"sequential kernel != fixpoint suppress_mask "
                     f"({regime}, thr {thr})")

            def run():
                return suppress_mask_seq_cuda(boxes, scores, thr, SEQ_K)

            k_ms = cuda_ms(run, 20)
            p_ms = cuda_ms(lambda: suppress_mask_seq_plain(boxes, scores,
                                                           thr, SEQ_K), 2,
                           warmup=1)
            bound, by, live, n_picks, most = seq_bound_ms(boxes, scores,
                                                          picks, thr)
            line("seq_vs_plain", regime=regime, thr=thr,
                 segments=SEQ_SEGMENTS, k=SEQ_K, equal=True,
                 valid=int((scores > 0).sum()), kept=int(kept.sum()),
                 picks=n_picks, most_picks=most, live_pairs=live,
                 kernel_ms=f"{k_ms:.4f}", device_ms=f"{device_ms(run):.4f}",
                 host_us=f"{host_us(run, 50):.1f}", plain_ms=f"{p_ms:.3f}",
                 bound_ms=f"{bound:.4f}", bound_by=by)
        del boxes, scores, kept, picks, p_kept, p_picks
    seq_edge_phase(dev)
    seq_wide_phase(dev)


def seq_edge_phase(dev):
    """Phase 2c, equality only: the sequential kernel's kept and picks
    against the plain loop's on sticky picks (boxes of zero width, zero
    height and x2 < x1, never removed by themselves: picked at every
    remaining step), thr = 1.0 and 1.5 (every box sticky), thr = 0.0, -0.5
    and NaN (every pair suppresses), caps of 0, 1 and 7, all-dead segments,
    candidates already in key order (the RPN's case), one segment and 200
    (more than the card holds clusters at once), and ragged K (1, 33,
    257)."""
    import torch

    from edgeml_tpu_torch.ops.nms_seq import (
        suppress_mask_seq, suppress_mask_seq_cuda, suppress_mask_seq_plain,
    )

    bx, sc = seq_candidates(3, SEQ_SEGMENTS, SEQ_K, "dense")
    rng = np.random.default_rng(4)
    sticky, sticky_sc = bx.copy(), sc.copy()
    for seg in range(SEQ_SEGMENTS):
        hit = rng.choice(SEQ_K, 12, replace=False)
        sticky[seg, hit[:4], 2] = sticky[seg, hit[:4], 0]
        sticky[seg, hit[4:8], 3] = sticky[seg, hit[4:8], 1]
        sticky[seg, hit[8:], 0] = bx[seg, hit[8:], 2]
        sticky[seg, hit[8:], 2] = bx[seg, hit[8:], 0]
        sticky_sc[seg, hit[::3]] = np.float32(0.999)  # picked early
    dead = sc.copy()
    dead[::3] = 0.0
    # a top-k's order with saturated ties (in index order) and dead
    # candidates in between, as the RPN gives them
    tb, ts = seq_candidates(5, SEQ_SEGMENTS, SEQ_K, "ties")
    presorted = -np.sort(-ts, axis=1)
    presorted[ts <= 0] = 0.0
    cases = [("sticky", sticky, sticky_sc, 0.7, SEQ_K),
             ("sticky", sticky, sticky_sc, 0.7, 50)]
    cases += [("thr", bx, sc, thr, SEQ_K)
              for thr in (1.0, 1.5, 0.0, -0.5, float("nan"))]
    cases += [("cap", bx, sc, 0.7, m) for m in (0, 1, 7)]
    cases.append(("dead", bx, dead, 0.7, SEQ_K))
    cases.append(("presorted", tb, presorted, 0.7, SEQ_K))
    for s in (1, 200):
        cases.append((f"segments{s}", *seq_candidates(s, s, SEQ_K, "ties"),
                      0.7, SEQ_K))
    for k in (1, 33, 257):
        cases.append((f"k{k}", *seq_candidates(k, 16, k, "dense"), 0.5, k))
    for tag, b, s_, thr, max_keep in cases:
        boxes = torch.from_numpy(b).to(dev)
        scores = torch.from_numpy(s_).to(dev)
        before = suppress_mask_seq_cuda.launches
        kept, picks = suppress_mask_seq(boxes, scores, thr, max_keep)
        torch.cuda.synchronize()
        if suppress_mask_seq_cuda.launches != before + 1:
            fail(f"seq edge {tag}: the sequential kernel did not launch")
        p_kept, p_picks = suppress_mask_seq_plain(boxes, scores, thr,
                                                  max_keep)
        if not (torch.equal(kept, p_kept) and torch.equal(picks, p_picks)):
            fail(f"sequential kernel != plain ({tag}, thr {thr}, max_keep "
                 f"{max_keep}): {int((kept != p_kept).sum())} mask entries, "
                 f"{int((picks != p_picks).sum())} picks differ")
        line("seq_vs_plain", regime=tag, thr=thr, segments=scores.shape[0],
             k=scores.shape[1], max_keep=max_keep, equal=True,
             kept=int(kept.sum()), picks=int((picks >= 0).sum()))


def seq_wide_phase(dev):
    """Phase 2c, K above the cluster kernel's 1024: the literal-loop kernel
    (``seq_wide_kernel``, one block of 1024 threads per segment, boxes in
    shared memory up to 10,240 candidates, in global memory above) against
    the plain loop, kept and picks bit for bit, at K = 1025, 2000 and 4096
    and at 12,000 (global memory), with thresholds 0.7, 0.5, NaN and 1.0
    (sticky), caps of 10 to K, and its device time and bound."""
    import torch

    from edgeml_tpu_torch.ops.nms_seq import (
        suppress_mask_seq, suppress_mask_seq_plain,
        suppress_mask_seq_wide_cuda,
    )

    cases = [(1025, 16, "dense", 0.7, 1025), (1025, 16, "ties", 0.5, 300),
             (2000, 16, "dense", 0.7, 2000), (2000, 16, "sparse", 0.7, 300),
             (2000, 16, "ties", float("nan"), 10),
             (4096, 8, "dense", 0.7, 4096), (4096, 8, "sparse", 0.5, 1000),
             (4096, 8, "ties", 1.0, 50), (12000, 2, "dense", 0.7, 12000)]
    for k, segs, regime, thr, max_keep in cases:
        bx, sc = seq_candidates(k + segs, segs, k, regime)
        boxes = torch.from_numpy(bx).to(dev)
        scores = torch.from_numpy(sc).to(dev)
        before = suppress_mask_seq_wide_cuda.launches
        kept, picks = suppress_mask_seq(boxes, scores, thr, max_keep)
        torch.cuda.synchronize()
        if suppress_mask_seq_wide_cuda.launches != before + 1:
            fail(f"seq wide K = {k}: the literal-loop kernel did not launch")
        p_kept, p_picks = suppress_mask_seq_plain(boxes, scores, thr,
                                                  max_keep)
        if not (torch.equal(kept, p_kept) and torch.equal(picks, p_picks)):
            fail(f"wide sequential kernel != plain (K {k}, {regime}, thr "
                 f"{thr}, max_keep {max_keep}): "
                 f"{int((kept != p_kept).sum())} mask entries, "
                 f"{int((picks != p_picks).sum())} picks differ")

        def run():
            return suppress_mask_seq_wide_cuda(boxes, scores, thr, max_keep)

        n_picks = (picks >= 0).sum(dim=1)
        kw = {}
        if thr == thr and k <= 4096:  # the bound's IoU matrix is (S, P, K)
            bound, by, live, _, _ = seq_bound_ms(boxes, scores, picks, thr)
            kw = dict(live_pairs=live, bound_ms=f"{bound:.4f}", bound_by=by)
        line("seq_wide_vs_plain", k=k, segments=segs, regime=regime, thr=thr,
             max_keep=max_keep, equal=True, kept=int(kept.sum()),
             picks=int(n_picks.sum()), most_picks=int(n_picks.max()),
             device_ms=f"{device_ms(run, iters=3, reps=3):.4f}", **kw)
        del boxes, scores, kept, picks, p_kept, p_picks


def large_k_route_phase(dev):
    """Phase 2f: above K = 2048 the batched suppressor's dispatcher takes the
    global fixpoint on the card (``greedy_keep_mask_global``, chosen by K as
    the reference chooses its XLA fixpoint): ``nms_split_batch`` and
    ``nms_rows`` at max_cand 4096 equal to the CPU's, the route's counter
    moved and no suppressor kernel launched."""
    import torch

    from edgeml_tpu_torch.ops import nms

    rng = np.random.default_rng(4096)
    b, n, nc = 4, 6000, 4
    obj = rng.random((b, n)).astype(np.float32)
    xywh = np.stack([rng.uniform(50, 600, (b, n)),
                     rng.uniform(50, 600, (b, n)),
                     rng.uniform(5, 80, (b, n)), rng.uniform(5, 80, (b, n))],
                    -1).astype(np.float32)
    cls = (rng.random((b, n, nc)) ** 4).astype(np.float32)
    boxes = np.concatenate([xywh[..., :2] - xywh[..., 2:] / 2,
                            xywh[..., :2] + xywh[..., 2:] / 2], -1)
    scores = obj.copy()
    scores[rng.random((b, n)) < 0.1] = 0.0
    ids = rng.integers(0, 6, (b, n)).astype(np.float32)
    for tag, fn, args in (
            ("nms_split_batch", lambda *a: nms.nms_split_batch(
                *a, conf_thres=1e-3, iou_thres=0.6, max_cand=4096),
             (obj, xywh, cls)),
            ("nms_rows", lambda *a: nms.nms_rows(*a, iou_thres=0.5,
                                                 max_cand=4096),
             (boxes, scores, ids))):
        ts = [torch.from_numpy(a) for a in args]
        reset_counts()
        before = nms.greedy_keep_mask_global.launches
        d, v = fn(*[t.to(dev) for t in ts])
        torch.cuda.synchronize()
        mono, blocked, seq, _ = counts()
        if nms.greedy_keep_mask_global.launches != before + 1 or mono \
                or blocked or seq:
            fail(f"{tag} at max_cand 4096: the K > 2048 route did not run")
        d_cpu, v_cpu = fn(*ts)
        if not (torch.equal(d.cpu(), d_cpu) and torch.equal(v.cpu(), v_cpu)):
            fail(f"{tag} at max_cand 4096: card != CPU")
        line("large_k_route", call=tag, batch=b, k=4096, equal_cpu=True,
             rows=int(v.sum()), route_calls=1)


def gather_phase(dev):
    """Phase 2d: the row gather against its plain version (``torch.gather``,
    times the scale), bit for bit, at YOLOv5's tail (B = 64, N = 25,200,
    C = 80, K = 1024, scaled, f32 and bf16), Faster R-CNN's ``nms_rows``
    gather (B = 16, N = 90,000, C = 4, K = 2048), the same from a source
    view offset by one element (rows not 16-byte aligned) and its class-id
    gather (C = 1). Each with the looped time, the device time alone and the
    host time per call, beside ``torch.gather``'s. Returns the kernel's
    record at the Faster R-CNN shape (its launches filled in later)."""
    import torch

    from edgeml_tpu_torch.ops.gather import (
        gather_rows, gather_rows_cuda, gather_rows_plain,
    )

    record = None
    rng = np.random.default_rng(11)
    for tag, b, n, c, k, dtype, scaled, offset in (
            ("yolo_f32", 64, 25200, 80, 1024, torch.float32, True, 0),
            ("yolo_bf16", 64, 25200, 80, 1024, torch.bfloat16, True, 0),
            ("frcnn_rows", 16, 90000, 4, 2048, torch.float32, False, 0),
            ("frcnn_rows_offset", 16, 90000, 4, 2048, torch.float32, False,
             1),
            ("frcnn_cls", 16, 90000, 1, 2048, torch.float32, False, 0)):
        flat = torch.from_numpy(rng.random(b * n * c + offset,
                                           np.float32)).to(dev, dtype)
        src = flat[offset:].view(b, n, c)
        idx = torch.from_numpy(rng.integers(0, n, (b, k))).to(dev)
        scale = torch.from_numpy(rng.random((b, n), np.float32)).to(
            dev, dtype) if scaled else None
        before = gather_rows_cuda.launches
        got = gather_rows(src, idx, scale)
        torch.cuda.synchronize()
        if gather_rows_cuda.launches != before + 1:
            fail(f"gather {tag}: the kernel did not launch")
        want = gather_rows_plain(src, idx, scale)
        if not (got.dtype == want.dtype and torch.equal(got, want)):
            fail(f"gather {tag}: kernel != plain")
        err = float((got.float() - want.float()).abs().max())
        full = idx[..., None].expand(b, k, c)

        def run():
            return gather_rows_cuda(src, idx, scale)

        def lib():
            return torch.gather(src, 1, full)

        # 500 calls a loop: these take microseconds, and one host hiccup
        # of a millisecond would double the mean of 50
        k_ms = cuda_ms(run, 500)
        p_ms = cuda_ms(lambda: gather_rows_plain(src, idx, scale), 500)
        lib_ms = cuda_ms(lib, 500)
        bound, by = gather_bound_ms(src, idx, scale, got)
        line("gather_vs_plain", shape=tag, batch=b, n=n, c=c, k=k,
             dtype=str(dtype).split(".")[-1], scaled=scaled, equal=True,
             kernel_ms=f"{k_ms:.4f}", device_ms=f"{device_ms(run, 50):.5f}",
             host_us=f"{host_us(run):.2f}", plain_ms=f"{p_ms:.4f}",
             library_ms=f"{lib_ms:.4f}",
             library_device_ms=f"{device_ms(lib, 50):.5f}",
             library_host_us=f"{host_us(lib):.2f}", bound_ms=f"{bound:.5f}",
             bound_by=by)
        if tag == "frcnn_rows":
            record = {
                "name": "gather_rows",
                "route": "cuda",
                "source": "edgeml_tpu_torch/csrc/gather_rows.cu",
                "replaces": "tools/gather_pallas_kernel.py:32",
                "launches": None,
                "max_abs_err": err,
                "ms": k_ms,
                "plain_ms": p_ms,
                "bound_ms": bound,
                "bound_by": by,
                "library_ms": lib_ms,
            }
        del flat, src, idx, scale, got, want, full
    return record


def conv_mode_probe(net, x, ref):
    """The Faster R-CNN RPN outputs' error against the CPU's (ref) with
    cuDNN left to its heuristics, restricted to deterministic algorithms,
    benchmarking its algorithms, and switched off (PyTorch's own
    convolutions): whether the convolution algorithm sets the error."""
    import torch

    cudnn = torch.backends.cudnn
    saved = (cudnn.enabled, cudnn.deterministic, cudnn.benchmark)
    rels = {}
    try:
        for mode, flags in (("default", (True, False, False)),
                            ("deterministic", (True, True, False)),
                            ("benchmark", (True, False, True)),
                            ("cudnn_off", (False, False, False))):
            cudnn.enabled, cudnn.deterministic, cudnn.benchmark = flags
            got = [t for lv in net.run_rpn(net.features(x)) for t in lv]
            rels[mode] = max(
                float((a.cpu() - b).abs().max()) / float(b.abs().max())
                for a, b in zip(got, ref))
    finally:
        cudnn.enabled, cudnn.deterministic, cudnn.benchmark = saved
    line("frcnn_rpn_conv_modes",
         **{k: f"{v:.3e}" for k, v in rels.items()})


def roi_align_sources(boxes, feats, dev):
    """Where the strict-f32 RoIAlign of the card and the CPU part, on the
    same proposals (N, 4) and P2..P5 levels: the box heights divided by the
    Python scalar 7 (CUDA multiplies by the reciprocal, the CPU divides),
    sqrt and log of the areas (the level choice), and the (2, 2) sample
    mean's sum of the same values in each device's order."""
    import torch

    from edgeml_tpu_torch.models import faster_rcnn as tfr

    def differ(fn, x):
        a, b = fn(x.to(dev)).cpu(), fn(x)
        return int((a != b).sum()), float((a - b).abs().max())

    h = boxes[:, 3] - boxes[:, 1]
    area = torch.clamp_min(h * (boxes[:, 2] - boxes[:, 0]), 1e-6)
    div_n, div_e = differ(lambda t: t / tfr.ROI_OUT, h)
    sqrt_n, _ = differ(torch.sqrt, area)
    log_n, _ = differ(torch.log, torch.sqrt(area) / 224.0 + 1e-9)
    lvl_n, _ = differ(lambda t: torch.floor(4.0 + torch.log(
        torch.sqrt(t) / 224.0 + 1e-9) / torch.log(torch.full((), 2.0))),
        area)
    # P2's values in (2, 2) groups, summed on each device as the sample
    # mean sums them
    p2 = feats[0][0].permute(1, 2, 0)
    k = min(p2.shape[0], p2.shape[1]) // 14
    vals = p2[:14 * k, :14 * k].reshape(k, 7, 2, k, 7, 2, -1)
    sum_n, sum_e = differ(lambda t: t.sum(dim=(2, 5)), vals)
    line("frcnn_roi_align_sources", boxes=boxes.shape[0],
         div7_differ=div_n, div7_max_err=f"{div_e:.3e}", sqrt_differ=sqrt_n,
         log_differ=log_n, level_differ=lvl_n, sum_differ=sum_n,
         sum_max_err=f"{sum_e:.3e}", sum_values=vals.numel() // 4)


def frcnn_phases(dev, tmp, img_dir, shapes, gather_record):
    """Phase 9: Faster R-CNN-ResNet50-FPN-v2 serving over FRCNN_IMAGES
    images at batch FRCNN_BATCH in f32 (launch counts exact, files
    checked), a traced run, one device-resident batch timed stage by stage
    in f32 and bf16, and the proposal and final tails against their plain
    reruns. Returns the records of the sequential suppressor and of the row
    gather."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from edgeml_tpu_torch.data.coco_labelmap import coco_to_yolov5
    from edgeml_tpu_torch.data.loader import decode_image
    from edgeml_tpu_torch.models import faster_rcnn as tfr
    from edgeml_tpu_torch.models.infer import (
        _detect_generic, run_detection, square_batch,
    )
    from edgeml_tpu_torch.ops import nms
    from edgeml_tpu_torch.ops.nms_fused import greedy_keep_mask_blocked_cuda
    from edgeml_tpu_torch.ops.nms_seq import (
        suppress_mask_seq_cuda, suppress_mask_seq_plain,
    )

    names = sorted(os.listdir(img_dir))[:FRCNN_IMAGES]
    sub_dir = os.path.join(tmp, "images_frcnn")
    os.makedirs(sub_dir)
    for n in names:
        shutil.copy(os.path.join(img_dir, n), sub_dir)
    first = [decode_image(os.path.join(img_dir, n))
             for n in names[:FRCNN_BATCH]]
    x = torch.from_numpy(square_batch(first, 640)).to(dev)
    net = seeded_faster_rcnn(5, x, dev)
    conf, iou = 0.001, 0.6

    # a small-input reference: the card's f32 trunk and RPN head against
    # the CPU's
    cpu_net = copy.deepcopy(net).cpu()
    with torch.no_grad():
        feats_c = cpu_net.features(x[:1].cpu())
        ref = [t for lv in cpu_net.run_rpn(feats_c) for t in lv]
        got = [t for lv in net.run_rpn(net.features(x[:1])) for t in lv]
        # image 0 of the serving batch: the convolution algorithms cuDNN
        # picks at batch 16 (an FFT one among them) against the CPU's
        got16 = [t[:1] for lv in net.run_rpn(net.features(x)) for t in lv]
        # the bound the check had before, 1e-3 of the largest output's
        # largest value, stays beside the card's tolerance
        old_abs = 1e-3 * max(float(t.abs().max()) for t in ref)
        outputs_vs_cpu("frcnn_rpn_vs_cpu", got, ref, old_abs=old_abs,
                       tol=FRCNN_RPN_CARD_TOL, images=1)
        outputs_vs_cpu("frcnn_rpn_vs_cpu", got16, ref, old_abs=old_abs,
                       tol=FRCNN_RPN_CARD_TOL, images=1, batch=FRCNN_BATCH)
        conv_mode_probe(net, x[:1], ref)
        # the second stage on the same inputs: the CPU's P2..P5 and
        # proposals through the card's RoIAlign (strict f32 and the bf16
        # serving pyramid) and box head
        boxes_c, _ = cpu_net.proposals(*cpu_net.run_rpn(feats_c))
        feats_g = [f.to(dev) for f in feats_c[:4]]
        pooled_c = cpu_net.roi_align(feats_c[:4], boxes_c)
        outputs_vs_cpu("frcnn_roi_align_vs_cpu",
                       [net.roi_align(feats_g, boxes_c.to(dev))], [pooled_c],
                       images=1, rois=boxes_c.shape[1])
        pc16 = cpu_net.roi_align(feats_c[:4], boxes_c, tfr.ROI_PYR)
        pg16 = net.roi_align(feats_g, boxes_c.to(dev), tfr.ROI_PYR)
        err16 = float((pg16.float().cpu() - pc16.float()).abs().max())
        line("frcnn_roi_align_vs_cpu", pyramid="bf16",
             max_abs_err=f"{err16:.3e}", tol="4e-2 abs (bf16 rounding)")
        if not err16 <= 4e-2:
            fail("frcnn_roi_align_vs_cpu: the bf16 pyramid's RoIAlign on "
                 "the card disagrees with the CPU's")
        roi_align_sources(boxes_c[0], feats_c[:4], dev)
        outputs_vs_cpu("frcnn_box_head_vs_cpu",
                       net.box_head(pooled_c.to(dev)),
                       cpu_net.box_head(pooled_c), images=1,
                       rois=boxes_c.shape[1])
    del cpu_net, ref, feats_c, feats_g, pooled_c, pc16, pg16

    _detect_generic(net, x, conf, iou)  # warm-up
    torch.cuda.synchronize()
    n_batches = math.ceil(FRCNN_IMAGES / FRCNN_BATCH)
    out_dir = os.path.join(tmp, "frcnn_f32")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    run_detection(net, sub_dir, out_dir, batch_size=FRCNN_BATCH,
                  conf_thres=conf, iou_thres=iou, class_map=coco_to_yolov5,
                  device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mono, blocked, seq, gathers = counts()
    if (mono, blocked, seq, gathers) != (0, n_batches, n_batches,
                                         5 * n_batches):
        fail(f"faster_rcnn: kernels launched {mono} + {blocked} + {seq} + "
             f"{gathers} times for {n_batches} batches (want 0 + "
             f"{n_batches} + {n_batches} + {5 * n_batches})")
    n_rows = check_files(out_dir, shapes[:FRCNN_IMAGES], 80, conf)
    peak = torch.cuda.max_memory_allocated() / 2**30
    line("frcnn_serve_f32", images=FRCNN_IMAGES, batch=FRCNN_BATCH,
         files=FRCNN_IMAGES, rows=n_rows, seq_launches=seq,
         blocked_launches=blocked, gather_launches=gathers,
         e2e_img_s=f"{FRCNN_IMAGES / wall:.1f}", peak_gib=f"{peak:.2f}")
    launches = {"seq": seq, "gather": gathers}

    traced("frcnn_trace_f32", lambda: run_detection(
        net, sub_dir, os.path.join(tmp, "frcnn_traced"),
        batch_size=FRCNN_BATCH, conf_thres=conf, iou_thres=iou,
        class_map=coco_to_yolov5, device="cuda"))
    files_vs_cpu("frcnn", net, img_dir, shapes, tmp, batch_size=4,
                 conf_thres=conf, iou_thres=iou, class_map=coco_to_yolov5)

    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            net.run_rpn(net.features(x[:1]))
        trunk_gflop = fc.get_total_flops() / 1e9
        feats = net.features(x[:1])
        boxes1, _ = net.proposals(*net.run_rpn(feats))
        pooled1 = net.roi_align(feats[:4], boxes1, tfr.ROI_PYR)
        with FlopCounterMode(display=False) as fc:
            net.box_head(pooled1)
        head_gflop = fc.get_total_flops() / 1e9
        del feats, boxes1, pooled1

        b = FRCNN_BATCH
        for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
            xd = x if dtype is None else x.to(dtype)
            pyr = tfr.ROI_PYR if dtype is None else None
            torch.cuda.reset_peak_memory_stats()
            dets, valid = _detect_generic(net, x, conf, iou, dtype=dtype)
            peak = torch.cuda.max_memory_allocated() / 2**30
            if not (torch.isfinite(dets).all() and int(valid.sum()) > 0):
                fail(f"faster_rcnn {label}: no finite detections")
            feats = net.features(xd)
            objs, regs = net.run_rpn(feats)
            boxes, pvalid = net.proposals(objs, regs)
            pooled = net.roi_align(feats[:4], boxes, pyr)
            cls, reg = net.box_head(pooled, dtype)
            cls, reg = cls.view(b, -1, 91), reg.view(b, -1, 91, 4)
            trunk_ms = cuda_ms(lambda: net.run_rpn(net.features(xd)), 3)
            prop_ms = cuda_ms(lambda: net.proposals(objs, regs), 5)
            roi_ms = cuda_ms(lambda: net.roi_align(feats[:4], boxes, pyr), 3)
            head_ms = cuda_ms(lambda: net.box_head(pooled, dtype), 3)
            tail_ms = cuda_ms(lambda: net.postprocess(
                cls, reg, boxes, pvalid, conf, iou), 5)
            dev_ms = cuda_ms(lambda: _detect_generic(net, x, conf, iou,
                                                     dtype=dtype), 3)
            line(f"frcnn_device_{label}", batch=b, rows=int(valid.sum()),
                 proposals=int(pvalid.sum()), device_batch_ms=f"{dev_ms:.3f}",
                 device_img_s=f"{b / dev_ms * 1e3:.1f}",
                 trunk_rpn_ms=f"{trunk_ms:.3f}", proposals_ms=f"{prop_ms:.3f}",
                 roi_align_ms=f"{roi_ms:.3f}", box_head_ms=f"{head_ms:.3f}",
                 final_tail_ms=f"{tail_ms:.3f}",
                 trunk_gflop_per_img=f"{trunk_gflop:.3f}",
                 trunk_tflop_s=f"{trunk_gflop * b / trunk_ms:.2f}",
                 box_head_gflop_per_img=f"{head_gflop:.3f}",
                 box_head_tflop_s=f"{head_gflop * b / head_ms:.2f}",
                 peak_gib=f"{peak:.2f}")
            if dtype is None:
                f32_state = (objs, regs, boxes, pvalid, cls, reg)
            del feats, pooled

        # the proposal and final tails against their plain reruns
        objs, regs, boxes, pvalid, cls, reg = f32_state
        seen = {}

        def recording(mod, name):
            real = getattr(mod, name)

            def fn(*args):
                seen[name] = args
                return real(*args)

            setattr(mod, name, fn)
            return real

        reset_counts()
        real_seq = recording(tfr, "suppress_mask_seq")
        real_fused = recording(nms, "greedy_keep_mask_fused")
        try:
            k_boxes, k_valid = net.proposals(objs, regs)
            k_dets, k_dvalid = net.postprocess(cls, reg, boxes, pvalid, conf,
                                               iou)
        finally:
            tfr.suppress_mask_seq = real_seq
            nms.greedy_keep_mask_fused = real_fused
        torch.cuda.synchronize()
        if counts() != (0, 1, 1, 5):
            fail(f"faster_rcnn tails: kernels launched {counts()}, want "
                 f"(0, 1, 1, 5)")
        reset_counts()
        with plain_kernels():
            p_boxes, p_valid = net.proposals(objs, regs)
            p_dets, p_dvalid = net.postprocess(cls, reg, boxes, pvalid, conf,
                                               iou)
        if counts() != (0, 0, 0, 0):
            fail("faster_rcnn plain tails launched a kernel")
        if not (torch.equal(k_boxes, p_boxes) and torch.equal(k_valid,
                                                              p_valid)):
            fail("faster_rcnn proposals: kernel and plain disagree")
        if not (torch.equal(k_dets, p_dets) and torch.equal(k_dvalid,
                                                            p_dvalid)):
            fail("faster_rcnn final tail: kernel and plain disagree")

        # the sequential suppressor at the main path's shape and data
        seg_boxes, seg_scores, thr, max_keep = seen["suppress_mask_seq"]
        kept, picks = suppress_mask_seq_cuda(seg_boxes, seg_scores, thr,
                                             max_keep)
        p_kept, p_picks = suppress_mask_seq_plain(seg_boxes, seg_scores, thr,
                                                  max_keep)
        if not (torch.equal(kept, p_kept) and torch.equal(picks, p_picks)):
            fail("faster_rcnn RPN segments: sequential kernel != plain")
        n_valid = int((seg_scores > 0).sum())
        if not 0 < int(kept.sum()) < n_valid:
            fail("faster_rcnn RPN segments: degenerate, nothing suppressed")

        def seq_run():
            return suppress_mask_seq_cuda(seg_boxes, seg_scores, thr,
                                          max_keep)

        seq_ms = cuda_ms(seq_run, 20)
        seq_dev_ms, seq_host_us = device_ms(seq_run), host_us(seq_run, 50)
        seq_plain_ms = cuda_ms(lambda: suppress_mask_seq_plain(
            seg_boxes, seg_scores, thr, max_keep), 2, warmup=1)
        bound, by, live, n_picks, most = seq_bound_ms(seg_boxes, seg_scores,
                                                      picks, thr)
        # the blocked suppressor on the final tail (K = 2048)
        off, top, iou_f = seen["greedy_keep_mask_fused"]
        off, fvalid = off.contiguous(), (top > 0).contiguous()
        if off.shape[1] != 2048 or not bool(fvalid.all()):
            fail("faster_rcnn final tail: not K = 2048 real candidates")
        blocked_ms = cuda_ms(lambda: greedy_keep_mask_blocked_cuda(
            off, fvalid, iou_f), 20)
        blocked_bound, blocked_by = suppressor_bound_ms(off, top)
        line("frcnn_tails_kernel_vs_plain", batch=b, proposals_equal=True,
             dets_equal=True, segments=tuple(seg_scores.shape)[0],
             k=tuple(seg_scores.shape)[1], candidates=n_valid,
             kept=int(kept.sum()), picks=n_picks, most_picks=most,
             live_pairs=live, seq_kernel_ms=f"{seq_ms:.4f}",
             seq_device_ms=f"{seq_dev_ms:.4f}",
             seq_host_us=f"{seq_host_us:.1f}", seq_plain_ms=f"{seq_plain_ms:.3f}", seq_bound_ms=f"{bound:.4f}",
             seq_bound_by=by, rows=int(k_dvalid.sum()),
             blocked_kernel_ms=f"{blocked_ms:.4f}",
             blocked_bound_ms=f"{blocked_bound:.4f}",
             blocked_bound_by=blocked_by)

    gather_record["launches"] = launches["gather"]
    return [{
        "name": "nms_seq_suppress",
        "route": "cuda",
        "source": "edgeml_tpu_torch/csrc/nms_seq.cu",
        "replaces": "edgeml_tpu/ops/nms_pallas.py:29",
        "launches": launches["seq"],
        "max_abs_err": int((kept.int() - p_kept.int()).abs().max()),
        "ms": seq_ms,
        "plain_ms": seq_plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }, gather_record]


# ---- the reward path: bench.py's synthetic ORIE workload, copied ----------
ORIE_CLS = 80  # bench.py N_CLS
ORIE_DETS = 16  # bench.py DETS_PER_IMG
ORIE_LABELS = 8  # bench.py LABELS_PER_IMG
ORIE_E = 1000  # bench.py NUM_ENSEMBLE
ORIE_OPS = 30  # f32 operations per (C, T, K) element of one evaluation
ORIE_CPU_DRAWS = 128  # E = N - 1 rewards, card against CPU, on this many


def make_workload(rng, n_img, n_cls=ORIE_CLS):
    """set_data-format triples with matching-consistent TP flags (a copy of
    ``bench.py make_workload``, with the class count as a parameter)."""
    weak, strong, labels = [], [], []
    for _ in range(n_img):
        m = rng.integers(max(ORIE_LABELS // 2, 1), ORIE_LABELS * 2 + 1)
        lab = rng.integers(0, n_cls, size=m)
        labels.append(lab)
        for out, skill in ((weak, 0.35), (strong, 0.6)):
            n = rng.integers(max(ORIE_DETS // 2, 1), ORIE_DETS * 2 + 1)
            cls = rng.integers(0, n_cls, size=n)
            tp = rng.random((n, 1)) < skill
            for c in np.unique(cls):
                cap = int(np.sum(lab == c))
                rows = np.nonzero(cls == c)[0]
                hot = rows[tp[rows, 0]]
                if len(hot) > cap:
                    tp[hot[cap:], 0] = False
            out.append((tp, rng.random(n), cls))
    return weak, strong, labels


def with_thresholds(weak, strong, t, rng):
    """The workload at T IoU thresholds (mAP@0.5:0.95): the flags of each
    stricter threshold are a random subset of the previous one's, so every
    column stays matching-consistent."""
    def widen(stream):
        out = []
        for tp, conf, cls in stream:
            cols = [tp[:, 0]]
            for _ in range(t - 1):
                cols.append(cols[-1] & (rng.random(len(cls)) < 0.85))
            out.append((np.stack(cols, 1), conf, cls))
        return out
    return widen(weak), widen(strong)


def orie_bound_ms(pool, n_draws):
    """Least time of n_draws ORIE draws: ORIE_OPS f32 operations per (C, T,
    K) element of each of a draw's two evaluations over the non-tensor f32
    rate, against the pool read once a draw (tp, the int64 image ids and
    three masks: C K (T + 11) bytes) over the HBM rate. Returns (ms, bound
    by, ops ms, bytes ms)."""
    c, k, t = pool.tp.shape
    t_ops = ORIE_OPS * 2 * c * t * k * n_draws / H100_F32_OPS
    t_bytes = c * k * (t + 11) * n_draws / H100_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", t_ops * 1e3,
            t_bytes * 1e3)


def orie_case(dev, tag, weak, strong, labels, timed_runs=3, trace=False):
    """ORIE at E = 1000 on one workload: the pool built on the host, warm
    reward img/s (median of timed_runs with one seed, every run equal),
    batch 128 equal to the default batch, peak memory, and the card against
    the port's CPU path (64 injected mask draws through orie_map_pair, each
    mAP within 3e-5; E = N - 1 rewards of ORIE_CPU_DRAWS images within 6e-5
    N); every draw exactly E images and never its target. Returns the
    card's pool."""
    import torch

    from edgeml_tpu_torch.ops import map_kernel as tmk
    from edgeml_tpu_torch.reward import orie as torie

    n = len(labels)
    t0 = time.perf_counter()
    pool = tmk.build_pool(weak, strong, labels, device=dev)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    c, k, t = pool.tp.shape
    batch = torie.default_batch(pool)
    torie.orie_rewards(weak, strong, labels, ORIE_E, pool=pool)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, first = [], None
    for _ in range(timed_runs):
        t0 = time.perf_counter()
        r = torie.orie_rewards(weak, strong, labels, ORIE_E, seed=0,
                               pool=pool)
        torch.cuda.synchronize()
        runs.append(n / (time.perf_counter() - t0))
        if first is None:
            first = r
        elif not np.array_equal(r, first):
            fail(f"orie {tag}: two runs with one seed differ")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if trace:
        traced(f"orie_trace_{tag}", lambda: torie.orie_rewards(
            weak, strong, labels, ORIE_E, seed=0, pool=pool))
    if not (np.isfinite(first).all() and np.any(first != 0)):
        fail(f"orie {tag}: rewards not finite or all zero")
    if not np.array_equal(first, torie.orie_rewards(
            weak, strong, labels, ORIE_E, seed=0, pool=pool, batch=128)):
        fail(f"orie {tag}: batch 128 and the default batch differ")
    img_s = sorted(runs)[len(runs) // 2]
    bound, by, ops_ms, bytes_ms = orie_bound_ms(pool, n)
    ms = n / img_s * 1e3

    # the port's CPU path on the same draws
    cpu_pool = tmk.build_pool(weak, strong, labels)
    rng = np.random.default_rng(n + t)
    ens = torch.from_numpy(rng.random((64, n)) < rng.uniform(0.05, 0.6,
                                                             (64, 1)))
    target = torch.from_numpy(rng.integers(0, n, 64))
    wg, sg = tmk.orie_map_pair(pool, ens.to(dev), target.to(dev))
    wc, sc = tmk.orie_map_pair(cpu_pool, ens, target)
    err_map = max(float((wg.cpu() - wc).abs().max()),
                  float((sg.cpu() - sc).abs().max()))
    idx = torch.from_numpy(np.sort(rng.choice(n, ORIE_CPU_DRAWS, False)))
    rg = torie.orie_batch(pool, idx.to(dev), n - 1, 0)
    rc = torie.orie_batch(cpu_pool, idx, n - 1, 0)
    err_all = float((rg.cpu() - rc).abs().max())
    if not (err_map <= 3e-5 and err_all <= 6e-5 * n):
        fail(f"orie {tag}: card != CPU (mAP {err_map:.3e}, E = N - 1 "
             f"reward {err_all:.3e})")
    exact = True
    for s_ in range(0, n, 1024):
        tg = torch.arange(s_, min(s_ + 1024, n), device=dev)
        m = torie.ensemble_masks(0, tg, n, ORIE_E)
        exact &= bool((m.sum(dim=1) == ORIE_E).all()) and not bool(
            m[torch.arange(len(tg), device=dev), tg].any())
    if not exact:
        fail(f"orie {tag}: a draw is not exactly E images without the "
             f"target")
    line("orie", workload=tag, images=n, classes=c, k=k, t=t, e=ORIE_E,
         batch=batch, pool_build_ms=f"{build_ms:.1f}",
         img_s=f"{img_s:.1f}", runs=repr([round(x, 1) for x in runs]),
         ms=f"{ms:.3f}", bound_ms=f"{bound:.4f}", bound_by=by,
         bound_ops_ms=f"{ops_ms:.4f}", bound_bytes_ms=f"{bytes_ms:.4f}",
         peak_gib=f"{peak:.2f}", seed_repeat_equal=True,
         batch128_equal=True, cpu_draws=64,
         max_map_err=f"{err_map:.3e}", tol_map="3e-5",
         e_all_images=ORIE_CPU_DRAWS, max_e_all_err=f"{err_all:.3e}",
         tol_e_all=f"{6e-5 * n:.3e}", exact_e=True)
    del cpu_pool
    return pool


def write_estimates(root, dataset_split, seed):
    """One directory of per-fold estimate{k}.npz files (train_est over the
    other folds' images, val_est over the fold's), as the estimators write
    them."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    for k, val in enumerate(dataset_split):
        np.savez(os.path.join(root, f"estimate{k + 1}.npz"),
                 train_est=rng.normal(0, 1, int((~val).sum())),
                 val_est=rng.normal(0, 1, int(val.sum())))
    return root


def folds(n, k, seed):
    rng = np.random.default_rng(seed)
    fold = rng.permutation(np.arange(n) % k)
    return np.stack([fold == f for f in range(k)])


def reward_phases(dev, tmp):
    """Phases 10-12: ORIE at the sizes its users run (bench.py's workload:
    N = 2048 and the COCO-val-5k scale N = 5000 at mAP@0.5, N = 2048 at
    mAP@0.5:0.95), test_map on the 5000-image pool, and the reward and test
    CLIs end to end on files."""
    import torch

    from edgeml_tpu_torch import eval as teval
    from edgeml_tpu_torch.ops import map_kernel as tmk

    w2k, s2k, l2k = make_workload(np.random.default_rng(0), 2048)
    orie_case(dev, "n2048_t1", w2k, s2k, l2k, trace=True)
    weak, strong, labels = make_workload(np.random.default_rng(11), 5000)
    pool5k = orie_case(dev, "n5000_t1", weak, strong, labels)
    w10, s10 = with_thresholds(w2k, s2k, 10, np.random.default_rng(10))
    orie_case(dev, "n2048_t10", w10, s10, l2k)
    torch.cuda.empty_cache()

    # test_map: 3 estimate directories x 5 folds on the 5000-image pool
    split = folds(5000, 5, 5)
    dirs = [write_estimates(os.path.join(tmp, f"est5k_{i}"), split, i)
            for i in range(3)]
    teval.test_map(weak, strong, labels, dirs, split, pool=pool5k)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = teval.test_map(weak, strong, labels, dirs, split, pool=pool5k)
    ms = (time.perf_counter() - t0) * 1e3
    want = teval.test_map(weak, strong, labels, dirs, split,
                          pool=tmk.build_pool(weak, strong, labels))
    err = float(np.abs(got - want).max())
    if not (got.shape == (3, 11) and np.isfinite(got).all() and err <= 3e-5):
        fail(f"test_map: card != CPU ({err:.3e}) or bad shape {got.shape}")
    line("test_map", images=len(labels), estimates=3, folds=5, ratios=11,
         ms=f"{ms:.2f}", max_abs_err=f"{err:.3e}", tol="3e-5",
         map_at_0=f"{got[0, 0]:.4f}", map_at_1=f"{got[0, -1]:.4f}")
    del pool5k
    torch.cuda.empty_cache()
    reward_cli_phase(dev, tmp, w2k, s2k, l2k)


def write_yolo_files(root, weak, strong, labels, seed):
    """The workload as YOLO-format files: labels/{img}.txt rows "cls x y w
    h", weak/ and strong/{img}.txt rows "cls x y w h conf"; a detection
    flagged a true positive sits on a label of its class (jittered within
    IoU 0.5), the others at random."""
    rng = np.random.default_rng(seed)
    dirs = [os.path.join(root, d) for d in ("weak", "strong", "labels")]
    for d in dirs:
        os.makedirs(d)
    for i, lab in enumerate(labels):
        lb = np.concatenate([rng.uniform(0.2, 0.8, (len(lab), 2)),
                             rng.uniform(0.05, 0.3, (len(lab), 2))], 1)
        with open(os.path.join(dirs[2], f"img{i:05d}.txt"), "w") as f:
            f.writelines(f"{c} {b[0]:.6f} {b[1]:.6f} {b[2]:.6f} {b[3]:.6f}\n"
                         for c, b in zip(lab, lb))
        for d, (tp, conf, cls) in ((dirs[0], weak[i]), (dirs[1], strong[i])):
            bx = np.concatenate([rng.uniform(0.2, 0.8, (len(cls), 2)),
                                 rng.uniform(0.05, 0.3, (len(cls), 2))], 1)
            for j, c in enumerate(cls):
                same = np.nonzero(lab == c)[0]
                if tp[j, 0] and same.size:
                    bx[j] = lb[rng.choice(same)] * (1 + rng.normal(
                        0, 0.01, 4))
            with open(os.path.join(d, f"img{i:05d}.txt"), "w") as f:
                f.writelines(f"{c} {b[0]:.6f} {b[1]:.6f} {b[2]:.6f} "
                             f"{b[3]:.6f} {p:.6f}\n"
                             for c, b, p in zip(cls, bx, conf))
    return dirs


def reward_cli_phase(dev, tmp, weak, strong, labels):
    """Phase 12: the N = 2048 workload written as YOLO files; the reward CLI
    (orie, E = 1000, and dcsb) and the test CLI run on the card; wall
    seconds split into file read, set_data (of which box_correct on the
    card), rewards and write; keys and dtypes checked; dcsb.npz equal to a
    --device cpu run bit for bit."""
    import torch

    from edgeml_tpu_torch.cli import reward as cli_reward
    from edgeml_tpu_torch.cli import test as cli_test
    from edgeml_tpu_torch.data import io as tio
    from edgeml_tpu_torch.reward import compute_rewards

    root = os.path.join(tmp, "reward_cli")
    dirs = write_yolo_files(root, weak, strong, labels, 12)
    out = os.path.join(root, "out")
    walls = {}
    for method in ("orie", "dcsb"):
        t0 = time.perf_counter()
        cli_reward.main(cli_reward.getargs([*dirs, out, "--method", method,
                                            "--num-ensemble", str(ORIE_E)]))
        walls[method] = time.perf_counter() - t0
    orie = np.load(os.path.join(out, f"orie{ORIE_E}.npz"))
    dcsb = np.load(os.path.join(out, "dcsb.npz"))
    for f, dt in ((orie, np.float32), (dcsb, np.int64)):
        if sorted(f.files) != ["reward", "time"] or f["reward"].dtype != dt \
                or f["reward"].shape != (len(labels),) \
                or f["time"].dtype != np.float64:
            fail(f"reward CLI: bad file {f.files} {f['reward'].dtype}")
    if not (np.isfinite(orie["reward"]).all() and np.any(orie["reward"])):
        fail("reward CLI: ORIE rewards not finite or all zero")
    out_cpu = os.path.join(root, "out_cpu")
    cli_reward.main(cli_reward.getargs([*dirs, out_cpu, "--method", "dcsb",
                                        "--device", "cpu"]))
    if not np.array_equal(dcsb["reward"], np.load(os.path.join(
            out_cpu, "dcsb.npz"))["reward"]):
        fail("reward CLI: dcsb on the card != --device cpu")

    # the CLI's steps timed one by one
    names = tio.list_image_names(dirs[2])
    t0 = time.perf_counter()
    raw_w = tio.load_data(dirs[0], names, True)
    raw_s = tio.load_data(dirs[1], names, True)
    raw_l = tio.load_data(dirs[2], names)
    t1 = time.perf_counter()
    iouv = np.array([0.5])
    tio._batched_correct(raw_w, raw_l, iouv, dev)
    tio._batched_correct(raw_s, raw_l, iouv, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    data = tio.set_data(*dirs, device=dev)
    t3 = time.perf_counter()
    reward, secs = compute_rewards(*data, "orie", ORIE_E, device=dev)
    t4 = time.perf_counter()
    np.savez(os.path.join(root, "probe.npz"), reward=reward, time=secs)
    t5 = time.perf_counter()
    if not np.array_equal(reward, orie["reward"]):
        fail("reward CLI: rewards differ from the same steps run by hand")

    split = folds(len(labels), 5, 7)
    np.save(os.path.join(root, "split.npy"), split)
    ests = [write_estimates(os.path.join(root, f"est{i}"), split, 20 + i)
            for i in range(3)]
    t6 = time.perf_counter()
    cli_test.main(cli_test.getargs([*dirs, os.path.join(root, "split.npy"),
                                    out, "--estimates", *ests]))
    test_s = time.perf_counter() - t6
    tm = np.load(os.path.join(out, "test_map.npy"))
    if tm.shape != (3, 11) or not np.isfinite(tm).all():
        fail(f"test CLI: test_map.npy {tm.shape}")
    line("reward_cli", images=len(labels), orie_wall_s=f"{walls['orie']:.3f}",
         dcsb_wall_s=f"{walls['dcsb']:.3f}", read_s=f"{t1 - t0:.3f}",
         box_correct_s=f"{t2 - t1:.3f}", set_data_s=f"{t3 - t2:.3f}",
         rewards_s=f"{t4 - t3:.3f}", reward_time_key=f"{secs:.3f}",
         write_s=f"{t5 - t4:.4f}", test_cli_s=f"{test_s:.3f}",
         dcsb_equal_cpu=True, keys_dtypes_ok=True,
         test_map_shape=repr(tm.shape))



# ---- the host resize: the native taps against the NumPy evaluation -------
RESIZE_TOL = 2e-6  # the two evaluations differ only in summation order


def resize_phase(dev, tmp, img_dir):
    """[resize]: the first 64 images letterboxed for YOLOv5n (640) and
    resized for SSDLite (320 square) through the native resampler (what
    serving runs) and through the NumPy tap evaluation, on one thread,
    the native result the same on a second run and within 2e-6 of NumPy's;
    then YOLOv5n and SSDLite f32 serving of the 256 images with each
    evaluation, in the order NumPy, native, native, NumPy."""
    import torch

    from edgeml_tpu_torch.data import loader
    from edgeml_tpu_torch.data.coco_labelmap import coco_to_yolov5
    from edgeml_tpu_torch.models.common import letterbox_batch
    from edgeml_tpu_torch.models.infer import run_detection, square_batch

    names = sorted(os.listdir(img_dir))
    imgs = [loader.decode_image(os.path.join(img_dir, n))
            for n in names[:BATCH]]
    native = loader._eval_taps
    evals = {"native": native, "numpy": loader.eval_taps_numpy}

    def with_eval(how, fn):
        loader._eval_taps = evals[how]
        try:
            return fn()
        finally:
            loader._eval_taps = native

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out

    batches = {
        "yolov5n_letterbox_640": lambda: letterbox_batch(imgs, 640)[0],
        "ssdlite_resize_320": lambda: np.stack(
            [loader.resize_bilinear(im, 320, 320) for im in imgs]),
    }
    for tag, make in batches.items():
        ms_np, a_np = with_eval("numpy", lambda: timed(make))
        ms_nat, a_nat = with_eval("native", lambda: timed(make))
        ms_nat2, again = with_eval("native", lambda: timed(make))
        err = float(np.abs(a_nat - a_np).max())
        if not (np.array_equal(a_nat, again) and err <= RESIZE_TOL):
            fail(f"resize {tag}: native runs differ or native vs NumPy "
                 f"{err:.3e} > {RESIZE_TOL}")
        line("resize", batch=tag, images=BATCH, native_ms=f"{ms_nat:.1f}",
             native_ms_again=f"{ms_nat2:.1f}", numpy_ms=f"{ms_np:.1f}",
             speedup=f"{ms_np / ms_nat:.2f}", native_repeat_equal=True,
             max_abs_vs_numpy=f"{err:.3e}", tol=RESIZE_TOL)

    x = torch.from_numpy(letterbox_batch(imgs, 640)[0]).to(dev)
    xs = torch.from_numpy(square_batch(imgs, 320)).to(dev)
    nets = {"yolov5n": (seeded_yolov5("n", 1, x[:16], dev), {}),
            "ssdlite": (seeded_ssdlite(3, xs[:16], dev),
                        {"class_map": coco_to_yolov5})}
    del x, xs
    for name, (net, kw) in nets.items():
        def serve(i):
            run_detection(net, img_dir, os.path.join(tmp, f"ab_{name}_{i}"),
                          batch_size=BATCH, conf_thres=0.001, iou_thres=0.6,
                          device="cuda", **kw)
            torch.cuda.synchronize()

        serve("warm")
        rates = []
        for i, how in enumerate(("numpy", "native", "native", "numpy")):
            ms, _ = with_eval(how, lambda: timed(lambda: serve(i)))
            rates.append(N_IMAGES / ms * 1e3)
        line("resize_serving_ab", model=name, images=N_IMAGES, batch=BATCH,
             order="numpy,native,native,numpy",
             e2e_img_s=repr([round(r, 1) for r in rates]),
             numpy_mean=f"{(rates[0] + rates[3]) / 2:.1f}",
             native_mean=f"{(rates[1] + rates[2]) / 2:.1f}")
    del nets
    torch.cuda.empty_cache()


# ---- the estimator path ---------------------------------------------------
EST_VOC_IMAGES = 4952  # the VOC2007 test set
EST_COCO_IMAGES = 5000  # COCO val2017
EST_K = 25  # detections per output feature: nc + 5k = 145 (VOC), 205 (COCO)
EST_FOLDS = 5
# Every CNN of the script trains 20 epochs (milestones at the same
# fractions, 60, 75 and 90%) instead of 100: its training steps are bound
# by launches, and at 100 the CLI's five folds took some 270 s and the
# fold-1 fit on the card and the CPU 85-120 s of the script's 1200 (PERF.md)
CNN_EPOCHS = 20


def cnn_cut(base, **kw):
    """``base`` (CNNOpt) at CNN_EPOCHS, its milestones scaled."""
    e = CNN_EPOCHS
    return base(max_epoch=e, milestones=[e * 60 // 100, e * 75 // 100,
                                         e * 90 // 100], **kw)


# card against CPU, at the CPU tests' tolerances (tests/test_torch_port_*)
CLOSE_TOL = 1e-5  # LR, EN, BR, SGD, KNR: of the largest |estimate|
# SVR, LSVR: validation MSE, relative. Adam near a hinge's optimum takes
# rounding-driven steps, so at this size the outcome moves with the last
# bits of the input: [estimators] prints the CPU's own move under 1e-6
# relative input noise beside the card's difference.
HINGE_MSE_TOL = 0.25
# AF: of the largest |w| (its Adam too steps on rounding near the optimum:
# the CPU's own move under input noise is printed beside it); decisions
# equal wherever the measured weight difference cannot flip them
AF_W_TOL = 5e-2
CNN_MSE_TOL = 0.25  # CNN: validation MSE, relative
SGD_OPS_PER_FEATURE = 7  # dot (2) and update (5) per feature a step
SGD_OPS_PER_STEP = 4  # err (2) and the bias (2)


def quiet(fn):
    """fn()'s result with its chatter (per-fold log lines) kept out of the
    smoke log."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def estimator_workload(dev, tmp, n_img, n_cls, seed):
    """make_workload's images (n_cls classes) written as YOLO files, their
    stage-24 output features (n_cls + 5k, from the weak detector's files)
    and ORIE rewards (E = 1000, on the card); fold 1 of the 5-fold split.
    Returns (dirs, features, rewards, val_mask, dcsb inputs)."""
    from edgeml_tpu_torch.data import io as tio
    from edgeml_tpu_torch.dataprep import split_dataset
    from edgeml_tpu_torch.reward import orie as torie

    weak, strong, labels = make_workload(np.random.default_rng(seed), n_img,
                                         n_cls)
    root = os.path.join(tmp, f"est_{n_img}_{n_cls}")
    dirs = write_yolo_files(root, weak, strong, labels, seed + 1)
    feat = os.path.join(root, "features")
    names = tio.list_image_names(dirs[2])
    for n in names:
        os.makedirs(os.path.join(feat, n))
    tio.extract_output_feature(dirs[0], feat, n_cls, EST_K)
    x = tio.load_feature(feat, 24, pool=False)
    reward = torie.orie_rewards(weak, strong, labels, ORIE_E, seed=0,
                                device=dev)
    val = split_dataset(n_img, EST_FOLDS)[0]
    wd = tio.load_data(dirs[0], names, True)
    boxes = [(np.array([]), np.array([])) if len(d) == 0 else
             (d[2], (d[1][:, 2] - d[1][:, 0]) * (d[1][:, 3] - d[1][:, 1]))
             for d in wd]
    n_lab = np.array([len(l) for l in labels])
    return dirs, x, reward, val, (boxes, n_lab)


def fold(items, val):
    if isinstance(items, np.ndarray):
        return items[~val], items[val]
    return ([f for f, v in zip(items, val) if not v],
            [f for f, v in zip(items, val) if v])


def fit_one(name, d, model_dir, x, reward, val, boxes=None):
    """One family fitted on device d on fold 1: (result, wall s, pickled
    state or None). The seeded draws (SGD's orders, RFR's bootstrap, the
    CNN's init and masks) come from host generators: the same on every
    device."""
    from edgeml_tpu_torch import estimators as E

    xtr, xva = fold(x, val)
    so = E.SaveOpt(model_dir=model_dir)
    yb = np.where(reward > 0, 1, 0)
    if name == "AF":
        data = (xtr, xva, *fold(yb, val))
        run = lambda: E.fit_af(data, 3.0, so, device=d)
    elif name == "DCSB":
        data = (*fold(boxes[0], val), *fold(yb, val))
        run = lambda: E.fit_dcsb(data, fold(boxes[1], val)[0], so, device=d)
    elif name == "CNN":
        data = (xtr, xva, *fold(reward, val))
        opts = cnn_cut(E.CNNOpt, linear=[len(x[0]), 16, 16, 16, 16, 1])
        run = lambda: E.fit_CNN(data, opts, plot=False, device=d)[0]
    else:
        data = (xtr, xva, *fold(reward, val))
        fit = E.MODEL_FITTERS[E.MODEL_NAMES.index(name)]
        run = lambda: fit(data, save_opts=so, device=d)
    t0 = time.perf_counter()
    res = quiet(run)
    wall = time.perf_counter() - t0
    state = None
    pk = os.path.join(model_dir, "wts1.pickle")
    if os.path.isfile(pk):
        with open(pk, "rb") as f:
            state = pickle.load(f)
    return res, wall, state


def fit_both(name, dev, tmp, x, reward, val, boxes=None):
    """One family fitted on the card, then on the CPU, on the same fold and
    the same seeded draws. Returns {"card"/"cpu": fit_one's triple}."""
    import torch

    return {where: fit_one(name, d, os.path.join(tmp, f"wts_{name}_{where}"),
                           x, reward, val, boxes)
            for where, d in (("card", dev), ("cpu", torch.device("cpu")))}


def agreement(name, runs, x, reward, val):
    """(measure, value, bound, ok) of the card against the CPU."""
    card, cpu = runs["card"][0], runs["cpu"][0]
    if name in ("RFR", "GBR", "DCSB"):
        same = all(np.array_equal(card[k], cpu[k])
                   for k in ("train_est", "val_est"))
        if name != "DCSB":
            tc, tp = runs["card"][2][0]["trees"], runs["cpu"][2][0]["trees"]
            same &= all(np.array_equal(tc[k], tp[k]) for k in tc)
        else:
            same &= runs["card"][2] == runs["cpu"][2]
        return "exact", int(not same), 0, same
    if name in ("SVR", "LSVR", "CNN"):
        yv = fold(reward, val)[1]
        a, b = (float(np.mean((r["val_est"] - yv) ** 2)) for r in (card, cpu))
        tol = CNN_MSE_TOL if name == "CNN" else HINGE_MSE_TOL
        rel = abs(a - b) / b
        return "val_mse_rel", rel, tol, rel <= tol
    if name == "AF":
        sc, sp = runs["card"][2], runs["cpu"][2]
        scale = float(np.abs(sp["w"]).max())
        dw = max(float(np.abs(sc["w"] - sp["w"]).max()), abs(sc["b"] - sp["b"]))
        xs = np.stack(x).astype(np.float32)
        ok = dw <= AF_W_TOL * scale
        for key, rows in zip(("train_est", "val_est"), fold(xs, val)):
            # a decision can flip only where the weights' difference can
            far = np.abs(rows @ sp["w"] + sp["b"]) > \
                dw * (np.abs(rows).sum(1) + 1)
            ok &= bool(np.array_equal(card[key][far], cpu[key][far]))
        return "w_rel", dw / scale, AF_W_TOL, ok
    err = max(float(np.abs(card[k] - cpu[k]).max()) for k in ("train_est",
                                                              "val_est"))
    scale = max(float(np.abs(cpu[k]).max()) for k in ("train_est", "val_est"))
    return "est_rel", err / scale, CLOSE_TOL, err <= CLOSE_TOL * scale


def noise_spread(name, tmp, runs, x, reward, val):
    """The same measure as ``agreement`` between the CPU's fit and a second
    CPU fit with each nonzero feature perturbed by 1e-6 of itself (seeded):
    how far the family's outcome moves with the last bits of its input."""
    import torch

    rng = np.random.default_rng(0)
    xn = [f * (1 + 1e-6 * rng.standard_normal(f.shape)) for f in x]
    noisy = fit_one(name, torch.device("cpu"),
                    os.path.join(tmp, f"wts_{name}_noise"), xn, reward, val)
    return agreement(name, {"card": noisy, "cpu": runs["cpu"]}, x, reward,
                     val)[1]


def estimator_case(tag, dev, tmp, names, x, reward, val, boxes=None):
    """Each family on the card and on the CPU: fit seconds, prediction
    microseconds per image, validation MSE (accuracy for AF and DCSB) and
    the card against the CPU. Returns the card's wall seconds by family."""
    yv = fold(reward, val)[1]
    walls = {}
    for name in names:
        runs = fit_both(name, dev, tmp, x, reward, val, boxes)
        res, wall, _ = runs["card"]
        n_pred = len(res["train_est"]) + len(res["val_est"])
        pred_s = res["train_time"] * len(res["train_est"]) + \
            res["val_time"] * len(res["val_est"])
        if name in ("AF", "DCSB"):
            score = ("val_acc", float(np.mean(res["val_est"]
                                              == np.where(yv > 0, 1, 0))))
        else:
            score = ("val_mse", float(np.mean((res["val_est"] - yv) ** 2)))
        measure, value, bound, ok = agreement(name, runs, x, reward, val)
        noise = {}
        if name in ("SVR", "LSVR", "AF"):
            noise[f"cpu_noise_{measure}"] = \
                f"{noise_spread(name, tmp, runs, x, reward, val):.3e}"
        line("estimators", workload=tag, family=name, train=int((~val).sum()),
             val=int(val.sum()), features=len(x[0]),
             fit_s=f"{wall - pred_s:.3f}",
             predict_us=f"{pred_s / n_pred * 1e6:.3f}",
             **{score[0]: f"{score[1]:.5f}"},
             cpu_fit_s=f"{runs['cpu'][1]:.3f}",
             **{f"card_vs_cpu_{measure}": f"{value:.3e}"}, tol=bound, **noise)
        if not ok:
            fail(f"estimators {tag} {name}: card against CPU {measure} "
                 f"{value:.3e} over {bound}")
        walls[name] = wall
    return walls


def sgd_bound_ms(n, f, steps):
    """Least time of one SGD fit: ~7F + 4 f32 operations a step over the
    non-tensor f32 rate, against x, y, the order and the step sizes read
    once and w written once over HBM. Returns (ms, bound by)."""
    t_ops = steps * (SGD_OPS_PER_FEATURE * f + SGD_OPS_PER_STEP) / H100_F32_OPS
    t_bytes = 4 * (n * f + n + 2 * steps + f + 1) / H100_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sgd_phase(dev, x, reward, val, launches):
    """[sgd_scan_vs_plain]: the kernel against the plain eager loop on the
    card, on fold 1's standardised features and the port's 60 seeded
    epoch orders: w and b within 1e-5 of the largest |w|, both timed, and
    the bound. Returns the kernel's JSON record."""
    import torch

    from edgeml_tpu_torch.estimators import SGDOpt
    from edgeml_tpu_torch.estimators.common import StandardScaler
    from edgeml_tpu_torch.ops import sgd as tsgd

    o = SGDOpt()
    xtr = np.stack(fold(x, val)[0])
    xs = torch.from_numpy(StandardScaler().fit(xtr).transform(xtr).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(fold(reward, val)[0].astype(np.float32)).to(dev)
    n, f = xs.shape
    orders = tsgd.sgd_orders(o.seed, n, o.max_epochs)
    order = torch.from_numpy(orders.reshape(-1)).to(dev)
    eta = torch.from_numpy(tsgd.sgd_eta(o.eta0, o.power_t,
                                        order.numel())).to(dev)

    def run():
        return tsgd.sgd_fit_cuda(xs, y, order, eta, o.alpha)

    wk, bk = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wp, bp = tsgd.sgd_fit_plain(xs, y, order, eta, o.alpha)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(float((wk - wp).abs().max()), abs(float(bk) - float(bp)))
    scale = float(wp.abs().max())
    if not err <= CLOSE_TOL * scale:
        fail(f"sgd_scan: kernel != plain ({err:.3e} > {CLOSE_TOL} x {scale})")
    k_ms = cuda_ms(run, 3, warmup=1)
    d_ms = device_ms(run, iters=3, reps=2)
    h_us = host_us(run, iters=10, reps=3)
    bound, by = sgd_bound_ms(n, f, order.numel())
    line("sgd_scan_vs_plain", n=n, f=f, epochs=o.max_epochs,
         dependent_steps=order.numel(), max_abs_err=f"{err:.3e}",
         tol=f"{CLOSE_TOL * scale:.3e}", kernel_ms=f"{k_ms:.3f}",
         device_ms=f"{d_ms:.3f}", host_us=f"{h_us:.1f}",
         plain_ms=f"{plain_ms:.1f}", bound_ms=f"{bound:.5f}", bound_by=by,
         ns_per_step=f"{d_ms * 1e6 / order.numel():.1f}",
         launches_main_path=launches)
    return {
        "name": "sgd_scan",
        "route": "cuda",
        "source": "edgeml_tpu_torch/csrc/sgd_scan.cu",
        "replaces": "edgeml_tpu/estimators/linear.py:239",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": by,
        "library_ms": None,
    }


def estimator_phases(dev, tmp):
    """[estimators], [sgd_scan_vs_plain], [estimator_cli]. The VOC-scale
    workload (4,952 images, 20 classes, 145 features; fold 1 of 5: 3,962
    train, 990 validation) through all ten families and both baselines on
    the card and the CPU, then LR, KNR, SVR and RFR at COCO scale (5,000
    images, 205 features); the SGD kernel against its plain loop; and the
    whole offline chain as files through the CLIs. The card runs of the
    VOC families are this path's main run: counts set to 0 before, read
    after. Returns the SGD kernel's JSON record."""
    import torch

    from edgeml_tpu_torch.estimators import MODEL_NAMES

    dirs, x, reward, val, boxes = estimator_workload(dev, tmp, EST_VOC_IMAGES,
                                                     20, 31)
    reset_counts()
    walls = estimator_case("voc4952", dev, tmp, MODEL_NAMES + ["AF", "DCSB"],
                           x, reward, val, boxes)
    launches = sgd_launches()
    if launches != 1 or counts() != (0, 0, 0, 0):
        fail(f"estimators: the SGD kernel launched {launches} times (want 1 "
             f"for one fit), detection kernels {counts()}")
    line("estimators_total", workload="voc4952",
         card_wall_s=f"{sum(walls.values()):.2f}", sgd_launches=launches,
         cnn_epochs=CNN_EPOCHS)
    record = sgd_phase(dev, x, reward, val, launches)
    _, xc, rc, vc, _ = estimator_workload(dev, tmp, EST_COCO_IMAGES, ORIE_CLS,
                                          41)
    estimator_case("coco5000", dev, tmp, ["LR", "KNR", "SVR", "RFR"], xc, rc,
                   vc)
    del xc, rc
    torch.cuda.empty_cache()
    estimator_cli_phase(dev, tmp, dirs)
    return record


def estimator_cli_phase(dev, tmp, dirs):
    """[estimator_cli]: the offline chain on the VOC-scale files, on the
    card, as a user runs it: the reward CLI (ORIE, E = 1000), features,
    the 5-fold split, regression (LR, SGD, and the CNN at CNN_EPOCHS, all 5
    folds), both baselines and the test CLI on their
    estimates; the wall seconds of each, the files checked."""
    from edgeml_tpu_torch.cli import baseline as cb
    from edgeml_tpu_torch.cli import dataset_split as cs
    from edgeml_tpu_torch.cli import extract_feature as cf
    from edgeml_tpu_torch.cli import regression as cr
    from edgeml_tpu_torch.cli import reward as crw
    from edgeml_tpu_torch.cli import test as ct

    root = os.path.join(tmp, "cli")
    os.makedirs(root)
    weak, strong, labels = dirs
    out = lambda *p: os.path.join(root, *p)
    steps = [
        ("reward", crw, [weak, strong, labels, out("rewards"), "--method",
                         "orie", "--num-ensemble", str(ORIE_E)]),
        ("extract_feature", cf, [weak, out("features"), labels, "--dataset",
                                 "voc"]),
        ("dataset_split", cs, [labels, out("split.npy")]),
    ]
    reward = out("rewards", f"orie{ORIE_E}.npz")
    for model in ("LR", "SGD", "CNN"):
        steps.append((f"regression_{model}", cr, [
            out("features"), reward, out("split.npy"), out(f"est_{model}"),
            "--model", model, "--model-dir", out(f"wts_{model}")]))
    steps += [
        ("baseline_af", cb, [out("features"), reward, out("split.npy"),
                             out("est_af"), "--baseline", "af",
                             "--model_dir", out("wts_af")]),
        ("baseline_dcsb", cb, [weak, reward, out("split.npy"),
                               out("est_dcsb"), "--baseline", "dcsb",
                               "--label_dir", labels,
                               "--model_dir", out("wts_dcsb")]),
    ]
    ests = [out("est_LR"), out("est_SGD"), out("est_CNN_best"),
            out("est_af", "3.0"), out("est_dcsb")]
    steps.append(("test", ct, [weak, strong, labels, out("split.npy"),
                               out("test"), "--estimates", *ests]))
    walls = {}
    cwd = os.getcwd()
    cnn_opt = cr.CNNOpt
    cr.CNNOpt = lambda: cnn_cut(cnn_opt)
    os.chdir(root)  # the CNN's loss figures land in the working directory
    try:
        reset_counts()
        for tag, mod, argv in steps:
            t0 = time.perf_counter()
            quiet(lambda: mod.main(mod.getargs(argv)))
            walls[tag] = time.perf_counter() - t0
        launches = sgd_launches()
    finally:
        os.chdir(cwd)
        cr.CNNOpt = cnn_opt
    if launches != EST_FOLDS or counts() != (0, 0, 0, 0):
        fail(f"estimator CLI: the SGD kernel launched {launches} times (want "
             f"{EST_FOLDS}), detection kernels {counts()}")
    split = np.load(out("split.npy"))
    for d in ests + [out("est_CNN_last")]:
        for k, v in enumerate(split):
            e = np.load(os.path.join(d, f"estimate{k + 1}.npz"))
            if e["val_est"].shape != (int(v.sum()),) or \
                    e["train_est"].shape != (int((~v).sum()),) or \
                    not np.isfinite(e["val_est"]).all():
                fail(f"estimator CLI: bad estimates in {d}")
    for d, name in ((out("wts_LR"), "wts{}.pickle"),
                    (out("wts_CNN_best"), "wts{}.npz"),
                    (out("wts_af", "3.0"), "wts{}.pickle"),
                    (out("wts_dcsb"), "wts{}.pickle")):
        if not all(os.path.isfile(os.path.join(d, name.format(k)))
                   for k in range(1, EST_FOLDS + 1)):
            fail(f"estimator CLI: weight files missing in {d}")
    tm = np.load(out("test", "test_map.npy"))
    if not (tm.shape == (len(ests), 11) and np.isfinite(tm).all()
            and (tm >= 0).all() and (tm <= 1).all()):
        fail(f"estimator CLI: test_map.npy {tm.shape}")
    pdfs = sorted(f for f in os.listdir(root) if f.endswith(".pdf"))
    line("estimator_cli", images=split.shape[1], folds=len(split),
         cnn_epochs=CNN_EPOCHS,
         **{f"{k}_s": f"{v:.2f}" for k, v in walls.items()},
         sgd_launches=launches, cnn_pdfs=len(pdfs),
         test_map_shape=repr(tm.shape),
         map_at_0=f"{tm[0, 0]:.4f}", map_at_1=f"{tm[0, -1]:.4f}",
         map_at_half=repr([round(float(v), 4) for v in tm[:, 5]]))

# ---- hidden-stage features, labels and the COCO evaluator ---------------

HIDDEN_STAGES = (9, 17, 20, 23)  # dump_features' default taps
# YOLOv5n's taps at 640 (80 classes): SPPF, then the three head inputs
TAP_SHAPES = {9: (256, 20, 20), 17: (64, 80, 80), 20: (128, 40, 40),
              23: (256, 20, 20)}
DUMP_CPU_IMAGES = 4  # dump_features on the card against a CPU run
ROI_P = 8  # the estimator CLI's --resize
ROI_BATCH = 128  # load_feature's batch
ROI_CPU_IMAGES = 32  # of the batch, held against the CPU
ROI_AVG_TOL = 1e-6  # roi_align, card against CPU: of the call's largest value
LABEL_COCO_IMAGES = 5000  # COCO val2017
LABEL_COCO_OBJECTS = 7  # objects an image, about val2017's mean
LABEL_COCO_TRAIN_IMAGES = 500  # the CLI converts train2017 too
LABEL_VOC_IMAGES = 20  # each of the five VOC splits
HIDDEN_LABELS = 5  # labels an image: the strong detector's top rows


def hidden_net(dev, img_dir, seed):
    """A seeded full-width YOLOv5n (80 classes, 640), BatchNorm statistics
    from the first 16 letterboxed images."""
    import torch

    from edgeml_tpu_torch.data.loader import decode_image
    from edgeml_tpu_torch.models.common import letterbox_batch

    names = sorted(os.listdir(img_dir))[:16]
    lb, _ = letterbox_batch(
        [decode_image(os.path.join(img_dir, n)) for n in names], 640)
    return seeded_yolov5("n", seed, torch.from_numpy(lb).to(dev), dev)


def tap_name(stage):
    from edgeml_tpu_torch.data.io import V5_STAGE_NAMES

    return f"stage{stage}_{V5_STAGE_NAMES[stage]}_features.npy"


def hidden_phases(dev, tmp, img_dir):
    """[dump_features], [roi_resize], [hidden_cli], [label_cli] and
    [eval_coco]: the hidden-stage feature path, the label converter and the
    COCO evaluator over the 256 serving images."""
    import torch

    root = os.path.join(tmp, "hidden")
    os.makedirs(root)
    walls = {}

    def timed(tag, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[tag] = time.perf_counter() - t0
        return out

    net = timed("net", hidden_net, dev, img_dir, 1)
    feat = timed("dump_features", dump_features_phase, dev, root, img_dir,
                 net)
    timed("roi_resize", roi_resize_phase, dev, feat)
    dirs = timed("hidden_cli", hidden_cli_phase, dev, root, img_dir, net,
                 feat)
    del net
    torch.cuda.empty_cache()
    timed("label_cli", label_cli_phase, root)
    timed("eval_coco", eval_coco_phase, dev, dirs)
    line("hidden_wall", total_s=f"{sum(walls.values()):.1f}",
         **{f"{k}_s": f"{v:.1f}" for k, v in walls.items()})


def dump_features_phase(dev, root, img_dir, net):
    """dump_features of the seeded YOLOv5n over the serving images (one
    image a forward, f32, TF32 off): every file's name, dtype and shape, and
    DUMP_CPU_IMAGES images' maps against a CPU run of the same net, each
    within 1e-4 of its largest value. Returns the feature tree."""
    import torch

    from edgeml_tpu_torch.models.infer import dump_features

    names = sorted(os.listdir(img_dir))
    sub = os.path.join(root, "dump_images")
    os.makedirs(sub)
    for n in names[:DUMP_CPU_IMAGES]:
        shutil.copy(os.path.join(img_dir, n), sub)
    # the card's run on the few images doubles as the warm-up
    dump_features(net, sub, os.path.join(root, "dump_card"))
    dump_features(copy.deepcopy(net).cpu(), sub,
                  os.path.join(root, "dump_cpu"), device="cpu")
    worst = 0.0
    for n in names[:DUMP_CPU_IMAGES]:
        stem = n.rsplit(".", 1)[0]
        for stage in HIDDEN_STAGES:
            a, b = (np.load(os.path.join(root, d, stem, tap_name(stage)))
                    for d in ("dump_card", "dump_cpu"))
            worst = max(worst, float(np.abs(a - b).max())
                        / float(np.abs(b).max()))
    feat = os.path.join(root, "features")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dump_features(net, img_dir, feat)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_bytes = 0
    for n in names:
        d = os.path.join(feat, n.rsplit(".", 1)[0])
        if sorted(os.listdir(d)) != sorted(tap_name(s) for s in HIDDEN_STAGES):
            fail(f"dump_features: files of {d}: {sorted(os.listdir(d))}")
        for stage in HIDDEN_STAGES:
            a = np.load(os.path.join(d, tap_name(stage)), mmap_mode="r")
            if a.dtype != np.float32 or a.shape != TAP_SHAPES[stage]:
                fail(f"dump_features: {d} stage {stage}: {a.dtype} {a.shape}")
            n_bytes += a.nbytes
    if len(os.listdir(feat)) != len(names):
        fail(f"dump_features: {len(os.listdir(feat))} directories for "
             f"{len(names)} images")
    # where an image's time goes: the forward alone (a device-resident
    # letterboxed image), the four maps' copies to the host, their writes
    from edgeml_tpu_torch.data.loader import decode_image
    from edgeml_tpu_torch.models.common import letterbox_batch

    lb, _ = letterbox_batch([decode_image(os.path.join(img_dir, names[0]))],
                            640)
    x = torch.from_numpy(lb).to(dev)
    fwd_ms = cuda_ms(lambda: net.taps(x, HIDDEN_STAGES), 20)
    taps = net.taps(x, HIDDEN_STAGES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        maps = [taps[st][0].cpu().numpy() for st in HIDDEN_STAGES]
    d2h_ms = (time.perf_counter() - t0) / 20 * 1e3
    probe = os.path.join(root, "save_probe")
    os.makedirs(probe)
    t0 = time.perf_counter()
    for i in range(20):
        for st, a in zip(HIDDEN_STAGES, maps):
            np.save(os.path.join(probe, f"{i}_{tap_name(st)}"), a)
    save_ms = (time.perf_counter() - t0) / 20 * 1e3
    shutil.rmtree(probe)
    line("dump_features", images=len(names), stages=repr(HIDDEN_STAGES),
         files=len(names) * len(HIDDEN_STAGES), mb=f"{n_bytes / 1e6:.1f}",
         wall_s=f"{wall:.2f}", img_s=f"{len(names) / wall:.1f}",
         ms_per_img=f"{wall / len(names) * 1e3:.1f}",
         forward_ms=f"{fwd_ms:.2f}", d2h_ms=f"{d2h_ms:.2f}",
         save_ms=f"{save_ms:.2f}",
         vs_cpu_images=DUMP_CPU_IMAGES, max_rel_err=f"{worst:.3e}",
         tol=f"{CPU_SUITE_TOL:g} x each map's max")
    if not worst < CPU_SUITE_TOL:
        fail(f"dump_features: the card's maps disagree with the CPU's "
             f"({worst:.3e})")
    return feat


def roi_resize_phase(dev, feat):
    """roi_resize_batch on the card against the CPU path for stages 17 and
    23 at P = ROI_P, avg and max, on ROI_BATCH dumped maps cropped to
    seeded ragged (h, w) and square-padded top-left as load_feature builds
    them: max bit-equal, avg within ROI_AVG_TOL of its largest value; the
    card's time per batch against its bytes bound."""
    import torch

    from edgeml_tpu_torch.ops.roi import roi_resize, roi_resize_batch

    rng = np.random.default_rng(8)
    images = sorted(os.listdir(feat))[:ROI_BATCH]
    n_cpu = min(ROI_CPU_IMAGES, len(images))
    for stage in (17, 23):
        c, s, _ = TAP_SHAPES[stage]
        sizes = rng.integers(s // 2, s + 1, (len(images), 2)).astype(
            np.float32)
        sizes[0] = s
        f = np.zeros((len(images), c, s, s), np.float32)
        for i, img in enumerate(images):
            h, w = sizes[i].astype(int)
            f[i, :, :h, :w] = np.load(
                os.path.join(feat, img, tap_name(stage)))[:, :h, :w]
        f_dev = torch.from_numpy(f).to(dev)
        sz_dev = torch.from_numpy(sizes).to(dev)
        bound = (f.nbytes + f.nbytes // (s * s) * ROI_P * ROI_P) \
            / H100_BYTES * 1e3
        for func in ("max", "avg"):
            # the CPU holds the first ROI_CPU_IMAGES (an image's result does
            # not depend on its batch: tests/test_torch_port_roi.py)
            card = roi_resize_batch(f, sizes, ROI_P, func)[:n_cpu]
            cpu = roi_resize_batch(f[:n_cpu], sizes[:n_cpu], ROI_P, func,
                                   device="cpu")
            err = float(np.abs(card - cpu).max())
            rel = err / float(np.abs(cpu).max())
            ms = cuda_ms(lambda: roi_resize(f_dev, sz_dev, ROI_P, func), 5)
            line("roi_resize", stage=stage, func=func, batch=len(images),
                 shape=repr((c, s, s)), out=ROI_P, ms=f"{ms:.3f}",
                 vs_cpu_images=n_cpu,
                 bound_ms=f"{bound:.4f}", bound_by="bytes",
                 max_abs_err=f"{err:.3e}", max_rel_err=f"{rel:.3e}",
                 tol="bit-equal" if func == "max"
                 else f"{ROI_AVG_TOL:g} x the largest value")
            if card.shape != (n_cpu, c, ROI_P, ROI_P) or not (
                    err == 0 if func == "max" else rel <= ROI_AVG_TOL):
                fail(f"roi_resize: stage {stage} {func}: the card disagrees "
                     f"with the CPU ({err:.3e})")
        del f_dev
        torch.cuda.empty_cache()


def write_labels(strong_dir, label_dir, k):
    """Labels from the strong detector's files: each image's k most
    confident rows as "cls x y w h"."""
    os.makedirs(label_dir)
    for n in sorted(os.listdir(strong_dir)):
        rows = np.loadtxt(os.path.join(strong_dir, n), ndmin=2)
        with open(os.path.join(label_dir, n), "w") as f:
            f.writelines(f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} "
                         f"{r[4]:.6f}\n" for r in rows[:k])


def hidden_cli_phase(dev, root, img_dir, net, feat):
    """The hidden-stage chain on the card: detection files of the weak
    (seeded YOLOv5n) and the strong detector (a second seeded YOLOv5n),
    labels from the strong's top rows, the reward CLI (ORIE), the feature
    tree of [dump_features], the split CLI, the regression CLI on stage 23
    RoI-pooled to ROI_P (the CNN, CNN_EPOCHS epochs, 5 folds) and the
    test CLI; each step's wall, the files checked. Returns the weak, strong
    and label directories."""
    from edgeml_tpu_torch.cli import dataset_split as cs
    from edgeml_tpu_torch.cli import regression as cr
    from edgeml_tpu_torch.cli import reward as crw
    from edgeml_tpu_torch.cli import test as ct
    from edgeml_tpu_torch.models.infer import run_detection

    out = lambda *p: os.path.join(root, "cli", *p)  # noqa: E731
    os.makedirs(out())
    weak, strong, labels = out("weak"), out("strong"), out("labels")
    walls = {}
    t0 = time.perf_counter()
    run_detection(net, img_dir, weak, batch_size=BATCH, fmt="txt",
                  device=dev)
    walls["detect_weak"] = time.perf_counter() - t0
    strong_net = hidden_net(dev, img_dir, 2)
    run_detection(strong_net, img_dir, strong, batch_size=BATCH, fmt="txt",
                  device=dev)
    del strong_net
    write_labels(strong, labels, HIDDEN_LABELS)
    reward = out("rewards", f"orie{ORIE_E}.npz")
    steps = [
        ("reward", crw, [weak, strong, labels, out("rewards"), "--method",
                         "orie", "--num-ensemble", str(ORIE_E)]),
        ("dataset_split", cs, [labels, out("split.npy")]),
        ("regression_CNN_s23_r8", cr, [
            feat, reward, out("split.npy"), out("est"), "--stage", "23",
            "--resize", str(ROI_P), "--model", "CNN", "--model-dir",
            out("wts")]),
        ("test", ct, [weak, strong, labels, out("split.npy"), out("test"),
                      "--estimates", out("est_best")]),
    ]
    cwd = os.getcwd()
    cnn_opt = cr.CNNOpt
    cr.CNNOpt = lambda: cnn_cut(cnn_opt)
    os.chdir(out())  # the CNN's loss figures land in the working directory
    try:
        for tag, mod, argv in steps:
            t0 = time.perf_counter()
            quiet(lambda: mod.main(mod.getargs(argv)))
            walls[tag] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        cr.CNNOpt = cnn_opt
    n = len(os.listdir(img_dir))
    r = np.load(reward)["reward"]
    split = np.load(out("split.npy"))
    if r.shape != (n,) or not np.isfinite(r).all() or \
            split.shape != (EST_FOLDS, n):
        fail(f"hidden CLI: rewards {r.shape} or split {split.shape}")
    for d in (out("est_best"), out("est_last")):
        for k, v in enumerate(split):
            est = np.load(os.path.join(d, f"estimate{k + 1}.npz"))
            if est["val_est"].shape != (int(v.sum()),) or \
                    not np.isfinite(est["val_est"]).all():
                fail(f"hidden CLI: bad estimates in {d}")
    tm = np.load(out("test", "test_map.npy"))
    if not (tm.shape == (1, 11) and np.isfinite(tm).all()):
        fail(f"hidden CLI: test_map.npy {tm.shape}")
    line("hidden_cli", images=n, stage=23, resize=ROI_P, folds=len(split),
         cnn_epochs=CNN_EPOCHS,
         **{f"{k}_s": f"{v:.2f}" for k, v in walls.items()},
         reward_mean=f"{r.mean():.4f}", map_at_0=f"{tm[0, 0]:.4f}",
         map_at_1=f"{tm[0, -1]:.4f}")
    return weak, strong, labels


def write_coco_tree(root, rng):
    """A synthetic COCO annotation tree: val2017 with LABEL_COCO_IMAGES
    images of LABEL_COCO_OBJECTS objects each, train2017 with
    LABEL_COCO_TRAIN_IMAGES, COCO's 80 category ids."""
    cat_ids = [i for i in range(1, 91) if i not in (
        12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
    os.makedirs(os.path.join(root, "annotations"))
    for split, n in (("val", LABEL_COCO_IMAGES),
                     ("train", LABEL_COCO_TRAIN_IMAGES)):
        w = rng.integers(200, 641, n)
        h = rng.integers(200, 641, n)
        images = [{"id": int(i), "file_name": f"{i:012d}.jpg",
                   "width": int(w[i]), "height": int(h[i])} for i in range(n)]
        m = n * LABEL_COCO_OBJECTS
        img = np.repeat(np.arange(n), LABEL_COCO_OBJECTS)
        bw = rng.uniform(0.05, 0.5, m) * w[img]
        bh = rng.uniform(0.05, 0.5, m) * h[img]
        bx = rng.uniform(0, 1, m) * (w[img] - bw)
        by = rng.uniform(0, 1, m) * (h[img] - bh)
        cats = rng.choice(cat_ids, m)
        anns = [{"id": j + 1, "image_id": int(img[j]),
                 "category_id": int(cats[j]),
                 "bbox": [round(float(bx[j]), 2), round(float(by[j]), 2),
                          round(float(bw[j]), 2), round(float(bh[j]), 2)],
                 "area": float(bw[j] * bh[j]), "iscrowd": 0}
                for j in range(m)]
        with open(os.path.join(root, "annotations",
                               f"instances_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": c} for c in cat_ids]}, f)
    return cat_ids


def write_voc_tree(root, rng):
    """A small synthetic VOCdevkit: LABEL_VOC_IMAGES images in each of the
    five splits, 1-4 objects an image, some difficult."""
    from edgeml_tpu_torch.dataprep import VOC_CLASS_NAMES, VOC_SPLITS

    for year, image_set in VOC_SPLITS:
        dev = os.path.join(root, "VOCdevkit", f"VOC{year}")
        os.makedirs(os.path.join(dev, "ImageSets", "Main"), exist_ok=True)
        os.makedirs(os.path.join(dev, "Annotations"), exist_ok=True)
        ids = [f"{year}_{image_set}_{i:04d}" for i in range(LABEL_VOC_IMAGES)]
        with open(os.path.join(dev, "ImageSets", "Main",
                               f"{image_set}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
        for img_id in ids:
            objs = "".join(
                f"<object><name>{rng.choice(VOC_CLASS_NAMES)}</name>"
                f"<difficult>{int(rng.random() < 0.1)}</difficult><bndbox>"
                f"<xmin>{x}</xmin><xmax>{x + 40}</xmax><ymin>{y}</ymin>"
                f"<ymax>{y + 30}</ymax></bndbox></object>"
                for x, y in rng.integers(1, 300, (int(rng.integers(1, 5)), 2)))
            with open(os.path.join(dev, "Annotations", f"{img_id}.xml"),
                      "w") as f:
                f.write(f"<annotation><size><width>500</width><height>375"
                        f"</height></size>{objs}</annotation>")


def label_cli_phase(root):
    """cli.label on a synthetic COCO tree (val2017's 5,000 images, 7 objects
    each) and a small VOC tree: the file count, one file's rows against the
    conversion done here by hand, the wall."""
    from edgeml_tpu_torch.cli import label as cl

    rng = np.random.default_rng(12)
    coco, voc = os.path.join(root, "coco"), os.path.join(root, "voc")
    cat_ids = write_coco_tree(coco, rng)
    write_voc_tree(voc, rng)
    walls = {}
    for tag, data in (("coco", coco), ("voc", voc)):
        t0 = time.perf_counter()
        cl.main(cl.getargs([data, os.path.join(root, f"labels_{tag}"),
                            "--dataset", tag]))
        walls[tag] = time.perf_counter() - t0
    val = os.path.join(root, "labels_coco", "val2017")
    n_coco = len(os.listdir(val))
    n_train = len(os.listdir(os.path.join(root, "labels_coco", "train2017")))
    with open(os.path.join(coco, "annotations",
                           "instances_val2017.json")) as f:
        anno = json.load(f)
    im = anno["images"][0]
    want = [(cat_ids.index(a["category_id"]),
             (a["bbox"][0] + a["bbox"][2] / 2) / im["width"],
             (a["bbox"][1] + a["bbox"][3] / 2) / im["height"],
             a["bbox"][2] / im["width"], a["bbox"][3] / im["height"])
            for a in anno["annotations"] if a["image_id"] == im["id"]]
    with open(os.path.join(val, im["file_name"].split(".")[0] + ".txt")) as f:
        got = [tuple(float(v) for v in r.split()) for r in f.read().split(
            "\n") if r]
    n_voc = sum(len(os.listdir(os.path.join(root, "labels_voc", d)))
                for d in os.listdir(os.path.join(root, "labels_voc")))
    line("label_cli", coco_images=n_coco, coco_train_images=n_train,
         coco_objects=len(anno["annotations"]), coco_wall_s=f"{walls['coco']:.2f}",
         voc_images=n_voc, voc_wall_s=f"{walls['voc']:.2f}",
         first_file_rows=len(got))
    if not (n_coco == LABEL_COCO_IMAGES and n_train == LABEL_COCO_TRAIN_IMAGES
            and n_voc == 5 * LABEL_VOC_IMAGES and got == want
            and len(got) == LABEL_COCO_OBJECTS):
        fail("label CLI: wrong file count or rows")


def eval_coco_phase(dev, dirs):
    """DetectionEvaluator over the [hidden_cli] detection files of both
    detectors and its labels: style="greedy" on the card and on the CPU
    (AP@[.5:.95], AP@.5 and AP@.75 bit-equal), then style="coco" once on
    the strong detector's; the times of each."""
    import torch

    from edgeml_tpu_torch.data import io as tio
    from edgeml_tpu_torch.eval_coco import DetectionEvaluator

    weak, strong, labels = dirs
    names = tio.list_image_names(labels)
    gts = [g if len(g) else (np.zeros(0), np.zeros((0, 4)))
           for g in tio.load_data(labels, names)]
    out = {}
    for tag, d in (("weak", weak), ("strong", strong)):
        dets = [r if len(r) else (np.zeros(0), np.zeros((0, 4)), np.zeros(0))
                for r in tio.load_data(d, names, True)]
        res, ms = {}, {}
        for where in ("cuda", "cpu", "cuda"):  # the first card run warms up
            ev = DetectionEvaluator(device=where)
            ev.update(dets, gts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[where] = ev.summarize(verbose=False)
            ms[where] = (time.perf_counter() - t0) * 1e3
        card, cpu = res["cuda"], res["cpu"]
        if not all(card[k] == cpu[k] for k in ("map", "map50", "map75")):
            fail(f"eval_coco: the card's greedy APs of the {tag} detector "
                 f"differ from the CPU's")
        out.update({f"{tag}_dets": sum(len(r[0]) for r in dets),
                    f"{tag}_map": f"{card['map']:.6f}",
                    f"{tag}_map50": f"{card['map50']:.6f}",
                    f"{tag}_map75": f"{card['map75']:.6f}",
                    f"{tag}_card_ms": f"{ms['cuda']:.1f}",
                    f"{tag}_cpu_ms": f"{ms['cpu']:.1f}"})
    ev = DetectionEvaluator(style="coco")
    ev.update(dets, gts)
    t0 = time.perf_counter()
    coco = ev.summarize(verbose=False)
    coco_ms = (time.perf_counter() - t0) * 1e3
    line("eval_coco", images=len(names), labels=sum(len(g[0]) for g in gts),
         **out, card_equals_cpu=True, coco_strong_map=f"{coco['map']:.6f}",
         coco_strong_map50=f"{coco['map50']:.6f}", coco_ms=f"{coco_ms:.1f}")
    if not (0 < float(out["strong_map"]) <= float(out["strong_map50"]) <= 1
            and 0 < coco["map"] <= 1):
        fail("eval_coco: the strong detector's APs out of range")


TRAIN_BATCH = 32
TRAIN_SIZE = {"yolo": 640, "ssd": 320}  # YOLOv5n's letterbox, SSDLite320's
TRAIN_STEPS = 30  # steps on one fixed batch: the loss must fall
TRAIN_SPLIT_FROM = 10  # steps whose stage times are averaged
TRAIN_LR = 0.01
TRAIN_CPU_BATCH = {"yolo": 2, "ssd": 8}
# one step, card against CPU, from the same weights: the loss sees the
# same parameters (the forward's rounding only); the step's update carries
# the gradients' rounding, held as the norm of the difference over the norm
# of the CPU's update, the whole model at once, each family at its own
# limit: YOLOv5n read 5.2e-05, SSDLite (batch 8) 1.8e-03 on an NVIDIA H100
# 80GB HBM3 at 700 W, its BatchNorms on 1x1 maps ill-conditioned and their
# rounding reaching every gradient behind them; the new BatchNorm
# statistics the batch moments' rounding. The same step with TF32 on is the control:
# the limits must catch it.
TRAIN_LOSS_TOL = 1e-5
TRAIN_UPDATE_TOL = {"yolo": 1e-3, "ssd": 1e-2}
TRAIN_STATS_TOL = 1e-4
TRAIN_CLI_BATCH = 16
EVAL_IMAGES = 32
# the trained checkpoint is served at this threshold: after one epoch
# YOLOv5n scores about 1e-5 (its objectness and class priors)
SERVE_CONF = 1e-6
EVAL_AP_TOL = 3e-5
# the trained net's scores, card against CPU, relative to each score
TRAINED_SCORE_TOL = 1e-5
TIE_TOP = 100  # the top candidates an image whose score gaps are read


def train_targets(rng, b, t=8):
    """(B, t, 5) seeded [cls, x, y, w, h] rows, 1 to t a image, and their
    validity."""
    tg = np.zeros((b, t, 5), np.float32)
    valid = np.zeros((b, t), bool)
    for i in range(b):
        k = int(rng.integers(1, t + 1))
        wh = rng.uniform(0.05, 0.5, (k, 2))
        xy = rng.uniform(wh / 2, 1 - wh / 2)
        tg[i, :k, 0] = rng.integers(0, 20, k)
        tg[i, :k, 1:3], tg[i, :k, 3:5] = xy, wh
        valid[i, :k] = True
    return tg, valid


def train_inputs(img_dir, family):
    """The first TRAIN_BATCH serving images as the family trains on them
    (YOLOv5: 640 letterbox; SSDLite: 320 square resize, normalised) and
    seeded targets."""
    from edgeml_tpu_torch.data.loader import decode_image
    from edgeml_tpu_torch.models.common import letterbox_batch
    from edgeml_tpu_torch.models.infer import square_batch

    names = sorted(os.listdir(img_dir))[:TRAIN_BATCH]
    imgs = [decode_image(os.path.join(img_dir, n)) for n in names]
    size = TRAIN_SIZE[family]
    x = letterbox_batch(imgs, size)[0] if family == "yolo" \
        else square_batch(imgs, size)
    tg, valid = train_targets(np.random.default_rng(11), TRAIN_BATCH)
    return x, tg, valid


def step_errors(net_g, net_c, before, losses):
    """(loss, update norm, largest update, stats) errors of the card's step
    against the CPU's, and the parameter of the largest update error."""
    l_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    s_err = u_max = big = sq_diff = sq_upd = 0.0
    worst = ""
    for (k, a), b in zip(net_g.state_dict().items(),
                         net_c.state_dict().values()):
        if not a.is_floating_point():
            continue
        d = (a.cpu() - b).double()
        err = float(d.abs().max())
        if "running" in k:
            s_err = max(s_err, err / max(float(b.abs().max()), 1.0))
            continue
        upd = (b - before[k]).double()
        sq_diff += float((d * d).sum())
        sq_upd += float((upd * upd).sum())
        big = max(big, float(upd.abs().max()))
        if err > u_max:
            u_max, worst = err, k
    return l_err, math.sqrt(sq_diff / sq_upd), u_max / big, s_err, worst


def train_step_vs_cpu(tag, family, make_net, x, tg, valid, dev):
    """One SGD step on the card and on the CPU from the same weights, held
    to the family's limits; then the control: the card's step with TF32 on,
    which the limits must catch."""
    import torch

    from edgeml_tpu_torch.device import exact_f32_cuda
    from edgeml_tpu_torch.models.engine import make_family_train_step
    from edgeml_tpu_torch.models.train import TrainConfig

    net_c = make_net()
    before = {k: v.clone() for k, v in net_c.state_dict().items()}
    nets_g = {"f32": copy.deepcopy(net_c).to(dev),
              "tf32": copy.deepcopy(net_c).to(dev)}
    losses = {}
    for where, net in (("f32", nets_g["f32"]), ("tf32", nets_g["tf32"]),
                       ("cpu", net_c)):
        torch.backends.cuda.matmul.allow_tf32 = where == "tf32"
        torch.backends.cudnn.allow_tf32 = where == "tf32"
        _, step = make_family_train_step(net, TrainConfig(lr=TRAIN_LR))
        loss, _ = step(*(torch.from_numpy(a).to(net_device(net))
                         for a in (x, tg, valid)), TRAIN_LR)
        losses[where] = float(loss)
    exact_f32_cuda()
    u_tol = TRAIN_UPDATE_TOL[family]
    tol = (f"loss {TRAIN_LOSS_TOL:g}, update norm {u_tol:g}, "
           f"stats {TRAIN_STATS_TOL:g}")
    passed = {}
    for mode, net_g in nets_g.items():
        l_err, u_err, u_max, s_err, worst = step_errors(
            net_g, net_c, before, {"cuda": losses[mode], "cpu": losses["cpu"]})
        passed[mode] = (l_err <= TRAIN_LOSS_TOL and u_err <= u_tol
                        and s_err <= TRAIN_STATS_TOL)
        line(f"{tag}_step_vs_cpu" + ("" if mode == "f32" else "_tf32_control"),
             batch=len(x), loss=f"{losses['cpu']:.6f}",
             loss_rel_err=f"{l_err:.3e}", update_norm_err=f"{u_err:.3e}",
             update_max_err=f"{u_max:.3e}", worst_param=worst,
             stats_err=f"{s_err:.3e}", tol=tol, within=passed[mode])
    if not passed["f32"]:
        fail(f"{tag}: the card's train step disagrees with the CPU's")
    if passed["tf32"]:
        fail(f"{tag}: the limits do not tell the step with TF32 on from the "
             f"f32 step")


def net_device(net):
    return next(net.parameters()).device


def train_family_phase(tag, make_net, x, tg, valid, dev):
    """[train_yolo] / [train_ssd]: one step card against CPU, then per dtype
    (f32, bf16) TRAIN_STEPS SGD steps with the EMA on one fixed batch: the
    loss must fall; each step's stage times (forward, loss, backward,
    optimiser, EMA) from CUDA events, img/s, peak GiB."""
    import torch

    from edgeml_tpu_torch.models.engine import make_family_train_step
    from edgeml_tpu_torch.models.train import ModelEMA, TrainConfig

    nb = TRAIN_CPU_BATCH[tag]
    train_step_vs_cpu(f"train_{tag}", tag, make_net, x[:nb], tg[:nb],
                      valid[:nb], dev)
    xd, tgd, vd = (torch.from_numpy(a).to(dev) for a in (x, tg, valid))
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        net = make_net().to(dev)
        _, step = make_family_train_step(net, TrainConfig(lr=TRAIN_LR),
                                         dtype=dtype)
        ema = ModelEMA(net)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, split = [], []
        t0 = time.perf_counter()
        for it in range(TRAIN_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            net.train()
            ev[0].record()
            pred = step.forward(xd)
            ev[1].record()
            total, _ = step.loss(pred, tgd, vd)
            ev[2].record()
            grads = step.grads(total)
            ev[3].record()
            step.opt.step(grads, TRAIN_LR)
            ev[4].record()
            ema.update(net)
            ev[5].record()
            torch.cuda.synchronize()
            losses.append(float(total.detach()))
            if it == 0:
                first_s = time.perf_counter() - t0
            if it >= TRAIN_SPLIT_FROM:
                split.append([ev[i].elapsed_time(ev[i + 1])
                              for i in range(5)])
        wall = time.perf_counter() - t0
        ms = np.mean(split, axis=0)
        step_ms = float(ms.sum())
        peak = torch.cuda.max_memory_allocated() / 2**30
        line(f"train_{tag}_{label}", batch=TRAIN_BATCH, steps=TRAIN_STEPS,
             loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
             step_ms=f"{step_ms:.3f}", forward_ms=f"{ms[0]:.3f}",
             loss_ms=f"{ms[1]:.3f}", backward_ms=f"{ms[2]:.3f}",
             optimizer_ms=f"{ms[3]:.3f}", ema_ms=f"{ms[4]:.3f}",
             device_img_s=f"{TRAIN_BATCH / step_ms * 1e3:.1f}",
             wall_img_s=f"{TRAIN_BATCH * TRAIN_STEPS / wall:.1f}",
             first_step_s=f"{first_s:.2f}", peak_gib=f"{peak:.2f}")
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail(f"train_{tag} {label}: the loss did not fall on a fixed "
                 f"batch ({losses[0]:.4f} -> {losses[-1]:.4f})")
        del net, ema, step, grads, pred, total
        torch.cuda.empty_cache()


def write_train_labels(img_dir, lab_dir):
    """Seeded YOLO label files for the serving images (1 to 8 objects)."""
    os.makedirs(lab_dir)
    rng = np.random.default_rng(12)
    for n in sorted(os.listdir(img_dir)):
        tg, valid = train_targets(rng, 1)
        rows = tg[0][valid[0]]
        with open(os.path.join(lab_dir, n.rsplit(".", 1)[0] + ".txt"),
                  "w") as f:
            f.writelines(f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} "
                         f"{r[4]:.6f}\n" for r in rows)


def train_cli_phase(dev, root, img_dir, shapes):
    """[train_cli]: the train CLI over the 256 serving images with seeded
    labels (--preset yolo --augment yolo --ema, one epoch at batch 16, the
    HSV jitter on the card): the loader's time a batch on one thread, the
    CLI loop's wait for each batch and its step, the card's step alone and
    its share of the CLI's time a step (host-bound below one half); then
    the detect CLI serves the checkpoint (its EMA) into per-image files.
    Returns the CLI's result."""
    import torch

    from edgeml_tpu_torch.cli import detect as detect_cli
    from edgeml_tpu_torch.cli import train as train_cli
    from edgeml_tpu_torch.data.loader import decode_image
    from edgeml_tpu_torch.data.yolo_aug import yolo_augment_batch
    from edgeml_tpu_torch.data.io import load_data
    from edgeml_tpu_torch.models.engine import make_family_train_step
    from edgeml_tpu_torch.models.train import pad_targets, yolo_recipe_config

    lab_dir = os.path.join(root, "labels")
    write_train_labels(img_dir, lab_dir)
    save = os.path.join(root, "ckpt")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = train_cli.main(train_cli.getargs(
            [img_dir, save, "--label-dir", lab_dir, "--model", "yolov5n",
             "--dataset", "coco", "-b", str(TRAIN_CLI_BATCH), "--epochs",
             "1", "--preset", "yolo", "--augment", "yolo", "--ema",
             "--img-size", str(TRAIN_SIZE["yolo"])]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = N_IMAGES // TRAIN_CLI_BATCH
    if sorted(os.listdir(save)) != ["checkpoint.pth", "model_0.pth"] or \
            not np.isfinite(res["epoch_loss"][0]) or \
            res["ema"].n_updates != steps:
        fail("train_cli: wrong checkpoint files, loss or EMA updates")
    # the loader's work for one batch on one thread; the CLI's own loop: its
    # wait for each batch (the loader's threads, the copy to the card and
    # the jitter) and its step (update, EMA, the loss read back), medians
    # over the epoch's steps; and the card's step alone at the same batch
    names = sorted(os.listdir(img_dir))[:TRAIN_CLI_BATCH]
    labs = load_data(lab_dir, [n.rsplit(".", 1)[0] for n in names])
    t1 = time.perf_counter()
    ex = [(decode_image(os.path.join(img_dir, n)), lab)
          for n, lab in zip(names, labs)]
    t2 = time.perf_counter()
    lb, rows, gains = yolo_augment_batch(ex, TRAIN_SIZE["yolo"], [0, 0, 0],
                                         hsv="device")
    tg, valid = pad_targets(rows, 64)
    t3 = time.perf_counter()
    meters = res["loggers"][0].meters
    wait_ms = meters["data_time"].median * 1e3
    cli_step_ms = meters["step_time"].median * 1e3
    net = res["state"]
    _, step = make_family_train_step(net, yolo_recipe_config(1))
    xd, tgd, vd = (torch.from_numpy(a).to(dev) for a in (lb, tg, valid))
    step_ms = cuda_ms(lambda: step(xd, tgd, vd, 1e-4), 5)
    loader_ms = (t3 - t1) * 1e3
    # the detect CLI on the checkpoint
    out = os.path.join(root, "dets")
    t4 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        detect_cli.main(detect_cli.getargs(
            [img_dir, out, "--model", "yolov5n", "--model-path",
             os.path.join(save, "checkpoint.pth"), "--batch-size", "64",
             "--conf-thres", str(SERVE_CONF)]))
    detect_s = time.perf_counter() - t4
    if "EMA weights" not in said.getvalue():
        fail("train_cli: the detect CLI did not serve the EMA weights")
    n_rows = check_files(out, shapes, 80, SERVE_CONF)
    if n_rows == 0:
        fail("train_cli: the served checkpoint wrote no detections")
    share = step_ms / (wall / steps * 1e3)
    line("train_cli", images=N_IMAGES, batch=TRAIN_CLI_BATCH, steps=steps,
         epoch_loss=f"{res['epoch_loss'][0]:.4f}", wall_s=f"{wall:.2f}",
         e2e_step_ms=f"{wall / steps * 1e3:.1f}",
         loader_ms_one_thread=f"{loader_ms:.1f}",
         decode_ms=f"{(t2 - t1) * 1e3:.1f}",
         augment_ms=f"{(t3 - t2) * 1e3:.1f}",
         cli_wait_ms=f"{wait_ms:.1f}", cli_step_ms=f"{cli_step_ms:.1f}",
         device_step_ms=f"{step_ms:.1f}", device_share=f"{share:.3f}",
         host_bound=share < 0.5,
         detect_s=f"{detect_s:.2f}", files=N_IMAGES, rows=n_rows)
    return res


def own_gt(net, images, family, k=3, conf=0.001):
    """GT rows from a net's own top-k detections above ``conf``, nudged
    (its APs are then neither 0 nor 1)."""
    import torch

    from edgeml_tpu_torch.models.common import letterbox_batch
    from edgeml_tpu_torch.models.infer import (
        _detect_generic, detect_batch, square_batch,
    )

    dev = net_device(net)
    net.eval()
    rows = []
    for s in range(0, len(images), 16):
        chunk = images[s:s + 16]
        if family == "yolo":
            lb, meta = letterbox_batch(chunk, net.img_size)
            hw = np.array([im.shape[:2] for im in chunk], np.float32)
            d, v = detect_batch(net, *(torch.from_numpy(a).to(dev)
                                       for a in (lb, meta, hw)), conf, 0.5)
        else:
            d, v = _detect_generic(net, torch.from_numpy(
                square_batch(chunk, net.image_size)).to(dev), conf, 0.5)
        rows += [di[vi][:k, :5] for di, vi in zip(d.cpu().numpy(),
                                                   v.cpu().numpy())]
    rng = np.random.default_rng(13)
    return [(r * np.r_[1, rng.uniform(0.97, 1.03, 4)]).astype(np.float32)
            for r in rows]


def train_eval_phase(dev, img_dir, trained):
    """[train_eval]: the training engine's ``evaluate`` on the card and on
    the CPU over EVAL_IMAGES serving images, GT from each net's own
    detections, nudged, with the card's launch counts of the suppressors
    and the gather. The serving phases' seeded YOLOv5n and SSDLite320: APs
    within EVAL_AP_TOL. The train CLI's net (its EMA, as the detect CLI
    serves it), which after one epoch scores every candidate near its
    priors: its scores card against CPU within TRAINED_SCORE_TOL, the
    gaps between its top scores against that difference, and its APs card
    against CPU beside the CPU against itself with the stem's weights
    scaled by one rounding (1 + 2^-23). Returns {kernel record name:
    launches}."""
    import torch

    from edgeml_tpu_torch.data.loader import decode_image
    from edgeml_tpu_torch.models.common import letterbox_batch
    from edgeml_tpu_torch.models.engine import evaluate
    from edgeml_tpu_torch.models.infer import square_batch

    images = [decode_image(os.path.join(img_dir, n))
              for n in sorted(os.listdir(img_dir))[:EVAL_IMAGES]]
    calib = images[:16]
    nets = {
        "yolo": seeded_yolov5("n", 1, torch.from_numpy(
            letterbox_batch(calib, 640)[0]).to(dev), dev),
        "ssd": seeded_ssdlite(3, torch.from_numpy(
            square_batch(calib, 320)).to(dev), dev),
    }
    launches = {}

    def count(mono, blocked, gathers):
        for name, n in (("nms_fused_greedy_keep", mono),
                        ("nms_blocked_greedy_keep", blocked),
                        ("gather_rows", gathers)):
            launches[name] = launches.get(name, 0) + n

    for family, net in nets.items():
        gts = own_gt(net, images, family)
        reset_counts()
        t0 = time.perf_counter()
        card = evaluate(net, images, gts, batch_size=16, conf_thres=0.001)
        card_s = time.perf_counter() - t0
        mono, blocked, _, gathers = counts()
        t0 = time.perf_counter()
        cpu = evaluate(copy.deepcopy(net).cpu(), images, gts, batch_size=16,
                       conf_thres=0.001)
        cpu_s = time.perf_counter() - t0
        err = max(abs(card[k] - cpu[k]) for k in ("map", "map50", "map75"))
        line(f"train_eval_{family}", images=EVAL_IMAGES,
             map=f"{card['map']:.6f}", map50=f"{card['map50']:.6f}",
             map75=f"{card['map75']:.6f}", max_ap_err=f"{err:.3e}",
             tol=EVAL_AP_TOL, card_s=f"{card_s:.2f}", cpu_s=f"{cpu_s:.2f}",
             nms_fused=mono, nms_blocked=blocked, gather=gathers)
        if not (err <= EVAL_AP_TOL and 0 < card["map50"] <= 1):
            fail(f"train_eval {family}: the card's APs disagree with the "
                 f"CPU's or are out of range")
        want = (mono > 0 and gathers > 0) if family == "yolo" \
            else blocked > 0
        if not want:
            fail(f"train_eval {family}: evaluate did not launch the "
                 f"suppressor and gather kernels ({mono}, {blocked}, "
                 f"{gathers})")
        count(mono, blocked, gathers)
    trained_eval(dev, trained, images, count)
    return launches


def trained_eval(dev, net, images, count):
    """The trained-net half of [train_eval] (see ``train_eval_phase``)."""
    import torch

    from edgeml_tpu_torch.models.common import letterbox_batch
    from edgeml_tpu_torch.models.engine import evaluate

    net = net.to(dev).eval()
    net_c = copy.deepcopy(net).cpu()
    lb = torch.from_numpy(letterbox_batch(images[:16], net.img_size)[0])
    with torch.no_grad():
        scores = {}
        for where, m in (("cuda", net), ("cpu", net_c)):
            obj, _, cls = m.predict(lb.to(net_device(m)).float() / 255.0)
            scores[where] = (obj[..., None] * cls).amax(-1).cpu().double()
    card, cpu = scores["cuda"], scores["cpu"]
    score_err = float(((card - cpu).abs() / cpu.abs()).max())
    top = torch.sort(cpu, dim=1, descending=True).values[:, :TIE_TOP]
    spread = float(((top[:, 0] - top[:, -1]) / top[:, 0]).median())
    gaps = (top[:, :-1] - top[:, 1:]) / top[:, :-1]
    tie_share = float((gaps < score_err).double().mean())
    gts = own_gt(net, images, "yolo", conf=SERVE_CONF)
    reset_counts()
    t0 = time.perf_counter()
    ap = {"card": evaluate(net, images, gts, batch_size=16,
                           conf_thres=SERVE_CONF)}
    card_s = time.perf_counter() - t0
    mono, blocked, _, gathers = counts()
    ap["cpu"] = evaluate(net_c, images, gts, batch_size=16,
                         conf_thres=SERVE_CONF)
    with torch.no_grad():
        next(net_c.parameters()).mul_(1 + 2.0 ** -23)
    ap["nudged"] = evaluate(net_c, images, gts, batch_size=16,
                            conf_thres=SERVE_CONF)
    keys = ("map", "map50", "map75")
    ap_err = max(abs(ap["card"][k] - ap["cpu"][k]) for k in keys)
    nudge_err = max(abs(ap["nudged"][k] - ap["cpu"][k]) for k in keys)
    line("train_eval_trained", images=len(images), conf=SERVE_CONF,
         top_score=f"{float(top[:, 0].max()):.6e}",
         top100_spread=f"{spread:.3e}", score_card_cpu_err=f"{score_err:.3e}",
         score_tol=TRAINED_SCORE_TOL, tie_share=f"{tie_share:.3f}",
         map=f"{ap['card']['map']:.6f}", map50=f"{ap['card']['map50']:.6f}",
         ap_card_cpu_err=f"{ap_err:.3e}", ap_cpu_nudged_err=f"{nudge_err:.3e}",
         card_s=f"{card_s:.2f}", nms_fused=mono, gather=gathers)
    if not (score_err <= TRAINED_SCORE_TOL and mono > 0 and gathers > 0
            and all(0 <= ap[w][k] <= 1 for w in ap for k in keys)):
        fail("train_eval: the trained net's scores disagree with the CPU's, "
             "its APs are out of range, or evaluate did not launch the "
             "kernels")
    count(mono, blocked, gathers)


def train_phases(dev, tmp, img_dir, shapes):
    """[train_yolo], [train_ssd], [train_cli], [train_eval]: training of the
    two edge detectors at full width, the train CLI to a served checkpoint,
    and evaluate through the kernels. Returns the kernels' launch counts of
    the train -> evaluate path."""
    import torch

    from edgeml_tpu_torch.models.engine import make_detector

    root = os.path.join(tmp, "train")
    os.makedirs(root)
    walls = {}
    t0 = time.perf_counter()
    x, tg, valid = train_inputs(img_dir, "yolo")
    train_family_phase(
        "yolo", lambda: make_detector(
            "yolov5n", 80, TRAIN_SIZE["yolo"],
            torch.Generator().manual_seed(21)),
        x, tg, valid, dev)
    walls["train_yolo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, tg, valid = train_inputs(img_dir, "ssd")
    train_family_phase(
        "ssd", lambda: make_detector(
            "ssd", 20, TRAIN_SIZE["ssd"], torch.Generator().manual_seed(22)),
        x, tg, valid, dev)
    walls["train_ssd"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = train_cli_phase(dev, root, img_dir, shapes)
    walls["train_cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = train_eval_phase(dev, img_dir, res["ema"].module)
    walls["train_eval"] = time.perf_counter() - t0
    line("train_wall", total_s=f"{sum(walls.values()):.1f}",
         **{f"{k}_s": f"{v:.1f}" for k, v in walls.items()})
    return launches


# ---- training of the frozen-norm families (RetinaNet, Faster R-CNN) -------
FROZEN_SIZE = 640  # ResNet-50-FPN-v2 at the serving size
FROZEN_BATCH = 4
FROZEN_CLASSES = 20  # VOC: num_classes + 1 = 21 columns
FROZEN_STEPS = 20  # steps on one fixed batch: the loss must fall
FROZEN_SPLIT_FROM = 5  # steps whose stage times are averaged
# RetinaNet's box loss climbs from a random init at 0.01 without the
# schedule's warmup (2.35 -> 4.32 -> 3.56 on the CPU at 256); 1e-3 falls
FROZEN_LR = {"retinanet": 1e-3, "faster_rcnn": 1e-2}
# one step card against CPU at a cut size (the CPU's time), from the same
# weights and sampling draws
FROZEN_CPU_SIZE = 256
FROZEN_CPU_BATCH = 2
# its limits per family and dtype: every loss part's relative error and
# the update's (every trained tensor at once) norm of the difference over
# the CPU update's norm, about 5-13x the readings of an NVIDIA H100 80GB
# HBM3 at 700 W: f32 RetinaNet loss 1.0e-07, update 1.6e-05, Faster R-CNN
# 1.6e-07, 1.5e-05; bf16 RetinaNet 3.5e-04, 9.6e-02, Faster R-CNN 2.1e-02
# (its RoI regression part), 5.3e-03. The f32 step with TF32 on is the
# control and must break one (read: RetinaNet 1.6e-04, 3.2e-02; Faster
# R-CNN 2.5e-06, 3.1e-03).
FROZEN_LIMITS = {
    ("retinanet", "f32"): {"loss": 1e-5, "update": 2e-4},
    ("retinanet", "bf16"): {"loss": 2e-3, "update": 0.5},
    ("faster_rcnn", "f32"): {"loss": 1e-5, "update": 2e-4},
    ("faster_rcnn", "bf16"): {"loss": 0.1, "update": 3e-2},
}
FROZEN_SHORT = {"retinanet": "retina", "faster_rcnn": "frcnn"}
FROZEN_CLI_IMAGES = 16
FROZEN_EVAL_IMAGES = 8
FROZEN_SERVE_CONF = 0.01


def frozen_inputs(img_dir, size, b):
    """The first ``b`` serving images as the train CLI feeds the frozen-norm
    families (square resize, normalised) and seeded targets."""
    from edgeml_tpu_torch.data.loader import decode_image
    from edgeml_tpu_torch.models.infer import square_batch

    names = sorted(os.listdir(img_dir))[:b]
    x = square_batch([decode_image(os.path.join(img_dir, n))
                      for n in names], size)
    tg, valid = train_targets(np.random.default_rng(14), b)
    return x, tg, valid


def frozen_net(family, size):
    import torch

    from edgeml_tpu_torch.models.engine import make_detector

    return make_detector(family, FROZEN_CLASSES, size,
                         torch.Generator().manual_seed(23))


def frozen_draws(net, b, t, dev):
    """One step's seeded sampling draws on ``dev`` (None for RetinaNet)."""
    import torch

    from edgeml_tpu_torch.models import faster_rcnn as tfr
    from edgeml_tpu_torch.models.rcnn_loss import uniform_draws

    if not isinstance(net, tfr.FasterRCNN):
        return None
    anchors = tfr.rpn_anchors(net.image_size)
    n_roi = min(net.rpn_post_nms, sum(min(tfr.PRE_NMS, len(a))
                                      for a in anchors)) + t
    draws = uniform_draws(torch.Generator().manual_seed(15), b,
                          sum(len(a) for a in anchors), n_roi, "cpu")
    return type(draws)(*(d.to(dev) for d in draws))


def frozen_step_vs_cpu(tag, family, label, dtype, img_dir, dev):
    """One SGD step at FROZEN_CPU_SIZE on the CPU and on the card (and, in
    f32, on the card with TF32 on) from the same weights and draws: every
    loss part and the update against the CPU's, held to FROZEN_LIMITS."""
    import torch

    from edgeml_tpu_torch.device import exact_f32_cuda
    from edgeml_tpu_torch.models.engine import make_family_train_step
    from edgeml_tpu_torch.models.train import TrainConfig

    x, tg, valid = frozen_inputs(img_dir, FROZEN_CPU_SIZE, FROZEN_CPU_BATCH)
    net_c = frozen_net(family, FROZEN_CPU_SIZE)
    lr = FROZEN_LR[family]
    modes = ["card"] + (["tf32"] if dtype is None else [])
    nets = {m: copy.deepcopy(net_c).to(dev) for m in modes}
    nets["cpu"] = net_c
    before = [p.detach().clone() for p in net_c.parameters()
              if p.requires_grad]
    runs = {}
    for mode, net in nets.items():
        torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
        torch.backends.cudnn.allow_tf32 = mode == "tf32"
        where = net_device(net)
        _, step = make_family_train_step(net, TrainConfig(lr=lr),
                                         dtype=dtype)
        draws = frozen_draws(net, len(x), tg.shape[1], where)
        if draws is not None:
            step.draw_fn = lambda *a, d=draws: d
        loss, parts = step(*(torch.from_numpy(a).to(where)
                             for a in (x, tg, valid)), lr)
        runs[mode] = ({"total": float(loss),
                       **{k: float(v) for k, v in parts.items()}},
                      [p.detach().cpu() for p in step.opt.params])
    exact_f32_cuda()
    lim = FROZEN_LIMITS[(family, label)]
    cpu_parts, cpu_params = runs["cpu"]
    sq_u = sum(float(((p - b).double() ** 2).sum())
               for p, b in zip(cpu_params, before))
    passed = {}
    for mode in modes:
        parts, params = runs[mode]
        errs = {k: abs(parts[k] - v) / abs(v) for k, v in cpu_parts.items()}
        sq_d = sum(float(((a - b).double() ** 2).sum())
                   for a, b in zip(params, cpu_params))
        u_err = math.sqrt(sq_d / sq_u)
        passed[mode] = max(errs.values()) <= lim["loss"] \
            and u_err <= lim["update"]
        line(f"{tag}_step_vs_cpu" + ("" if mode == "card"
                                     else "_tf32_control"),
             size=FROZEN_CPU_SIZE, batch=len(x),
             **{f"cpu_{k}": f"{v:.6f}" for k, v in cpu_parts.items()},
             **{f"{k}_rel_err": f"{e:.3e}" for k, e in errs.items()},
             update_norm_err=f"{u_err:.3e}",
             tol=f"loss {lim['loss']:g}, update norm {lim['update']:g}",
             within=passed[mode])
    if not passed["card"]:
        fail(f"{tag}: the card's train step disagrees with the CPU's")
    if passed.get("tf32"):
        fail(f"{tag}: the limits do not tell the step with TF32 on from the "
             f"f32 step")


def frozen_kernels_at_step(net, step, xd, tgd, vd):
    """The Faster R-CNN step's proposals, kernel against plain on the
    step's own RPN outputs, and the sequential suppressor's and the row
    gather's times at the step's shapes (looped, and the device alone in a
    replayed CUDA graph) beside their bounds. Returns {record name:
    {train_step_ms (the device's), train_step_bound_ms}}."""
    import torch

    from edgeml_tpu_torch.models import faster_rcnn as tfr
    from edgeml_tpu_torch.ops.gather import gather_rows
    from edgeml_tpu_torch.ops.nms_seq import (
        suppress_mask_seq_cuda, suppress_mask_seq_plain,
    )

    seen = {"gather_rows": []}
    real_seq, real_gather = tfr.suppress_mask_seq, tfr.gather_rows

    def seq(*args):
        seen["seq"] = args
        return real_seq(*args)

    def gather(*args):
        seen["gather_rows"].append(args)
        return real_gather(*args)

    net.train()
    with torch.no_grad():
        _, objs, regs = step.forward(xd)
        tfr.suppress_mask_seq, tfr.gather_rows = seq, gather
        try:
            k_boxes, k_valid = net.proposals(objs, regs)
        finally:
            tfr.suppress_mask_seq, tfr.gather_rows = real_seq, real_gather
        with plain_kernels():
            p_boxes, p_valid = net.proposals(objs, regs)
    if not (torch.equal(k_boxes, p_boxes) and torch.equal(k_valid, p_valid)):
        fail("train_frcnn: the step's proposals, kernel != plain")
    boxes, scores, thr, max_keep = seen["seq"]
    kept, picks = suppress_mask_seq_cuda(boxes, scores, thr, max_keep)
    p_kept, p_picks = suppress_mask_seq_plain(boxes, scores, thr, max_keep)
    if not (torch.equal(kept, p_kept) and torch.equal(picks, p_picks)):
        fail("train_frcnn: the step's RPN segments, kernel != plain")
    def seq_run():
        return suppress_mask_seq_cuda(boxes, scores, thr, max_keep)

    calls = seen["gather_rows"]

    def gather_run():
        return [gather_rows(*a) for a in calls]

    seq_ms, g_ms = cuda_ms(seq_run, 20), cuda_ms(gather_run, 20)
    seq_dev, g_dev = device_ms(seq_run), device_ms(gather_run)
    seq_bound, seq_by, _, _, _ = seq_bound_ms(boxes, scores, picks, thr)
    g_bound = sum(gather_bound_ms(a[0], a[1], a[2] if len(a) > 2 else None,
                                  gather_rows(*a))[0] for a in calls)
    line("train_frcnn_proposals_kernel_vs_plain", batch=len(xd),
         segments=tuple(scores.shape)[0], k=tuple(scores.shape)[1],
         proposals_equal=True, proposals=int(k_valid.sum()),
         seq_kernel_ms=f"{seq_ms:.4f}", seq_device_ms=f"{seq_dev:.4f}",
         seq_bound_ms=f"{seq_bound:.4f}", seq_bound_by=seq_by,
         gathers=len(calls), gather_kernel_ms=f"{g_ms:.4f}",
         gather_device_ms=f"{g_dev:.4f}", gather_bound_ms=f"{g_bound:.4f}")
    return {"nms_seq_suppress": {"train_step_ms": seq_dev,
                                 "train_step_bound_ms": seq_bound},
            "gather_rows": {"train_step_ms": g_dev,
                            "train_step_bound_ms": g_bound}}


def frozen_family_phase(family, img_dir, dev):
    """[train_retina_*] / [train_frcnn_*]: per dtype (f32, bf16) one step
    card against CPU, then FROZEN_STEPS SGD steps with the EMA at full
    width on one fixed batch: the loss must fall; each step's stage times
    (forward, loss, backward, optimiser, EMA) from CUDA events, img/s,
    peak GiB, the kernels launched a step, and one step traced (device
    busy time, idle share, the largest device items). Faster R-CNN: its
    forward is the trunk and the RPN head, its loss the proposals, both
    samplings, RoIAlign, the box head and the losses. Returns the kernel
    records' train-step fields."""
    import torch

    from edgeml_tpu_torch.models.engine import make_family_train_step
    from edgeml_tpu_torch.models.train import ModelEMA, TrainConfig

    short = FROZEN_SHORT[family]
    lr = FROZEN_LR[family]
    x, tg, valid = frozen_inputs(img_dir, FROZEN_SIZE, FROZEN_BATCH)
    xd, tgd, vd = (torch.from_numpy(a).to(dev) for a in (x, tg, valid))
    fields = {}
    for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        tag = f"train_{short}_{label}"
        frozen_step_vs_cpu(tag, family, label, dtype, img_dir, dev)
        net = frozen_net(family, FROZEN_SIZE).to(dev)
        _, step = make_family_train_step(net, TrainConfig(lr=lr),
                                         dtype=dtype, seed=16)
        ema = ModelEMA(net)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, split = [], []
        reset_counts()
        t0 = time.perf_counter()
        for it in range(FROZEN_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            net.train()
            ev[0].record()
            pred = step.forward(xd)
            ev[1].record()
            total, _ = step.loss(pred, tgd, vd)
            ev[2].record()
            grads = step.grads(total)
            ev[3].record()
            step.opt.step(grads, lr)
            ev[4].record()
            ema.update(net)
            ev[5].record()
            torch.cuda.synchronize()
            losses.append(float(total.detach()))
            if it == 0:
                first_s = time.perf_counter() - t0
            if it >= FROZEN_SPLIT_FROM:
                split.append([ev[i].elapsed_time(ev[i + 1])
                              for i in range(5)])
        wall = time.perf_counter() - t0
        launched = counts()
        ms = np.mean(split, axis=0)
        step_ms = float(ms.sum())
        peak = torch.cuda.max_memory_allocated() / 2**30
        line(tag, batch=FROZEN_BATCH, size=FROZEN_SIZE, steps=FROZEN_STEPS,
             loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
             step_ms=f"{step_ms:.3f}", forward_ms=f"{ms[0]:.3f}",
             loss_ms=f"{ms[1]:.3f}", backward_ms=f"{ms[2]:.3f}",
             optimizer_ms=f"{ms[3]:.3f}", ema_ms=f"{ms[4]:.3f}",
             device_img_s=f"{FROZEN_BATCH / step_ms * 1e3:.1f}",
             wall_img_s=f"{FROZEN_BATCH * FROZEN_STEPS / wall:.1f}",
             first_step_s=f"{first_s:.2f}", peak_gib=f"{peak:.2f}",
             nms_seq_per_step=launched[2] / FROZEN_STEPS,
             gather_per_step=launched[3] / FROZEN_STEPS)
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            fail(f"{tag}: the loss did not fall on a fixed batch "
                 f"({losses[0]:.4f} -> {losses[-1]:.4f})")
        want = (0, 0, FROZEN_STEPS, 3 * FROZEN_STEPS) \
            if family == "faster_rcnn" else (0, 0, 0, 0)
        if launched != want:
            fail(f"{tag}: kernels launched {launched} in {FROZEN_STEPS} "
                 f"steps, want {want}")
        traced(f"{tag}_trace", lambda: step(xd, tgd, vd, lr))
        if family == "faster_rcnn" and dtype is None:
            fields = frozen_kernels_at_step(net, step, xd, tgd, vd)
            fields["nms_seq_suppress"]["train_step_launches"] = 1
            fields["gather_rows"]["train_step_launches"] = 3
        del net, ema, step, grads, pred, total
        torch.cuda.empty_cache()
    return fields


def frozen_cli_phase(family, dev, root, img_dir, shapes, lab_dir):
    """[train_cli_retina] / [train_cli_frcnn]: the train CLI over the first
    FROZEN_CLI_IMAGES serving images (VOC labels, --ema, one epoch at
    FROZEN_BATCH, 640, --lr FROZEN_LR), the detect CLI on its checkpoint (the EMA), then
    ``evaluate`` of the served net over FROZEN_EVAL_IMAGES images, GT from
    its own detections, on the card and on the CPU, with the kernels the
    card's launched. A net trained a few steps scores alike everywhere:
    the APs' card-CPU difference is printed beside the CPU's own under the
    stem scaled by one rounding, gated only to [0, 1]. Returns {kernel
    record name: launches}."""
    import torch

    from edgeml_tpu_torch.cli import detect as detect_cli
    from edgeml_tpu_torch.cli import train as train_cli
    from edgeml_tpu_torch.data.loader import decode_image
    from edgeml_tpu_torch.models.engine import evaluate

    short = FROZEN_SHORT[family]
    names = sorted(os.listdir(img_dir))[:FROZEN_CLI_IMAGES]
    sub, sub_lab = (os.path.join(root, f"{short}_{d}")
                    for d in ("images", "labels"))
    os.makedirs(sub)
    os.makedirs(sub_lab)
    for n in names:
        shutil.copy(os.path.join(img_dir, n), sub)
        stem = n.rsplit(".", 1)[0] + ".txt"
        shutil.copy(os.path.join(lab_dir, stem), sub_lab)
    save = os.path.join(root, f"{short}_ckpt")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = train_cli.main(train_cli.getargs(
            [sub, save, "--label-dir", sub_lab, "--model", family,
             "--dataset", "voc", "-b", str(FROZEN_BATCH), "--epochs", "1",
             "--ema", "--img-size", str(FROZEN_SIZE), "--lr",
             str(FROZEN_LR[family])]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = FROZEN_CLI_IMAGES // FROZEN_BATCH
    ck = os.path.join(save, "checkpoint.pth")
    with open(ck, "rb") as f:
        payload = pickle.load(f)
    if sorted(os.listdir(save)) != ["checkpoint.pth", "model_0.pth"] or \
            not np.isfinite(res["epoch_loss"][0]) or \
            res["ema"].n_updates != steps or \
            payload["model"]["stats"] is not None:
        fail(f"train_cli_{short}: wrong checkpoint files, loss, EMA updates "
             f"or statistics tree")
    meters = res["loggers"][0].meters
    out = os.path.join(root, f"{short}_dets")
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        detect_cli.main(detect_cli.getargs(
            [sub, out, "--model", family, "--dataset", "voc",
             "--model-path", ck, "--batch-size", "8", "--conf-thres",
             str(FROZEN_SERVE_CONF)]))
    detect_s = time.perf_counter() - t1
    if "EMA weights" not in said.getvalue():
        fail(f"train_cli_{short}: the detect CLI did not serve the EMA")
    n_rows = check_files(out, shapes[:FROZEN_CLI_IMAGES], 20,
                         FROZEN_SERVE_CONF)
    if n_rows == 0:
        fail(f"train_cli_{short}: the served checkpoint wrote no detections")

    net = res["ema"].module.to(dev).eval()
    images = [decode_image(os.path.join(img_dir, n))
              for n in names[:FROZEN_EVAL_IMAGES]]
    gts = own_gt(net, images, family)

    def quiet_eval(m):
        with contextlib.redirect_stdout(io.StringIO()):
            return evaluate(m, images, gts, batch_size=FROZEN_BATCH,
                            conf_thres=0.001)

    reset_counts()
    t2 = time.perf_counter()
    ap = {"card": quiet_eval(net)}
    card_s = time.perf_counter() - t2
    mono, blocked, seq, gathers = counts()
    net_c = copy.deepcopy(net).cpu()
    ap["cpu"] = quiet_eval(net_c)
    with torch.no_grad():
        next(net_c.parameters()).mul_(1 + 2.0 ** -23)
    ap["nudged"] = quiet_eval(net_c)
    keys = ("map", "map50", "map75")
    ap_err = max(abs(ap["card"][k] - ap["cpu"][k]) for k in keys)
    nudge_err = max(abs(ap["nudged"][k] - ap["cpu"][k]) for k in keys)
    line(f"train_cli_{short}", images=FROZEN_CLI_IMAGES,
         batch=FROZEN_BATCH, steps=steps,
         epoch_loss=f"{res['epoch_loss'][0]:.4f}", wall_s=f"{wall:.2f}",
         cli_wait_ms=f"{meters['data_time'].median * 1e3:.1f}",
         cli_step_ms=f"{meters['step_time'].median * 1e3:.1f}",
         detect_s=f"{detect_s:.2f}", files=FROZEN_CLI_IMAGES, rows=n_rows,
         eval_images=FROZEN_EVAL_IMAGES, map=f"{ap['card']['map']:.6f}",
         map50=f"{ap['card']['map50']:.6f}",
         ap_card_cpu_err=f"{ap_err:.3e}",
         ap_cpu_nudged_err=f"{nudge_err:.3e}", eval_card_s=f"{card_s:.2f}",
         nms_blocked=blocked, nms_seq=seq, gather=gathers)
    ok = all(0 <= ap[w][k] <= 1 for w in ap for k in keys) and blocked > 0
    if family == "faster_rcnn":
        ok = ok and seq > 0 and gathers > 0
    if not ok:
        fail(f"train_cli_{short}: APs out of range, or evaluate did not "
             f"launch the kernels ({blocked}, {seq}, {gathers})")
    return {"nms_fused_greedy_keep": mono, "nms_blocked_greedy_keep": blocked,
            "nms_seq_suppress": seq, "gather_rows": gathers}


def frozen_train_phases(dev, tmp, img_dir, shapes):
    """RetinaNet and Faster R-CNN training at full width (ResNet-50-FPN-v2,
    640, VOC), the train CLI to a served checkpoint and evaluate through
    the kernels. Returns ({kernel record name: evaluate launches}, the
    kernel records' train-step fields)."""
    root = os.path.join(tmp, "train_frozen")
    os.makedirs(root)
    walls, launches, fields = {}, {}, {}
    for family in ("retinanet", "faster_rcnn"):
        short = FROZEN_SHORT[family]
        t0 = time.perf_counter()
        fields.update(frozen_family_phase(family, img_dir, dev))
        walls[f"train_{short}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = frozen_cli_phase(family, dev, root, img_dir, shapes,
                               os.path.join(tmp, "train", "labels"))
        walls[f"train_cli_{short}"] = time.perf_counter() - t0
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    line("frozen_train_wall", total_s=f"{sum(walls.values()):.1f}",
         **{f"{k}_s": f"{v:.1f}" for k, v in walls.items()})
    return launches, fields


if __name__ == "__main__":
    if sys.argv[1:] not in ([], ["--kernels-only"]):
        fail(f"usage: {sys.argv[0]} [--kernels-only]")
    main(kernels_only=sys.argv[1:] == ["--kernels-only"])
