"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``edgeml_tpu_torch/csrc`` (one nvcc per
source, in parallel), holds each kernel against its plain PyTorch version,
then drives the port's main paths at full published width (random weights
from a seed) from an image directory to per-image detection files and checks
what comes out:

  * YOLOv5n serving (80 classes, 640x640 letterbox) in f32 and bf16, through
    the monolithic suppressor kernel (K = 1024); then the strong detector
    (YOLOv5m) through the same code on one batch;
  * SSDLite320-MobileNetV3-Large serving (91 classes, COCO -> 80 class map)
    in f32 and bf16, through the blocked suppressor kernel (K = 2048);
  * RetinaNet-ResNet50-FPN-v2 serving (91 classes, 640) in f32, through the
    blocked kernel, and one device-resident batch timed in f32 and bf16.

Each path's launch counts are set to 0 just before it runs and read just
after. Every phase prints one line; any failure exits non-zero. The last
lines are the kernels' JSON record, the card's name and power limit as
nvidia-smi reports them, and the result:

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": N}}

Imports torch, numpy, the standard library and ``edgeml_tpu_torch`` only.
Scratch files go to ``.smoke_tmp/`` beside this script and are removed.
"""

import copy
import json
import math
import os
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
BATCH = 64
N_IMAGES = 256
RETINA_BATCH = 16
RETINA_IMAGES = 64
BLOCKED_KS = (1280, 1536, 2048)
SHAPES = [(480, 640), (640, 427), (640, 640), (500, 375)]


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
    scores = np.ascontiguousarray(
        np.sort(rng.random((b, k)).astype(np.float32), axis=-1)[:, ::-1])
    scores[scores < 0.05] = 0.0
    cls = rng.integers(0, ncls, (b, k)).astype(np.float32)
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], axis=-1)
    return (boxes + cls[..., None] * np.float32(max_wh)).astype(np.float32), \
        scores


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


def make_images(img_dir, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(img_dir)
    shapes = []
    for i in range(N_IMAGES):
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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    from edgeml_tpu_torch import _build
    from edgeml_tpu_torch.models.infer import exact_f32_cuda
    from edgeml_tpu_torch.ops import nms
    from edgeml_tpu_torch.ops.nms_fused import (
        greedy_keep_mask_blocked_cuda, greedy_keep_mask_blocked_plain,
        greedy_keep_mask_fused, greedy_keep_mask_plain,
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
    _build.build(["nms_fused", "nms_blocked"])
    build_s = time.perf_counter() - t0
    line("device", name=repr(kind), count=count, smi=repr(smi),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc_build_s=f"{build_s:.2f}")

    # ---- phase 2: monolithic kernel against its plain version, K=1024 -----
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
            k_ms = cuda_ms(lambda: greedy_keep_mask_fused(boxes, scores, thr),
                           20)
            p_ms = cuda_ms(lambda: greedy_keep_mask_plain(boxes, scores, thr),
                           3, warmup=1)
            bound, by = suppressor_bound_ms(boxes, scores)
            line("kernel_vs_plain", regime=f"{seed}/{spread}/{ncls}",
                 thr=thr, equal=True, kept=int(got.sum()),
                 valid=int((scores > 0).sum()), kernel_ms=f"{k_ms:.4f}",
                 plain_ms=f"{p_ms:.3f}", bound_ms=f"{bound:.4f}",
                 bound_by=by)

    # ---- phase 2b: blocked kernel against its plain versions, B=64 --------
    for k in BLOCKED_KS:
        for seed, spread, ncls in [(0, 80.0, 1), (1, 300.0, 4),
                                   (2, 2000.0, 80)]:
            for thr in (0.6, 0.45):
                off, sc = fuzz(seed + k, BATCH, k, spread, ncls, nms.MAX_WH)
                boxes = torch.from_numpy(off).to(dev)
                scores = torch.from_numpy(sc).to(dev)
                before = greedy_keep_mask_blocked_cuda.launches
                got = greedy_keep_mask_fused(boxes, scores, thr)
                torch.cuda.synchronize()
                if greedy_keep_mask_blocked_cuda.launches != before + 1:
                    fail(f"K = {k} did not launch the blocked kernel")
                want = greedy_keep_mask_blocked_plain(boxes, scores, thr)
                if not torch.equal(got, want):
                    fail(f"blocked kernel != plain (K {k}, seed {seed}, "
                         f"thr {thr}): {int((got != want).sum())} entries "
                         f"differ")
                if k == 2048 and not torch.equal(
                        got, greedy_keep_mask_plain(boxes, scores, thr)):
                    fail(f"blocked kernel != global plain (seed {seed})")
                k_ms = cuda_ms(
                    lambda: greedy_keep_mask_fused(boxes, scores, thr), 20)
                p_ms = cuda_ms(
                    lambda: greedy_keep_mask_blocked_plain(boxes, scores,
                                                           thr), 3, warmup=1)
                bound, by = suppressor_bound_ms(boxes, scores)
                line("blocked_vs_plain", k=k,
                     regime=f"{seed}/{spread}/{ncls}", thr=thr, batch=BATCH,
                     equal=True, kept=int(got.sum()),
                     valid=int((scores > 0).sum()), kernel_ms=f"{k_ms:.4f}",
                     plain_ms=f"{p_ms:.3f}", bound_ms=f"{bound:.4f}",
                     bound_by=by)
            del boxes, scores, got, want
    torch.cuda.empty_cache()

    tmp = os.path.join(ROOT, ".smoke_tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        img_dir = os.path.join(tmp, "images")
        shapes = make_images(img_dir, seed=0)
        records = [serving_phases(dev, tmp, img_dir, shapes),
                   ssd_phases(dev, tmp, img_dir, shapes)]
        retina_phases(dev, tmp, img_dir, shapes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)


def reset_counts():
    from edgeml_tpu_torch.ops.nms_fused import (
        greedy_keep_mask_blocked_cuda, greedy_keep_mask_cuda,
    )

    greedy_keep_mask_cuda.launches = 0
    greedy_keep_mask_blocked_cuda.launches = 0


def counts():
    """(monolithic, blocked) suppressor launches since reset_counts()."""
    from edgeml_tpu_torch.ops.nms_fused import (
        greedy_keep_mask_blocked_cuda, greedy_keep_mask_cuda,
    )

    return greedy_keep_mask_cuda.launches, \
        greedy_keep_mask_blocked_cuda.launches


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
    line("trunk_vs_cpu", images=2, max_score_err=f"{err_s:.3e}",
         max_box_err_px=f"{err_b:.3e}", tol="scores 1e-3, boxes 0.5 px")
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
        launches, blocked = counts()
        if launches != n_batches or blocked != 0:
            fail(f"{label}: suppressor kernels launched {launches} + "
                 f"{blocked} times for {n_batches} batches")
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
    k_ms = cuda_ms(lambda: greedy_keep_mask_cuda(off, valid, iou), 50)
    p_ms = cuda_ms(lambda: greedy_keep_mask_plain(off, top, iou), 5,
                   warmup=1)
    bound, by = suppressor_bound_ms(off, top)
    line("tail_kernel_vs_plain", batch=BATCH, k=1024, dets_equal=True,
         candidates=n_valid, kept=n_kept, rows=int(v_k.sum()),
         kernel_ms=f"{k_ms:.4f}", plain_ms=f"{p_ms:.3f}",
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
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(got, ref))
    scale = max(float(b.abs().max()) for b in ref)
    line("ssd_heads_vs_cpu", images=2, max_abs_err=f"{err:.3e}",
         max_abs=f"{scale:.3f}", tol="1e-3")
    if not err < 1e-3:
        fail("SSDLite f32 heads on the card disagree with the CPU")
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
        mono, blocked = counts()
        if blocked != n_batches or mono != 0:
            fail(f"ssd {label}: suppressor kernels launched {mono} + "
                 f"{blocked} times for {n_batches} batches")
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
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(got, ref))
    scale = max(float(b.abs().max()) for b in ref)
    line("retina_heads_vs_cpu", images=1, max_abs_err=f"{err:.3e}",
         max_abs=f"{scale:.3f}", tol="1e-3 x max_abs")
    if not err < 1e-3 * scale:
        fail("RetinaNet f32 heads on the card disagree with the CPU")
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
    mono, blocked = counts()
    if blocked != n_batches or mono != 0:
        fail(f"retinanet: suppressor kernels launched {mono} + {blocked} "
             f"times for {n_batches} batches")
    n_rows = check_files(out_dir, shapes[:RETINA_IMAGES], 80, conf)
    peak = torch.cuda.max_memory_allocated() / 2**30
    line("retina_serve_f32", images=RETINA_IMAGES, batch=RETINA_BATCH,
         files=RETINA_IMAGES, rows=n_rows, launches=blocked,
         e2e_img_s=f"{RETINA_IMAGES / wall:.1f}", peak_gib=f"{peak:.2f}")

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


if __name__ == "__main__":
    main()
