"""End-to-end detector inference: images -> per-image detection files.

The serving loop: worker threads decode the next batches image by image and
prepare each batch straight into pinned host memory (on the card); the
device runs trunk + decode + NMS on a batch while the host queues the next
one, and a writer thread writes a batch's files while the device serves the
one after it. YOLOv5 batches are letterboxed and their boxes unmapped;
SSDLite, RetinaNet and Faster R-CNN batches are square-resized to the
model's input size and normalised with torchvision's mean/std, so their
normalised coordinates need no unmap. Output rows are
(cls, x, y, w, h, conf), xywh-center normalised to the original image
size, one ``.npy`` or ``.txt`` file per image named after the image stem; a
``class_map`` renames classes and drops the rows of unmapped ones. YOLOv5
and SSDLite also serve int8 post-training-quantized trunks
(``models/quant.py``, ``models/quant_ssd.py``), calibrated on the first
images of the directory itself.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and none asked for they raise.

``run_detection(data_parallel=True)`` under a process group of several
ranks (``parallel/mesh.py``) serves each global batch by rows: every rank
runs its contiguous block of the batch on its own device and writes the
files of its own images.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..data import fastprep
from ..data.io import V5_STAGE_NAMES
from ..data.loader import decode_image, iter_batches, list_images
from ..device import exact_f32_cuda, resolve_device
from ..ops.nms import nms_split_batch
from ..parallel.mesh import local_device, replicate, shard_along, \
    world_size
from ..utils.profiling import span
from .common import letterbox_batch
from .faster_rcnn import FasterRCNN
from .quant import prepare_int8, q8_predict, tree_to
from .quant_ssd import prepare_int8_ssd, q8_ssd_apply
from .retinanet import RetinaNet, retina_postprocess
from .ssd_loss import ssd_postprocess
from .ssdlite import SSDLite
from .yolov5 import YoloV5

# torchvision's detection-transform normalisation (SSDLite, RetinaNet,
# Faster R-CNN)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _nms_unmap(pred, meta, orig_hw, conf_thres, iou_thres,
               max_det=300, multi_label=True):
    """Batched NMS + letterbox unmap over split trunk outputs.

    pred: (obj, xywh, cls) from YoloV5.predict; meta: (B, 3) letterbox
    (ratio, dw, dh); orig_hw: (B, 2) original (h, w), f32.
    Returns (dets (B, max_det, 6) rows [cls, x, y, w, h, conf] normalised to
    the original image, valid (B, max_det))."""
    obj, xywh, cls = pred
    dets, valid = nms_split_batch(
        obj, xywh, cls, conf_thres, iou_thres,
        max_det=max_det, multi_label=multi_label,
    )
    r = meta[:, 0:1]
    dw = meta[:, 1:2]
    dh = meta[:, 2:3]
    h, w = orig_hw[:, 0:1], orig_hw[:, 1:2]
    x1 = torch.minimum(torch.clamp_min((dets[:, :, 0] - dw) / r, 0), w)
    y1 = torch.minimum(torch.clamp_min((dets[:, :, 1] - dh) / r, 0), h)
    x2 = torch.minimum(torch.clamp_min((dets[:, :, 2] - dw) / r, 0), w)
    y2 = torch.minimum(torch.clamp_min((dets[:, :, 3] - dh) / r, 0), h)
    out = torch.stack(
        [
            dets[:, :, 5],
            (x1 + x2) / 2.0 / w,
            (y1 + y2) / 2.0 / h,
            (x2 - x1) / w,
            (y2 - y1) / h,
            dets[:, :, 4],
        ],
        dim=2,
    )
    return out, valid


@torch.no_grad()
def detect_batch(net: YoloV5, images, meta, orig_hw, conf_thres: float,
                 iou_thres: float, max_det: int = 300,
                 multi_label: bool = True, dtype=None, q8=None):
    """Forward + decode + NMS + unmap for one letterboxed batch on the
    images' device.

    images: (B, S, S, 3) uint8 pixels or float in [0, 1]; dtype: None (f32)
    or torch.bfloat16 for the trunk and score path; q8: a quantized tree
    (``quant.Q8Yolo.tree``) serves the int8 trunk instead, and ``dtype`` is
    then the dtype of its dequantized obj/cls logits (bf16 keys the bf16
    NMS tail; boxes stay f32).
    Returns (dets (B, max_det, 6) rows [cls, x, y, w, h, conf], valid)."""
    with span("detect"):
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) / 255.0
        with span("detect.trunk"):
            if q8 is not None:
                pred = q8_predict(net, q8, images, score_dtype=dtype)
            else:
                pred = net.predict(images, dtype=dtype)
        with span("detect.tail"):
            return _nms_unmap(pred, meta, orig_hw, conf_thres, iou_thres,
                              max_det, multi_label)


@torch.no_grad()
def _detect_generic(net, images, conf_thres: float, iou_thres: float,
                    dtype=None, q8=None):
    """SSDLite / RetinaNet / Faster R-CNN: forward + the family's
    postprocess on a batch of square-resized, normalised images
    (B, S, S, 3) f32 on their device.

    dtype: None (f32) or torch.bfloat16 for the trunk and heads. SSDLite's
    head outputs go back to f32 before the postprocess; RetinaNet's
    postprocess casts only the 2048 rows it gathers; Faster R-CNN keeps
    every decision in f32 (``FasterRCNN.detect``). q8 (SSDLite only): a
    quantized tree (``quant_ssd.Q8SSD.tree``) serves the int8 trunk, whose
    f32 logits take the same postprocess.
    Returns (dets (B, max_det, 6) rows [cls, x, y, w, h, conf] normalised by
    the input size, valid (B, max_det)). A plain square resize makes
    normalised coordinates scale-invariant: x / S in model space equals
    x_orig / w in the image."""
    if q8 is not None and not isinstance(net, SSDLite):
        raise ValueError("int8 (q8) serving: YOLO and SSDLite only")
    with span("detect"):
        x = images if dtype is None else images.to(dtype)
        if isinstance(net, SSDLite):
            with span("detect.trunk"):
                if q8 is not None:
                    cls_logits, reg = q8_ssd_apply(net, q8, images)
                else:
                    cls_logits, reg = net(x)
            with span("detect.tail"):
                dets, valid = ssd_postprocess(
                    net, cls_logits.to(torch.float32), reg.to(torch.float32),
                    net.anchors(images.device), score_thresh=conf_thres,
                    nms_thresh=iou_thres)
        elif isinstance(net, RetinaNet):
            with span("detect.trunk"):
                feats = net.features(x)
            with span("detect.head"):
                cls_logits, reg = net.head_outputs(feats)
            del feats
            with span("detect.tail"):
                dets, valid = retina_postprocess(
                    net, cls_logits, reg, net.anchors(images.device),
                    score_thresh=conf_thres, nms_thresh=iou_thres)
        elif isinstance(net, FasterRCNN):
            dets, valid = net.detect(x, score_thresh=conf_thres,
                                     nms_thresh=iou_thres, dtype=dtype)
        else:
            raise TypeError(f"{type(net).__name__} is not yet ported")
        s = net.image_size
        x1, y1, x2, y2 = (dets[..., i] / s for i in range(4))
        out = torch.stack([dets[..., 5], (x1 + x2) / 2, (y1 + y2) / 2,
                           x2 - x1, y2 - y1, dets[..., 4]], dim=-1)
        return out, valid


def square_batch(images, size: int, out=None):
    """Host side of SSDLite/RetinaNet/Faster R-CNN serving: each (H, W, 3)
    image in [0, 1] resized to (size, size) and normalised with
    torchvision's mean/std in one native pass (``data/fastprep.py``);
    returns (B, size, size, 3) f32 (``out`` where given)."""
    with span("prep.square"):
        return fastprep.square(images, size, IMAGENET_MEAN, IMAGENET_STD,
                               out=out)


def map_classes(rows, class_map):
    """Rows (n, 6) [cls, x, y, w, h, conf] with each class renamed by
    ``class_map``; rows of a class that maps to -1 or is absent dropped."""
    cls = np.array([class_map.get(int(c), -1) for c in rows[:, 0]],
                   np.float32).reshape(-1)
    keep = cls != -1
    rows = rows[keep]
    rows[:, 0] = cls[keep]
    return rows


def run_detection(
    net,
    img_dir: str,
    save_dir: str,
    batch_size: int = 16,
    conf_thres: float = 0.001,
    iou_thres: float = 0.6,
    img_size: int = 640,
    fmt: str = "npy",
    class_map=None,
    dtype=None,
    device=None,
    data_parallel: bool = False,
):
    """Detect every image in img_dir; save per-image detection files.

    :param net: a YoloV5, SSDLite, RetinaNet or FasterRCNN module; it is
        moved to ``device`` (in place).
    :param img_size: YOLOv5's letterbox size; the other families resize to
        their own ``image_size``.
    :param class_map: optional {model class id: output class id}; rows of a
        class that maps to -1 or is absent are dropped.
    :param dtype: None (f32, TF32 off), torch.bfloat16, or (YOLOv5 and
        SSDLite) "int8": the post-training-quantized trunk, calibrated on
        the first min(batch_size, 16) images of ``img_dir`` (letterboxed for
        YOLOv5; square-resized and normalised for SSDLite), its scores f32;
        "int8-bf16" casts YOLOv5's dequantized obj/cls logits to bf16 (the
        bf16 NMS tail); SSDLite's int8 logits stay f32 either way.
    :param device: "cuda" (the default when None) or "cpu".
    :param data_parallel: under a process group of several ranks, serve each
        global batch of ``batch_size`` images (a multiple of the world size)
        by rows: this rank runs its contiguous block of it on
        ``local_device(device)`` and writes its own images' files. The net's
        weights and the int8 tree are rank 0's, and every rank calibrates
        int8 on the same global images. In one process: the path above.
    """
    is_yolo = isinstance(net, YoloV5)
    int8 = isinstance(dtype, str)
    if int8 and dtype not in ("int8", "int8-bf16"):
        raise ValueError(f"run_detection: unknown dtype {dtype!r}")
    if int8 and not (is_yolo or isinstance(net, SSDLite)):
        raise ValueError(
            "int8 serving is implemented for YOLO and SSDLite only")
    world = world_size() if data_parallel else 1
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} not divisible by the "
                         f"world size {world}")
    dev = resolve_device(device) if world == 1 else local_device(device)
    if not (is_yolo or isinstance(net, (SSDLite, RetinaNet, FasterRCNN))):
        raise TypeError(f"run_detection: {type(net).__name__} is not yet "
                        f"ported (YOLOv5, SSDLite, RetinaNet and Faster "
                        f"R-CNN are)")
    if dev.type == "cuda":
        exact_f32_cuda()
    net.to(dev).eval()
    if world > 1:
        replicate(net)
    names = list_images(img_dir)
    Path(save_dir).mkdir(parents=True, exist_ok=True)
    q8 = None
    if int8 and names:
        # calibrate on the serving distribution: the first images of img_dir
        calib = [decode_image(os.path.join(img_dir, n))
                 for n in names[:min(batch_size, len(names), 16)]]
        if is_yolo:
            xc = torch.from_numpy(letterbox_batch(calib, img_size)[0]).to(dev)
            q8 = prepare_int8(net, lambda i: xc, iters=1).tree
            dtype = torch.bfloat16 if dtype == "int8-bf16" else None
        else:
            xc = torch.from_numpy(square_batch(calib, net.image_size)).to(dev)
            q8 = prepare_int8_ssd(net, lambda i: xc, iters=1).tree
            dtype = None
        del xc
        if world > 1:  # one tree, rank 0's, as the reference replicates one
            q8 = tree_to(replicate(tree_to(q8, "cpu")), dev)

    local_bs = batch_size // world
    # this rank's rows of each global batch (the tail batch's may be short
    # or empty); every row without data_parallel, even inside a group
    order = [i for s in range(0, len(names), batch_size)
             for i in (shard_along(list(range(s, s + batch_size)))
                       if world > 1 else range(s, s + batch_size))
             if i < len(names)]

    # on the card a batch is prepared straight into pinned memory, so its
    # copy up is queued without holding the host
    def staged(n):
        """(B, n, n, 3) float32 for a batch: a pinned tensor on the card,
        else a plain one."""
        return torch.empty((local_bs, n, n, 3), dtype=torch.float32,
                           pin_memory=dev.type == "cuda")

    def make_batch(items):
        """Worker thread: letterbox or square-resize; pad the tail batch to
        full size."""
        chunk_names = [n for n, _ in items]
        imgs = [im for _, im in items]
        imgs_p = imgs + [imgs[-1]] * (local_bs - len(imgs))
        if not is_yolo:
            x = staged(net.image_size)
            square_batch(imgs_p, net.image_size, out=x.numpy())
            return chunk_names, x, None, None
        x = staged(img_size)
        meta = torch.from_numpy(letterbox_batch(imgs_p, img_size,
                                                out=x.numpy())[1])
        hw = torch.tensor([im.shape[:2] for im in imgs_p], dtype=torch.float32)
        if dev.type == "cuda":
            meta, hw = meta.pin_memory(), hw.pin_memory()
        return chunk_names, x, meta, hw

    def save_batch(chunk_names, dets, valid):
        for bi, name in enumerate(chunk_names):
            rows = dets[bi][valid[bi]]
            if class_map is not None:
                rows = map_classes(rows, class_map)
            stem = ".".join(name.split(".")[:-1]) or name
            if fmt == "npy":
                np.save(os.path.join(save_dir, stem + ".npy"), rows)
            else:
                with open(os.path.join(save_dir, stem + ".txt"), "w") as f:
                    for r in rows:
                        f.write(
                            f"{int(r[0])} {r[1]:.6f} {r[2]:.6f} {r[3]:.6f} "
                            f"{r[4]:.6f} {r[5]:.6f}\n"
                        )

    def to_host(dets, valid):
        """Queue the copy of a batch's rows to the host behind its work:
        (dets, valid, the event that marks them there, or None off the
        card)."""
        if dev.type != "cuda":
            return dets, valid, None
        dets = dets.to("cpu", non_blocking=True)
        valid = valid.to("cpu", non_blocking=True)
        there = torch.cuda.Event()
        there.record(torch.cuda.current_stream(dev))
        return dets, valid, there

    # next() by hand, so the wait for each batch is a span of its own. The
    # loader keeps a batch in flight on each of its four workers; a batch is
    # launched before the host waits for the batch before it, whose files
    # the writer thread writes while the device serves this one; the last
    # batch (iter_batches yields ceil(len(order) / local_bs)) waits for its
    # own rows too
    last = (len(order) - 1) // local_bs
    queued = writes = None
    with contextlib.closing(iter_batches(img_dir, names, local_bs,
                                         make_batch, order=order,
                                         prefetch=3)) as batches, \
            ThreadPoolExecutor(max_workers=1) as writer:
        for k in itertools.count():
            with span("serve.loader_wait"):
                item = next(batches, None)
            if item is None:
                break
            chunk_names, arr, meta, hw = item
            with span("serve.batch"):
                with span("serve.h2d"):
                    x = arr.to(dev, non_blocking=True)
                    if is_yolo:
                        meta = meta.to(dev, non_blocking=True)
                        hw = hw.to(dev, non_blocking=True)
                if is_yolo:
                    dets, valid = detect_batch(net, x, meta, hw, conf_thres,
                                               iou_thres, dtype=dtype, q8=q8)
                else:
                    dets, valid = _detect_generic(net, x, conf_thres,
                                                  iou_thres, dtype=dtype,
                                                  q8=q8)
                with span("serve.d2h"):
                    ready = [queued] if queued is not None else []
                    queued = (chunk_names, *to_host(dets, valid))
                    if k == last:
                        ready.append(queued)
                    for *_, there in ready:
                        if there is not None:
                            there.synchronize()
                with span("serve.save"):
                    for rows in ready:
                        if writes is not None:
                            writes.result()
                        writes = writer.submit(
                            save_batch, rows[0], rows[1].numpy(),
                            rows[2].numpy())
        if writes is not None:
            writes.result()


def dump_features(
    net: YoloV5,
    img_dir: str,
    save_dir: str,
    stages=(9, 17, 20, 23),
    img_size: int = 640,
    device=None,
):
    """Save YOLOv5 hidden-stage feature maps per image, the file format the
    estimators read (``data/io.py load_feature``):
    ``{save_dir}/{stem}/stage{S}_{Name}_features.npy``, f32 (C, H, W), the
    stem being the file name without its last extension.

    One letterboxed image per forward, as the JAX package's ``dump_features``
    runs them. The net is moved to ``device`` (in place): the CUDA device
    unless "cpu" is asked for; f32 with TF32 off.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        exact_f32_cuda()
    net.to(dev).eval()
    stages = tuple(stages)
    names = list_images(img_dir)

    def make_batch(items):
        (name, img), = items
        lb, _ = letterbox_batch([img], img_size)
        return name, lb

    for name, lb in iter_batches(img_dir, names, 1, make_batch):
        taps = net.taps(torch.from_numpy(lb).to(dev), stages)
        stem = ".".join(name.split(".")[:-1]) or name
        out = Path(save_dir) / stem
        out.mkdir(parents=True, exist_ok=True)
        for s_idx in stages:
            np.save(out / f"stage{s_idx}_{V5_STAGE_NAMES[s_idx]}_features.npy",
                    taps[s_idx][0].cpu().numpy())
