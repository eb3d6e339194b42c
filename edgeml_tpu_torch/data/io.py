"""The on-disk format contract and dataset assembly for rewards and
evaluation.

The port of the JAX package's ``data/io.py``:
  * labels:      {img}.txt rows "cls x y w h" (normalised xywh-center);
  * detections:  {img}.txt or {img}.npy rows "cls x y w h conf";
  * features:    {img}/stage{S}_{Name}_features.npy (C, H, W);
  * output feat: {img}/stage24_output_features.npy (num_class + 5k,).

``set_data`` pads the whole dataset to fixed shapes once and runs the
batched ``box_correct`` over all images on the device, in chunks of fixed
shape.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.metrics import box_correct
from ..ops.roi import roi_resize_batch
from . import fastio

# Stage names of YOLOv5 detectors, used in feature-map file names.
V5_STAGE_NAMES = [
    "Conv", "Conv", "C3", "Conv", "C3", "Conv", "C3", "Conv", "C3", "SPPF",
    "Conv", "Upsample", "Concat", "C3", "Conv", "Upsample", "Concat", "C3",
    "Conv", "Concat", "C3", "Conv", "Concat", "C3", "output",
]


def list_image_names(label_dir: str) -> list[str]:
    """Sorted image-name universe, extensions stripped."""
    names = sorted(os.listdir(label_dir))
    return [".".join(n.split(".")[:-1]) for n in names]


def _xywh2xyxy_np(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x)
    out[:, 0] = x[:, 0] - x[:, 2] / 2
    out[:, 1] = x[:, 1] - x[:, 3] / 2
    out[:, 2] = x[:, 0] + x[:, 2] / 2
    out[:, 3] = x[:, 1] + x[:, 3] / 2
    return out


def _read_rows(file_path: str):
    """Read one per-image file in Python: .txt (space-separated) preferred,
    else .npy; None when missing or empty."""
    if os.path.isfile(file_path + ".txt"):
        with open(file_path + ".txt", "r") as f:
            rows = [line.strip().split(" ") for line in f if line.strip()]
        if not rows:
            return None
        return np.array(rows, dtype=float)
    if os.path.isfile(file_path + ".npy"):
        arr = np.load(file_path + ".npy")
        if len(arr) == 0:
            return None
        return np.asarray(arr, dtype=float)
    return None


def load_data(path: str, files: Sequence[str], with_conf: bool = False):
    """Load per-image box files into (cls, xyxy boxes[, conf]) tuples.

    Rows are "cls x y w h [conf]" in normalised xywh-center; an empty or
    missing file gives an empty tuple. Text files go through the native
    reader (float32); .npy files and any file it rejects are parsed in
    Python.
    """
    cols = 6 if with_conf else 5
    txt_pos = [i for i, f in enumerate(files)
               if os.path.isfile(os.path.join(path, f) + ".txt")]
    native = fastio.load_txt_boxes(
        [os.path.join(path, files[i]) + ".txt" for i in txt_pos], cols)
    native_by_idx = dict(zip(txt_pos, native))

    data = []
    for i, file in enumerate(files):
        arr = native_by_idx.get(i)
        if arr is not None and len(arr) == 0:
            data.append(())
            continue
        if arr is None:
            arr = _read_rows(os.path.join(path, file))
            if arr is None:
                data.append(())
                continue
        arr = np.asarray(arr, float)
        cls = arr[:, 0].astype(int)
        boxes = _xywh2xyxy_np(arr[:, 1:5])
        if with_conf:
            data.append((cls, boxes, arr[:, -1]))
        else:
            data.append((cls, boxes))
    return data


def _batched_correct(det_list, lab_list, iouv: np.ndarray, device,
                     chunk: int = 512):
    """``box_correct`` over a whole dataset, in chunks of ``chunk`` images
    padded to one shape, on ``device``.

    det_list: (cls, boxes, conf) or () per image; lab_list: (cls, boxes) or
    () per image. Returns a list of (n_i, t) bool arrays.
    """
    n_img = len(det_list)
    maxd = max([len(d[0]) for d in det_list if len(d) > 0] + [1])
    maxl = max([len(l[0]) for l in lab_list if len(l) > 0] + [1])

    db = np.zeros((n_img, maxd, 4), np.float32)
    dc = np.full((n_img, maxd), -1, np.int32)
    dv = np.zeros((n_img, maxd), bool)
    lb = np.zeros((n_img, maxl, 4), np.float32)
    lc = np.full((n_img, maxl), -2, np.int32)
    lv = np.zeros((n_img, maxl), bool)
    for i, (d, l) in enumerate(zip(det_list, lab_list)):
        if len(d) > 0:
            k = len(d[0])
            db[i, :k], dc[i, :k], dv[i, :k] = d[1], d[0], True
        if len(l) > 0:
            k = len(l[0])
            lb[i, :k], lc[i, :k], lv[i, :k] = l[1], l[0], True

    iouv_t = torch.as_tensor(np.asarray(iouv, np.float32), device=device)
    outs = []
    for s in range(0, n_img, chunk):
        e = min(s + chunk, n_img)
        args = [torch.from_numpy(a[s:e]).to(device)
                for a in (db, dc, dv, lb, lc, lv)]
        outs.append(box_correct(*args, iouv_t).cpu().numpy())
    tp = np.concatenate(outs) if outs else np.zeros((0, maxd, len(iouv)),
                                                    bool)
    return [tp[i, :len(d[0]) if len(d) > 0 else 0]
            for i, d in enumerate(det_list)]


def set_data(weak: str, strong: str, label: str,
             iouv: np.ndarray | None = None, device=None):
    """Per-image true-positive triples for both detector streams.

    Returns (weak_data, strong_data, labels): each ``*_data[i]`` is
    (correct (n_i, t) bool, conf (n_i,), cls (n_i,)) and ``labels[i]`` the
    (m_i,) class vector (empty when the image has no labels, and then all
    its detections are incorrect).

    :param iouv: IoU thresholds; None for [0.5] (mAP@0.5), or
        np.linspace(0.5, 0.95, 10) for mAP@0.5:0.95.
    :param device: where ``box_correct`` runs: the CUDA device unless
        "cpu" is asked for.
    """
    dev = resolve_device(device)
    if iouv is None:
        iouv = np.array([0.5])
    img_names = list_image_names(label)
    weak_raw = load_data(weak, img_names, True)
    strong_raw = load_data(strong, img_names, True)
    labels_raw = load_data(label, img_names)

    weak_tp = _batched_correct(weak_raw, labels_raw, iouv, dev)
    strong_tp = _batched_correct(strong_raw, labels_raw, iouv, dev)

    weak_data, strong_data, labels = [], [], []
    for i in range(len(img_names)):
        for raw, tp, out in ((weak_raw[i], weak_tp[i], weak_data),
                             (strong_raw[i], strong_tp[i], strong_data)):
            if len(raw) > 0:
                out.append((tp.astype(bool), raw[2], raw[0]))
            else:
                out.append((np.zeros((0, len(iouv)), bool), np.array([]),
                            np.array([])))
        labels.append(labels_raw[i][0] if len(labels_raw[i]) > 0
                      else np.array([]))
    return weak_data, strong_data, labels


def load_feature(path: str, stage: int, pool: bool = True,
                 batch_size: int = 128, func: str = "avg", size: int = 8,
                 device=None):
    """Per-image feature maps ``{img}/stage{S}_{Name}_features.npy`` of every
    image directory under ``path``, in sorted order.

    With ``pool=False``: a list of the stage-24 output features
    (num_class + 5k,) or a hidden stage's raw (C, H, W) maps. With
    ``pool=True``: each (C, h, w) map square-padded top-left and RoI-resized
    to (size, size) by ``ops/roi.py`` (``func`` "avg": roi_align, "max":
    roi_pool), ``batch_size`` images a call on ``device`` (the CUDA device
    unless "cpu" is asked for); one (N, C, size, size) f32 array, or
    ``np.zeros((0,))`` when there is no image.
    """
    images = sorted(
        f for f in os.listdir(path) if not os.path.isfile(os.path.join(path, f))
    )
    name = f"stage{stage}_{V5_STAGE_NAMES[stage]}_features.npy"
    if not pool:
        return [np.load(os.path.join(path, img, name)) for img in images]
    dev = resolve_device(device)
    out = []
    for s in range(0, len(images), batch_size):
        feats, sizes = [], []
        for img in images[s: s + batch_size]:
            fm = np.load(os.path.join(path, img, name))  # (C, H, W)
            c, h, w = fm.shape
            side = max(h, w)
            padded = np.zeros((c, side, side), fm.dtype)
            padded[:, :h, :w] = fm
            feats.append(padded)
            sizes.append((h, w))
        out.append(roi_resize_batch(np.stack(feats),
                                    np.array(sizes, np.float32), size, func,
                                    device=dev))
    return np.concatenate(out) if out else np.zeros((0,))


def extract_output_feature(output_path: str, feature_path: str,
                           num_class: int, k: int = 25):
    """Adaptive-Feeding output features from each image's first k detections.

    A float64 vector of length num_class + 5k: the class histogram of the
    first k rows, then their (x, y, w, h, conf) flattened, saved as
    ``{img}/stage24_output_features.npy`` for every image directory under
    ``feature_path``. Rows are taken in file order, not re-sorted by
    confidence.
    """
    img_names = sorted(
        f for f in os.listdir(feature_path)
        if not os.path.isfile(os.path.join(feature_path, f))
    )
    for img in img_names:
        feature = np.zeros((num_class + 5 * k,), float)
        arr = _read_rows(os.path.join(output_path, img))
        if arr is not None:
            arr = arr[:k]
            for c in arr[:, 0].astype(int):
                feature[c] += 1
            flat = arr[:, 1:].flatten()
            feature[num_class: num_class + flat.size] = flat
        np.save(os.path.join(feature_path, img, "stage24_output_features.npy"),
                feature)
