"""Plain pieces shared by the frozen references: image decode and resize,
norms, stable ranking and greedy NMS.

Everything here is plain PyTorch or NumPy in the precision the caller's
backend flags allow (the benchmark turns TF32 off for the f32 reference and
on for its control). Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_WH = 7680.0  # class-offset stride of class-aware NMS (the yolov5 convention)


def set_tf32(on: bool):
    """TF32 on or off for cuDNN convolutions and CUDA matmuls."""
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def decode_jpeg(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) float32 in [0, 1] (PIL, RGB)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def taps(in_size: int, out_size: int):
    """Banded bilinear taps (indices (out, span) int64, weights (out, span)
    f32): half-pixel centres, the triangle kernel widened to 1/scale when
    downscaling, taps outside the image given weight 0 (their index
    clipped) and each row renormalised, the weights computed in f64."""
    scale = out_size / in_size
    x = np.arange(out_size, dtype=np.float64)
    u = (x + 0.5) / scale - 0.5
    s = max(1.0, 1.0 / scale)
    lo = np.floor(u - s).astype(int)
    span = int(np.ceil(2 * s)) + 2
    j = lo[:, None] + np.arange(span)[None, :]
    w = np.clip(1.0 - np.abs((j - u[:, None]) / s), 0.0, None)
    w = np.where((j >= 0) & (j < in_size), w, 0.0)
    w = w / np.maximum(w.sum(1, keepdims=True), 1e-12)
    return np.clip(j, 0, in_size - 1), w.astype(np.float32)


def resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W, 3) f32 image -> (out_h, out_w, 3) by the banded taps: rows
    first, then columns, each output the sum of its taps' products taken in
    tap order in f32 (identity at scale 1)."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.clone()
    dev = img.device
    jh, wh = (torch.from_numpy(a).to(dev) for a in taps(h, out_h))
    jw, ww = (torch.from_numpy(a).to(dev) for a in taps(w, out_w))
    tmp = wh[:, 0, None, None] * img[jh[:, 0]]
    for t in range(1, wh.shape[1]):
        tmp = tmp + wh[:, t, None, None] * img[jh[:, t]]
    out = ww[:, 0, None] * tmp[:, jw[:, 0]]
    for t in range(1, ww.shape[1]):
        out = out + ww[:, t, None] * tmp[:, jw[:, t]]
    return out


def bn_eval(y, sd, prefix, eps):
    """Eval BatchNorm over NCHW ``y``: (y - mean) * rsqrt(var + eps) * gain
    + shift."""
    m, v = sd[prefix + ".running_mean"], sd[prefix + ".running_var"]
    inv = torch.rsqrt(v + torch.full((), eps, dtype=v.dtype, device=v.device))
    return (y - m[:, None, None]) * inv[:, None, None] \
        * sd[prefix + ".weight"][:, None, None] + sd[prefix + ".bias"][:, None, None]


def frozen_bn(x, sd, prefix, eps=1e-5):
    """Frozen BatchNorm as one affine: scale = gain * rsqrt(var + eps),
    shift = bias - mean * scale."""
    scale = sd[prefix + ".weight"] * torch.rsqrt(sd[prefix + ".running_var"] + eps)
    shift = sd[prefix + ".bias"] - sd[prefix + ".running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def calibrate_stats(y, sd, prefix, floor=None):
    """Set a norm's statistics to the per-channel mean and biased variance
    of NCHW ``y`` (optionally floored)."""
    var = y.var(dim=(0, 2, 3), unbiased=False)
    if floor is not None:
        var = var.clamp_min(floor)
    sd[prefix + ".running_mean"].copy_(y.mean(dim=(0, 2, 3)))
    sd[prefix + ".running_var"].copy_(var)


def stable_desc(x, k):
    """Top k along the last dim, values descending, equal values in
    ascending index order. Returns (values, indices)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def iou_matrix(boxes, clamp_area=True):
    """(B, K, 4) xyxy -> (B, K, K) IoU, f32, intersection over
    max(union, 1e-12); areas clamped at 0 unless ``clamp_area`` is off."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    ix = torch.minimum(x2[:, :, None], x2[:, None, :]) - torch.maximum(
        x1[:, :, None], x1[:, None, :])
    iy = torch.minimum(y2[:, :, None], y2[:, None, :]) - torch.maximum(
        y1[:, :, None], y1[:, None, :])
    inter = torch.maximum(ix, zero) * torch.maximum(iy, zero)
    if clamp_area:
        area = torch.maximum(x2 - x1, zero) * torch.maximum(y2 - y1, zero)
    else:
        area = (x2 - x1) * (y2 - y1)
    union = area[:, :, None] + area[:, None, :] - inter
    return inter / torch.maximum(union, torch.full((), 1e-12, dtype=boxes.dtype,
                                                   device=boxes.device))


def greedy_nms(boxes, live, thr, clamp_area=True):
    """Greedy NMS of candidates sorted best first: kept[i] iff live[i] and
    no kept j < i has IoU(j, i) > thr. The greedy answer is the unique
    fixpoint of that rule, iterated from kept = live.

    boxes (B, K, 4), live (B, K) bool -> kept (B, K) bool."""
    k = boxes.shape[1]
    lower = torch.ones((k, k), dtype=torch.bool, device=boxes.device).tril(-1)
    thr_t = torch.full((), thr, dtype=torch.float32, device=boxes.device)
    sup = (iou_matrix(boxes, clamp_area) > thr_t) & lower  # sup[b, i, j]
    kept = live
    while True:
        new = live & ~(sup & kept[:, None, :]).any(-1)
        if torch.equal(new, kept):
            return kept
        kept = new


def compact(kept, rows, max_det):
    """The first ``max_det`` kept rows of each image, in candidate order:
    a list of (n, C) tensors."""
    return [r[m][:max_det] for r, m in zip(rows, kept)]
