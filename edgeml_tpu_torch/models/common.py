"""Detector building blocks in PyTorch (NCHW inside, explicit padding).

Conv + eval BatchNorm + SiLU, the 5x5 stride-1 max pool, nearest 2x upsample
and the host-side letterbox. BatchNorm in eval mode is computed as
``(x - mean) * rsqrt(var + eps) * scale + bias`` in the activation dtype,
the reference's formula; a bf16 serving pass runs it in bf16 end to end.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.loader import resize_bilinear


class CastCache:
    """Copies of a module's f32 tensors in another dtype, rebuilt whenever a
    source tensor is replaced or changed in place (its version counter), so a
    bf16 pass casts each weight once instead of on every call."""

    def __init__(self):
        self._cache = {}

    def get(self, tensors, dtype):
        if dtype == tensors[0].dtype:
            return tensors
        stamp = tuple((id(t), t.data_ptr(), t._version) for t in tensors)
        hit = self._cache.get(dtype)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        out = [t.detach().to(dtype) for t in tensors]
        self._cache[dtype] = (stamp, out)
        return out


class ConvBN(nn.Module):
    """Conv2d (no bias) + eval BatchNorm + SiLU, ultralytics naming (``conv``,
    ``bn``) so state_dict keys match yolov5 checkpoints."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1,
                 p: int | None = None, eps: float = 1e-3,
                 momentum: float = 0.03):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, k // 2 if p is None else p,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=eps, momentum=momentum)
        self._cast = CastCache()

    def forward(self, x):
        w, g, b, m, v = self._cast.get(
            [self.conv.weight, self.bn.weight, self.bn.bias,
             self.bn.running_mean, self.bn.running_var], x.dtype)
        y = F.conv2d(x, w, None, self.conv.stride, self.conv.padding)
        inv = torch.rsqrt(v + torch.full((), self.bn.eps, dtype=v.dtype,
                                         device=v.device))
        y = (y - m[:, None, None]) * inv[:, None, None] * g[:, None, None] \
            + b[:, None, None]
        return y * torch.sigmoid(y)


def max_pool_same(x, k: int = 5):
    """k x k max pool, stride 1, SAME padding (implicit -inf padding)."""
    return F.max_pool2d(x, k, 1, k // 2)


def upsample2x(x):
    """Nearest-neighbour x2 upsample (NCHW)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


PAD_VALUE = 114 / 255  # the YOLOv5 letterbox's gray fill


def letterbox_batch(images, size: int = 640):
    """Resize-with-aspect + pad a batch of (H, W, 3) images to (size, size).

    Host-side NumPy (ragged inputs); returns (B, size, size, 3) float32 plus
    per-image (ratio, dw, dh) for unmapping boxes. The YOLOv5 letterbox
    convention: symmetric padding, gray fill.
    """
    out = np.full((len(images), size, size, 3), PAD_VALUE, np.float32)
    meta = np.zeros((len(images), 3), np.float32)
    for i, img in enumerate(images):
        h, w = img.shape[:2]
        r = min(size / h, size / w)
        nh, nw = int(round(h * r)), int(round(w * r))
        resized = resize_bilinear(np.asarray(img, np.float32), nh, nw)
        dh, dw = (size - nh) // 2, (size - nw) // 2
        out[i, dh : dh + nh, dw : dw + nw] = resized
        meta[i] = (r, dw, dh)
    return out, meta
