"""On-device colour jitter for the YOLOv5 training recipe.

With ``--yolo-hsv device`` the loader keeps only the geometry (mosaic,
affine window, flip) and draws each image's (h, s, v) gains from the same
random stream as the host jitter (``data/yolo_aug.py hsv_gains``); the
jitter itself is elementwise and runs on the training batch's device. Plain
torch, the reference package's ``ops/color.py`` op for op in float32 (the
host path applies the gains in float64, so the two agree to float
rounding).
"""

from __future__ import annotations

import torch


def hsv_jitter(images: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """Apply per-image HSV gains to a batch of RGB images.

    :param images: (B, H, W, 3) float RGB in [0, 1].
    :param gains: (B, 3) multiplicative (h, s, v) gains.
    :return: jittered images, same shape and dtype; hue wraps, s and v
        clip.
    """
    f = images.to(torch.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    mx = f.amax(dim=-1)
    mn = f.amin(dim=-1)
    diff = mx - mn
    one = torch.ones_like(diff)
    zero = torch.zeros_like(diff)
    safe = torch.where(diff == 0.0, one, diff)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(diff == 0.0, zero, h) / 6.0
    s = torch.where(mx == 0.0, zero, diff / torch.where(mx == 0.0, one, mx))
    gn = gains.to(device=f.device, dtype=torch.float32)[:, None, None, :]
    h = torch.remainder(h * gn[..., 0], 1.0)
    s = torch.clamp(s * gn[..., 1], 0.0, 1.0)
    v = torch.clamp(mx * gn[..., 2], 0.0, 1.0)
    h6 = torch.remainder(h, 1.0) * 6.0
    fl = torch.floor(h6)
    i = torch.remainder(fl.to(torch.int32), 6)
    fr = h6 - fl
    p = v * (1.0 - s)
    q = v * (1.0 - s * fr)
    t = v * (1.0 - s * (1.0 - fr))

    def select(choices, default):
        out = default
        for k in range(len(choices) - 1, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    out = torch.stack([select([v, q, p, p, t], v),
                       select([t, v, v, q, p], p),
                       select([p, p, t, v, v], q)], dim=-1)
    return out.to(images.dtype)
