"""RoI align / RoI pool of square-padded feature maps, one RoI per image.

The port of the JAX package's ``ops/roi.py``, in plain torch ops on the
tensors' device (the JAX package leaves it to XLA; it holds no Pallas
kernel). Each image's RoI is the un-padded region [0, 0, w, h] of a
(C, S, S) map, pooled to (P, P) with torchvision's numerics for that case:

  * roi_align: aligned=False, spatial_scale=1, sampling_ratio=-1 (an
    adaptive ceil(roi / P) sampling grid), bilinear interpolation with the
    [-1, S] border convention, the mean over the samples;
  * roi_pool: quantised bins (floor / ceil), a roi extent of round(w) + 1
    (the legacy +1 convention), the max over the bin, 0 for an empty bin.

Per-image RoI sizes are values, not shapes: every grid is built at its
static bound (G = max(ceil(S / P), 1) samples a bin side for align, W =
max(ceil((S + 1) / P) + 1, 1) cells for pool) and masked, so one call
serves a ragged batch, with no Python loop over images or bins (the only
loop adds the G * G samples of every bin at once, one sample a step).

f32 arithmetic follows the JAX package's op order as XLA compiles it for
the CPU: a bin side is roi * f32(1 / P) (XLA rewrites the division by the
constant P into that multiply), sample positions are left to right and
fused into one FMA where G = 1, the four corner products form XLA's FMA
chain, and the samples are summed one after another (``_xla_sum``). Data
divisors are tensors on the maps' device (CUDA turns a division by a
Python scalar into a multiply by its reciprocal, which moves a bin edge by
one rounding). Every step is an elementwise IEEE operation in a fixed
order, so the card's results equal the CPU's bit for bit; against the JAX
package the max is exact and the mean differs only where XLA's vectorised
reduction reorders a sum (within 1e-6 of the call's largest value).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device

_XLA_WINDOW = 32  # XLA's CPU tree reduction: the window of a long sum


def _inverse(P: int, like: torch.Tensor) -> torch.Tensor:
    """f32(1 / P) as a tensor beside ``like``: what XLA multiplies by for
    the JAX code's ``x / P``."""
    return torch.tensor(np.float32(1.0) / np.float32(P), dtype=like.dtype,
                        device=like.device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32, as a fused multiply-add rounds it: the
    product of two f32 values is exact in f64, and so is its sum with an f32
    value within 29 binades of it (rarer inputs round twice)."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(a.dtype)


def _xla_sum(vals: torch.Tensor) -> torch.Tensor:
    """Sum of (B, P, P, G, G, C) over its (G, G) samples in XLA's CPU order:
    one after another in row-major (iy, ix) order; where G > _XLA_WINDOW,
    each side is zero-padded (centred) to a multiple of the window, each
    window's samples are summed in that order and the windows' sums after
    them (XLA's tree-reduction rewrite). The same sums on every device."""
    g = vals.shape[3]
    if g > _XLA_WINDOW:
        pad = -g % _XLA_WINDOW
        lo = pad // 2
        vals = torch.nn.functional.pad(vals, (0, 0, lo, pad - lo, lo, pad - lo))
        b, p, _, gp, _, c = vals.shape
        n, w = gp // _XLA_WINDOW, _XLA_WINDOW
        blocks = vals.reshape(b, p, p, n, w, n, w, c)
        part = _xla_sum(blocks.permute(0, 1, 2, 3, 5, 4, 6, 7)
                        .reshape(b, p, p * n * n, w, w, c))
        return _xla_sum(part.reshape(b, p, p, n, n, c))
    flat = vals.flatten(3, 4)
    acc = flat[:, :, :, 0]
    for j in range(1, flat.shape[3]):
        acc = acc + flat[:, :, :, j]
    return acc


def _bilinear(fm_t: torch.Tensor, y: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of maps fm_t (B, S*S, C) (channels last) at
    positions y, x (B, ...) -> (B, ..., C)."""
    b, ss, _ = fm_t.shape
    s = math.isqrt(ss)
    valid = (y >= -1.0) & (y <= s) & (x >= -1.0) & (x <= s)
    yc = y.clamp(0.0, s - 1)
    xc = x.clamp(0.0, s - 1)
    y0 = torch.floor(yc).to(torch.int64)
    x0 = torch.floor(xc).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=s - 1)
    x1 = torch.clamp(x0 + 1, max=s - 1)
    ly = yc - y0.to(yc.dtype)
    lx = xc - x0.to(xc.dtype)
    hy, hx = 1.0 - ly, 1.0 - lx
    bi = torch.arange(b, device=fm_t.device).view((b,) + (1,) * (y.dim() - 1))

    def at(yi, xi):
        return fm_t[bi, yi * s + xi]  # (B, ..., C)

    w = lambda a, c: (a * c)[..., None]  # noqa: E731
    # v00 w00 + v01 w01 + v10 w10 + v11 w11 as XLA's CPU code contracts it:
    # fma(v11, w11, fma(v10, w10, fma(v01, w01, v00 w00)))
    out = _fma(at(y0, x1), w(hy, lx), at(y0, x0) * w(hy, hx))
    out = _fma(at(y1, x0), w(ly, hx), out)
    out = _fma(at(y1, x1), w(ly, lx), out)
    return torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype,
                                                          device=out.device))


def _roi_align(feats: torch.Tensor, sizes: torch.Tensor, P: int,
               G: int) -> torch.Tensor:
    """roi_align of (B, C, S, S) maps with RoIs [0, 0, w, h] -> (B, C, P,
    P)."""
    b, c, s, _ = feats.shape
    dev, f32 = feats.device, feats.dtype
    h = torch.clamp(sizes[:, 0], min=1.0)
    w = torch.clamp(sizes[:, 1], min=1.0)
    bin_h = h * _inverse(P, h)
    bin_w = w * _inverse(P, w)
    grid_h = torch.ceil(bin_h).to(torch.int32)  # the adaptive sampling ratio
    grid_w = torch.ceil(bin_w).to(torch.int32)

    ph = torch.arange(P, device=dev).to(f32)
    it = torch.arange(G, device=dev)
    iy = it.to(f32)

    def positions(bin_, grid):
        # y[p, i] = p * bin + (i + .5) * bin / grid, left to right. Where
        # G = 1, XLA's CPU code fuses the add with the first product into
        # one FMA (with G > 1 it hoists the product out of the sample loop
        # and rounds it alone)
        bin_ = bin_[:, None, None]
        off = (iy[None, None, :] + 0.5) * bin_ / grid.to(f32)[:, None, None]
        if G > 1:
            return ph[None, :, None] * bin_ + off
        return _fma(ph[None, :, None], bin_, off)

    ys = positions(bin_h, grid_h)  # (B, P, G)
    xs = positions(bin_w, grid_w)
    my = it[None, :] < grid_h[:, None]  # (B, G) sample validity
    mx = it[None, :] < grid_w[:, None]

    yy = ys[:, :, None, :, None].expand(b, P, P, G, G)
    xx = xs[:, None, :, None, :].expand(b, P, P, G, G)
    fm_t = feats.reshape(b, c, s * s).transpose(1, 2)  # (B, S*S, C)
    vals = _bilinear(fm_t, yy, xx)  # (B, P, P, G, G, C)
    mask = (my[:, :, None] & mx[:, None, :]).to(f32)  # (B, G, G)
    vals = vals * mask[:, None, None, :, :, None]
    count = torch.clamp(grid_h * grid_w, min=1).to(f32)
    out = _xla_sum(vals) / count[:, None, None, None]  # (B, P, P, C)
    return out.permute(0, 3, 1, 2).contiguous()


def _roi_pool(feats: torch.Tensor, sizes: torch.Tensor, P: int,
              W: int) -> torch.Tensor:
    """roi_pool of (B, C, S, S) maps with RoIs [0, 0, w, h] -> (B, C, P,
    P)."""
    b, c, s, _ = feats.shape
    dev, f32 = feats.device, feats.dtype
    # the legacy +1 box convention: the roi spans round(coord) inclusive
    roi_h = torch.clamp(torch.round(sizes[:, 0]) + 1.0, min=1.0)
    roi_w = torch.clamp(torch.round(sizes[:, 1]) + 1.0, min=1.0)
    bin_h = (roi_h * _inverse(P, roi_h))[:, None]  # (B, 1)
    bin_w = (roi_w * _inverse(P, roi_w))[:, None]

    ph = torch.arange(P, device=dev).to(f32)[None, :]  # (1, P)

    def edges(bin_):
        start = torch.clamp(torch.floor(ph * bin_), 0, s).to(torch.int64)
        end = torch.clamp(torch.ceil((ph + 1.0) * bin_), 0, s).to(torch.int64)
        return start, end

    hstart, hend = edges(bin_h)  # (B, P)
    wstart, wend = edges(bin_w)
    off = torch.arange(W, device=dev)
    yi = torch.clamp(hstart[:, :, None] + off, max=s - 1)  # (B, P, W)
    xi = torch.clamp(wstart[:, :, None] + off, max=s - 1)
    my = off < (hend - hstart)[:, :, None]  # (B, P, W)
    mx = off < (wend - wstart)[:, :, None]

    fm_t = feats.reshape(b, c, s * s).transpose(1, 2)  # (B, S*S, C)
    flat = yi[:, :, None, :, None] * s + xi[:, None, :, None, :]  # B,P,P,W,W
    bi = torch.arange(b, device=dev).view(b, 1, 1, 1, 1)
    sub = fm_t[bi, flat]  # (B, P, P, W, W, C)
    mask = my[:, :, None, :, None] & mx[:, None, :, None, :]  # (B,P,P,W,W)
    neg = torch.tensor(torch.finfo(f32).min, dtype=f32, device=dev)
    sub = torch.where(mask[..., None], sub, neg)
    out = sub.amax(dim=(3, 4))  # (B, P, P, C)
    empty = ~mask.any(dim=(3, 4))  # (B, P, P)
    out = torch.where(empty[..., None], torch.zeros((), dtype=f32, device=dev),
                      out)
    return out.permute(0, 3, 1, 2).contiguous()


def roi_resize(feats: torch.Tensor, sizes: torch.Tensor, P: int,
               func: str = "avg") -> torch.Tensor:
    """Resize a (B, C, S, S) f32 batch of square-padded maps to (B, C, P,
    P) on its device; ``sizes`` (B, 2) f32 holds each image's (h, w)."""
    s = feats.shape[-1]
    if func == "avg":
        return _roi_align(feats, sizes, P, max(math.ceil(s / P), 1))
    if func == "max":
        return _roi_pool(feats, sizes, P, max(math.ceil((s + 1) / P) + 1, 1))
    raise ValueError(f"func must be 'avg' or 'max', not {func!r}")


@torch.no_grad()
def roi_resize_batch(feats, sizes, P: int, func: str = "avg",
                     device=None) -> np.ndarray:
    """Resize a (B, C, S, S) batch of square-padded maps to (B, C, P, P).

    :param feats: square-padded feature maps (original content top-left).
    :param sizes: (B, 2) array of the original (h, w) per image.
    :param P: output side.
    :param func: "avg" (roi_align) or "max" (roi_pool).
    :param device: where it runs: the CUDA device unless "cpu" is asked
        for.
    :return: (B, C, P, P) f32 NumPy array.
    """
    dev = resolve_device(device)
    f = torch.as_tensor(np.asarray(feats, np.float32), device=dev)
    sz = torch.as_tensor(np.asarray(sizes, np.float32), device=dev)
    return roi_resize(f, sz, P, func).cpu().numpy()
