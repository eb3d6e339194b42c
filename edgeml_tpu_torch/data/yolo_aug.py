"""YOLOv5 training-recipe augmentation (host side, loader threads).

The ultralytics VOC recipe's data pipeline, as the reference package
implements it: mosaic-4, a random scale/translate affine, HSV jitter and a
horizontal flip, on decoded float RGB arrays with NumPy only, at the
hyp.scratch-low defaults (degrees, shear and perspective 0, so the affine
is a scale + translate window, computed as a crop and a bilinear resize).
The mosaic's 3 partners are drawn from the current batch (the streaming
loader decodes per batch).

All randomness flows through ``np.random.default_rng`` streams seeded from
the caller's key, the same draws in the same order as the reference
package's, so images and labels equal its for the same key: the resizes
evaluate the same taps through the same native resampler, and the host
HSV jitter runs the same native kernel (``fastaug``; a failed build
raises). ``hsv_jitter_numpy`` keeps the NumPy expression as the tests'
oracle.
"""

from __future__ import annotations

import numpy as np

from .loader import resize_bilinear, resize_bilinear_window

FILL = 114.0 / 255.0


# ---------------------------------------------------------------------------
# HSV colour jitter
# ---------------------------------------------------------------------------


def _rgb_to_hsv(img: np.ndarray):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.max(-1)
    mn = img.min(-1)
    diff = mx - mn
    safe = np.where(diff == 0, 1.0, diff)
    h = np.where(
        mx == r, (g - b) / safe % 6.0,
        np.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    )
    h = np.where(diff == 0, 0.0, h) / 6.0  # [0, 1)
    s = np.where(mx == 0, 0.0, diff / np.where(mx == 0, 1.0, mx))
    return h, s, mx


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray):
    h6 = (h % 1.0) * 6.0
    i = np.floor(h6).astype(np.int32) % 6
    f = h6 - np.floor(h6)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def hsv_gains(rng: np.random.Generator, hgain: float = 0.015,
              sgain: float = 0.7, vgain: float = 0.4) -> np.ndarray:
    """The ultralytics augment_hsv gain draw: r = 1 + U(-1, 1) * gain per
    (h, s, v) channel. Split out so the device jitter (``ops/color.py``)
    consumes the same random stream as the host path."""
    return rng.uniform(-1, 1, 3) * (hgain, sgain, vgain) + 1.0


def hsv_jitter_numpy(img: np.ndarray, rh, rs, rv) -> np.ndarray:
    """The HSV jitter with gains (rh, rs, rv) as a NumPy expression (gains
    applied in float64): the oracle of the native kernel."""
    h, s, v = _rgb_to_hsv(img)
    h = (h * rh) % 1.0
    s = np.clip(s * rs, 0.0, 1.0)
    v = np.clip(v * rv, 0.0, 1.0)
    return _hsv_to_rgb(h, s, v).astype(img.dtype)


def hsv_jitter(img: np.ndarray, rng: np.random.Generator,
               hgain: float = 0.015, sgain: float = 0.7,
               vgain: float = 0.4) -> np.ndarray:
    """ultralytics augment_hsv on float RGB in [0, 1]: random gains
    r = 1 + U(-1, 1) * gain applied to (h, s, v); h wraps, s/v clip.
    Evaluated by the fused native kernel (``native/aug.cpp``)."""
    rh, rs, rv = hsv_gains(rng, hgain, sgain, vgain)
    if rh == rs == rv == 1.0:
        return img
    from .fastaug import native_hsv_jitter

    return native_hsv_jitter(img, rh, rs, rv)


# ---------------------------------------------------------------------------
# Mosaic + scale/translate affine
# ---------------------------------------------------------------------------


def mosaic4(images: list, labels: list, size: int, rng: np.random.Generator):
    """4 images -> one (2*size, 2*size, 3) canvas around a random center.

    labels: per image (cls (n,), xyxy normalized (n, 4)).
    Returns (canvas, cls (m,), boxes xyxy in canvas PIXELS (m, 4)).
    Matches ultralytics load_mosaic: each source image is resized so its long
    side is `size` (aspect preserved), placed into its quadrant against the
    center point; boxes shift accordingly and clip to the canvas.
    """
    s = size
    yc, xc = (int(rng.uniform(s // 2, 2 * s - s // 2)) for _ in range(2))
    canvas = np.full((2 * s, 2 * s, 3), FILL, np.float32)
    out_cls, out_box = [], []
    for qi, (img, (cls, xyxy)) in enumerate(zip(images, labels)):
        h0, w0 = img.shape[:2]
        r = s / max(h0, w0)
        h, w = int(round(h0 * r)), int(round(w0 * r))
        if qi == 0:  # top-left of center
            x1a, y1a = max(xc - w, 0), max(yc - h, 0)
            x2a, y2a = xc, yc
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
        elif qi == 1:  # top-right
            x1a, y1a = xc, max(yc - h, 0)
            x2a, y2a = min(xc + w, 2 * s), yc
            x1b, y1b = 0, h - (y2a - y1a)
        elif qi == 2:  # bottom-left
            x1a, y1a = max(xc - w, 0), yc
            x2a, y2a = xc, min(yc + h, 2 * s)
            x1b, y1b = w - (x2a - x1a), 0
        else:  # bottom-right
            x1a, y1a = xc, yc
            x2a, y2a = min(xc + w, 2 * s), min(yc + h, 2 * s)
            x1b, y1b = 0, 0
        # resample ONLY the visible window of the quadrant (identical pixels
        # to a full resize + crop; the clipped remainder is never computed)
        canvas[y1a:y2a, x1a:x2a] = resize_bilinear_window(
            img, h, w, y1b, y1b + (y2a - y1a), x1b, x1b + (x2a - x1a)
        )
        if len(cls):
            bx = xyxy * np.array([w, h, w, h], np.float32)
            bx[:, [0, 2]] += x1a - x1b
            bx[:, [1, 3]] += y1a - y1b
            out_cls.append(np.asarray(cls))
            out_box.append(bx)
    if out_cls:
        cls = np.concatenate(out_cls)
        box = np.concatenate(out_box)
        box = np.clip(box, 0, 2 * s)
    else:
        cls = np.zeros((0,), np.float32)
        box = np.zeros((0, 4), np.float32)
    return canvas, cls, box


def box_candidates(before: np.ndarray, after: np.ndarray,
                   wh_thr: float = 2.0, ar_thr: float = 100.0,
                   area_thr: float = 0.1) -> np.ndarray:
    """ultralytics box_candidates: keep boxes that survive the warp with
    width/height > wh_thr px, area ratio > area_thr, aspect ratio < ar_thr."""
    w1 = before[:, 2] - before[:, 0]
    h1 = before[:, 3] - before[:, 1]
    w2 = after[:, 2] - after[:, 0]
    h2 = after[:, 3] - after[:, 1]
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return (
        (w2 > wh_thr)
        & (h2 > wh_thr)
        & (w2 * h2 / (w1 * h1 + 1e-16) > area_thr)
        & (ar < ar_thr)
    )


def scale_translate(canvas: np.ndarray, cls: np.ndarray, boxes: np.ndarray,
                    size: int, rng: np.random.Generator,
                    scale: float = 0.5, translate: float = 0.1):
    """The hyp-default random_perspective (degrees=0, shear=0,
    perspective=0): sample gain g ~ U(1-scale, 1+scale) and translation
    t ~ U(0.5-translate, 0.5+translate)*size, i.e. an output window of side
    size/g in canvas space — realized as a FILL-padded crop + bilinear
    resize (a matmul on the host, no general warp needed).

    Returns (out (size, size, 3), cls, boxes xyxy in out pixels) with
    box_candidates filtering applied.
    """
    cs = canvas.shape[0]  # 2 * size
    g = rng.uniform(1.0 - scale, 1.0 + scale)
    tx = rng.uniform(0.5 - translate, 0.5 + translate) * size
    ty = rng.uniform(0.5 - translate, 0.5 + translate) * size
    # ultralytics composes: center shift (-cs/2), scale g, translate (tx, ty):
    #   x_out = g * (x_in - cs/2) + tx  =>  window x_in = (x_out - tx)/g + cs/2
    win = size / g  # window side in canvas pixels
    x0 = (0 - tx) / g + cs / 2
    y0 = (0 - ty) / g + cs / 2
    # integer crop bounds; keep the exact origin for box mapping
    xi0, yi0 = int(np.floor(x0)), int(np.floor(y0))
    xi1 = int(np.ceil(x0 + win)) + 1
    yi1 = int(np.ceil(y0 + win)) + 1
    pad = np.full((yi1 - yi0, xi1 - xi0, 3), FILL, np.float32)
    sy0, sy1 = max(yi0, 0), min(yi1, cs)
    sx0, sx1 = max(xi0, 0), min(xi1, cs)
    if sy1 > sy0 and sx1 > sx0:
        pad[sy0 - yi0 : sy1 - yi0, sx0 - xi0 : sx1 - xi0] = canvas[
            sy0:sy1, sx0:sx1
        ]
    # crop holds canvas [xi0, yi1) — resample its [x0-xi0, x0-xi0+win) window.
    # Scale each dim by g SEPARATELY: pad's H and W differ by a pixel or two
    # (independent floor/ceil of x0 and y0), and sizing both from the width
    # would apply a y-scale of g*W/H != g while boxes are mapped with exact
    # g — a systematic 1-3 px vertical label misalignment.
    out_big = resize_bilinear(pad, int(round(pad.shape[0] * g)),
                              int(round(pad.shape[1] * g)))
    # offset of the true window origin inside the resized crop
    ox = int(round((x0 - xi0) * g))
    oy = int(round((y0 - yi0) * g))
    out = out_big[oy : oy + size, ox : ox + size]
    if out.shape[0] < size or out.shape[1] < size:  # numeric edge: pad
        o = np.full((size, size, 3), FILL, np.float32)
        o[: out.shape[0], : out.shape[1]] = out
        out = o
    if len(cls):
        before = boxes * g  # pre-clip size reference in output scale
        bx = (boxes - np.array([x0, y0, x0, y0], np.float32)) * g
        bx = np.clip(bx, 0, size)
        keep = box_candidates(before, bx)
        cls, bx = cls[keep], bx[keep]
    else:
        bx = boxes
    return np.ascontiguousarray(out), cls, bx


def yolo_augment_batch(examples: list, size: int, base_rng_key,
                       scale: float = 0.5, translate: float = 0.1,
                       fliplr: float = 0.5, hsv=True, samples=None):
    """One training batch through the full recipe.

    :param examples: list of (image HWC float [0,1], (cls, xyxy normalized)).
    :param base_rng_key: sequence seeding np.random.default_rng per sample
        (e.g. [seed, epoch, batch_index]).
    :param hsv: True — apply HSV jitter on the host; False — no jitter;
        "device" — draw the per-image gains from the same rng stream but
        leave the pixels untouched, returning the gains for the training
        step to apply on the device (``ops/color.hsv_jitter``).
    :param samples: the batch positions to make (default: all), each as the
        whole batch would make it (its own seed, mosaic partners from the
        whole batch): a rank's rows of a global batch.
    :return: (images (B, size, size, 3) float32,
        rows list of (m, 5) [cls, x, y, w, h] normalized per image)
        — plus gains (B, 3) float32 when hsv == "device".
    """
    b = len(examples)
    samples = list(range(b)) if samples is None else list(samples)
    device_hsv = hsv == "device"
    gains = np.ones((len(samples), 3), np.float32) if device_hsv else None
    out_imgs = np.empty((len(samples), size, size, 3), np.float32)
    out_rows = []
    for o, i in enumerate(samples):
        rng = np.random.default_rng(list(base_rng_key) + [i])
        part = [i] + list(rng.choice(b, 3, replace=True))
        imgs = [examples[p][0] for p in part]
        labs = [examples[p][1] for p in part]
        canvas, cls, boxes = mosaic4(imgs, labs, size, rng)
        img, cls, boxes = scale_translate(
            canvas, cls, boxes, size, rng, scale, translate
        )
        if device_hsv:
            gains[o] = hsv_gains(rng)  # same stream position as host mode
        elif hsv:
            img = hsv_jitter(img, rng)
        if rng.random() < fliplr:
            img = img[:, ::-1]
            boxes = boxes[:, [2, 1, 0, 3]].copy() if len(cls) else boxes
            if len(cls):
                boxes[:, [0, 2]] = size - boxes[:, [0, 2]]
        out_imgs[o] = img
        if len(cls):
            x1, y1, x2, y2 = boxes.T
            rows = np.stack(
                [cls, (x1 + x2) / 2 / size, (y1 + y2) / 2 / size,
                 (x2 - x1) / size, (y2 - y1) / size], 1
            ).astype(np.float32)
        else:
            rows = np.zeros((0, 5), np.float32)
        out_rows.append(rows)
    if device_hsv:
        return out_imgs, out_rows, gains
    return out_imgs, out_rows
