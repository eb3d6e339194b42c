"""Detection data augmentation (host side, NumPy, batch preparation).

The five transforms that the train CLI's ``--augment flip`` and ``--augment
ssd`` build, copied from the reference package's ``data/transforms.py``
(the torchvision detection references' transforms): Compose,
RandomHorizontalFlip, RandomIoUCrop, RandomZoomOut and
RandomPhotometricDistort. Samples are (image (H, W, 3) float32 in [0, 1],
target dict with 'boxes' (N, 4) xyxy pixels and 'labels' (N,)); every draw
comes from an explicit ``np.random.Generator``, so a sample is the
reference package's for the same generator.
"""

from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, image, target, rng):
        for t in self.transforms:
            image, target = t(image, target, rng)
        return image, target


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, image, target, rng):
        if rng.random() >= self.p:
            return image, target
        w = image.shape[1]
        image = image[:, ::-1].copy()
        boxes = target["boxes"].copy()
        boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        target = {**target, "boxes": boxes}
        if "masks" in target:
            target["masks"] = np.asarray(target["masks"])[..., ::-1].copy()
        if "keypoints" in target:
            raise NotImplementedError(
                "flipping keypoints is not yet ported")
        return image, target


def _box_ioa(boxes, crop):
    """Intersection-over-area of boxes vs one crop rect."""
    x1 = np.maximum(boxes[:, 0], crop[0])
    y1 = np.maximum(boxes[:, 1], crop[1])
    x2 = np.minimum(boxes[:, 2], crop[2])
    y2 = np.minimum(boxes[:, 3], crop[3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area = np.maximum(
        (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), 1e-9
    )
    return inter / area


class RandomIoUCrop:
    """SSD-style crop: sample a patch whose IoU with kept boxes exceeds a
    randomly chosen threshold; keep boxes whose centers fall inside."""

    def __init__(self, min_scale=0.3, max_scale=1.0, min_aspect=0.5,
                 max_aspect=2.0, trials: int = 40):
        self.min_scale, self.max_scale = min_scale, max_scale
        self.min_aspect, self.max_aspect = min_aspect, max_aspect
        self.options = (0.0, 0.1, 0.3, 0.5, 0.7, 0.9, None)
        self.trials = trials

    def __call__(self, image, target, rng):
        h, w = image.shape[:2]
        boxes = target["boxes"]
        if len(boxes) == 0:
            return image, target
        while True:
            thr = self.options[rng.integers(len(self.options))]
            if thr is None:
                return image, target
            for _ in range(self.trials):
                scale = rng.uniform(self.min_scale, self.max_scale)
                ratio = rng.uniform(self.min_aspect, self.max_aspect)
                cw = int(w * scale * np.sqrt(ratio))
                ch = int(h * scale / np.sqrt(ratio))
                if cw <= 0 or ch <= 0 or cw > w or ch > h:
                    continue
                left = rng.integers(0, w - cw + 1)
                top = rng.integers(0, h - ch + 1)
                crop = (left, top, left + cw, top + ch)
                cx = (boxes[:, 0] + boxes[:, 2]) / 2
                cy = (boxes[:, 1] + boxes[:, 3]) / 2
                keep = (
                    (cx > crop[0]) & (cx < crop[2]) & (cy > crop[1]) & (cy < crop[3])
                )
                if not keep.any():
                    continue
                ioa = _box_ioa(boxes[keep], np.array(crop, np.float32))
                if ioa.min() < thr:
                    continue
                image = image[top : top + ch, left : left + cw].copy()
                nb = boxes[keep].copy()
                nb[:, [0, 2]] = np.clip(nb[:, [0, 2]] - left, 0, cw)
                nb[:, [1, 3]] = np.clip(nb[:, [1, 3]] - top, 0, ch)
                return image, {
                    **target,
                    "boxes": nb,
                    "labels": target["labels"][keep],
                }


class RandomZoomOut:
    """Place the image on a larger canvas filled with `fill`."""

    def __init__(self, fill=(0.485, 0.456, 0.406), side_range=(1.0, 4.0), p=0.5):
        self.fill = np.asarray(fill, np.float32)
        self.side_range = side_range
        self.p = p

    def __call__(self, image, target, rng):
        if rng.random() >= self.p:
            return image, target
        h, w = image.shape[:2]
        r = rng.uniform(*self.side_range)
        nh, nw = int(h * r), int(w * r)
        top = rng.integers(0, nh - h + 1)
        left = rng.integers(0, nw - w + 1)
        canvas = np.broadcast_to(self.fill, (nh, nw, 3)).copy()
        canvas[top : top + h, left : left + w] = image
        boxes = target["boxes"].copy()
        boxes[:, [0, 2]] += left
        boxes[:, [1, 3]] += top
        return canvas.astype(np.float32), {**target, "boxes": boxes}


class RandomPhotometricDistort:
    """Brightness / contrast / saturation / hue jitter + channel shuffle."""

    def __init__(self, contrast=(0.5, 1.5), saturation=(0.5, 1.5),
                 hue=(-0.05, 0.05), brightness=(0.875, 1.125), p=0.5):
        self.contrast, self.saturation = contrast, saturation
        self.hue, self.brightness = hue, brightness
        self.p = p

    def __call__(self, image, target, rng):
        img = image
        if rng.random() < self.p:
            img = img * rng.uniform(*self.brightness)
        if rng.random() < self.p:
            mean = img.mean()
            img = (img - mean) * rng.uniform(*self.contrast) + mean
        if rng.random() < self.p:
            gray = img.mean(axis=2, keepdims=True)
            img = gray + (img - gray) * rng.uniform(*self.saturation)
        if rng.random() < self.p:
            # cheap hue approximation: rotate channels toward their mean
            shift = rng.uniform(*self.hue)
            img = img + shift * (img[..., [1, 2, 0]] - img)
        if rng.random() < self.p:
            img = img[..., rng.permutation(3)]
        return np.clip(img, 0.0, 1.0).astype(np.float32), target
