"""Detection data augmentation (host side, NumPy, batch preparation).

The reference package's ``data/transforms.py`` (the torchvision detection
references' transforms): Compose, PILToTensor, ConvertImageDtype,
RandomHorizontalFlip (with COCO person keypoints), RandomIoUCrop,
RandomZoomOut, RandomPhotometricDistort, ScaleJitter, FixedSizeCrop,
RandomShortestSize and SimpleCopyPaste; the train CLI's ``--augment flip``
and ``--augment ssd`` build from the first ones. Samples are (image (H, W,
3) float32 in [0, 1], target dict with 'boxes' (N, 4) xyxy pixels and
'labels' (N,)); every draw comes from an explicit ``np.random.Generator`` in
the reference's order, so a sample is the reference package's for the same
generator. The two resizing transforms resize with ``resize_antialiased``,
the reference's antialiased bilinear (``jax.image.resize(..., "bilinear")``
shrinks through a widened triangle kernel): the same within 5e-6.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, image, target, rng):
        for t in self.transforms:
            image, target = t(image, target, rng)
        return image, target


class PILToTensor:
    """The torchvision shim that makes a uint8 image: images here are
    already HWC arrays, so whatever the loader produced becomes a uint8 HWC
    array (float inputs in [0, 1] are scaled, as ``F.pil_to_tensor``'s
    bytes)."""

    def __call__(self, image, target, rng):
        if image.dtype != np.uint8:
            image = np.round(np.clip(image, 0.0, 1.0) * 255.0).astype(
                np.uint8)
        return image, target


class ConvertImageDtype:
    """Dtype conversion with torchvision's value scaling: uint8 -> float
    divides by 255; any other conversion is a plain cast."""

    def __init__(self, dtype=np.float32):
        self.dtype = np.dtype(dtype)

    def __call__(self, image, target, rng):
        if image.dtype == np.uint8 and self.dtype.kind == "f":
            image = image.astype(self.dtype) / np.asarray(
                255.0, self.dtype)
        else:
            image = image.astype(self.dtype)
        return image, target


# COCO person left/right joint swap under a horizontal flip
_KP_FLIP_INDS = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)


def flip_coco_person_keypoints(kps, width):
    """Mirror (N, 17, 3) COCO keypoints: swap left/right joints, reflect x,
    and keep the convention that invisible joints (v == 0) sit at (0, 0)."""
    flipped = np.asarray(kps)[:, list(_KP_FLIP_INDS)].copy()
    flipped[..., 0] = width - flipped[..., 0]
    flipped[flipped[..., 2] == 0] = 0
    return flipped


def resize_antialiased(image, nh: int, nw: int):
    """(H, W, 3) f32 image resized to (nh, nw): bilinear with half-pixel
    centres, antialiased when shrinking (the triangle kernel widened by the
    scale), weights renormalised at the borders."""
    x = torch.from_numpy(np.ascontiguousarray(image, np.float32))
    out = F.interpolate(x.permute(2, 0, 1)[None], size=(nh, nw),
                        mode="bilinear", align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).numpy()


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
            target["keypoints"] = flip_coco_person_keypoints(
                target["keypoints"], w)
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


class ScaleJitter:
    """Resize by a random factor relative to a target size (LSJ)."""

    def __init__(self, target_size=(1024, 1024), scale_range=(0.1, 2.0)):
        self.target_size = target_size
        self.scale_range = scale_range

    def __call__(self, image, target, rng):
        h, w = image.shape[:2]
        scale = rng.uniform(*self.scale_range)
        r = min(self.target_size[0] / h, self.target_size[1] / w) * scale
        nh, nw = max(int(h * r), 1), max(int(w * r), 1)
        image = resize_antialiased(image, nh, nw)
        boxes = target["boxes"] * np.array([nw / w, nh / h, nw / w, nh / h])
        return image, {**target, "boxes": boxes.astype(np.float32)}


class FixedSizeCrop:
    """Crop/pad to an exact size, keeping boxes whose centers survive."""

    def __init__(self, size=(640, 640), fill=0.0):
        self.size = size
        self.fill = fill

    def __call__(self, image, target, rng):
        h, w = image.shape[:2]
        th, tw = self.size
        top = rng.integers(0, max(h - th, 0) + 1)
        left = rng.integers(0, max(w - tw, 0) + 1)
        img = image[top : top + th, left : left + tw]
        boxes = target["boxes"].copy()
        boxes[:, [0, 2]] -= left
        boxes[:, [1, 3]] -= top
        ch, cw = img.shape[:2]
        cx = (boxes[:, 0] + boxes[:, 2]) / 2
        cy = (boxes[:, 1] + boxes[:, 3]) / 2
        keep = (cx > 0) & (cx < cw) & (cy > 0) & (cy < ch)
        boxes = np.clip(
            boxes[keep], 0, np.array([cw, ch, cw, ch], np.float32)
        )
        out = np.full((th, tw, 3), self.fill, np.float32)
        out[:ch, :cw] = img
        return out, {**target, "boxes": boxes, "labels": target["labels"][keep]}


class RandomShortestSize:
    """Resize so the shorter side matches a randomly chosen target."""

    def __init__(self, min_size=(480, 512, 544, 576, 608, 640), max_size=1024):
        self.min_size = tuple(np.atleast_1d(min_size))
        self.max_size = max_size

    def __call__(self, image, target, rng):
        h, w = image.shape[:2]
        ms = self.min_size[rng.integers(len(self.min_size))]
        r = min(ms / min(h, w), self.max_size / max(h, w))
        nh, nw = int(h * r), int(w * r)
        image = resize_antialiased(image, nh, nw)
        boxes = target["boxes"] * np.array([nw / w, nh / h, nw / w, nh / h])
        return image, {**target, "boxes": boxes.astype(np.float32)}


class SimpleCopyPaste:
    """Paste another sample's object regions (box-masked) onto this image:
    the box-level form of torchvision's mask-based transform (the pipeline
    carries no instance masks)."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, sample_a, sample_b, rng):
        (img_a, tgt_a), (img_b, tgt_b) = sample_a, sample_b
        if rng.random() >= self.p or len(tgt_b["boxes"]) == 0:
            return img_a, tgt_a
        ha, wa = img_a.shape[:2]
        out = img_a.copy()
        new_boxes, new_labels = [tgt_a["boxes"]], [tgt_a["labels"]]
        n = rng.integers(1, len(tgt_b["boxes"]) + 1)
        pick = rng.permutation(len(tgt_b["boxes"]))[:n]
        for i in pick:
            x1, y1, x2, y2 = tgt_b["boxes"][i].astype(int)
            patch = img_b[y1:y2, x1:x2]
            ph, pw = patch.shape[:2]
            if ph < 2 or pw < 2 or ph >= ha or pw >= wa:
                continue
            top = rng.integers(0, ha - ph)
            left = rng.integers(0, wa - pw)
            out[top : top + ph, left : left + pw] = patch
            new_boxes.append(
                np.array([[left, top, left + pw, top + ph]], np.float32)
            )
            new_labels.append(np.array([tgt_b["labels"][i]]))
        return out, {
            "boxes": np.concatenate(new_boxes),
            "labels": np.concatenate(new_labels),
        }
