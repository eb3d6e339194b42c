"""COCO dataset utilities: stdlib-JSON indexing, polygon masks, RLE codec.

A copy of the JAX package's ``dataprep/coco_dataset.py`` (host NumPy only;
the port keeps its own so that it never imports the JAX package). Masks,
RLE dicts and targets equal the JAX package's exactly.

  * CocoIndex          — COCO-API-shaped view (imgs/anns/cats lookups) over a
                         plain dict, stdlib json only;
  * polygons_to_mask   — COCO polygon segmentation -> bool mask (NumPy
                         even-odd scanline fill at pixel centers);
  * rle_decode/encode  — uncompressed and compressed COCO RLE;
  * convert_polys_target — torchvision's ConvertCocoPolysToMask semantics:
                         crowd drop, xywh->xyxy with clamping, degenerate-box
                         filter, mask stack;
  * CocoDetectionDataset + get_coco — the dataset builder, with train-split
                         filtering of unannotated images;
  * dataset_to_coco_index — torchvision's convert_to_coco_api: rebuild a
                         CocoIndex from loaded targets, annotation ids
                         starting at 1.

Masks are NumPy bool arrays (H, W).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..data.loader import decode_image


# ---- RLE codec ---------------------------------------------------------------


def rle_decode(rle: dict) -> np.ndarray:
    """{'counts': list|str|bytes, 'size': [h, w]} -> (h, w) bool mask.
    COCO RLE runs are column-major, starting with a background run."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _rle_unstring(counts)
    flat = np.zeros(h * w, bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos : pos + c] = True
        pos += c
        val = not val
    return flat.reshape(w, h).T  # column-major


def rle_encode(mask: np.ndarray) -> dict:
    """(h, w) bool mask -> uncompressed COCO RLE dict."""
    h, w = mask.shape
    flat = np.asarray(mask, bool).T.reshape(-1)  # column-major
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    counts = runs.tolist()
    if flat.size and flat[0]:  # runs must start with background
        counts = [0] + counts
    return {"counts": counts, "size": [h, w]}


def _rle_unstring(s) -> list:
    """COCO compressed RLE string -> counts list (LEB128-style base-32 with
    sign bit and delta coding for runs past the second)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_area(rle: dict) -> int:
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _rle_unstring(counts)
    return int(sum(counts[1::2]))


# ---- polygon rasterization ----------------------------------------------------


def polygons_to_mask(polygons, height: int, width: int) -> np.ndarray:
    """COCO polygon segmentation (list of flat [x0, y0, x1, y1, ...]) ->
    (height, width) bool mask; union over polygons, even-odd fill sampled at
    pixel centers."""
    mask = np.zeros((height, width), bool)
    for poly in polygons:
        p = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(p) < 3:
            continue
        mask |= _fill_polygon(p, height, width)
    return mask


def _fill_polygon(pts: np.ndarray, height: int, width: int) -> np.ndarray:
    """Even-odd scanline fill of one polygon at pixel centers (x+.5, y+.5).

    A pixel is inside iff the number of edge crossings strictly to the RIGHT
    of its center is odd. Crossings are binned to pixel columns and counted
    with a per-row cumsum — O(H*(E+W)) time and memory; the naive
    (H, E, W) crossing tensor peaks at hundreds of MB for COCO-sized
    polygons (E~300, 640x480)."""
    x, y = pts[:, 0], pts[:, 1]
    x2, y2 = np.roll(x, -1), np.roll(y, -1)
    yc = np.arange(height)[:, None] + 0.5  # (H, 1) scanline centers
    # edges crossing each scanline (half-open rule avoids double-counting
    # vertices)
    cross = (np.minimum(y, y2)[None, :] <= yc) & (yc < np.maximum(y, y2)[None, :])
    # Horizontal edges (y2 == y) never satisfy `cross` (the half-open test is
    # empty), so their intersection x is irrelevant — substitute a unit
    # denominator explicitly instead of letting 0/0 produce NaNs that the
    # cross mask would silently drop.
    dy = y2 - y
    t = (yc - y[None, :]) / np.where(dy == 0.0, 1.0, dy)[None, :]
    xs = x[None, :] + t * (x2 - x)[None, :]  # (H, E) intersection x
    # crossings_at_or_left(row, j) = #{xs <= j + 0.5}; a crossing at exactly
    # the pixel center does NOT count as "to the right" (strict >), so it
    # belongs to column ceil(xs - 0.5) and every column after it.
    rows, edges = np.nonzero(cross)
    col = np.clip(np.ceil(xs[rows, edges] - 0.5).astype(np.int64), 0, width)
    hist = np.zeros((height, width + 1), np.int64)
    np.add.at(hist, (rows, col), 1)
    at_or_left = np.cumsum(hist[:, :width], axis=1)
    n_cross = cross.sum(axis=1)  # (H,)
    return ((n_cross[:, None] - at_or_left) % 2).astype(bool)


def segmentation_to_mask(seg, height: int, width: int) -> np.ndarray:
    """Any COCO segmentation (polygons, uncompressed RLE dict, compressed RLE
    dict) -> bool mask."""
    if isinstance(seg, dict):
        return rle_decode(seg)
    return polygons_to_mask(seg, height, width)


# ---- annotation -> target conversion ------------------------------------------


def filter_remap_categories(anns: list, categories: list, remap: bool = True):
    """Keep annotations whose category is in `categories`; optionally remap
    ids to positions (torchvision's FilterAndRemapCocoCategories)."""
    anns = [a for a in anns if a["category_id"] in categories]
    if remap:
        anns = [dict(a, category_id=categories.index(a["category_id"]))
                for a in anns]
    return anns


def convert_polys_target(anns: list, height: int, width: int,
                         image_id: int, with_masks: bool = True) -> dict:
    """ConvertCocoPolysToMask semantics: drop crowds,
    xywh->xyxy clamped to the image, rasterize masks, filter degenerate
    boxes. Returns NumPy arrays."""
    anns = [a for a in anns if a.get("iscrowd", 0) == 0]
    boxes = np.asarray(
        [a["bbox"] for a in anns], np.float32
    ).reshape(-1, 4)
    boxes[:, 2:] += boxes[:, :2]
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, width)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, height)
    classes = np.asarray([a["category_id"] for a in anns], np.int64)
    masks = None
    if with_masks:
        masks = (
            np.stack(
                [segmentation_to_mask(a["segmentation"], height, width)
                 for a in anns]
            )
            if anns
            else np.zeros((0, height, width), bool)
        )
    keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
    target = {
        "boxes": boxes[keep],
        "labels": classes[keep],
        "image_id": image_id,
        "area": np.asarray([a["area"] for a in anns], np.float32),
        "iscrowd": np.asarray([a.get("iscrowd", 0) for a in anns], np.int64),
    }
    if with_masks:
        target["masks"] = masks[keep]
    return target


# ---- COCO index + dataset ------------------------------------------------------


class CocoIndex:
    """COCO-API-shaped lookups over a plain dict (stdlib json)."""

    def __init__(self, dataset: dict):
        self.dataset = dataset
        self.imgs = {im["id"]: im for im in dataset.get("images", [])}
        self.cats = {c["id"]: c for c in dataset.get("categories", [])}
        self.img_to_anns = {i: [] for i in self.imgs}
        self.anns = {}
        for a in dataset.get("annotations", []):
            self.anns[a["id"]] = a
            self.img_to_anns.setdefault(a["image_id"], []).append(a)

    @classmethod
    def from_file(cls, ann_file: str):
        with open(ann_file) as f:
            return cls(json.load(f))

    def get_ann_ids(self, img_id):
        return [a["id"] for a in self.img_to_anns.get(img_id, [])]

    def load_anns(self, ann_ids):
        return [self.anns[i] for i in ann_ids]


class CocoDetectionDataset:
    """(image array, target dict) pairs from a COCO JSON + image folder —
    torchvision's CocoDetection wrapper in NumPy."""

    def __init__(self, img_folder: str, ann_file: str, with_masks: bool = True,
                 categories: list | None = None, remap: bool = True):
        self.img_folder = img_folder
        self.coco = CocoIndex.from_file(ann_file)
        self.ids = sorted(self.coco.imgs)
        self.with_masks = with_masks
        self.categories = categories
        self.remap = remap

    def __len__(self):
        return len(self.ids)

    def annotations(self, idx: int):
        anns = self.coco.img_to_anns.get(self.ids[idx], [])
        if self.categories is not None:
            anns = filter_remap_categories(anns, self.categories, self.remap)
        return anns

    def __getitem__(self, idx: int):
        info = self.coco.imgs[self.ids[idx]]
        img = decode_image(os.path.join(self.img_folder, info["file_name"]))
        target = convert_polys_target(
            self.annotations(idx), info["height"], info["width"],
            self.ids[idx], self.with_masks,
        )
        return img, target


def remove_images_without_annotations(dataset: CocoDetectionDataset,
                                      cat_list: list | None = None):
    """Indices of images with at least one usable annotation
    (bbox criteria; no keypoint task here)."""

    def has_only_empty_bbox(anns):
        return all(any(v <= 1 for v in a["bbox"][2:]) for a in anns)

    keep = []
    for idx in range(len(dataset)):
        anns = dataset.coco.img_to_anns.get(dataset.ids[idx], [])
        if cat_list is not None:
            anns = [a for a in anns if a["category_id"] in cat_list]
        if anns and not has_only_empty_bbox(anns):
            keep.append(idx)
    return keep


def get_coco(root: str, image_set: str, mode: str = "instances",
             with_masks: bool = True):
    """The dataset builder of torchvision's detection recipe: standard 2017
    layout, train split drops images without annotations. Returns
    (dataset, kept_indices)."""
    paths = {
        "train": ("train2017", os.path.join(
            "annotations", f"{mode}_train2017.json")),
        "val": ("val2017", os.path.join(
            "annotations", f"{mode}_val2017.json")),
    }
    img_folder, ann_file = paths[image_set]
    ds = CocoDetectionDataset(
        os.path.join(root, img_folder), os.path.join(root, ann_file),
        with_masks=with_masks,
    )
    idx = (
        remove_images_without_annotations(ds)
        if image_set == "train"
        else list(range(len(ds)))
    )
    return ds, idx


def dataset_to_coco_index(dataset, indices=None) -> CocoIndex:
    """convert_to_coco_api: rebuild a CocoIndex from
    loaded (image, target) pairs; annotation ids start at 1; masks stored as
    uncompressed RLE."""
    indices = range(len(dataset)) if indices is None else indices
    out = {"images": [], "categories": [], "annotations": []}
    categories = set()
    ann_id = 1
    for idx in indices:
        img, t = dataset[idx]
        image_id = int(t["image_id"])
        out["images"].append(
            {"id": image_id, "height": img.shape[0], "width": img.shape[1]}
        )
        boxes = np.asarray(t["boxes"], np.float64).copy()
        boxes[:, 2:] -= boxes[:, :2]  # back to xywh
        for i in range(len(boxes)):
            ann = {
                "image_id": image_id,
                "bbox": boxes[i].tolist(),
                "category_id": int(t["labels"][i]),
                "area": float(t["area"][i]) if i < len(t["area"])
                else float(boxes[i, 2] * boxes[i, 3]),
                "iscrowd": int(t["iscrowd"][i]) if i < len(t["iscrowd"]) else 0,
                "id": ann_id,
            }
            if "masks" in t:
                ann["segmentation"] = rle_encode(np.asarray(t["masks"][i]))
            categories.add(int(t["labels"][i]))
            out["annotations"].append(ann)
            ann_id += 1
    out["categories"] = [{"id": i} for i in sorted(categories)]
    return CocoIndex(out)
