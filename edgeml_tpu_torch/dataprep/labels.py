"""Annotation converters: COCO JSON / VOC XML -> YOLO-format label files.

A copy of the JAX package's ``dataprep/labels.py`` (host-only code; the
port keeps its own so that it never imports the JAX package). One
"{cls} {x} {y} {w} {h}" line per object, normalised xywh-center, each
value written with ``str`` in the same arithmetic order, so the files are
byte-identical to the JAX package's. COCO JSON is parsed with the stdlib
``json`` module (no pycocotools).
"""

from __future__ import annotations

import json
import os
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

VOC_CLASS_NAMES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

COCO_SPLITS = (("2017", "train"), ("2017", "val"))
VOC_SPLITS = (
    ("2012", "train"), ("2012", "val"),
    ("2007", "train"), ("2007", "val"), ("2007", "test"),
)


def _write_rows(path: str, rows) -> None:
    lines = [" ".join(str(a) for a in row) for row in rows]
    with open(path, "w") as out:
        out.write("\n".join(lines) + ("\n" if lines else ""))


def coco_label(data_dir: str, save_dir: str, splits=COCO_SPLITS) -> None:
    """Convert COCO instance annotations to per-image YOLO label files.

    Class ids are compacted to 0..79 by their index in the sorted
    category-id list. COCO boxes (x_topleft, y_topleft, w, h) become
    center-xywh normalised by the image size. Every image gets a file, an
    empty one when it has no annotation.
    """
    for year, image_set in splits:
        lbs_path = os.path.join(save_dir, f"{image_set}{year}")
        Path(lbs_path).mkdir(parents=True, exist_ok=True)
        anno_path = os.path.join(
            data_dir, "annotations", f"instances_{image_set}{year}.json")
        with open(anno_path) as f:
            anno = json.load(f)
        cat_ids = sorted(c["id"] for c in anno["categories"])
        cat_index = {cid: i for i, cid in enumerate(cat_ids)}
        per_image: dict[int, list] = {img["id"]: [] for img in anno["images"]}
        for obj in anno.get("annotations", []):
            per_image.setdefault(obj["image_id"], []).append(obj)
        for img in anno["images"]:
            name = img["file_name"].split(".")[0]
            w, h = img["width"], img["height"]
            rows = []
            for obj in per_image.get(img["id"], []):
                bx, by, bw, bh = obj["bbox"]
                rows.append((cat_index[obj["category_id"]],
                             (bx + bw / 2) / w, (by + bh / 2) / h,
                             bw / w, bh / h))
            _write_rows(os.path.join(lbs_path, f"{name}.txt"), rows)


def _split_ids(devkit: str, year: str, image_set: str) -> list:
    ids_file = os.path.join(devkit, f"VOC{year}/ImageSets/Main/{image_set}.txt")
    with open(ids_file) as f:
        return f.read().strip().split()


def voc_label(data_dir: str, save_dir: str, splits=VOC_SPLITS) -> None:
    """Convert Pascal VOC XML annotations to per-image YOLO label files
    (``parse_voc_xml``'s rows)."""
    devkit = os.path.join(data_dir, "VOCdevkit")
    for year, image_set in splits:
        lbs_path = os.path.join(save_dir, f"{image_set}{year}")
        Path(lbs_path).mkdir(parents=True, exist_ok=True)
        for img_id in _split_ids(devkit, year, image_set):
            rows = parse_voc_xml(
                os.path.join(devkit, f"VOC{year}/Annotations/{img_id}.xml"))
            _write_rows(os.path.join(lbs_path, f"{img_id}.txt"), rows)


def parse_voc_xml(xml_path: str) -> list:
    """One VOC annotation XML -> YOLO-normalised rows (cls, x, y, w, h).

    Difficult objects and classes outside the 20-class list are skipped;
    the center is ((xmin + xmax) / 2 - 1), the original VOC tooling's
    convention, before normalisation.
    """
    root = ET.parse(xml_path).getroot()
    size = root.find("size")
    w = int(size.find("width").text)
    h = int(size.find("height").text)
    rows = []
    for obj in root.iter("object"):
        cls = obj.find("name").text
        difficult = int(obj.find("difficult").text)
        if cls not in VOC_CLASS_NAMES or difficult == 1:
            continue
        bb = obj.find("bndbox")
        xmin, xmax, ymin, ymax = (
            float(bb.find(k).text) for k in ("xmin", "xmax", "ymin", "ymax"))
        rows.append((VOC_CLASS_NAMES.index(cls),
                     ((xmin + xmax) / 2.0 - 1) / w,
                     ((ymin + ymax) / 2.0 - 1) / h,
                     (xmax - xmin) / w,
                     (ymax - ymin) / h))
    return rows


def voc_examples(voc_root: str, splits=VOC_SPLITS):
    """(image_paths, labels) straight from a VOCdevkit tree, without the
    label files: labels are (cls (n,), xyxy (n, 4)) f32 pairs in
    normalised coordinates (the ``load_data`` convention). ``voc_root`` is
    the VOCdevkit directory or its parent."""
    devkit = (
        voc_root
        if os.path.basename(os.path.normpath(voc_root)) == "VOCdevkit"
        else os.path.join(voc_root, "VOCdevkit")
    )
    paths, labels = [], []
    for year, image_set in splits:
        for img_id in _split_ids(devkit, year, image_set):
            rows = np.asarray(
                parse_voc_xml(os.path.join(
                    devkit, f"VOC{year}/Annotations/{img_id}.xml")),
                np.float32).reshape(-1, 5)
            cls = rows[:, 0]
            x, y, bw, bh = rows[:, 1], rows[:, 2], rows[:, 3], rows[:, 4]
            xyxy = np.stack(
                [x - bw / 2, y - bh / 2, x + bw / 2, y + bh / 2], axis=1)
            paths.append(
                os.path.join(devkit, f"VOC{year}/JPEGImages/{img_id}.jpg"))
            labels.append((cls, xyxy))
    return paths, labels
