"""The port's label converters and label CLI against the JAX package's.

Tolerance: none. Label files are byte-identical (the rows are written with
``str(float)`` in the same arithmetic order), and ``voc_examples``' paths
and arrays are equal. The trees are ``tests/test_dataprep.py``'s synthetic
COCO and VOC trees, widened with seeded boxes of arbitrary float size.
"""

import json
import os

import numpy as np
import pytest
import torch

import data_processing.label as jlabel_cli
from edgeml_tpu.dataprep import coco_label as jcoco_label
from edgeml_tpu.dataprep import labels as jlabels
from edgeml_tpu.dataprep import voc_label as jvoc_label
from edgeml_tpu_torch import dataprep as tdataprep
from edgeml_tpu_torch.cli import label as tlabel_cli
from edgeml_tpu_torch.dataprep import coco_label, voc_examples, voc_label

torch.set_num_threads(1)

VOC_XML = """<annotation>
  <size><width>{w}</width><height>{h}</height><depth>3</depth></size>
{objects}</annotation>"""
VOC_OBJ = """  <object><name>{name}</name><difficult>{difficult}</difficult>
    <bndbox><xmin>{x0}</xmin><xmax>{x1}</xmax><ymin>{y0}</ymin><ymax>{y1}</ymax></bndbox>
  </object>
"""


def write_coco(root, seed=0, n_img=6, splits=("val",)):
    """test_dataprep.py's COCO tree (two images, unsorted category ids, an
    image with no annotation) plus seeded images with float boxes."""
    rng = np.random.default_rng(seed)
    (root / "annotations").mkdir(parents=True)
    for split in splits:
        images = [
            {"id": 7, "file_name": "000001.jpg", "width": 200, "height": 100},
            {"id": 9, "file_name": "000002.jpg", "width": 100, "height": 100},
        ]
        anns = [
            {"image_id": 7, "category_id": 5, "bbox": [20, 10, 40, 30]},
            {"image_id": 7, "category_id": 2, "bbox": [0, 0, 10, 10]},
        ]
        cats = [5, 2, 11, 90, 3]
        for i in range(n_img):
            w, h = int(rng.integers(100, 641)), int(rng.integers(100, 641))
            images.append({"id": 100 + i, "file_name": f"{i:012d}.jpg",
                           "width": w, "height": h})
            for _ in range(int(rng.integers(0, 5))):
                bw, bh = rng.uniform(1, w / 2), rng.uniform(1, h / 2)
                anns.append({
                    "image_id": 100 + i,
                    "category_id": int(rng.choice(cats)),
                    "bbox": [round(float(rng.uniform(0, w - bw)), 2),
                             round(float(rng.uniform(0, h - bh)), 2),
                             round(float(bw), 2), round(float(bh), 2)]})
        anno = {"images": images,
                "categories": [{"id": c, "name": str(c)} for c in cats],
                "annotations": anns}
        with open(root / "annotations" / f"instances_{split}2017.json",
                  "w") as f:
            json.dump(anno, f)
    return root


def write_voc(root, seed=0, n_img=5, splits=(("2007", "val"),)):
    """test_dataprep.py's VOC image (a difficult object and an unknown class
    skipped) plus seeded images with fractional corners."""
    rng = np.random.default_rng(seed)
    for year, image_set in splits:
        devkit = root / "VOCdevkit" / f"VOC{year}"
        (devkit / "ImageSets" / "Main").mkdir(parents=True, exist_ok=True)
        (devkit / "Annotations").mkdir(parents=True, exist_ok=True)
        ids = [f"{year}42"]
        objs = [dict(name="dog", difficult=0, x0=20, x1=60, y0=10, y1=40),
                dict(name="cat", difficult=1, x0=0, x1=10, y0=0, y1=10),
                dict(name="unicorn", difficult=0, x0=0, x1=10, y0=0, y1=10)]
        xmls = [VOC_XML.format(w=200, h=100, objects="".join(
            VOC_OBJ.format(**o) for o in objs))]
        for i in range(n_img):
            w, h = int(rng.integers(100, 501)), int(rng.integers(100, 501))
            objs = []
            for _ in range(int(rng.integers(0, 4))):
                x0, y0 = rng.uniform(1, w / 2), rng.uniform(1, h / 2)
                objs.append(dict(
                    name=str(rng.choice(tdataprep.VOC_CLASS_NAMES)),
                    difficult=int(rng.random() < 0.2),
                    x0=round(x0, 1), y0=round(y0, 1),
                    x1=round(x0 + rng.uniform(1, w / 2), 1),
                    y1=round(y0 + rng.uniform(1, h / 2), 1)))
            ids.append(f"{year}_{i:06d}")
            xmls.append(VOC_XML.format(w=w, h=h, objects="".join(
                VOC_OBJ.format(**o) for o in objs)))
        (devkit / "ImageSets" / "Main" / f"{image_set}.txt").write_text(
            "\n".join(ids) + "\n")
        for img_id, xml in zip(ids, xmls):
            (devkit / "Annotations" / f"{img_id}.xml").write_text(xml)
    return root


def tree_bytes(root):
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_constants_equal_jax():
    assert tdataprep.VOC_CLASS_NAMES == jlabels.VOC_CLASS_NAMES
    assert tdataprep.COCO_SPLITS == jlabels.COCO_SPLITS
    assert tdataprep.VOC_SPLITS == jlabels.VOC_SPLITS


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_label_byte_identical(tmp_path, seed):
    data = write_coco(tmp_path / "coco", seed)
    coco_label(str(data), str(tmp_path / "ours"), splits=(("2017", "val"),))
    jcoco_label(str(data), str(tmp_path / "theirs"),
                splits=(("2017", "val"),))
    ours, theirs = tree_bytes(tmp_path / "ours"), tree_bytes(
        tmp_path / "theirs")
    assert ours == theirs and len(ours) == 8
    # category 5 is index 2 of the sorted ids [2, 3, 5, 11, 90]
    rows = ours[os.path.join("val2017", "000001.txt")].decode().splitlines()
    assert rows[0].split()[0] == "2" and len(rows) == 2
    assert ours[os.path.join("val2017", "000002.txt")] == b""


@pytest.mark.parametrize("seed", [0, 1])
def test_voc_label_byte_identical(tmp_path, seed):
    data = write_voc(tmp_path / "voc", seed,
                     splits=(("2007", "val"), ("2012", "train")))
    splits = (("2007", "val"), ("2012", "train"))
    voc_label(str(data), str(tmp_path / "ours"), splits=splits)
    jvoc_label(str(data), str(tmp_path / "theirs"), splits=splits)
    ours, theirs = tree_bytes(tmp_path / "ours"), tree_bytes(
        tmp_path / "theirs")
    assert ours == theirs and len(ours) == 12
    rows = ours[os.path.join("val2007", "200742.txt")].decode().splitlines()
    assert len(rows) == 1 and rows[0].split()[0] == "11"  # 'dog'


@pytest.mark.parametrize("dataset", ["coco", "voc"])
def test_label_cli_byte_identical(tmp_path, dataset, monkeypatch):
    """Both CLIs at their default splits (COCO train/val 2017, the five VOC
    splits), from the same tree."""
    if dataset == "coco":
        data = write_coco(tmp_path / "data", 3, splits=("train", "val"))
    else:
        data = write_voc(tmp_path / "data", 3, n_img=2,
                         splits=jlabels.VOC_SPLITS)
    tlabel_cli.main(tlabel_cli.getargs(
        [str(data), str(tmp_path / "ours"), "--dataset", dataset]))
    monkeypatch.setattr("sys.argv", ["label.py", str(data),
                                     str(tmp_path / "theirs"), "--dataset",
                                     dataset])
    jlabel_cli.main(jlabel_cli.getargs())
    ours, theirs = tree_bytes(tmp_path / "ours"), tree_bytes(
        tmp_path / "theirs")
    assert ours == theirs
    assert len(ours) == (16 if dataset == "coco" else 15)


def test_label_cli_arguments_are_the_jax_cli(monkeypatch):
    monkeypatch.setattr("sys.argv", ["label.py", "d", "s"])
    theirs = vars(jlabel_cli.getargs())
    assert vars(tlabel_cli.getargs(["d", "s"])) == theirs
    assert theirs == {"data_dir": "d", "save_dir": "s", "dataset": "coco"}


def test_voc_examples_equal_jax(tmp_path):
    splits = (("2007", "val"), ("2012", "train"))
    data = write_voc(tmp_path / "voc", 4, splits=splits)
    for root in (str(data), str(data / "VOCdevkit")):
        paths, labels = voc_examples(root, splits=splits)
        jpaths, jlabs = jlabels.voc_examples(root, splits=splits)
        assert paths == jpaths and len(paths) == 12
        for (c, b), (jc, jb) in zip(labels, jlabs):
            assert c.dtype == jc.dtype == np.float32
            assert b.dtype == jb.dtype and b.shape == jb.shape
            np.testing.assert_array_equal(c, jc)
            np.testing.assert_array_equal(b, jb)
    assert any(len(c) == 0 for c, _ in labels)  # an image with no object
