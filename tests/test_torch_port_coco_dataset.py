"""The port's COCO dataset utilities against the JAX package's.

Tolerance: none. RLE dicts, compressed-string decodes, polygon masks,
targets, remapped annotations, the dataset builder and the rebuilt COCO
index must equal the JAX package's exactly. Cases are those of
``tests/test_coco_dataset.py`` (copied) plus seeded random masks and
polygons.
"""

import json

import numpy as np
import pytest
import torch

from edgeml_tpu.dataprep import coco_dataset as jcd
from edgeml_tpu_torch.dataprep import coco_dataset as tcd

torch.set_num_threads(1)


def assert_same(a, b):
    """Deep equality of nested dicts / lists / arrays, dtypes included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


@pytest.mark.parametrize("seed", range(4))
def test_rle_round_trip_equal(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(1, 40, 2)
    for density in (0.0, 0.3, 0.7, 1.0):
        m = rng.random((h, w)) < density
        rle = tcd.rle_encode(m)
        assert_same(rle, jcd.rle_encode(m))
        assert_same(tcd.rle_decode(rle), jcd.rle_decode(rle))
        np.testing.assert_array_equal(tcd.rle_decode(rle), m)
        assert tcd.rle_area(rle) == jcd.rle_area(rle) == int(m.sum())


def _rle_string(counts):
    """COCO's compressed RLE string of a counts list (pycocotools
    rleToString: LEB128-style base-32 with a sign bit, runs past the second
    delta-coded against the run two before)."""
    out = bytearray()
    for i, c in enumerate(counts):
        x = c - counts[i - 2] if i > 2 else c
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not ch & 0x10) or (x == -1 and ch & 0x10))
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return out.decode("ascii")


def test_compressed_rle_strings_equal():
    # test_coco_dataset.py's hand case: "1232" -> runs [1, 2, 3, 4]
    assert tcd._rle_unstring("1232") == jcd._rle_unstring("1232") == [
        1, 2, 3, 4]
    rle = {"counts": "1232", "size": [2, 5]}
    assert_same(tcd.rle_decode(rle), jcd.rle_decode(rle))
    rng = np.random.default_rng(7)
    for _ in range(20):
        h, w = rng.integers(1, 30, 2)
        m = rng.random((h, w)) < rng.random()
        counts = tcd.rle_encode(m)["counts"]
        s = _rle_string(counts)
        assert tcd._rle_unstring(s) == jcd._rle_unstring(s) == counts
        for enc in (s, s.encode("ascii")):
            rle = {"counts": enc, "size": [int(h), int(w)]}
            assert_same(tcd.rle_decode(rle), jcd.rle_decode(rle))
            assert tcd.rle_area(rle) == jcd.rle_area(rle) == int(m.sum())


def test_polygons_to_mask_equal():
    cases = [
        ([[2, 2, 6, 2, 6, 6, 2, 6]], 8, 8),  # the square
        ([[0, 0, 8, 0, 0, 8]], 8, 8),  # the triangle
        ([[0, 0, 2, 0, 2, 2, 0, 2], [5, 5, 7, 5, 7, 7, 5, 7]], 8, 8),
        ([[1, 1, 1, 4, 1, 1]], 8, 8),  # degenerate
        ([[0, 0, 5, 5]], 6, 6),  # fewer than 3 points: skipped
    ]
    rng = np.random.default_rng(3)
    for _ in range(12):  # seeded self-intersecting and spilling polygons
        h, w = (int(v) for v in rng.integers(4, 48, 2))
        polys = [list(rng.uniform(-4, max(h, w) + 4, 2 * int(rng.integers(
            3, 12)))) for _ in range(int(rng.integers(1, 3)))]
        cases.append((polys, h, w))
    for polys, h, w in cases:
        got = tcd.polygons_to_mask(polys, h, w)
        assert_same(got, jcd.polygons_to_mask(polys, h, w))
        assert_same(tcd.segmentation_to_mask(polys, h, w),
                    jcd.segmentation_to_mask(polys, h, w))
    rle = tcd.rle_encode(got)
    assert_same(tcd.segmentation_to_mask(rle, h, w),
                jcd.segmentation_to_mask(rle, h, w))


def test_convert_polys_target_equal():
    anns = [  # test_coco_dataset.py's four annotations
        {"bbox": [2, 2, 4, 4], "category_id": 3, "area": 16.0,
         "iscrowd": 0, "segmentation": [[2, 2, 6, 2, 6, 6, 2, 6]]},
        {"bbox": [0, 0, 8, 8], "category_id": 1, "area": 64.0,
         "iscrowd": 1, "segmentation": {"counts": [64], "size": [8, 8]}},
        {"bbox": [1, 1, 0, 3], "category_id": 2, "area": 0.0,
         "iscrowd": 0, "segmentation": [[1, 1, 1, 4, 1, 1]]},
        {"bbox": [6, 6, 5, 5], "category_id": 3, "area": 25.0,
         "iscrowd": 0, "segmentation": [[6, 6, 8, 6, 8, 8, 6, 8]]},
        {"bbox": [1.5, 0.25, 3.5, 2.75], "category_id": 4, "area": 9.6,
         "segmentation": tcd.rle_encode(np.eye(8, dtype=bool))},
    ]
    for with_masks in (True, False):
        got = tcd.convert_polys_target(anns, 8, 8, 42, with_masks)
        assert_same(got, jcd.convert_polys_target(anns, 8, 8, 42,
                                                  with_masks))
    assert got["labels"].tolist() == [3, 3, 4]
    empty = tcd.convert_polys_target([], 5, 7, 1)
    assert_same(empty, jcd.convert_polys_target([], 5, 7, 1))
    assert empty["masks"].shape == (0, 5, 7)


def test_filter_remap_equal():
    anns = [{"category_id": c, "id": i} for i, c in enumerate((5, 9, 5, 2))]
    for remap in (True, False):
        got = tcd.filter_remap_categories(anns, [5, 2], remap)
        assert_same(got, jcd.filter_remap_categories(anns, [5, 2], remap))
    assert [a["category_id"] for a in got] == [5, 5, 2]


@pytest.fixture()
def coco_tree(tmp_path):
    """test_coco_dataset.py's tree (image 102 unannotated) with a second
    category, a crowd region and an RLE segmentation."""
    rng = np.random.default_rng(0)
    for split in ("train2017", "val2017"):
        (tmp_path / split).mkdir()
    (tmp_path / "annotations").mkdir()
    images, annotations = [], []
    ann_id = 1
    for i in range(5):
        h, w = 16, 20
        for split in ("train2017", "val2017"):
            np.save(tmp_path / split / f"im{i}.npy",
                    rng.random((h, w, 3)).astype(np.float32))
        images.append({"id": 100 + i, "file_name": f"im{i}.npy",
                       "height": h, "width": w})
        if i == 2:
            continue
        annotations.append({
            "id": ann_id, "image_id": 100 + i, "category_id": 7,
            "bbox": [2, 2, 6, 6], "area": 36.0, "iscrowd": 0,
            "segmentation": [[2, 2, 8, 2, 8, 8, 2, 8]]})
        ann_id += 1
        if i >= 3:
            annotations.append({
                "id": ann_id, "image_id": 100 + i, "category_id": 11,
                "bbox": [1.5, 3.25, 9.5, 7.0], "area": 40.0,
                "iscrowd": int(i == 4),
                "segmentation": tcd.rle_encode(rng.random((h, w)) < 0.3)})
            ann_id += 1
    for split in ("train", "val"):
        with open(tmp_path / "annotations" / f"instances_{split}2017.json",
                  "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": [{"id": 7, "name": "thing"},
                                      {"id": 11, "name": "other"}]}, f)
    return tmp_path


@pytest.mark.parametrize("image_set", ["train", "val"])
@pytest.mark.parametrize("with_masks", [True, False])
def test_get_coco_and_index_equal(coco_tree, image_set, with_masks):
    ds, idx = tcd.get_coco(str(coco_tree), image_set, with_masks=with_masks)
    jds, jidx = jcd.get_coco(str(coco_tree), image_set,
                             with_masks=with_masks)
    assert idx == jidx
    assert idx == ([0, 1, 3, 4] if image_set == "train" else list(range(5)))
    assert ds.ids == jds.ids and len(ds) == len(jds) == 5
    for i in range(len(ds)):
        (img, t), (jimg, jt) = ds[i], jds[i]
        assert_same(img, jimg)
        assert_same(t, jt)
    assert tcd.remove_images_without_annotations(ds, [11]) == \
        jcd.remove_images_without_annotations(jds, [11]) == [3, 4]
    index = tcd.dataset_to_coco_index(ds, idx)
    jindex = jcd.dataset_to_coco_index(jds, jidx)
    assert_same(index.dataset, jindex.dataset)
    assert_same(index.anns, jindex.anns)
    assert index.get_ann_ids(103) == jindex.get_ann_ids(103)
    assert_same(index.load_anns(index.get_ann_ids(103)),
                jindex.load_anns(jindex.get_ann_ids(103)))


def test_dataset_categories_and_coco_index_lookups(coco_tree):
    path = str(coco_tree / "annotations" / "instances_val2017.json")
    ds = tcd.CocoDetectionDataset(str(coco_tree / "val2017"), path,
                                  categories=[11, 7])
    jds = jcd.CocoDetectionDataset(str(coco_tree / "val2017"), path,
                                   categories=[11, 7])
    for i in range(len(ds)):
        assert_same(ds.annotations(i), jds.annotations(i))
        assert_same(ds[i][1], jds[i][1])
    index, jindex = tcd.CocoIndex.from_file(path), jcd.CocoIndex.from_file(
        path)
    assert_same(index.imgs, jindex.imgs)
    assert_same(index.cats, jindex.cats)
    assert_same(index.img_to_anns, jindex.img_to_anns)
