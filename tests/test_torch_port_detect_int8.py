"""int8 serving end to end against the JAX package: ``run_detection`` with
``dtype="int8"`` and ``"int8-bf16"`` (YOLOv5n here, SSDLite's ``"int8"`` in
``test_torch_port_detect_int8_ssd.py``) on the CPU, 5 ragged images, batch
2, 64 px, 8 classes.

Each package calibrates on the first images of the directory itself, so
their quantized trees differ by what their f32 calibration passes do (scales
1e-5 apart, a few int8 weights one step apart: test_torch_port_quant.py).
Two comparisons follow from that:

  * The JAX package's tree (its prepare on the same calibration batch its
    run_detection takes), carried into the port and served batch by batch
    through the port's ``detect_batch`` / ``_detect_generic``: the same rows
    as the JAX package's files (rows of equal conf in either order),
    classes equal, conf within 1e-5 and xywh within 1e-4. The trunks agree
    bit for bit on the int8 maps; only the f32 sigmoids and softmax round
    an ulp apart. With bf16 scores conf is the bf16 product of two bf16
    sigmoids, each of which may round one ulp apart: within three bf16 ulps
    of a value in [0.5, 1) (3 * 2^-8).
  * The port's own ``run_detection``: the files' contract of
    tests/test_quant.py (finite rows of 6, conf in (0, 1], classes in
    range), and its rows paired one to one with the JAX package's by class
    and box (within 0.05 of the image, conf within 0.02), at most one row
    in ten unpaired: scales 1e-5 apart move int8 scores by ~1e-3 and
    reorder near-equal candidates.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from edgeml_tpu.data.loader import decode_image as jax_decode_image
from edgeml_tpu.models.common import letterbox_batch as jax_letterbox
from edgeml_tpu.models.infer import run_detection as jax_run_detection
from edgeml_tpu.models.quant import prepare_int8 as jax_prepare_int8
from edgeml_tpu_torch.models.common import letterbox_batch
from edgeml_tpu_torch.models.infer import detect_batch, run_detection
from edgeml_tpu_torch.models.quant import from_jax_q8

from test_torch_port_detect import ragged_images
from test_torch_port_yolov5 import carried

torch.set_num_threads(1)

BATCH = 2
BF16_CONF_TOL = 3 * 2.0 ** -8
PAIR_BOX = 0.05
PAIR_CONF = 0.02
UNPAIRED = 0.1


def _numpy_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _write_images(root, imgs):
    img_dir = root / "imgs"
    img_dir.mkdir()
    for i, im in enumerate(imgs):
        np.save(img_dir / f"im{i}.npy", im)
    return img_dir


def _calibration_images(img_dir):
    names = sorted(os.listdir(img_dir))[:BATCH]
    return [jax_decode_image(str(img_dir / n)) for n in names]


def check_contract(rows, nc):
    assert rows.ndim == 2 and rows.shape[1] == 6 and rows.dtype == np.float32
    assert np.isfinite(rows).all()
    assert ((rows[:, 5] > 0) & (rows[:, 5] <= 1)).all()
    assert ((rows[:, 0] >= 0) & (rows[:, 0] < nc)).all()


def pair_files(a, b, box_tol=PAIR_BOX, conf_tol=PAIR_CONF):
    """Rows of b paired one to one with the rows of a: each row of a takes
    the free row of b of its class with box within box_tol and conf within
    conf_tol that is nearest in both (many rows share a box, such as the
    whole image). Returns the count of rows left unpaired in either file."""
    free = np.ones(len(b), bool)
    pairs = 0
    for row in a:
        box = np.abs(b[:, 1:5] - row[1:5]).max(axis=1)
        conf = np.abs(b[:, 5] - row[5])
        cand = np.nonzero(free & (b[:, 0] == row[0]) & (box <= box_tol)
                          & (conf <= conf_tol))[0]
        if cand.size:
            j = cand[np.argmin(box[cand] / box_tol + conf[cand] / conf_tol)]
            free[j] = False
            pairs += 1
    return len(a) + len(b) - 2 * pairs


def serve_batches(img_dir, serve):
    """The port's serving of img_dir in run_detection's batches (the tail
    padded with its last image): {file name: rows}."""
    names = sorted(os.listdir(img_dir))
    out = {}
    for lo in range(0, len(names), BATCH):
        chunk = names[lo:lo + BATCH]
        imgs = [jax_decode_image(str(img_dir / n)) for n in chunk]
        imgs += [imgs[-1]] * (BATCH - len(imgs))
        dets, valid = serve(imgs)
        for bi, n in enumerate(chunk):
            out[n] = dets[bi][valid[bi]].numpy()
    return out


def assert_same_rows(got, want, conf_tol):
    """The same rows: as many, each paired with one of the same class, conf
    within conf_tol and box within 1e-4. Rows of equal conf may come in
    either order (a softmax an ulp apart reorders exact ties)."""
    assert got.shape == want.shape
    assert pair_files(want, got, 1e-4, conf_tol) == 0


@pytest.fixture(scope="module")
def yolo(tmp_path_factory):
    root = tmp_path_factory.mktemp("yolo")
    imgs = ragged_images(3)
    img_dir = _write_images(root, imgs)
    lb, _ = jax_letterbox(imgs, 64)
    jnet, params, stats, net = carried(9, lb)
    calib, _ = jax_letterbox(_calibration_images(img_dir), 64)
    tree = from_jax_q8(_numpy_tree(jax_prepare_int8(
        jnet, params, stats, lambda i: jnp.asarray(calib), iters=1).tree))
    return dict(root=root, img_dir=img_dir, jnet=jnet, params=params,
                stats=stats, net=net, tree=tree)


@pytest.mark.parametrize("dtype", ["int8", "int8-bf16"])
def test_yolo_run_detection_int8_matches_jax(yolo, dtype):
    root, img_dir = yolo["root"], yolo["img_dir"]
    kw = dict(batch_size=BATCH, conf_thres=0.2, iou_thres=0.5, img_size=64,
              dtype=dtype)
    jax_run_detection(yolo["jnet"], yolo["params"], yolo["stats"],
                      str(img_dir), str(root / f"jax_{dtype}"), **kw)
    run_detection(yolo["net"], str(img_dir), str(root / f"port_{dtype}"),
                  device="cpu", **kw)
    score = torch.bfloat16 if dtype == "int8-bf16" else None

    def serve(imgs):
        lb, meta = letterbox_batch(imgs, 64)
        hw = np.array([im.shape[:2] for im in imgs], np.float32)
        return detect_batch(yolo["net"], torch.from_numpy(lb),
                            torch.from_numpy(meta), torch.from_numpy(hw),
                            0.2, 0.5, dtype=score, q8=yolo["tree"])

    carried_rows = serve_batches(img_dir, serve)
    assert sorted(os.listdir(root / f"port_{dtype}")) == \
        sorted(os.listdir(root / f"jax_{dtype}")) == sorted(carried_rows)
    rows = unpaired = 0
    for name in sorted(os.listdir(img_dir)):
        want = np.load(root / f"jax_{dtype}" / name)
        got = np.load(root / f"port_{dtype}" / name)
        check_contract(got, 8)
        assert_same_rows(carried_rows[name], want,
                         BF16_CONF_TOL if score else 1e-5)
        rows += len(want)
        unpaired += pair_files(want, got)
    assert rows > 30
    assert unpaired <= UNPAIRED * rows, f"{unpaired} of {rows} rows unpaired"

