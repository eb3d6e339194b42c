"""SSDLite int8 serving end to end against the JAX package:
``run_detection(dtype="int8")`` on the CPU, 5 ragged images, batch 2, 64 px,
8 classes (background included), the carried net of
``test_torch_port_quant_ssd.py``. The comparisons and their tolerances are
``test_torch_port_detect_int8.py``'s: the JAX package's tree served by the
port gives the JAX package's rows (conf 1e-5, boxes 1e-4); the port's own
run_detection meets the files' contract and pairs with the JAX package's
rows. SSDLite's int8 logits are f32, so there is no bf16 variant.
"""

import os

import numpy as np
import torch

import jax.numpy as jnp

from edgeml_tpu.models.infer import run_detection as jax_run_detection
from edgeml_tpu.models.quant_ssd import prepare_int8_ssd as jax_prepare_ssd
from edgeml_tpu_torch.models.infer import (
    _detect_generic, run_detection, square_batch,
)
from edgeml_tpu_torch.models.quant_ssd import from_jax_q8_ssd

from test_torch_port_detect import ragged_images
from test_torch_port_detect_int8 import (
    BATCH, UNPAIRED, _calibration_images, _numpy_tree, _write_images,
    assert_same_rows, check_contract, pair_files, serve_batches,
)
from test_torch_port_quant_ssd import carried_ssd

torch.set_num_threads(1)


def test_ssd_run_detection_int8_matches_jax(tmp_path):
    imgs = ragged_images(4)
    img_dir = _write_images(tmp_path, imgs)
    x = square_batch(imgs, 64)
    jnet, params, stats, net = carried_ssd(11, x)
    calib = square_batch(_calibration_images(img_dir), 64)
    tree = from_jax_q8_ssd(_numpy_tree(jax_prepare_ssd(
        jnet, params, stats, lambda i: jnp.asarray(calib), iters=1).tree))
    kw = dict(batch_size=BATCH, conf_thres=0.05, iou_thres=0.5,
              dtype="int8")
    jax_run_detection(jnet, params, stats, str(img_dir),
                      str(tmp_path / "jax"), **kw)
    run_detection(net, str(img_dir), str(tmp_path / "port"), device="cpu",
                  **kw)
    carried_rows = serve_batches(img_dir, lambda im: _detect_generic(
        net, torch.from_numpy(square_batch(im, 64)), 0.05, 0.5, q8=tree))
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax")) == sorted(carried_rows)
    rows = unpaired = 0
    for name in sorted(os.listdir(img_dir)):
        want = np.load(tmp_path / "jax" / name)
        got = np.load(tmp_path / "port" / name)
        check_contract(got, 8)
        assert_same_rows(carried_rows[name], want, 1e-5)
        rows += len(want)
        unpaired += pair_files(want, got)
    assert rows > 30
    assert unpaired <= UNPAIRED * rows, f"{unpaired} of {rows} rows unpaired"
