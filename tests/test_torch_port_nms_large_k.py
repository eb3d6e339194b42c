"""The suppressors above the kernels' candidate counts, on the CPU.

``nms_split_batch`` and ``nms_rows`` at max_cand 4096 (K > 2048) take the
plain global fixpoint, chosen by K in the dispatcher as the reference
chooses its XLA fixpoint; their dets are held bit for bit against the JAX
package's, and the route's counter must move. The sequential suppressor's
plain loop at K = 1100 (above the cluster kernel's 1024) is held bit for bit
against the interpret-mode Pallas kernel (``nms_pallas.suppress_mask`` and
``nms_pallas.nms_pallas``). Tolerance: none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from edgeml_tpu.ops.nms import nms_rows as jax_nms_rows
from edgeml_tpu.ops.nms import nms_split_batch as jax_nms_split_batch
from edgeml_tpu.ops.nms_pallas import nms_pallas as jax_nms_pallas
from edgeml_tpu.ops.nms_pallas import suppress_mask as jax_pallas_mask
from edgeml_tpu_torch.ops import nms as tnms
from edgeml_tpu_torch.ops.nms_seq import (
    MAX_K, nms_seq, suppress_mask_seq_plain,
)

torch.set_num_threads(1)


def split_case(seed, b, n, nc):
    rng = np.random.default_rng(seed)
    obj = rng.random((b, n)).astype(np.float32)
    xywh = np.stack([rng.uniform(50, 600, (b, n)),
                     rng.uniform(50, 600, (b, n)),
                     rng.uniform(5, 80, (b, n)), rng.uniform(5, 80, (b, n))],
                    axis=-1).astype(np.float32)
    cls = (rng.random((b, n, nc)) ** 4).astype(np.float32)
    return obj, xywh, cls


def rows_case(seed, b, n):
    rng = np.random.default_rng(seed)
    c = rng.uniform(20, 500, (b, n, 2))
    wh = rng.uniform(10, 120, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.random((b, n)).astype(np.float32)
    scores[rng.random((b, n)) < 0.1] = 0.0
    cls = rng.integers(0, 6, (b, n)).astype(np.float32)
    return boxes, scores, cls


@pytest.mark.parametrize("bf16", [False, True])
def test_nms_split_batch_max_cand_4096_matches_jax(bf16):
    """K = 4096 candidates: the global fixpoint route, bit-equal to JAX."""
    obj, xywh, cls = split_case(4096 + bf16, 1, 2500, 4)
    kw = dict(conf_thres=1e-3, iou_thres=0.6, max_det=300, max_cand=4096)
    dt_j = jnp.bfloat16 if bf16 else jnp.float32
    dt_t = torch.bfloat16 if bf16 else torch.float32
    d_ref, v_ref = jax_nms_split_batch(
        jnp.asarray(obj, dt_j), jnp.asarray(xywh), jnp.asarray(cls, dt_j),
        pool=False, **kw)
    before = tnms.greedy_keep_mask_global.launches
    d, v = tnms.nms_split_batch(torch.from_numpy(obj).to(dt_t),
                                torch.from_numpy(xywh),
                                torch.from_numpy(cls).to(dt_t), **kw)
    assert tnms.greedy_keep_mask_global.launches == before + 1
    assert int(np.asarray(v_ref).sum()) > 100
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))


@pytest.mark.parametrize("max_cand", [4096, 2049])
def test_nms_rows_large_max_cand_matches_jax(max_cand):
    """nms_rows above K = 2048 takes the global fixpoint, image by image
    equal to JAX's nms_rows; at max_cand 2048 the same rows take the
    suppressor route and the global route's counter stays."""
    boxes, scores, cls = rows_case(max_cand, 2, 5000)
    tb, ts, tc = map(torch.from_numpy, (boxes, scores, cls))
    before = tnms.greedy_keep_mask_global.launches
    d, v = tnms.nms_rows(tb, ts, tc, 0.5, 300, max_cand=max_cand)
    assert tnms.greedy_keep_mask_global.launches == before + 1
    for i in range(2):
        d_ref, v_ref = jax_nms_rows(jnp.asarray(boxes[i]),
                                    jnp.asarray(scores[i]),
                                    jnp.asarray(cls[i]), 0.5, 300,
                                    max_cand=max_cand)
        np.testing.assert_array_equal(v[i].numpy(), np.asarray(v_ref))
        np.testing.assert_array_equal(d[i].numpy(), np.asarray(d_ref))
    tnms.nms_rows(tb, ts, tc, 0.5, 300, max_cand=2048)
    assert tnms.greedy_keep_mask_global.launches == before + 1


@pytest.mark.parametrize("regime", ["dense", "ties"])
@pytest.mark.parametrize("max_keep", [8, 40])
def test_seq_plain_above_cluster_k_matches_pallas(regime, max_keep):
    """K = 1100 > MAX_K: the plain loop (what the wide kernel is held to on
    the card) equals the interpret-mode Pallas kernel's mask and dets."""
    k = 1100
    assert k > MAX_K
    rng = np.random.default_rng(k + max_keep)
    c = rng.uniform(0, 150.0 if regime == "dense" else 400.0, (k, 2))
    wh = rng.uniform(8, 150, (k, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    if regime == "ties":
        scores = rng.choice([1.0, 1.0, 0.9, 0.5, 0.0], k).astype(np.float32)
    else:
        scores = rng.random(k).astype(np.float32)
        scores[rng.random(k) < 0.2] = 0.0
    want = np.asarray(jax_pallas_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                      0.7, max_keep))
    kept, picks = suppress_mask_seq_plain(torch.from_numpy(boxes)[None],
                                          torch.from_numpy(scores)[None],
                                          0.7, max_keep)
    np.testing.assert_array_equal(kept[0].numpy(), want)
    assert int((picks >= 0).sum()) == min(max_keep, int(want.sum()))
    cls = rng.integers(0, 3, k).astype(np.float32)
    d_ref, v_ref = jax_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores),
                                  jnp.asarray(cls), 0.6, max_keep)
    d, v = nms_seq(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(cls), 0.6, max_keep)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
