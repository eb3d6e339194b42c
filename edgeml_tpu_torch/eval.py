"""Offloading-policy evaluation: realized mAP against offloading ratio.

The port of the JAX package's ``eval.py``. Each estimate directory's 11
offload masks (one per ratio) are evaluated by one batched ``dataset_map``
over the shared DetectionPool on the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .device import resolve_device
from .ops.map_kernel import DetectionPool, build_pool, dataset_map

# The offloading ratios to evaluate.
OFFLOADING_RATIOS = np.arange(0, 1.01, 0.1)


def offload_masks_for_estimates(estimate_path: str, dataset_split: np.ndarray,
                                ratios=OFFLOADING_RATIOS) -> np.ndarray:
    """Per-ratio offload masks (R, N) from the per-fold ``estimate{k}.npz``
    files of one directory.

    The threshold of ratio r is the train estimate at descending rank
    floor((n_train - 1) * r); a validation image offloads when its estimate
    is strictly greater.
    """
    n_img = dataset_split.shape[1]
    masks = np.zeros((len(ratios), n_img), dtype=bool)
    for cv_idx, val_mask in enumerate(dataset_split):
        data = np.load(os.path.join(estimate_path,
                                    f"estimate{cv_idx + 1}.npz"))
        train_est, val_est = data["train_est"], data["val_est"]
        desc = np.sort(train_est)[::-1]
        for ri, ratio in enumerate(ratios):
            thresh = desc[int((len(train_est) - 1) * ratio)]
            masks[ri, val_mask] = val_est > thresh
    return masks


def test_map(weak_data, strong_data, labels, reward_estimates, dataset_split,
             pool: DetectionPool | None = None, device=None) -> np.ndarray:
    """Realized mAP of each estimate directory at each offloading ratio:
    (n_estimates, 11), the content of ``test_map.npy``.

    :param pool: a pool already built from these triples (its device is
        used); else one is built on ``device`` (the CUDA device unless
        "cpu" is asked for).
    """
    if pool is None:
        pool = build_pool(weak_data, strong_data, labels,
                          device=resolve_device(device))
    results = []
    for estimate_path in reward_estimates:
        masks = offload_masks_for_estimates(estimate_path, dataset_split)
        maps = dataset_map(pool, torch.from_numpy(masks).to(pool.device))
        results.append(maps.cpu().numpy())
    return np.array(results)
