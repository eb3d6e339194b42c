"""Baseline offloading methods: Adaptive Feeding SVM and DCSB thresholds.

    python -m edgeml_tpu_torch.cli.baseline DATA_DIR REWARD SPLIT SAVE_DIR --baseline af

The same positional arguments and flags as the JAX package's
``baseline.py``, plus ``--device`` (default ``cuda``). Rewards are binarised
(> 0 offloads). Writes ``estimate{k}.npz`` per fold (under
``{SAVE_DIR}/{positive_weight}`` for AF) and, with ``--model_dir``,
``wts{k}.pickle`` (AF under ``{model_dir}/{positive_weight}``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.io import list_image_names, load_data, load_feature
from ..device import resolve_device
from ..estimators import SaveOpt, fit_af, fit_dcsb
from ..utils.paths import save_result


def get_area(bbox_coord):
    """Areas of xyxy boxes."""
    return (bbox_coord[:, 2] - bbox_coord[:, 0]) * (bbox_coord[:, 3] - bbox_coord[:, 1])


def main(opts):
    dev = resolve_device(opts.device)
    reward_data = np.load(opts.reward_path)["reward"]
    # both baselines are binary offload classifiers
    reward_data = np.where(reward_data > 0, 1, 0)
    data_split = np.load(opts.split_path)
    assert len(reward_data) == data_split.shape[1], \
        "Inconsistent number of data points from the dataset and the split."

    save_opts = SaveOpt()
    if opts.baseline == "af":
        feature_data = load_feature(opts.data_dir, 24, pool=False)
        save_opts.model_dir = (
            os.path.join(opts.model_dir, f"{opts.positive_weight}")
            if opts.model_dir
            else ""
        )
        label_num = None
    else:
        img_names = list_image_names(opts.label_dir)
        weak_data = load_data(opts.data_dir, img_names, True)
        feature_data = [
            (np.array([]), np.array([])) if len(wd) == 0 else (wd[2], get_area(wd[1]))
            for wd in weak_data
        ]
        labels = load_data(opts.label_dir, img_names)
        label_num = np.array(
            [0 if len(l) == 0 else len(l[0]) for l in labels], dtype=int
        )
        save_opts.model_dir = opts.model_dir
    assert len(feature_data) == len(reward_data), \
        "Inconsistent number of feature maps and offloading rewards."

    for cv_idx, val_mask in enumerate(data_split):
        train_feature = [f for f, v in zip(feature_data, val_mask) if not v]
        val_feature = [f for f, v in zip(feature_data, val_mask) if v]
        train_reward = reward_data[np.logical_not(val_mask)]
        val_reward = reward_data[val_mask]
        print(
            f"==============================Cross Validation Fold {cv_idx + 1}"
            "=============================="
        )
        save_opts.model_idx = cv_idx + 1
        data = (train_feature, val_feature, train_reward, val_reward)
        if opts.baseline == "af":
            result = fit_af(data, opts.positive_weight, save_opts, device=dev)
            save_result(os.path.join(opts.save_dir, f"{opts.positive_weight}"),
                        result, cv_idx)
        else:
            train_label = label_num[np.logical_not(val_mask)]
            result = fit_dcsb(data, train_label, save_opts, device=dev)
            save_result(opts.save_dir, result, cv_idx)


def getargs(argv=None):
    """Parse command line arguments."""
    args = argparse.ArgumentParser()
    args.add_argument('data_dir',
                      help="Inputs for the chosen baseline: the stage-24 feature tree for 'af', "
                           "the weak detector's raw detection files for 'dcsb'.")
    args.add_argument('reward_path', help="Reward .npz produced by reward.py.")
    args.add_argument('split_path', help="Cross-validation split .npy.")
    args.add_argument('save_dir', help="Output directory for estimate{k}.npz files.")
    args.add_argument('--baseline', type=str, default="af", choices=['af', 'dcsb'],
                      help="Baseline method: Adaptive Feeding SVM or DCSB thresholds.")
    args.add_argument('--positive_weight', type=float, default=3.0,
                      help="Class weight of the offload-positive class ('af' only).")
    args.add_argument('--label_dir', type=str, default='',
                      help="Ground-truth label files, needed for 'dcsb' calibration.")
    args.add_argument('--model_dir', type=str, default='',
                      help="Where to save/load per-fold wts{k}.pickle files.")
    args.add_argument('--device', type=str, default="cuda",
                      help="'cuda' (default) or 'cpu'.")
    return args.parse_args(argv)


if __name__ == '__main__':
    main(getargs())
