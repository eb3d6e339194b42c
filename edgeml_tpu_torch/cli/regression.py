"""Train a regression model mapping weak-detector features to offloading
reward, fold by fold.

    python -m edgeml_tpu_torch.cli.regression DATA_DIR REWARD SPLIT SAVE_DIR --model LR

The same positional arguments and flags as the JAX package's
``regression.py``, plus ``--device`` (default ``cuda``). Writes
``estimate{k}.npz`` per fold ({SAVE_DIR}_best and _last for the CNN) and,
with ``--model-dir``, ``wts{k}.pickle`` (``wts{k}.npz`` under _best / _last
for the CNN). A hidden ``--stage`` (0-23) takes the CNN only: with
``--resize 0`` its raw maps of varying shape, one image a batch and no
BatchNorm; with ``--resize P`` its maps RoI-pooled to (P, P) on the device
(``load_feature(pool=True)``), at the CNN's default batch with BatchNorm.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.io import load_feature
from ..estimators import MODEL_FITTERS, MODEL_NAMES, CNNOpt, SaveOpt, fit_CNN
from ..estimators.common import estimator_device
from ..utils.paths import parse_path, save_result


def rank_normalize(train_reward: np.ndarray, val_reward: np.ndarray):
    """Validation rewards map to their empirical-CDF position against the
    train set; train rewards map to rank / N."""
    val = np.array(
        [np.sum(train_reward <= x) / len(train_reward) for x in val_reward]
    )
    train = (np.argsort(np.argsort(train_reward)) + 1) / len(train_reward)
    return train, val


def main(opts):
    dev = estimator_device(opts.device)
    ifpool = opts.resize > 0 and opts.stage != 24
    feature_data = load_feature(opts.data_dir, opts.stage, pool=ifpool,
                                size=opts.resize, device=dev)
    reward_data = np.load(opts.reward_path)["reward"]
    assert len(feature_data) == len(reward_data), \
        "Inconsistent number of feature maps and offloading rewards."
    data_split = np.load(opts.split_path)
    assert len(reward_data) == data_split.shape[1], \
        "Inconsistent number of data points from the dataset and the split."

    try:
        model = MODEL_FITTERS[MODEL_NAMES.index(opts.model)]
    except ValueError:
        raise SystemExit(
            "Please select a regression model from "
            + ", ".join(f"'{n}'" for n in MODEL_NAMES)
        )

    cnn_opts = CNNOpt()
    if opts.stage != 24:
        assert opts.model == "CNN", \
            "Only fully convolutional NN can take feature maps from hidden layers as inputs."
        if opts.resize == 0:
            # raw hidden maps: per-image batches of varying shape, no
            # BatchNorm
            cnn_opts.resize = False
            cnn_opts.batch_size = 1
    if opts.model == "CNN":
        cnn_opts.weight = opts.weight and opts.normalize
        if opts.stage != 24 and not cnn_opts.channels:
            # fully convolutional default for hidden-stage features, the
            # input channel count taken from the data
            cin = np.asarray(feature_data[0]).shape[0]
            cnn_opts.channels = [cin, 16, 16, 16, 16, 1][:6]
            cnn_opts.linear = []

    save_opts = SaveOpt(model_dir=opts.model_dir)
    save_best_dir, save_last_dir = parse_path(opts.save_dir)
    for cv_idx, val_mask in enumerate(data_split):
        train_feature = [f for f, v in zip(feature_data, val_mask) if not v]
        val_feature = [f for f, v in zip(feature_data, val_mask) if v]
        train_reward = reward_data[np.logical_not(val_mask)]
        val_reward = reward_data[val_mask]
        if opts.normalize:
            train_reward, val_reward = rank_normalize(train_reward, val_reward)
        print(
            f"==============================Cross Validation Fold {cv_idx + 1}"
            "=============================="
        )
        save_opts.model_idx = cv_idx + 1
        data = (train_feature, val_feature, train_reward, val_reward)
        if opts.model == "CNN":
            best, last = fit_CNN(data, cnn_opts, save_opts, device=dev)
            save_result(save_best_dir, best, cv_idx)
            save_result(save_last_dir, last, cv_idx)
        else:
            result = model(data, save_opts=save_opts, device=dev)
            save_result(opts.save_dir, result, cv_idx)


def getargs(argv=None):
    """Parse command line arguments."""
    args = argparse.ArgumentParser()
    args.add_argument('data_dir', help="Feature-map tree ({img}/stage{S}_..._features.npy).")
    args.add_argument('reward_path', help="Reward .npz produced by reward.py.")
    args.add_argument('split_path', help="Cross-validation split .npy.")
    args.add_argument('save_dir', help="Output directory for estimate{k}.npz files.")
    args.add_argument('--normalize', action='store_true',
                      help="Rank-normalize rewards to a uniform distribution before fitting.")
    args.add_argument('--weight', action='store_true',
                      help="Reward-weighted MSE during CNN training (requires --normalize).")
    args.add_argument('--stage', type=int, default=24,
                      help="Feature stage: 0-23 = hidden-layer feature maps, 24 = detection-output features.")
    args.add_argument('--resize', type=int, default=0,
                      help="ROI-pool hidden feature maps to this square size (0 = keep raw shapes).")
    args.add_argument('--model', type=str, default='CNN',
                      help="Estimator family: LR, EN, BR, SGD, SVR, LSVR, RFR, GBR, KNR, or CNN.")
    args.add_argument('--model-dir', type=str, default='',
                      help="Where to save/load per-fold model weights (wts{k} files).")
    args.add_argument('--device', type=str, default="cuda",
                      help="'cuda' (default) or 'cpu'.")
    return args.parse_args(argv)


if __name__ == '__main__':
    main(getargs())
