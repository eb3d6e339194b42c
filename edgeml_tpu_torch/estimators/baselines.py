"""Baseline offloading predictors, Adaptive Feeding and DCSB (the port of the
JAX package's ``estimators/baselines.py``).

  * ``fit_af``: a linear SVM on the stage-24 output features against the
    binarised reward, the positive class weighted: the squared-hinge primal
    (L2, C = 1) minimised by full-batch Adam (2000 steps, lr 0.05).
  * ``fit_dcsb``: a confidence threshold calibrated by bisection (in Python
    doubles) until the expected object count matches the ground truth, then
    the best (count, minimum-area) thresholds on a 10 x 70 grid, with the
    JAX package's tie rules. Thresholds compare in f32, as JAX's weakly
    typed scalars do; the grid's area values are the JAX package's f32
    ``arange(0.2, 0.9, 0.01)``.

Both return {train_est, val_est, train_time, val_time} and write
``wts{k}.pickle`` in the JAX package's formats (AF: {'w', 'b'}; DCSB: the
three-scalar tuple).
"""

from __future__ import annotations

import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from .common import SaveOpt, Adam, estimator_device, f32, scalar

# jnp.arange(0.2, 0.9, 0.01) in f32: numpy's arange computed in f32
A_GRID = np.arange(0.2, 0.9, 0.01, dtype=np.float32)
N_GRID = np.arange(1, 11)


def svc_fit(x: torch.Tensor, t: torch.Tensor, cw: torch.Tensor, C: float,
            lr: float, steps: int):
    """min 0.5 |w|^2 + C sum_i cw_i max(0, 1 - t_i (x_i w + b))^2 by Adam
    from 0: (w, b)."""
    w = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    b = torch.zeros((), dtype=x.dtype, device=x.device)
    opt = Adam([w, b], lr)
    for _ in range(steps):
        margin = torch.clamp_min(1.0 - t * (x @ w + b), 0.0)
        d = -2.0 * C * cw * margin * t  # d loss / d (x w + b)
        opt.step([w + x.T @ d, d.sum()])
    return w, b


def _wts_path(save_opts: SaveOpt):
    return (os.path.join(save_opts.model_dir, f"wts{save_opts.model_idx}.pickle")
            if save_opts.model_dir else None)


def _save(save_opts: SaveOpt, path, obj):
    if save_opts.save and path:
        Path(save_opts.model_dir).mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(obj, f)


def fit_af(data, weight: float = 3.0, save_opts: SaveOpt | None = None,
           device=None):
    """Adaptive Feeding binary offloading classifier."""
    save_opts = save_opts or SaveOpt()
    dev = estimator_device(device)
    train_feature, val_feature, train_reward, val_reward = data
    x_train = np.stack([np.asarray(f, np.float64).reshape(-1) for f in train_feature])
    x_val = np.stack([np.asarray(f, np.float64).reshape(-1) for f in val_feature])
    y_train = np.asarray(train_reward).astype(int)

    wts_path = _wts_path(save_opts)
    if save_opts.load and wts_path:
        with open(wts_path, "rb") as f:
            state = pickle.load(f)
    else:
        t = f32(np.where(y_train > 0, 1.0, -1.0), dev)
        cw = f32(np.where(y_train > 0, weight, 1.0), dev)
        w, b = svc_fit(f32(x_train, dev), t, cw, 1.0, 0.05, 2000)
        state = {"w": w.cpu().numpy(), "b": float(b)}

    w = f32(state["w"], dev)
    b = scalar(float(np.float32(state["b"])), w)

    def decide(x):
        return (x @ w + b > 0).to(torch.int32).cpu().numpy()

    t1 = time.perf_counter()
    train_est = decide(f32(x_train, dev))
    t2 = time.perf_counter()
    val_est = decide(f32(x_val, dev))
    t3 = time.perf_counter()

    train_acc = float(np.mean(train_est == y_train))
    val_acc = float(np.mean(val_est == np.asarray(val_reward).astype(int)))
    print(
        f"Trained Adaptive Feeding SVM with training accuracy: {train_acc:.3f}, "
        f"validation accuracy: {val_acc:.3f}"
    )
    _save(save_opts, wts_path, state)
    return {
        "train_est": train_est,
        "val_est": val_est,
        "train_time": (t2 - t1) / max(len(train_est), 1),
        "val_time": (t3 - t2) / max(len(val_est), 1),
    }


def pad_boxes(feature, device):
    """Per-image (conf, area) pairs -> padded (N, D) f32 tensors (conf -inf
    and area 0 in the padding)."""
    n = len(feature)
    d = max([len(f[0]) for f in feature] + [1])
    conf = np.full((n, d), -np.inf, np.float32)
    area = np.zeros((n, d), np.float32)
    for i, (c, a) in enumerate(feature):
        k = len(c)
        if k:
            conf[i, :k] = c
            area[i, :k] = a
    return torch.from_numpy(conf).to(device), torch.from_numpy(area).to(device)


def filter_box(conf: torch.Tensor, area: torch.Tensor, thresh: float):
    """Boxes per image with conf > thresh (compared in f32) and the smallest
    such box's area (0 when none)."""
    mask = conf > scalar(thresh, conf)
    num = mask.sum(dim=1)
    amin = torch.where(mask, area, torch.inf).amin(dim=1)
    return num, torch.where(num > 0, amin, 0.0)


def dcsb_predict(conf, area, conf_thresh, num_thresh, area_thresh) -> np.ndarray:
    est_num, est_area = filter_box(conf, area, conf_thresh)
    det_num, _ = filter_box(conf, area, 0.5)
    offload = (est_num != det_num) & (
        (est_num > num_thresh) | (est_area < scalar(area_thresh, est_area)))
    return offload.cpu().numpy().astype(int)


def dcsb_thresholds(conf, area, total_gt: float, y: np.ndarray):
    """(conf_thresh, num_thresh, area_thresh) of DCSB on one training set."""
    lo, hi = 0.0, 1.0
    conf_thresh = 0.5
    for _ in range(64):
        conf_thresh = (lo + hi) / 2
        num, _ = filter_box(conf, area, conf_thresh)
        diff = float(num.sum()) - total_gt
        if abs(diff) / max(total_gt, 1e-12) < 1e-4:
            break
        if diff >= 0:
            lo = conf_thresh
        else:
            hi = conf_thresh

    est_num, est_area = filter_box(conf, area, conf_thresh)
    det_num, _ = filter_box(conf, area, 0.5)
    differs = est_num != det_num
    yt = torch.as_tensor(np.asarray(y).astype(np.int64), device=conf.device)
    n_grid = torch.as_tensor(N_GRID, device=conf.device)
    a_grid = torch.as_tensor(A_GRID, device=conf.device)
    # (num, area, image) predictions; accuracy = mean of a 0/1 vector in f32
    pred = differs[None, None, :] & (
        (est_num[None, None, :] > n_grid[:, None, None])
        | (est_area[None, None, :] < a_grid[None, :, None]))
    hits = (pred.to(torch.int64) == yt).to(torch.float32).sum(dim=2)
    acc = (hits / scalar(float(len(y)), hits)).cpu().numpy()
    # the JAX package's scan order: a smaller num_thresh wins ties (strict
    # improvement per n); within a row the first best area
    best_per_n = acc.max(axis=1)
    best_n_idx = 0
    for i in range(1, len(N_GRID)):
        if best_per_n[i] > best_per_n[best_n_idx]:
            best_n_idx = i
    return (conf_thresh, int(N_GRID[best_n_idx]),
            float(A_GRID[int(np.argmax(acc[best_n_idx]))]))


def fit_dcsb(data, train_label, save_opts: SaveOpt | None = None, device=None):
    """DCSB threshold model."""
    save_opts = save_opts or SaveOpt()
    dev = estimator_device(device)
    train_feature, val_feature, train_reward, val_reward = data
    tr_conf, tr_area = pad_boxes(train_feature, dev)
    va_conf, va_area = pad_boxes(val_feature, dev)

    wts_path = _wts_path(save_opts)
    if save_opts.load and wts_path:
        with open(wts_path, "rb") as f:
            conf_thresh, num_thresh, area_thresh = pickle.load(f)
    else:
        conf_thresh, num_thresh, area_thresh = dcsb_thresholds(
            tr_conf, tr_area, float(np.sum(train_label)), train_reward)

    t1 = time.perf_counter()
    train_est = dcsb_predict(tr_conf, tr_area, conf_thresh, num_thresh, area_thresh)
    t2 = time.perf_counter()
    val_est = dcsb_predict(va_conf, va_area, conf_thresh, num_thresh, area_thresh)
    t3 = time.perf_counter()

    train_acc = float(np.mean(train_est == np.asarray(train_reward).astype(int)))
    val_acc = float(np.mean(val_est == np.asarray(val_reward).astype(int)))
    print(
        f"Computed DCSB thresholds with training accuracy: {train_acc:.3f}, "
        f"validation accuracy: {val_acc:.3f}"
    )
    _save(save_opts, wts_path, (conf_thresh, num_thresh, area_thresh))
    return {
        "train_est": train_est,
        "val_est": val_est,
        "train_time": (t2 - t1) / max(len(train_est), 1),
        "val_time": (t3 - t2) / max(len(val_est), 1),
    }
