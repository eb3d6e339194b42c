"""Shared estimator plumbing: the device, scaling, save/load, Adam and the
generic fit driver (the port of the JAX package's ``estimators/common.py``).

``fit_model`` flattens the features, standardises them on the host in
float64, fits, times the predictions on train and validation per image,
logs the MSE and optionally pickles ``(model_state, scaler_state)`` as
``wts{k}.pickle``. States hold numpy arrays and Python scalars in the JAX
package's layout, so a pickle written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from pathlib import Path

import numpy as np
import torch

from ..device import exact_f32_cuda, resolve_device
# A 0-dim tensor of a tensor's dtype and device: thresholds compare in that
# dtype, and a division by it is IEEE (CUDA divides a tensor by a Python
# scalar as a multiplication by its reciprocal).
from ..ops.nms import _scalar as scalar


@dataclasses.dataclass
class SaveOpt:
    """Options for loading/saving model weights."""

    model_dir: str = ""  # Directory to save the model weights.
    load: bool = False  # If model is loaded from pre-trained weights.
    save: bool = True  # If model weights need to be saved after training.
    model_idx: int = 1  # The index of model in cross validation.


def estimator_device(device=None) -> torch.device:
    """The device an estimator runs on (the CUDA device unless "cpu" is
    asked for), with TF32 off there: every f32 product of the estimators is
    full f32."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        exact_f32_cuda()
    return dev


def f32(x, device) -> torch.Tensor:
    """``x`` (numpy or tensor) as a float32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class StandardScaler:
    """Per-feature zero-mean unit-variance scaling in float64 (population
    std; a zero std scales by 1)."""

    def __init__(self, mean=None, scale=None):
        self.mean = mean
        self.scale = scale

    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, np.float64)
        self.mean = x.mean(axis=0)
        std = x.std(axis=0)
        self.scale = np.where(std == 0.0, 1.0, std)
        return self

    def transform(self, x) -> np.ndarray:
        return (np.asarray(x, np.float64) - self.mean) / self.scale

    def state(self):
        return {"mean": self.mean, "scale": self.scale}

    @classmethod
    def from_state(cls, s):
        return cls(s["mean"], s["scale"])


class Adam:
    """``optax.adam`` (and, with ``weight_decay``, the chain
    add_decayed_weights -> scale_by_adam -> scale(-lr)) over a list of
    tensors, op for op in optax's order:

        g += wd * p;  mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;
        p += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    with the bias corrections computed in f32 as optax does. Updates the
    tensors in place (they carry no autograd history).
    """

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def step(self, grads, lr: float | None = None) -> None:
        lr = self.lr if lr is None else lr
        self.count += 1
        t = np.float32(self.count)
        bc1 = np.float32(1) - np.power(np.float32(self.b1), t)
        bc2 = np.float32(1) - np.power(np.float32(self.b2), t)
        like = self.params[0]
        d1, d2 = scalar(float(bc1), like), scalar(float(bc2), like)
        g = list(grads)
        if self.weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul(self.params,
                                                         self.weight_decay))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1 - self.b1))
        sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(sq, 1 - self.b2))
        mu_hat = torch._foreach_div(self.mu, d1)
        nu_hat = torch._foreach_div(self.nu, d2)
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_add_(self.params, torch._foreach_mul(upd, -lr))


def _flatten_features(feats) -> np.ndarray:
    return np.stack([np.asarray(f, np.float64).reshape(-1) for f in feats])


def _to_host(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        y = y.cpu().numpy()
    return np.asarray(y).reshape(-1)


def fit_model(model, name: str, data, save_opts: SaveOpt | None = None):
    """Generic fit/predict driver for the non-CNN regressors.

    ``model`` exposes ``fit(X, y) -> state`` and ``predict(state, X) ->
    y_hat`` with X standardised (float64 numpy). Returns the estimate{k}.npz
    payload {train_est, val_est, train_time, val_time}; the times are
    seconds per image, read after the estimates are on the host.
    """
    save_opts = save_opts or SaveOpt()
    train_feature, val_feature, train_reward, val_reward = data
    x_train = _flatten_features(train_feature)
    x_val = _flatten_features(val_feature)

    wts_path = (
        os.path.join(save_opts.model_dir, f"wts{save_opts.model_idx}.pickle")
        if save_opts.model_dir
        else None
    )
    if save_opts.load and wts_path:
        with open(wts_path, "rb") as f:
            state, scaler_state = pickle.load(f)
        scaler = StandardScaler.from_state(scaler_state)
        x_train = scaler.transform(x_train)
        x_val = scaler.transform(x_val)
    else:
        scaler = StandardScaler().fit(x_train)
        x_train = scaler.transform(x_train)
        x_val = scaler.transform(x_val)
        state = model.fit(x_train, np.asarray(train_reward, np.float64))

    t1 = time.perf_counter()
    train_est = _to_host(model.predict(state, x_train))
    t2 = time.perf_counter()
    val_est = _to_host(model.predict(state, x_val))
    t3 = time.perf_counter()
    train_time = (t2 - t1) / max(len(train_reward), 1)
    val_time = (t3 - t2) / max(len(val_reward), 1)

    train_mse = float(np.mean((np.asarray(train_reward) - train_est) ** 2))
    val_mse = float(np.mean((np.asarray(val_reward) - val_est) ** 2))
    print(
        f"Trained {name} model with training MSE: {train_mse:.3f}, "
        f"validation MSE: {val_mse:.3f}"
    )

    if save_opts.save and wts_path:
        Path(save_opts.model_dir).mkdir(parents=True, exist_ok=True)
        with open(wts_path, "wb") as f:
            pickle.dump((state, scaler.state()), f)
    return {
        "train_est": train_est,
        "val_est": val_est,
        "train_time": train_time,
        "val_time": val_time,
    }
