"""Training loop of the CNN/MLP reward estimator (the port of the JAX
package's ``estimators/train_cnn.py``).

Adam with weight decay added to the raw gradient (optax's
add_decayed_weights -> scale_by_adam -> scale(-lr), op for op: see
``common.Adam``), the MultiStep learning rate set per epoch ([60, 75, 90],
gamma 0.5), 100 epochs, batches of 64 in fixed order, MSE or the
reward-weighted ``mean((pred - y)^2 * y)``, validation every ``test_epoch``
epochs (the mean of batch means) with a best-by-validation snapshot, and
per-image train/validation inference times. Checkpoints are ``wts{k}.npz``
under ``{model_dir}_best`` / ``_last`` in the JAX package's layout
(``params`` / ``bn`` object arrays of numpy pytrees), so they load in either
package.

The init and the dropout masks come from ``torch.Generator(seed)`` (on the
host, so the CPU and the card see the same draws) unless given: ``init``
takes the JAX package's (params, bn_state), ``dropout`` a mask callable.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from pathlib import Path
from typing import Callable, List

import numpy as np
import torch

from ..utils.paths import parse_path
from .common import SaveOpt, Adam, estimator_device
from .nn import DROPOUT_P, EdgeDetectionNet


@dataclasses.dataclass
class CNNOpt:
    """Options for the Convolutional Neural Network model."""

    resize: bool = True  # Whether the inputs share the same shape.
    learning_rate: float = 5e-3  # Initial learning rate.
    gamma: float = 0.5  # Scale for updating learning rate at each milestone.
    weight_decay: float = 5e-5  # Weight decay parameter for optimizer.
    milestones: List = dataclasses.field(default_factory=lambda: [60, 75, 90])
    max_epoch: int = 100  # Maximum number of epochs for training.
    batch_size: int = 64  # Batch size for model training.
    channels: List = dataclasses.field(default_factory=lambda: [])
    kernels: List = dataclasses.field(default_factory=lambda: [3, 3, 3, 3, 3])
    pools: List = dataclasses.field(
        default_factory=lambda: [True, True, False, False, False]
    )
    weight: bool = False  # Reward-weighted MSE loss.
    linear: List = dataclasses.field(
        default_factory=lambda: [145, 16, 16, 16, 16, 1]
    )
    test_epoch: int = 1  # Validation period in epochs.
    seed: int = 0


_CNNOPT = CNNOpt()


def _batches(feats, rewards, batch_size, device):
    """Fixed-order batches on ``device``; per-sample arrays stacked (equal
    shapes within a batch, which resize=True guarantees and batch_size=1
    sidesteps)."""
    out = []
    for s in range(0, len(rewards), batch_size):
        e = min(s + batch_size, len(rewards))
        x = np.stack([np.asarray(f, np.float32) for f in feats[s:e]])
        y = np.asarray(rewards[s:e], np.float32).reshape(-1, 1)
        out.append((torch.from_numpy(x).to(device),
                    torch.from_numpy(y).to(device)))
    return out


def _loss(net, x, y, weighted, dropout=None):
    err = (net(x, dropout) - y) ** 2
    return torch.mean(err * y) if weighted else torch.mean(err)


def _mean64(values) -> float:
    return float(np.mean(np.asarray(values, np.float64)))


class SeededDropout:
    """The port's dropout masks: keep where a uniform draw is below 0.9.
    The uniforms come from one host generator a chunk at a time, moved to
    the device once per chunk and used site by site in order, so the CPU and
    the card draw the same masks and a training step never waits on a
    host-to-device copy."""

    CHUNK = 1 << 20

    def __init__(self, generator: torch.Generator, device):
        self.generator, self.device = generator, device
        self.buf = torch.empty(0, device=device)
        self.pos = 0

    def __call__(self, shape) -> torch.Tensor:
        n = math.prod(shape)
        if self.pos + n > self.buf.numel():
            fresh = torch.rand(max(self.CHUNK, n), generator=self.generator)
            if self.device.type == "cuda":
                fresh = fresh.pin_memory().to(self.device, non_blocking=True)
            self.buf = torch.cat([self.buf[self.pos:], fresh])
            self.pos = 0
        u = self.buf[self.pos:self.pos + n].view(tuple(shape))
        self.pos += n
        return u < 1.0 - DROPOUT_P


def fit_CNN(data, opts: CNNOpt = _CNNOPT, save_opts: SaveOpt | None = None,
            plot: bool = True, device=None, init=None,
            dropout: Callable | None = None):
    """Train EdgeDetectionNet; returns (best_result, last_result) dicts, the
    estimate{k}.npz payloads of the best-by-validation and the last weights.

    :param init: optional (params, bn_state) in the JAX package's layout,
        instead of the seeded init.
    :param dropout: optional callable shape -> bool keep mask (on the
        device), called for each dropout site of each training step in
        order, instead of the seeded draws.
    """
    save_opts = save_opts or SaveOpt()
    dev = estimator_device(device)
    train_feature, val_feature, train_reward, val_reward = data
    train_reward = np.asarray(train_reward, np.float32)
    val_reward = np.asarray(val_reward, np.float32)

    net = EdgeDetectionNet.from_opts(opts.channels, opts.kernels, opts.pools,
                                     opts.linear, opts.resize)
    gen = torch.Generator().manual_seed(opts.seed)
    if init is not None:
        net.from_jax_params(*init)
    else:
        net.reset_parameters(gen)

    model_best_dir, model_last_dir = parse_path(save_opts.model_dir)
    if save_opts.load and save_opts.model_dir:
        loaded = np.load(
            os.path.join(model_last_dir, f"wts{save_opts.model_idx}.npz"),
            allow_pickle=True)
        net.from_jax_params(loaded["params"].item(), loaded["bn"].item())
    net.to(dev)
    if dropout is None:
        dropout = SeededDropout(gen, dev)

    def lr_for_epoch(epoch: int) -> float:
        lr = opts.learning_rate
        for m in sorted(opts.milestones):
            if epoch >= m:
                lr *= opts.gamma
        return lr

    params = list(net.parameters())
    opt = Adam(params, opts.learning_rate, weight_decay=opts.weight_decay)
    train_b = _batches(train_feature, train_reward, opts.batch_size, dev)
    val_b = _batches(val_feature, val_reward, opts.batch_size, dev)

    def snapshot():
        return {k: v.detach().clone() for k, v in net.state_dict().items()}

    def test_loss_of():
        net.eval()
        with torch.no_grad():
            losses = [_loss(net, x, y, opts.weight) for x, y in val_b]
        if not losses:
            return float("inf")
        return _mean64(torch.stack(losses).cpu().numpy())

    best = snapshot()
    best_test_err = np.inf
    train_losses, test_losses = [], []
    for epoch in range(opts.max_epoch):
        lr = lr_for_epoch(epoch)
        net.train()
        epoch_losses = []
        for x, y in train_b:
            loss = _loss(net, x, y, opts.weight, dropout)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                opt.step(grads, lr)
            epoch_losses.append(loss.detach())
        train_losses.append(_mean64(torch.stack(epoch_losses).cpu().numpy())
                            if epoch_losses else 0.0)
        if epoch % opts.test_epoch == 0:
            tl = test_loss_of()
            test_losses.append(tl)
            if tl < best_test_err:
                best_test_err = tl
                best = snapshot()
        if epoch % 10 == 0 or epoch == opts.max_epoch - 1:
            print(
                f"Epoch {epoch + 1}: train loss {train_losses[-1]:.6f}"
                + (f", val loss {test_losses[-1]:.6f}" if test_losses else "")
            )
    last = snapshot()

    if plot:
        try:
            from .plotting import cnn_plot

            cnn_plot(train_losses, test_losses, opts.test_epoch,
                     opts.milestones, save_opts.model_idx)
        except Exception as exc:  # plotting must never kill a training run
            print(f"Skipping loss plot: {exc}")

    def estimate(state):
        net.load_state_dict(state)
        net.eval()
        with torch.no_grad():
            t1 = time.perf_counter()
            tr = [net(x) for x, _ in train_b]
            tr = torch.cat(tr).reshape(-1).cpu().numpy() if tr else \
                np.zeros(0, np.float32)
            t2 = time.perf_counter()
            va = [net(x) for x, _ in val_b]
            va = torch.cat(va).reshape(-1).cpu().numpy() if va else \
                np.zeros(0, np.float32)
            t3 = time.perf_counter()
        return {"train_est": tr, "val_est": va,
                "train_time": (t2 - t1) / max(len(train_reward), 1),
                "val_time": (t3 - t2) / max(len(val_reward), 1)}

    best_result = estimate(best)
    last_result = estimate(last)

    if save_opts.save and save_opts.model_dir:
        for d, state in ((model_best_dir, best), (model_last_dir, last)):
            net.load_state_dict(state)
            p, b = net.to_jax_params()
            Path(d).mkdir(parents=True, exist_ok=True)
            np.savez(os.path.join(d, f"wts{save_opts.model_idx}.npz"),
                     params=np.array(p, dtype=object),
                     bn=np.array(b, dtype=object))
    return best_result, last_result
