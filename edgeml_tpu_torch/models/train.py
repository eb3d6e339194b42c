"""Detector training: the optimiser, the schedule, the EMA, checkpoints.

The reference package's ``models/train.py`` in PyTorch: SGD (momentum,
optionally nesterov) or AdamW with MultiStep or cosine LR and a linear
warmup, the ultralytics YOLO recipe (``yolo_recipe_config``), a
decay-ramped model EMA over parameters and BatchNorm statistics, and
per-epoch checkpoints of {model, optimizer, lr_scheduler, args, epoch[,
ema]}.

The optimiser is written over the parameter tensors in optax's order, op
for op (``Optimizer``), so a step here and a step of the reference package
differ only by the rounding of the gradients they are given. Checkpoints
are pickles whose ``model`` and ``ema`` hold NumPy arrays in the reference
package's tree layout (``to_jax_params``), so either package's detect CLI
serves them; ``optimizer`` is a plain dict of arrays keyed by parameter
name. The frozen-norm families (RetinaNet, Faster R-CNN) keep no
statistics tree: their ``stats`` is None, and their EMA shadows the
parameters alone. The reference's rematerialisation knob and its orbax directory
format have no counterpart here (XLA- and JAX-specific).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import pickle
from pathlib import Path

import numpy as np
import torch


@dataclasses.dataclass
class TrainConfig:
    """Optimisation settings (names and defaults as the reference
    trainer's). The last four fields are the ultralytics YOLO recipe's
    optimiser shape: nesterov momentum, a cosine floor (``lrf``), an
    epoch-based warmup and weight decay on kernel weights only."""

    opt: str = "sgd"
    lr: float = 0.02
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_scheduler: str = "multisteplr"
    lr_steps: tuple = (16, 22)
    lr_gamma: float = 0.1
    epochs: int = 30
    warmup_iters: int = 1000  # min(1000, len(loader) - 1)
    warmup_factor: float = 1.0 / 1000
    nesterov: bool = False
    lrf: float = 0.0  # cosine final LR as a fraction of lr
    warmup_epochs: float = 0.0  # > 0: linear warmup over this many epochs
    decay_mask: str = "all"  # "weights": decay only ndim >= 2 kernels


def yolo_recipe_config(epochs: int = 300) -> TrainConfig:
    """The ultralytics hyp.scratch-low optimiser recipe: nesterov
    SGD(0.937), lr 0.01 cosine to lrf 0.01, a 3-epoch warmup, weight decay
    5e-4 on kernel weights only (one global 0 -> lr ramp)."""
    return TrainConfig(
        opt="sgd", lr=0.01, momentum=0.937, weight_decay=5e-4,
        lr_scheduler="cosineannealinglr", epochs=epochs, nesterov=True,
        lrf=0.01, warmup_epochs=3.0, decay_mask="weights",
    )


def lr_at(cfg: TrainConfig, epoch: int, it: int, steps_per_epoch: int) -> float:
    """The LR schedule: a linear warmup (over epoch 0's iterations, or over
    ``warmup_epochs``), then MultiStep or cosine with the ``lrf`` floor."""
    if cfg.lr_scheduler == "multisteplr":
        lr = cfg.lr * cfg.lr_gamma ** sum(epoch >= m for m in cfg.lr_steps)
    else:  # cosineannealinglr / one_cycle with floor
        lr = cfg.lr * (
            (1 - np.cos(np.pi * epoch / cfg.epochs)) / 2 * (cfg.lrf - 1) + 1
        )
    if cfg.warmup_epochs > 0:
        w = max(cfg.warmup_epochs * steps_per_epoch, 1)
        g = epoch * steps_per_epoch + it
        if g < w:
            lr = lr * (g / w)
    elif epoch == 0:
        w = min(cfg.warmup_iters, max(steps_per_epoch - 1, 1))
        a = min(it / max(w, 1), 1.0)
        lr = lr * (cfg.warmup_factor * (1 - a) + a)
    return float(lr)


def decays(cfg: TrainConfig, p: torch.Tensor) -> bool:
    """Whether weight decay applies to ``p``: always, or (``decay_mask``
    "weights") only to conv and linear kernels (ndim >= 2), not BatchNorm
    gains or biases."""
    if cfg.decay_mask == "all":
        return True
    if cfg.decay_mask == "weights":
        return p.ndim >= 2
    raise RuntimeError(f"Invalid decay_mask {cfg.decay_mask!r}.")


def _f32(v: float) -> float:
    """A Python float holding the f32 rounding of ``v``: the scalar the
    reference's f32 arithmetic uses."""
    return float(np.float32(v))


class Optimizer:
    """optax's SGD and AdamW chains over named parameter tensors, op for op:

      * sgd: add_decayed_weights -> trace(momentum, nesterov) -> scale(-1);
      * adamw: scale_by_adam -> add_decayed_weights -> scale(-1);

    then the update times lr is added to the parameter. The state lives in
    f32 beside the parameters; ``state_dict`` is a plain dict of NumPy
    arrays keyed by parameter name.
    """

    def __init__(self, cfg: TrainConfig, named_params, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        if cfg.opt not in ("sgd", "adamw"):
            raise RuntimeError(f"Invalid optimizer {cfg.opt}. Only SGD and "
                               f"AdamW are supported.")
        self.cfg = cfg
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.decay = [decays(cfg, p) for p in self.params]
        self._decayed = [i for i, d in enumerate(self.decay) if d]
        self.b1, self.b2, self.eps = b1, b2, eps
        zeros = lambda: [torch.zeros_like(p) for p in self.params]
        if cfg.opt == "sgd":
            self.trace = zeros()
        else:
            self.mu, self.nu = zeros(), zeros()
            self.count = 0

    def _add_decay(self, g):
        """g + wd * p on the decayed tensors (a multiply, then an add: the
        reference's two roundings)."""
        idx = self._decayed
        if not idx:
            return g
        g = list(g)
        dec = torch._foreach_add(
            [g[i] for i in idx],
            torch._foreach_mul([self.params[i] for i in idx],
                               self.cfg.weight_decay))
        for i, v in zip(idx, dec):
            g[i] = v
        return g

    @torch.no_grad()
    def step(self, grads, lr: float) -> None:
        """One update from ``grads`` (in the order of the parameters) at
        learning rate ``lr``; each op over all tensors at once (foreach),
        one rounding per op as in the reference."""
        g = list(grads)
        if self.cfg.opt == "sgd":
            g = self._add_decay(g)
            m = self.cfg.momentum
            self.trace = torch._foreach_add(g, torch._foreach_mul(self.trace,
                                                                  m))
            upd = torch._foreach_add(g, torch._foreach_mul(self.trace, m)) \
                if self.cfg.nesterov else self.trace
        else:
            self.count += 1
            t = np.float32(self.count)
            bc1 = _f32(np.float32(1) - np.power(np.float32(self.b1), t))
            bc2 = _f32(np.float32(1) - np.power(np.float32(self.b2), t))
            b1, b2 = self.b1, self.b2
            self.mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                         torch._foreach_mul(self.mu, b1))
            self.nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                torch._foreach_mul(self.nu, b2))
            den = torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div(self.nu, bc2)), self.eps)
            upd = self._add_decay(torch._foreach_div(
                torch._foreach_div(self.mu, bc1), den))
        torch._foreach_add_(self.params, torch._foreach_mul(upd, -_f32(lr)))

    def state_dict(self) -> dict:
        """The state as NumPy arrays: {"trace": {name: array}} for SGD,
        {"count", "mu", "nu"} for AdamW."""
        host = lambda ts: {n: t.detach().cpu().numpy().copy()
                           for n, t in zip(self.names, ts)}
        if self.cfg.opt == "sgd":
            return {"trace": host(self.trace)}
        return {"count": np.asarray(self.count, np.int32),
                "mu": host(self.mu), "nu": host(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict()``'s arrays onto the parameters' device."""
        if not isinstance(state, dict):
            raise ValueError("optimizer state is not this package's dict "
                             "(a checkpoint of the reference package cannot "
                             "be resumed here)")
        dev = lambda d: [torch.as_tensor(np.asarray(d[n]),
                                         device=p.device).to(p.dtype)
                         for n, p in zip(self.names, self.params)]
        if self.cfg.opt == "sgd":
            self.trace = dev(state["trace"])
        else:
            self.count = int(state["count"])
            self.mu, self.nu = dev(state["mu"]), dev(state["nu"])


def make_optimizer(cfg: TrainConfig, net: torch.nn.Module) -> Optimizer:
    """The optimiser of ``cfg`` over ``net``'s trained parameters (those
    that require a gradient: the leaves of the reference's parameter tree;
    not the identity norms' fixed weights)."""
    return Optimizer(cfg, [(n, p) for n, p in net.named_parameters()
                           if p.requires_grad])


def ema_state(module: torch.nn.Module):
    """The tensors an EMA shadows: every parameter (the frozen norms' gain,
    shift and statistics included) and every BatchNorm running mean and
    variance, in a fixed order."""
    return [p for p in module.parameters()] + [
        b for k, b in module.named_buffers()
        if k.endswith(("running_mean", "running_var"))]


class ModelEMA:
    """Model EMA with the ultralytics warmup ramp over parameters and
    BatchNorm statistics:

        d(n) = decay * (1 - exp(-n / tau));   ema <- ema + (1 - d)(value - ema)

    ``module`` is the shadow (a copy of the net, eval mode, no gradients);
    ``n_updates`` the 1-based optimiser-update count, carried across a
    resume."""

    def __init__(self, net: torch.nn.Module, decay: float = 0.9999,
                 tau: float = 2000.0, n_updates: int = 0):
        self.module = copy.deepcopy(net).eval().requires_grad_(False)
        self.decay, self.tau = decay, tau
        self.n_updates = n_updates

    @torch.no_grad()
    def update(self, net: torch.nn.Module) -> None:
        self.n_updates += 1
        n = np.float32(self.n_updates)
        d = np.float32(self.decay) * (
            np.float32(1) - np.exp(-n / np.float32(self.tau)))
        w = float(np.float32(1) - d)
        shadow, live = ema_state(self.module), ema_state(net)
        torch._foreach_add_(shadow, torch._foreach_mul(
            torch._foreach_sub(live, shadow), w))

    def payload(self) -> dict:
        """{params[, stats], n_updates}: no stats key for the frozen-norm
        families, whose reference EMA shadows the parameters alone."""
        params, stats = self.module.to_jax_params()
        out = {"params": params, "n_updates": np.asarray(self.n_updates)}
        if stats is not None:
            out["stats"] = stats
        return out


def save_checkpoint(path: str, net, opt: Optimizer, cfg: TrainConfig,
                    epoch: int, ema: ModelEMA | None = None):
    """Write the reference trainer's checkpoint dict ({model, optimizer,
    lr_scheduler, args, epoch}, plus ``ema`` with --ema) as a pickle;
    ``model`` and ``ema`` in the reference package's tree layout."""
    params, stats = net.to_jax_params()
    payload = {
        "model": {"params": params, "stats": stats},
        "optimizer": opt.state_dict(),
        "lr_scheduler": {
            "name": cfg.lr_scheduler,
            "steps": list(cfg.lr_steps),
            "gamma": cfg.lr_gamma,
        },
        "args": dataclasses.asdict(cfg),
        "epoch": epoch,
    }
    if ema is not None:
        payload["ema"] = ema.payload()
    Path(os.path.dirname(path) or ".").mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)


class _Opaque(tuple):
    """Stand-in for a class of a JAX-side module found in a checkpoint (the
    reference's optax state tuples): keeps its fields, needs no import."""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)

    def __setstate__(self, state):
        pass


_OPAQUE_MODULES = ("optax", "jax", "jaxlib", "chex", "flax", "orbax")


class CheckpointUnpickler(pickle.Unpickler):
    """Unpickles a checkpoint of either package without importing JAX or
    optax: their classes (only in the reference's optimizer state) load as
    opaque tuples; ``model`` and ``ema`` are plain dicts of NumPy arrays."""

    def find_class(self, module, name):
        if module.split(".")[0] in _OPAQUE_MODULES:
            return type(name, (_Opaque,), {"__module__": module})
        return super().find_class(module, name)


def read_payload(path: str):
    """A checkpoint's payload dict, or None where ``path`` is no pickle of
    the trainers' shape ({model: {params, stats}, ...})."""
    try:
        with open(path, "rb") as f:
            obj = CheckpointUnpickler(f).load()
    except Exception:
        return None
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict) \
            and "params" in obj["model"]:
        return obj
    return None


def load_jax_tree(net, params, stats=None):
    """Fill ``net`` from the reference's (params, stats) trees; ``stats``
    None for the frozen-norm families."""
    if stats is None:
        return net.from_jax_params(params)
    return net.from_jax_params(params, stats)


def load_checkpoint(path: str):
    """(params, stats, optimizer state, payload) of a pickle checkpoint;
    params and stats are the reference package's trees of NumPy arrays.
    Directory (orbax) checkpoints are not read by this package."""
    if os.path.isdir(path):
        raise ValueError(f"{path}: directory (orbax) checkpoints are "
                         f"written only by the reference package")
    payload = read_payload(path)
    if payload is None:
        raise ValueError(f"{path}: not a training checkpoint")
    return (payload["model"]["params"], payload["model"]["stats"],
            payload["optimizer"], payload)


def pad_targets(label_list, max_targets: int):
    """Per-image (m, 5) [cls, x, y, w, h] arrays -> (B, MAXT, 5) + mask."""
    b = len(label_list)
    out = np.zeros((b, max_targets, 5), np.float32)
    valid = np.zeros((b, max_targets), bool)
    for i, lab in enumerate(label_list):
        lab = np.asarray(lab, np.float32).reshape(-1, 5)[:max_targets]
        out[i, : len(lab)] = lab
        valid[i, : len(lab)] = True
    return out, valid
