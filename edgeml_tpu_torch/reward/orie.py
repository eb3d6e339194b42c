"""Offloading rewards: ORIE / ORI (Monte-Carlo ensemble mAP) and DCSB.

The port of the JAX package's ``reward/orie.py``. Detections are laid out
once into a ``DetectionPool``; each (image, ensemble draw) is a pair of
per-image inclusion masks, and a batch of images is one batched
``orie_map_pair`` on the device.

The ensemble draw (the port's divergence from the JAX package, which draws
with ``jax.random``; torch cannot reproduce that stream): for target image
i, every other image j gets the key

    key(i, j) = (h(h(i ^ s) ^ j) >> 1) << 31 | j,   s = h(seed ^ 0x9E3779B9),

with h the 32-bit ``lowbias32`` integer hash, and the ensemble is the E
images of smallest key (the target's key is the largest int64). h is a
bijection of 32-bit integers, so for one target the keys of distinct images
differ and the draw is exactly E images other than the target, uniform
without replacement up to the hash's quality. A key is a function of (seed,
i, j) alone, computed in integer ops on the device, so rewards do not depend
on the batch or on the order in which batches run, nor on how the images
are split over several devices (``orie_rewards(mesh=)``: each batch is cut
into contiguous blocks, one a device, against a copy of the pool on each,
and gathered in order).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.map_kernel import DetectionPool, build_pool, orie_map_pair
from ..parallel.mesh import make_mesh

_M32 = 0xFFFFFFFF
_TARGET_KEY = torch.iinfo(torch.int64).max


def _mul32(x, c: int):
    """Low 32 bits of x * c for 0 <= x < 2^32 (an int, or an int64
    tensor) and a 32-bit constant c, in two 16-bit halves (no int64
    overflow)."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def hash32(x):
    """lowbias32 (a bijection of 32-bit integers) of 0 <= x < 2^32."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def ensemble_masks(seed: int, targets: torch.Tensor, n: int,
                   num_ensemble: int) -> torch.Tensor:
    """(B, n) bool: the ensemble of each target image (B,), exactly
    ``num_ensemble`` images other than the target (0 <= E <= n - 1)."""
    dev = targets.device
    if num_ensemble <= 0:
        return torch.zeros((targets.shape[0], n), dtype=torch.bool,
                           device=dev)
    s = hash32((seed ^ 0x9E3779B9) & _M32)
    b = hash32(targets.to(torch.int64) ^ s)
    j = torch.arange(n, dtype=torch.int64, device=dev)
    key = ((hash32(b[:, None] ^ j[None, :]) >> 1) << 31) | j
    key = torch.where(j[None, :] == targets[:, None], _TARGET_KEY, key)
    kth = torch.kthvalue(key, num_ensemble, dim=1).values
    return key <= kth[:, None]


def default_batch(pool: DetectionPool) -> int:
    """Images per batch: what half the device's free memory holds (a
    quarter of 16 GiB on the CPU), at most 1024. A draw keeps some 48 (C, T,
    K + 2) f32 intermediates alive (about 24 for each of its two
    evaluations), its (C, K) masks and its (N,) keys."""
    c, k, t = pool.tp.shape
    per_draw = 2 * 24 * c * t * (k + 2) * 4 + 16 * c * k + 32 * \
        pool.num_images
    if pool.device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(pool.device)
        budget = free // 2
    else:
        budget = 4 * 2**30
    return int(min(max(budget // per_draw, 1), 1024))


def orie_batch(pool: DetectionPool, targets: torch.Tensor,
               num_ensemble: int, seed: int) -> torch.Tensor:
    """ORIE rewards (B,) of the target images (B,) on the pool's device,
    NaN -> 0 applied; 0 <= num_ensemble <= N - 1."""
    in_ens = ensemble_masks(seed, targets, pool.num_images, num_ensemble)
    weak_map, strong_map = orie_map_pair(pool, in_ens, targets)
    r = (strong_map - weak_map) * (num_ensemble + 1)
    return torch.where(torch.isnan(r), 0.0, r)


def pool_to(pool: DetectionPool, device) -> DetectionPool:
    """A copy of ``pool`` with its tensors on ``device``."""
    return dataclasses.replace(pool, **{
        f.name: getattr(pool, f.name).to(device)
        for f in dataclasses.fields(pool)
        if torch.is_tensor(getattr(pool, f.name))})


def orie_rewards(weak_data, strong_data, labels, num_ensemble: int = 1000,
                 seed: int = 0, batch: int | None = None,
                 pool: DetectionPool | None = None, verbose: bool = False,
                 device=None, mesh=None) -> np.ndarray:
    """ORIE reward of every image (ORI when num_ensemble = 0).

    Inputs are the ``set_data`` triples. num_ensemble is clamped to [0, N -
    1] with the reference's messages; a NaN reward (no labelled image in the
    draw) becomes 0.

    :param batch: images per batch (over all devices); None sizes it from
        the device's free memory, times the number of devices. The rewards
        do not depend on it.
    :param pool: a pool already built from these triples (its device is
        used); else one is built on ``device`` (the CUDA device unless
        "cpu" is asked for).
    :param mesh: None (the pool's device alone) or a list of devices: each
        batch is cut into one contiguous block a device, each block scored
        against the pool's copy there, the blocks gathered in order.
    :return: (N,) float32.
    """
    if pool is None:
        pool = build_pool(weak_data, strong_data, labels,
                          device=resolve_device(device))
    n = pool.num_images
    if num_ensemble > n - 1:
        num_ensemble = n - 1
        print("Ensemble size is too large. Set to the dataset size.")
    if num_ensemble < 0:
        num_ensemble = 0
        print("Ensemble size is negative. Set to 0.")
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    devices = [pool.device] if mesh is None \
        else [torch.device(d) for d in mesh]
    pools = {d: pool if d == pool.device else pool_to(pool, d)
             for d in dict.fromkeys(devices)}
    if batch is None:
        batch = default_batch(pool) * len(devices)

    # every block is dispatched before any is read back
    outs = [orie_batch(pools[d], block.to(d), num_ensemble, seed)
            for s in range(0, n, batch)
            for d, block in zip(devices, torch.tensor_split(
                torch.arange(s, min(s + batch, n)), len(devices)))
            if len(block)]
    out = torch.cat([o.cpu() for o in outs]).numpy().astype(np.float32) \
        if outs else np.zeros((0,), np.float32)
    if verbose:
        for i in range(n):
            print(f"ORIE for image {i}: {out[i]:.2f}.")
    return out


def dcsb_rewards(weak_data, strong_data, conf_thresh: float = 0.5
                 ) -> np.ndarray:
    """DCSB reward: the strong detector's count of confident detections
    minus the weak one's (strict ``conf > 0.5``), int64."""
    out = np.zeros((len(weak_data),), np.int64)
    for i, (w, s) in enumerate(zip(weak_data, strong_data)):
        out[i] = int(np.sum(np.asarray(s[1]) > conf_thresh)) - int(
            np.sum(np.asarray(w[1]) > conf_thresh))
    return out


def compute_rewards(weak_data, strong_data, labels, method: str = "orie",
                    num_ensemble: int = 1000, seed: int = 0,
                    verbose: bool = False, batch: int | None = None,
                    device=None, mesh="auto"):
    """Rewards with the wall time the reference stores beside them: the
    clock runs from before the pool is built to after the rewards are on
    the host (the device synchronised). Returns (reward, seconds).

    :param mesh: "auto" deals the images over every visible CUDA card when
        there is more than one (one card, or the CPU: one device); None
        forces ``device`` alone; or an explicit list of devices
        (``orie_rewards``)."""
    start = time.perf_counter()
    if method == "orie":
        dev = resolve_device(device)
        if mesh == "auto":
            mesh = make_mesh(dev)
            mesh = mesh if len(mesh) > 1 else None
        reward = orie_rewards(weak_data, strong_data, labels, num_ensemble,
                              seed, batch=batch, verbose=verbose, device=dev,
                              mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    else:
        reward = dcsb_rewards(weak_data, strong_data).astype(int)
    reward = np.where(np.isnan(reward), 0, reward)
    return reward, time.perf_counter() - start
