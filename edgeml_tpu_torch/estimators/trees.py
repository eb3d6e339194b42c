"""Histogram decision-tree ensembles, Random Forest and gradient boosting
(the port of the JAX package's ``estimators/trees.py``), as plain torch ops
on the chosen device.

Features are quantile-binned once; trees grow level-wise: per level, (sum g,
count) histograms over (node, feature, bin) for every open node, prefix sums
over the bins give every candidate split's two sides, and an argmax (first
index on ties) picks each node's (feature, bin) by variance reduction.
Trees equal the JAX package's node for node. That needs its float
arithmetic in its order, on both devices:

  * histogram sums are sequential in sample order, as XLA's CPU scatter-add
    makes them: ``index_add_`` on the CPU; on CUDA (whose atomics sum in a
    different order every run) a stable sort by cell and a segmented sum
    that walks each cell's samples in order;
  * prefix sums over the bins follow XLA's CPU cumulative sum: sequential
    in chunks of 16, the chunk totals scanned sequentially and added back
    (``xla_cumsum``);
  * gains are formed op by op as the JAX expression forms them, and a
    multiply-add (GBR's prediction update, the ensemble's base + scale *
    sum) rounds once, as XLA's CPU backend contracts it (``fma``).

Levels stop early once no node can split (the rest would change nothing),
and only the slots in use are scanned. RFR's bootstrap weights and GBR's
subsample masks come from ``torch.Generator(seed)`` unless given (JAX's
``jax.random`` stream cannot be reproduced). States are the JAX package's:
the trees as a dict of (T, slots) numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .common import SaveOpt, estimator_device, f32, fit_model, scalar

_CHUNK = 16  # XLA's CPU cumulative-sum rewrite: sequential runs of 16


@dataclasses.dataclass
class RFROpt:
    """Options for the Random Forest regression model."""

    n_estimators: int = 100  # The number of trees in the forest.
    max_depth: int = 20  # The maximum depth of the tree.
    min_samples_split: int = 100  # Min samples required to split a node.
    n_bins: int = 64
    seed: int = 0


@dataclasses.dataclass
class GBROpt:
    """Options for the Gradient Boosting regression model."""

    learning_rate: float = 0.1  # Shrinkage per boosting stage.
    n_estimators: int = 1000  # The number of boosting stages to perform.
    subsample: float = 1.0  # Fraction of samples per stage.
    max_depth: int = 3  # sklearn GBR default.
    min_samples_split: int = 2
    n_bins: int = 64
    seed: int = 0


_RFROPT = RFROpt()
_GBROPT = GBROpt()
_TREE_KEYS = ("feat", "thr", "left", "right", "is_split", "leaf")


def quantile_bins(x: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature bin edges (n_bins - 1, F) from training-data quantiles."""
    qs = np.linspace(0, 100, n_bins + 1)[1:-1]
    return np.percentile(x, qs, axis=0)


def bin_features(x, edges, device) -> torch.Tensor:
    """Digitise (N, F) features into int64 bins with per-feature edges
    (compared in f32)."""
    x = f32(x, device)
    e = f32(edges, device)  # (B-1, F)
    return (x[:, None, :] >= e[None, :, :]).sum(dim=1)


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis, strictly left to right."""
    y = x.clone()
    for k in range(1, y.shape[-1]):
        y[..., k] += y[..., k - 1]
    return y


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis in the order XLA's CPU backend
    takes (``jnp.cumsum``): sequential within chunks of 16 (zero-padded),
    the chunk totals' exclusive prefix (the same way, recursively) added to
    each chunk."""
    n = x.shape[-1]
    if n <= _CHUNK:
        return seq_cumsum(x)
    c = -(-n // _CHUNK)
    pad = x.new_zeros(x.shape[:-1] + (c * _CHUNK - n,))
    within = seq_cumsum(torch.cat([x, pad], -1).reshape(
        x.shape[:-1] + (c, _CHUNK)))
    tot = within[..., -1]
    excl = torch.cat([tot.new_zeros(tot.shape[:-1] + (1,)),
                      xla_cumsum(tot)[..., :-1]], -1)
    return (within + excl[..., None]).reshape(
        x.shape[:-1] + (c * _CHUNK,))[..., :n]


def ordered_sums(cell: torch.Tensor, vals: torch.Tensor, size: int
                 ) -> torch.Tensor:
    """out[c] = sum of vals[i] over cell[i] == c, added one by one in the
    order of i, in f32 (identical on the CPU and the card)."""
    if cell.device.type == "cpu":
        return torch.zeros(size, dtype=vals.dtype).index_add_(0, cell, vals)
    perm = torch.sort(cell, stable=True).indices
    lengths = torch.bincount(cell, minlength=size)
    # 2-D data: the per-segment kernel that walks each segment in order
    data = vals[perm][:, None].expand(-1, 2)
    return torch.segment_reduce(data, "sum", lengths=lengths, axis=0,
                                unsafe=True)[:, 0]


def build_tree(xb: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
               depth: int, slots: int, n_bins: int, min_split: int) -> dict:
    """Grow one regression tree level-wise.

    xb: (N, F) int64 bins; g: (N,) f32 targets; w: (N,) f32 sample weights
    (whole numbers). Returns the (slots,) node arrays feat, thr, left, right
    (int32), is_split (bool) and leaf (f32), as the JAX package's
    ``_build_tree``.
    """
    dev = xb.device
    n, f = xb.shape
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    feat = torch.zeros(slots, dtype=torch.int64, device=dev)
    thr = torch.zeros_like(feat)
    left = torch.zeros_like(feat)
    right = torch.zeros_like(feat)
    is_split = torch.zeros(slots, dtype=torch.bool, device=dev)
    terminal = torch.zeros_like(is_split)
    next_free = 1
    gw = g * w
    gw_rep = gw[:, None].expand(n, f).reshape(-1)
    w_rep = w[:, None].expand(n, f).reshape(-1)
    col = torch.arange(f, device=dev)
    rows = torch.arange(n, device=dev)
    eps = scalar(1e-12, g)
    min_gain = scalar(1e-7, g)
    for _ in range(depth):
        act = next_free  # slots in use; the rest hold no sample
        cell = ((node[:, None] * f + col) * n_bins + xb).reshape(-1)
        size = act * f * n_bins
        hist_s = ordered_sums(cell, gw_rep, size).reshape(act, f, n_bins)
        # counts are whole numbers below 2^24: exact in any order
        hist_c = torch.zeros(size, dtype=g.dtype, device=dev).index_add_(
            0, cell, w_rep).reshape(act, f, n_bins)
        cum_s = xla_cumsum(hist_s)
        cum_c = torch.cumsum(hist_c, dim=2)
        tot_s = cum_s[:, :, -1:]
        tot_c = cum_c[:, :, -1:]
        rest_s = tot_s - cum_s
        rest_c = tot_c - cum_c
        gain = (cum_s * cum_s / torch.maximum(cum_c, eps)
                + rest_s * rest_s / torch.maximum(rest_c, eps)) \
            - tot_s * tot_s / torch.maximum(tot_c, eps)
        ok = (cum_c >= 1.0) & (rest_c >= 1.0)
        gain = torch.where(ok, gain, -torch.inf)
        gain[:, :, -1] = -torch.inf  # last bin = no split
        flat = gain.reshape(act, -1)
        best = torch.argmax(flat, dim=1)
        best_gain = flat.gather(1, best[:, None])[:, 0]
        cnt = tot_c[:, 0, 0]
        considered = ~terminal[:act] & ~is_split[:act] & (cnt > 0.0)
        can = considered & (cnt >= min_split) & torch.isfinite(best_gain) \
            & (best_gain > min_gain)
        rank = torch.cumsum(can.to(torch.int64), 0) - 1
        new_l = next_free + 2 * rank
        can = can & (new_l + 1 < slots)  # slot budget guard
        feat[:act] = torch.where(can, best // n_bins, feat[:act])
        thr[:act] = torch.where(can, best % n_bins, thr[:act])
        left[:act] = torch.where(can, new_l, left[:act])
        right[:act] = torch.where(can, new_l + 1, right[:act])
        is_split[:act] |= can
        terminal[:act] |= considered & ~can
        n_new = int(can.sum())
        if n_new == 0:
            break  # nothing is open: later levels change nothing
        next_free += 2 * n_new
        can_all = torch.zeros_like(is_split)
        can_all[:act] = can
        go_left = xb[rows, feat[node]] <= thr[node]
        node = torch.where(can_all[node],
                           torch.where(go_left, left[node], right[node]), node)

    leaf_sum = ordered_sums(node, gw, slots)
    leaf_cnt = torch.zeros(slots, dtype=g.dtype, device=dev).index_add_(
        0, node, w)
    leaf = leaf_sum / torch.maximum(leaf_cnt, eps)
    i32 = torch.int32
    return {"feat": feat.to(i32), "thr": thr.to(i32), "left": left.to(i32),
            "right": right.to(i32), "is_split": is_split, "leaf": leaf}


def tree_predict(trees: dict, xb: torch.Tensor, depth: int) -> torch.Tensor:
    """Leaf values (T, N) of every sample in each of T stacked trees ((T,
    slots) arrays), walking ``depth`` levels."""
    t, s = trees["feat"].shape
    n = xb.shape[0]
    dev = xb.device
    node = torch.zeros((t, n), dtype=torch.int64, device=dev)
    base = (torch.arange(t, device=dev) * s)[:, None]
    flat = {k: v.reshape(-1) for k, v in trees.items()}
    rows = torch.arange(n, device=dev)[None, :]
    for _ in range(depth):
        at = base + node
        go_left = xb[rows, flat["feat"][at].long()] <= flat["thr"][at]
        nxt = torch.where(go_left, flat["left"][at], flat["right"][at]).long()
        node = torch.where(flat["is_split"][at], nxt, node)
    return flat["leaf"][base + node]


def fma(a: torch.Tensor, s: float, t: torch.Tensor) -> torch.Tensor:
    """a + s * t in f32, rounded once: the product of two f32 values is
    exact in f64, so one f64 add and a rounding to f32 give the fused
    multiply-add (up to a double rounding, some 2^-29 of the time), the
    same on every device."""
    return (a.double() + float(np.float32(s)) * t.double()).to(a.dtype)


def pairwise_sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis by halves (elementwise adds only): one order,
    the same on every device."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] + x[h:2 * h]
        x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def _stack(trees: list) -> dict:
    return {k: torch.stack([t[k] for t in trees]) for k in _TREE_KEYS}


def _to_numpy(trees: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in trees.items()}


class _Forest:
    """Shared predict: base + scale * (sum of the trees' leaf values)."""

    def __init__(self, opts, device, weights=None):
        self.opts = opts
        self.device = device
        self.weights = weights

    def predict(self, state, x):
        xb = bin_features(np.asarray(x, np.float32), state["edges"],
                          self.device)
        trees = {k: torch.as_tensor(np.asarray(state["trees"][k]),
                                    device=self.device) for k in _TREE_KEYS}
        total = pairwise_sum0(tree_predict(trees, xb, state["depth"]))
        return fma(torch.full_like(total, state["base"]), state["scale"],
                   total)


class _RFR(_Forest):
    def fit(self, x, y):
        o = self.opts
        x = np.asarray(x, np.float32)
        yt = f32(y, self.device)
        n = x.shape[0]
        edges = quantile_bins(x, o.n_bins)
        xb = bin_features(x, edges, self.device)
        slots = int(min(2 ** (o.max_depth + 1),
                        2 * o.max_depth * max(n // max(o.min_samples_split, 1), 1) + 16,
                        2 * n + 2))
        weights = self.weights
        if weights is None:
            weights = bootstrap_weights(o.seed, n, o.n_estimators)
        trees = [build_tree(xb, yt, f32(weights[t], self.device), o.max_depth,
                            slots, o.n_bins, o.min_samples_split)
                 for t in range(o.n_estimators)]
        return {
            "trees": _to_numpy(_stack(trees)),
            "edges": edges,
            "depth": o.max_depth,
            "scale": 1.0 / o.n_estimators,
            "base": 0.0,
        }


def bootstrap_weights(seed: int, n: int, n_trees: int) -> np.ndarray:
    """The port's bootstrap: (n_trees, n) f32 draw counts, each tree n
    draws with replacement from one CPU generator seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    out = np.zeros((n_trees, n), np.float32)
    for t in range(n_trees):
        idx = torch.randint(0, n, (n,), generator=g)
        out[t] = torch.bincount(idx, minlength=n).numpy()
    return out


class _GBR(_Forest):
    def fit(self, x, y):
        o = self.opts
        x = np.asarray(x, np.float32)
        yt = f32(y, self.device)
        n = x.shape[0]
        edges = quantile_bins(x, o.n_bins)
        xb = bin_features(x, edges, self.device)
        slots = 2 ** (o.max_depth + 1)
        base = float(np.mean(np.asarray(y)))
        g = torch.Generator().manual_seed(o.seed)
        pred = torch.full((n,), base, dtype=torch.float32, device=self.device)
        ones = torch.ones(n, dtype=torch.float32, device=self.device)
        trees = []
        for s in range(o.n_estimators):
            if self.weights is not None:
                w = f32(self.weights[s], self.device)
            elif o.subsample < 1.0:
                w = (torch.rand(n, generator=g) < o.subsample).to(
                    torch.float32).to(self.device)
            else:
                w = ones
            tree = build_tree(xb, yt - pred, w, o.max_depth, slots, o.n_bins,
                              o.min_samples_split)
            one = {k: v[None] for k, v in tree.items()}
            pred = fma(pred, o.learning_rate,
                       tree_predict(one, xb, o.max_depth)[0])
            trees.append(tree)
        return {
            "trees": _to_numpy(_stack(trees)),
            "edges": edges,
            "depth": o.max_depth,
            "scale": o.learning_rate,
            "base": base,
        }


def fit_RFR(data, opts: RFROpt = _RFROPT, save_opts: SaveOpt | None = None,
            device=None, weights=None):
    """Fit a Random Forest Regressor. ``weights`` (n_estimators, N)
    replaces the seeded bootstrap counts."""
    return fit_model(_RFR(opts, estimator_device(device), weights),
                     "Random Forest Regressor", data, save_opts)


def fit_GBR(data, opts: GBROpt = _GBROPT, save_opts: SaveOpt | None = None,
            device=None, weights=None):
    """Fit a Gradient Boosting Regressor. ``weights`` (n_estimators, N)
    replaces the per-stage sample weights (all ones at subsample 1)."""
    return fit_model(_GBR(opts, estimator_device(device), weights),
                     "Gradient Boosting Regressor", data, save_opts)
