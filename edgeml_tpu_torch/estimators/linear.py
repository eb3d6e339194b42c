"""Linear, kernel and neighbour reward estimators (the port of the JAX
package's ``estimators/linear.py``), in f32 torch on the chosen device:

  LR   least squares, minimum-norm by SVD with JAX's cutoff   (fit_LR)
  EN   elastic net by FISTA proximal gradient                 (fit_EN)
  BR   Bayesian ridge, evidence iteration on the SVD          (fit_BR)
  SGD  per-sample SGD, inverse-scaling step (ops/sgd.py)      (fit_SGD)
  SVR  RBF or linear epsilon-SVR, primal Adam                 (fit_SVR)
  LSVR linear epsilon-SVR, primal Adam                        (fit_LSVR)
  KNR  k-nearest-neighbours mean, stable-sorted distances     (fit_KNR)

Options keep the JAX package's field names and defaults, and states its
layout ({'w': numpy f32, 'b': float}, ...), so ``wts{k}.pickle`` files
interchange. Every fitter takes ``device`` (the CUDA device unless "cpu" is
asked for). SGD's per-epoch orders come from ``torch.Generator(seed)``
unless given (the JAX package's ``jax.random`` stream cannot be
reproduced); tests inject JAX's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.sgd import sgd_fit, sgd_orders
from .common import SaveOpt, Adam, estimator_device, f32, fit_model, scalar


@dataclasses.dataclass
class LROpt:
    """Options for plain linear regression (none — kept for symmetry)."""


class _LinearModel:
    """Shared predict for models with a {'w', 'b'} state."""

    def __init__(self, device):
        self.device = device

    def predict(self, state, x):
        w = f32(state["w"], self.device)
        b = scalar(float(np.float32(state["b"])), w)
        return f32(x, self.device) @ w + b

    @staticmethod
    def _state(w, b):
        return {"w": w.cpu().numpy(), "b": float(b)}


def lstsq_min_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares by SVD with ``jnp.linalg.lstsq``'s
    cutoff: singular values below eps * max(M, N) * s_max count as zero.
    Rank-deficient inputs (all-zero columns) are solved as JAX solves them;
    ``torch.linalg.lstsq`` on CUDA assumes full rank."""
    m, n = a.shape
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = float(np.finfo(np.float32).eps) * max(m, n)
    mask = (s > 0) & (s >= scalar(rcond, s) * s[0])
    s_inv = torch.where(mask, 1 / torch.where(mask, s, 1.0), 0.0)
    return vt.T @ (s_inv * (u.T @ b))


class _LR(_LinearModel):
    def fit(self, x, y):
        xt, yt = f32(x, self.device), f32(y, self.device)
        xm, ym = xt.mean(0), yt.mean()
        w = lstsq_min_norm(xt - xm, yt - ym)
        return self._state(w, ym - xm @ w)


def fit_LR(data, save_opts: SaveOpt | None = None, device=None):
    """Fit a linear regression model."""
    return fit_model(_LR(estimator_device(device)), "Linear Regression", data,
                     save_opts)


@dataclasses.dataclass
class ENOpt:
    """Options for the Elastic net regression model."""

    alpha: float = 0.01  # Constant that multiplies the penalty terms.
    l1_ratio: float = 0.5  # The ElasticNet mixing parameter.
    max_iter: int = 2000
    tol: float = 1e-7


_ENOPT = ENOpt()


def _fista_momenta(steps: int) -> list:
    """FISTA's (t - 1) / t_next for each step, in f32 as the JAX loop carries
    t (the sequence does not depend on the data)."""
    out, t = [], np.float32(1.0)
    for _ in range(steps):
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        out.append(float((t - np.float32(1.0)) / t_new))
        t = t_new
    return out


def en_fista(x: torch.Tensor, y: torch.Tensor, alpha: float, l1_ratio: float,
             max_iter: int) -> torch.Tensor:
    """min_w 1/(2n)||y - Xw||^2 + alpha*l1*|w|_1 + alpha*(1-l1)/2*|w|^2 by
    max_iter FISTA steps from 0 (x, y centred)."""
    n = x.shape[0]
    l1 = alpha * l1_ratio
    l2 = alpha * (1.0 - l1_ratio)
    lip = torch.linalg.matrix_norm(x, ord=2) ** 2 / scalar(n, x) + l2
    step = 1 / lip
    thresh = step * l1
    nn = scalar(n, x)
    w = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    z = w
    for mom in _fista_momenta(max_iter):
        g = x.T @ (x @ z - y) / nn + l2 * z
        w_new = z - step * g
        w_new = torch.sign(w_new) * torch.clamp_min(w_new.abs() - thresh, 0.0)
        z = w_new + mom * (w_new - w)
        w = w_new
    return w


class _EN(_LinearModel):
    def __init__(self, opts: ENOpt, device):
        super().__init__(device)
        self.opts = opts

    def fit(self, x, y):
        xt, yt = f32(x, self.device), f32(y, self.device)
        ym, xm = yt.mean(), xt.mean(0)
        w = en_fista(xt - xm, yt - ym, self.opts.alpha, self.opts.l1_ratio,
                     self.opts.max_iter)
        return self._state(w, ym - xm @ w)


def fit_EN(data, opts: ENOpt = _ENOPT, save_opts: SaveOpt | None = None,
           device=None):
    """Fit an elastic net model."""
    return fit_model(_EN(opts, estimator_device(device)), "Elastic Net", data,
                     save_opts)


@dataclasses.dataclass
class BROpt:
    """Options for the Bayesian ridge regression model."""

    alpha_1: float = 1e-6  # Shape parameter for the Gamma prior over alpha.
    alpha_2: float = 1e-6  # Rate parameter for the Gamma prior over alpha.
    lambda_1: float = 1e-6  # Shape parameter for the Gamma prior over lambda.
    lambda_2: float = 1e-6  # Rate parameter for the Gamma prior over lambda.
    n_iter: int = 300
    tol: float = 1e-3


_BROPT = BROpt()


def br_solve(x: torch.Tensor, y: torch.Tensor, o: BROpt) -> torch.Tensor:
    """Bayesian ridge weights (x, y centred): the evidence iteration on the
    SVD, up to n_iter rounds, stopping when |w - w_old|_1 < tol."""
    n, f = x.shape
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    uty = u.T @ y
    s2 = s * s
    eps = float(np.finfo(np.float32).eps)
    alpha = 1 / (torch.var(y, correction=0) + eps)
    lam = scalar(1.0, x)

    def coef(alpha, lam):
        return vt.T @ ((s / (s2 + lam / alpha)) * uty)

    w_old = torch.zeros(f, dtype=x.dtype, device=x.device)
    for _ in range(o.n_iter):
        w = coef(alpha, lam)
        rss = torch.sum((y - x @ w) ** 2)
        gamma = torch.sum(alpha * s2 / (lam + alpha * s2))
        lam_n = (gamma + 2.0 * o.lambda_1) / (torch.sum(w * w) + 2.0 * o.lambda_2)
        alpha_n = (n - gamma + 2.0 * o.alpha_1) / (rss + 2.0 * o.alpha_2)
        done = bool(torch.sum(torch.abs(w - w_old)) < o.tol)
        alpha, lam, w_old = alpha_n, lam_n, w
        if done:
            break
    return coef(alpha, lam)


class _BR(_LinearModel):
    def __init__(self, opts: BROpt, device):
        super().__init__(device)
        self.opts = opts

    def fit(self, x, y):
        xt, yt = f32(x, self.device), f32(y, self.device)
        xm, ym = xt.mean(0), yt.mean()
        w = br_solve(xt - xm, yt - ym, self.opts)
        return self._state(w, ym - xm @ w)


def fit_BR(data, opts: BROpt = _BROPT, save_opts: SaveOpt | None = None,
           device=None):
    """Fit a Bayesian ridge regression model."""
    return fit_model(_BR(opts, estimator_device(device)), "Bayesian Ridge",
                     data, save_opts)


@dataclasses.dataclass
class SGDOpt:
    """Options for the Stochastic Gradient Descent regression model."""

    alpha: float = 0.001  # Constant that multiplies the regularization term.
    eta0: float = 0.01
    power_t: float = 0.25
    max_epochs: int = 60
    seed: int = 0


_SGDOPT = SGDOpt()


class _SGD(_LinearModel):
    def __init__(self, opts: SGDOpt, device, orders=None):
        super().__init__(device)
        self.opts = opts
        self.orders = orders

    def fit(self, x, y):
        o = self.opts
        orders = self.orders
        if orders is None:
            orders = sgd_orders(o.seed, x.shape[0], o.max_epochs)
        w, b = sgd_fit(f32(x, self.device), f32(y, self.device), orders,
                       o.alpha, o.eta0, o.power_t)
        return self._state(w, b)


def fit_SGD(data, opts: SGDOpt = _SGDOPT, save_opts: SaveOpt | None = None,
            device=None, orders=None):
    """Fit a Stochastic Gradient Descent regressor. ``orders`` (max_epochs,
    N) replaces the seeded per-epoch permutations."""
    return fit_model(_SGD(opts, estimator_device(device), orders),
                     "Stochastic Gradient Descent Regressor", data, save_opts)


@dataclasses.dataclass
class SVROpt:
    """Options for the support vector regression model."""

    C: float = 0.05  # Regularization parameter.
    epsilon: float = 0.05  # Epsilon in the epsilon-SVR model.
    kernel: str = "rbf"  # 'rbf' or 'linear'.
    max_iter: int = 1000
    lr: float = 0.02


_SVROPT = SVROpt()


@dataclasses.dataclass
class LSVROpt:
    """Options for the linear support vector regression model."""

    C: float = 0.005  # Regularization parameter.
    epsilon: float = 0.005  # Epsilon in the epsilon-SVR model.
    max_iter: int = 1000
    lr: float = 0.02


_LSVROPT = LSVROpt()


def _hinge_sign(r: torch.Tensor, epsilon: float) -> torch.Tensor:
    """sign(r) where |r| > epsilon, else 0: the gradient of sum(max(|r| -
    epsilon, 0)) (JAX's maximum gives half at |r| == epsilon exactly)."""
    return torch.where((r.abs() - epsilon) > 0, torch.sign(r), 0.0)


def svr_rbf_fit(k: torch.Tensor, y: torch.Tensor, C: float, epsilon: float,
                lr: float, steps: int):
    """min 0.5 beta'K beta + C sum(max(|y - K beta - b| - eps, 0)) by Adam
    from 0: (beta, b). K is symmetric, so the gradient in beta is
    K (beta + d) with d the hinge's gradient in K beta. The gradient in b,
    a sum of +-C terms, is C times a whole-number sum: exact, so it is 0
    where the terms cancel (a float sum leaves its rounding there, which
    Adam would scale into full steps)."""
    beta = torch.zeros(k.shape[0], dtype=k.dtype, device=k.device)
    b = torch.zeros((), dtype=k.dtype, device=k.device)
    opt = Adam([beta, b], lr)
    for _ in range(steps):
        kb = k @ beta
        s = _hinge_sign(kb + b - y, epsilon)
        opt.step([k @ (beta + C * s), C * s.sum()])
    return beta, b


def svr_linear_fit(x: torch.Tensor, y: torch.Tensor, C: float, epsilon: float,
                   lr: float, steps: int):
    """min 0.5 w'w + C sum(max(|x w + b - y| - eps, 0)) by Adam from 0:
    (w, b); the gradient in b exact, as in ``svr_rbf_fit``."""
    w = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    b = torch.zeros((), dtype=x.dtype, device=x.device)
    opt = Adam([w, b], lr)
    for _ in range(steps):
        s = _hinge_sign(x @ w + b - y, epsilon)
        opt.step([w + x.T @ (C * s), C * s.sum()])
    return w, b


def rbf_kernel(a: torch.Tensor, b: torch.Tensor, gamma: float) -> torch.Tensor:
    sq = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * (a @ b.T)
    return torch.exp(-gamma * torch.clamp_min(sq, 0.0))


class _SVR:
    def __init__(self, opts: SVROpt, device):
        self.opts = opts
        self.device = device

    def fit(self, x, y):
        o = self.opts
        xt, yt = f32(x, self.device), f32(y, self.device)
        if o.kernel == "linear":
            w, b = svr_linear_fit(xt, yt, o.C, o.epsilon, o.lr, o.max_iter)
            return {"kernel": "linear", "w": w.cpu().numpy(), "b": float(b)}
        # sklearn's gamma='scale' = 1 / (n_features * X.var())
        gamma = 1.0 / (x.shape[1] * max(float(np.asarray(x).var()), 1e-12))
        k = rbf_kernel(xt, xt, gamma)
        beta, b = svr_rbf_fit(k, yt, o.C, o.epsilon, o.lr, o.max_iter)
        return {
            "kernel": "rbf",
            "beta": beta.cpu().numpy(),
            "b": float(b),
            "gamma": gamma,
            "x_train": np.asarray(x, np.float32),
        }

    def predict(self, state, x):
        xt = f32(x, self.device)
        b = float(np.float32(state["b"]))
        if state["kernel"] == "linear":
            return xt @ f32(state["w"], self.device) + b
        k = rbf_kernel(xt, f32(state["x_train"], self.device), state["gamma"])
        return k @ f32(state["beta"], self.device) + b


def fit_SVR(data, opts: SVROpt = _SVROPT, save_opts: SaveOpt | None = None,
            device=None):
    """Fit a support vector regression model."""
    return fit_model(_SVR(opts, estimator_device(device)),
                     "Support Vector Regression", data, save_opts)


class _LSVR(_LinearModel):
    def __init__(self, opts: LSVROpt, device):
        super().__init__(device)
        self.opts = opts

    def fit(self, x, y):
        o = self.opts
        w, b = svr_linear_fit(f32(x, self.device), f32(y, self.device), o.C,
                              o.epsilon, o.lr, o.max_iter)
        return self._state(w, b)


def fit_LSVR(data, opts: LSVROpt = _LSVROPT, save_opts: SaveOpt | None = None,
             device=None):
    """Fit a linear support vector regression model."""
    return fit_model(_LSVR(opts, estimator_device(device)),
                     "Linear Support Vector Regression", data, save_opts)


@dataclasses.dataclass
class KNROpt:
    """Options for the K-nearest Neighbors regression model."""

    n_neighbors: int = 500  # Number of neighbors to use.


_KNROPT = KNROpt()


def knr_predict(x_train: torch.Tensor, y_train: torch.Tensor, x: torch.Tensor,
                k: int) -> torch.Tensor:
    """Mean target of each row's k nearest training rows (squared distance;
    ties to the lower index, as ``lax.top_k`` breaks them: a stable sort,
    never ``torch.topk``)."""
    sq = (x * x).sum(1)[:, None] + (x_train * x_train).sum(1)[None, :] \
        - 2.0 * (x @ x_train.T)
    idx = torch.sort(sq, dim=1, stable=True).indices[:, :k]
    return y_train[idx].mean(dim=1)


class _KNR:
    def __init__(self, opts: KNROpt, device):
        self.opts = opts
        self.device = device

    def fit(self, x, y):
        return {"x": np.asarray(x, np.float32), "y": np.asarray(y, np.float32)}

    def predict(self, state, x):
        k = min(self.opts.n_neighbors, len(state["y"]))
        return knr_predict(f32(state["x"], self.device),
                           f32(state["y"], self.device), f32(x, self.device), k)


def fit_KNR(data, opts: KNROpt = _KNROPT, save_opts: SaveOpt | None = None,
            device=None):
    """Fit a K Neighbors Regressor."""
    return fit_model(_KNR(opts, estimator_device(device)),
                     "K Neighbors Regressor", data, save_opts)
