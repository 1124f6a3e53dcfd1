"""Decodability estimators in torch, on any device: what the sklearn
estimators behind ``scrubvae_tpu/evals/metrics.py`` compute, so the port's
decodability runs on the card without sklearn.

- ``r2_score``: sklearn's ``r2_score`` (uniform average over outputs,
  ``force_finite``; nan below 2 samples).
- ``linear_predict``: ``LinearRegression``, ordinary least squares with an
  intercept, the minimum-norm solution on centred data as
  ``scipy.linalg.lstsq`` gives it: singular values at most ``eps *
  largest`` count as zero, with ``eps`` of the input's dtype (sklearn
  solves in the input's dtype, so float32 latents cut at float32's eps).
  Solved through an SVD in float64: ``torch.linalg.lstsq`` on CUDA has only
  the full-rank ``gels`` driver, and latents carry collapsed dims.
- ``logistic_fit`` / ``logistic_predict``: ``LogisticRegression(l1_ratio=0.5,
  C=1, solver="saga")``. sklearn's saga runs 300 epochs from an unseeded
  shuffle, so it is neither deterministic nor always converged; this fits
  the optimum of the same objective,
  ``sum(log loss) + (1/C) * ((1 - l1_ratio) / 2 * |W|^2 + l1_ratio * |W|_1)``
  with an unpenalised intercept, by a deterministic full-batch projected
  Newton method on the orthant of the iterate, in float64. One-vs-rest
  problems are solved side by side; the softmax problem is one problem of
  all classes.
- ``qda_fit`` / ``qda_predict``: ``QuadraticDiscriminantAnalysis`` with its
  ``svd`` solver, its rank test and its exceptions.
- ``lda_fit`` / ``lda_predict``: ``LinearDiscriminantAnalysis`` with its
  ``svd`` solver.
- ``MLPProbe`` / ``train_mlp_probe``: the JAX package's MLP probe
  (``Linear(d,d)-ReLU-Linear(d,d)-ReLU-Linear(d,out)``, torch's default
  U(+-1/sqrt(fan_in)) init, full-batch sum-of-squares loss, AdamW with
  lr 1e-3 and weight decay 0.01), trained in float64: 200 AdamW steps on
  a few dozen rows amplify rounding by orders of magnitude, so in float32
  the card and the CPU land on visibly different R^2 from the same start
  (``chip_smoke.py`` reports by how much on the flagship's validation mu).

Nothing here draws from a global random stream: the probe's initial
weights come from a CPU ``torch.Generator`` of their own.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scrubvae_torch.device import resolve_device

__all__ = [
    "ConvergenceWarning",
    "r2_score",
    "linear_predict",
    "logistic_fit",
    "logistic_objective",
    "logistic_predict",
    "qda_fit",
    "qda_decision",
    "qda_predict",
    "lda_fit",
    "lda_predict",
    "MLPProbe",
    "probe_init",
    "train_mlp_probe",
]

# sklearn's settings behind the JAX package's probes: LogisticRegression's
# C and l1_ratio, the discriminant analyses' rank tolerance ``tol``
C = 1.0
L1_RATIO = 0.5
RANK_TOL = 1e-4
LOGISTIC_TOL = 1e-8
LOGISTIC_MAX_ITER = 500


class ConvergenceWarning(UserWarning):
    """An iterative fit stopped short of its tolerance (as sklearn's
    ``ConvergenceWarning``)."""


def r2_score(y_true: torch.Tensor, y_pred: torch.Tensor) -> float:
    """sklearn's ``r2_score``: per output ``1 - SS_res / SS_tot``, averaged
    uniformly; an output with ``SS_tot == 0`` scores 1.0 when it is also
    predicted exactly, else 0.0; nan for fewer than 2 samples."""
    if y_true.shape[0] < 2:
        warnings.warn("R^2 score is not well-defined with less than two samples.", stacklevel=2)
        return float("nan")
    y = y_true.reshape(y_true.shape[0], -1).double()
    p = y_pred.reshape(y_pred.shape[0], -1).double()
    num = ((y - p) ** 2).sum(0)
    den = ((y - y.mean(0)) ** 2).sum(0)
    scores = torch.ones_like(num)
    valid = (den != 0) & (num != 0)
    scores[valid] = 1.0 - num[valid] / den[valid]
    scores[(num != 0) & (den == 0)] = 0.0
    return float(scores.mean())


# ---------------------------------------------------------------------------
# linear regression
# ---------------------------------------------------------------------------


def linear_predict(z_train: torch.Tensor, y_train: torch.Tensor, z_test: torch.Tensor) -> torch.Tensor:
    """Least-squares fit with an intercept on (z_train, y_train); float64
    predictions for z_test."""
    eps = torch.finfo(z_train.dtype).eps if z_train.is_floating_point() else torch.finfo(torch.float64).eps
    X = z_train.double()
    Y = y_train.double().reshape(X.shape[0], -1)
    x_mean, y_mean = X.mean(0), Y.mean(0)
    U, S, Vh = torch.linalg.svd(X - x_mean, full_matrices=False)
    keep = S > eps * S[0]
    coef = (Vh[keep].T / S[keep]) @ (U[:, keep].T @ (Y - y_mean))
    pred = (z_test.double() - x_mean) @ coef + y_mean
    return pred.reshape(z_test.shape[0], *y_train.shape[1:])


# ---------------------------------------------------------------------------
# elastic-net logistic regression
# ---------------------------------------------------------------------------


def logistic_objective(
    X: torch.Tensor, target: torch.Tensor, W: torch.Tensor, b: torch.Tensor, multinomial: bool = False
) -> torch.Tensor:
    """sklearn's elastic-net logistic objective at (W, b), per binary
    column (shape (K,)) or, for the softmax, as one value (shape (1,)):
    ``sum(log loss) + (1/C) * ((1 - l1_ratio)/2 * |W|^2 + l1_ratio * |W|_1)``.
    X is (n, d), W (d, K), b (K,)."""
    X, target, W, b = X.double(), target.double(), W.double(), b.double()
    logits = X @ W + b
    pen = ((1 - L1_RATIO) / 2 * (W**2).sum(0) + L1_RATIO * W.abs().sum(0)) / C
    if multinomial:
        return (-(target * torch.log_softmax(logits, dim=1)).sum() + pen.sum()).reshape(1)
    return (F.softplus(logits) - target * logits).sum(0) + pen


def _binary_terms(Xt: torch.Tensor, target: torch.Tensor):
    """Mean log loss of K binary problems, one a row of theta (K, d+1):
    its value (K,), gradient (K, d+1) and Hessian (K, d+1, d+1)."""
    n = Xt.shape[0]

    def terms(theta, value_only=False):
        logits = Xt @ theta.T
        val = (F.softplus(logits) - target * logits).sum(0) / n
        if value_only:
            return val
        p = torch.sigmoid(logits)
        grad = (p - target).T @ Xt / n
        hess = torch.einsum("na,nk,nb->kab", Xt, p * (1 - p), Xt) / n
        return val, grad, hess

    return terms


def _softmax_terms(Xt: torch.Tensor, target: torch.Tensor):
    """Mean softmax log loss of one problem whose row of theta (1, K(d+1)-1)
    holds each class's (weights, intercept), the last intercept pinned to 0
    (the loss is blind to a shift of all intercepts, which would leave the
    Hessian singular)."""
    n, m1 = Xt.shape
    K = target.shape[1]
    eye = torch.eye(K, dtype=Xt.dtype, device=Xt.device)

    def terms(theta, value_only=False):
        full = torch.cat([theta[0], theta.new_zeros(1)]).reshape(K, m1)
        logp = torch.log_softmax(Xt @ full.T, dim=1)
        val = (-(target * logp).sum() / n).reshape(1)
        if value_only:
            return val
        p = logp.exp()
        grad = ((p - target).T @ Xt / n).reshape(1, -1)[:, :-1]
        w = p[:, :, None] * (eye - p[:, None, :])
        hess = torch.einsum("nkl,na,nb->kalb", w, Xt, Xt).reshape(K * m1, K * m1) / n
        return val, grad, hess[None, :-1, :-1]

    return terms


def _orthant_newton(terms, theta, pen, alpha, beta, tol, max_iter):
    """Minimise, row by row of theta (P, m), ``terms(theta)``'s smooth value
    plus ``alpha / 2 * |pen * theta|^2 + beta * |pen * theta|_1`` (``pen``:
    1 on the penalised coordinates, 0 on the intercepts).

    A two-metric projected Newton method on the orthant of the iterate
    (Gafni and Bertsekas; Andrew and Gao's OWL-QN for the orthant and the
    pseudo-gradient): the coordinates at zero, and those within ``eps`` of
    it moving towards it, take a diagonally scaled pseudo-gradient step,
    the others a Newton step; the step is projected onto the orthant
    (coordinates that would change sign stop at zero) and backtracked to
    Armijo's condition on the true objective. A row has converged when its
    pseudo-gradient (the least-norm subgradient) is at most ``tol`` in
    every coordinate, or when the decrease its Newton step predicts,
    ``-pg . step``, is below what float64 resolves in the objective
    (1e-15 of it): on latents far from isotropic a pseudo-gradient of 1e-8
    along a stiff direction is worth less than one rounding of the
    objective. A row whose line search finds no decrease or no move stops
    unconverged. Returns (theta, iterations, unconverged rows)."""
    P, m = theta.shape
    eye = torch.eye(m, dtype=theta.dtype, device=theta.device)
    pen_on = pen > 0
    bp = beta * pen

    def objective(val, th):
        return val + 0.5 * alpha * ((pen * th) ** 2).sum(1) + beta * (pen * th).abs().sum(1)

    active = torch.ones(P, dtype=torch.bool, device=theta.device)
    converged = torch.zeros_like(active)
    zero = torch.zeros_like(theta)
    it = 0
    for it in range(1, max_iter + 1):
        val, grad, hess = terms(theta)
        grad = grad + alpha * pen * theta
        hess = hess + alpha * torch.diag(pen)
        pg = torch.where(
            theta != 0, grad + bp * torch.sign(theta),
            torch.where(grad + bp < 0, grad + bp, torch.where(grad - bp > 0, grad - bp, zero)),
        )
        resid = pg.abs().amax(1)
        orthant = torch.where(theta != 0, torch.sign(theta), -torch.sign(pg))
        eps = torch.clamp(resid, max=1e-4)[:, None]
        scaled = pen_on & ((theta == 0) | ((theta.abs() <= eps) & (pg * theta > 0)))
        newton = ~scaled
        h_n = torch.where(newton[:, :, None] & newton[:, None, :], hess, eye)
        step = torch.where(
            newton, -torch.linalg.solve(h_n, torch.where(newton, pg, zero)),
            -pg / hess.diagonal(dim1=1, dim2=2),
        )
        f0 = objective(val, theta)
        done = active & ((resid <= tol) | (-(pg * step).sum(1) <= 1e-15 * f0.abs()))
        converged = converged | done
        active = active & ~done
        if not bool(active.any()):
            break
        t = torch.ones(P, dtype=theta.dtype, device=theta.device)
        todo = active.clone()
        new = theta
        for _ in range(50):
            cand = theta + t[:, None] * step
            cand = torch.where(pen_on & (cand * orthant < 0), zero, cand)
            ok = todo & (
                objective(terms(cand, value_only=True), cand) <= f0 + 1e-4 * (pg * (cand - theta)).sum(1)
            )
            new = torch.where(ok[:, None], cand, new)
            todo = todo & ~ok
            if not bool(todo.any()):
                break
            t = torch.where(todo, 0.5 * t, t)
        active = active & ~todo & (new != theta).any(1)
        theta = new
        if not bool(active.any()):
            break
    return theta, it, ~converged


def logistic_fit(
    X: torch.Tensor, target: torch.Tensor, multinomial: bool = False, max_iter: int = LOGISTIC_MAX_ITER
):
    """Minimise ``logistic_objective`` over (W, b) in float64.

    ``target`` (n, K) holds K binary problems (0/1 columns) solved side by
    side, or, with ``multinomial``, the one-hot classes of one softmax
    problem. The features are centred (the intercept is unpenalised, so
    this changes the intercept only) and the objective divided by n; the
    solver is ``_orthant_newton``, to a least-norm subgradient of at most
    ``LOGISTIC_TOL`` or the float64 floor of the objective. Latents are
    far from isotropic (``chip_smoke.py`` reports the ratio of the largest
    to the smallest singular value of a flagship classification fold, and
    the iterations this takes on it); a first-order method pays for that
    in iterations by the thousand. When a problem stops short (the
    iteration cap, or a step that finds no decrease) it warns with
    ``ConvergenceWarning``. Returns (W (d, K), b (K,), iterations)."""
    X = X.double()
    target = target.double()
    n, d = X.shape
    K = target.shape[1]
    x_mean = X.mean(0)
    Xt = torch.cat([X - x_mean, X.new_ones(n, 1)], dim=1)
    alpha = (1.0 - L1_RATIO) / (C * n)
    beta = L1_RATIO / (C * n)
    pen = torch.cat([X.new_ones(d), X.new_zeros(1)])
    if multinomial:
        terms = _softmax_terms(Xt, target)
        pen = pen.repeat(K)[:-1]
        theta = X.new_zeros(1, K * (d + 1) - 1)
    else:
        terms = _binary_terms(Xt, target)
        theta = X.new_zeros(K, d + 1)
    theta, iters, unconverged = _orthant_newton(terms, theta, pen, alpha, beta, LOGISTIC_TOL, max_iter)
    if bool(unconverged.any()):
        warnings.warn(
            f"logistic_fit: {int(unconverged.sum())} of {len(unconverged)} problems stopped after "
            f"{iters} iterations above tol {LOGISTIC_TOL}, which means the coefficients did not converge",
            ConvergenceWarning,
            stacklevel=2,
        )
    if multinomial:
        theta = torch.cat([theta[0], theta.new_zeros(1)]).reshape(K, d + 1)
    W = theta[:, :d].T
    return W, theta[:, d] - x_mean @ W, iters


def logistic_predict(
    z_train: torch.Tensor, y_train: torch.Tensor, z_test: torch.Tensor, multi_class: str = "ovr"
) -> torch.Tensor:
    """Fit and predict as ``LogisticRegression(l1_ratio=0.5,
    penalty="elasticnet")`` does: the binary fit for 2 classes, one-vs-rest
    over more (``OneVsRestClassifier``), or the softmax fit with
    ``multi_class="multinomial"``. Raises ``ValueError`` for a single
    class, as sklearn's solvers do."""
    y = y_train.reshape(-1)
    classes, inv = torch.unique(y, return_inverse=True)
    K = classes.numel()
    if K < 2:
        raise ValueError(
            "This solver needs samples of at least 2 classes in the data, but the data "
            f"contains only one class: {classes[0].item()}"
        )
    onehot = F.one_hot(inv, K).double()
    X = z_train.double()
    Xt = z_test.double()
    if K == 2:
        W, b, _ = logistic_fit(X, onehot[:, 1:])
        return classes[((Xt @ W + b)[:, 0] > 0).long()]
    W, b, _ = logistic_fit(X, onehot, multinomial=multi_class == "multinomial")
    return classes[torch.argmax(Xt @ W + b, dim=1)]


# ---------------------------------------------------------------------------
# discriminant analysis
# ---------------------------------------------------------------------------


def qda_fit(X: torch.Tensor, y: torch.Tensor, reg_param: float = 0.0) -> dict:
    """``QuadraticDiscriminantAnalysis(reg_param).fit`` with the svd
    solver, in float64: per class the mean and the SVD of the centred data,
    scalings ``S^2 / (n_c - 1)`` blended with ``reg_param``, priors from
    class frequencies. Raises as sklearn does: ``ValueError`` for fewer
    than 2 classes or a class of one sample, ``np.linalg.LinAlgError`` (a
    ``ValueError``) with "not full rank" when a class's scalings above
    ``RANK_TOL`` number fewer than the features."""
    X = X.double()
    y = y.reshape(-1)
    n, d = X.shape
    classes, inv, counts = torch.unique(y, return_inverse=True, return_counts=True)
    if classes.numel() < 2:
        raise ValueError(f"The number of classes has to be greater than one. Got {classes.numel()} class.")
    means, scalings, rotations = [], [], []
    for c in range(classes.numel()):
        Xk = X[inv == c]
        label = classes[c].item()
        if Xk.shape[0] == 1:
            raise ValueError(f"y has only 1 sample in class {label}, covariance is ill defined.")
        mean = Xk.mean(0)
        _, S, Vh = torch.linalg.svd(Xk - mean, full_matrices=False)
        scaling = (1 - reg_param) * (S**2 / (Xk.shape[0] - 1)) + reg_param
        rank = int((scaling > RANK_TOL).sum())
        if rank < d:
            if Xk.shape[0] <= d:
                raise np.linalg.LinAlgError(
                    f"The covariance matrix of class {label} is not full rank. When using "
                    f"`solver='svd'` the number of samples in each class should be more than the "
                    f"number of features, but class {label} has {Xk.shape[0]} samples and {d} "
                    "features. Try using `solver='eigen'` and setting the parameter `shrinkage` "
                    "for regularization."
                )
            raise np.linalg.LinAlgError(
                f"The covariance matrix of class {label} is not full rank. Increase the value "
                "of `reg_param` to reduce the collinearity."
            )
        means.append(mean)
        scalings.append(scaling)
        rotations.append(Vh.T)
    return {
        "classes": classes, "priors": counts.double() / n, "means": means,
        "scalings": scalings, "rotations": rotations,
    }


def qda_decision(fit: dict, X: torch.Tensor) -> torch.Tensor:
    """The log posterior of each class up to a constant, (n, classes)."""
    X = X.double()
    cols = []
    for mean, S, R in zip(fit["means"], fit["scalings"], fit["rotations"]):
        X2 = (X - mean) @ (R * S.rsqrt())
        cols.append(-0.5 * ((X2**2).sum(1) + torch.log(S).sum()))
    return torch.stack(cols, 1) + torch.log(fit["priors"])


def qda_predict(fit: dict, X: torch.Tensor) -> torch.Tensor:
    return fit["classes"][torch.argmax(qda_decision(fit, X), dim=1)]


def lda_fit(X: torch.Tensor, y: torch.Tensor) -> dict:
    """``LinearDiscriminantAnalysis().fit`` with the svd solver, in
    float64 (sklearn's ``_solve_svd``, then the binary reduction)."""
    X = X.double()
    y = y.reshape(-1)
    n, d = X.shape
    if n < 2:
        raise ValueError(f"Found array with {n} sample(s) while a minimum of 2 is required.")
    classes, inv, counts = torch.unique(y, return_inverse=True, return_counts=True)
    K = classes.numel()
    if n == K:
        raise ValueError("The number of samples must be more than the number of classes.")
    priors = counts.double() / n
    means = torch.zeros(K, d, dtype=torch.float64, device=X.device).index_add_(0, inv, X) / counts[:, None]
    Xc = X - means[inv]
    xbar = priors @ means
    std = Xc.std(0, unbiased=False)
    std = torch.where(std == 0, torch.ones_like(std), std)
    Xw = math.sqrt(1.0 / (n - K)) * (Xc / std)
    _, S, Vh = torch.linalg.svd(Xw, full_matrices=False)
    rank = int((S > RANK_TOL).sum())
    scalings = (Vh[:rank] / std).T / S[:rank]
    fac = 1.0 if K == 1 else 1.0 / (K - 1)
    Xb = (torch.sqrt(n * priors * fac) * (means - xbar).T).T @ scalings
    _, S, Vh = torch.linalg.svd(Xb, full_matrices=False)
    rank = int((S > RANK_TOL * S[0]).sum()) if S.numel() else 0
    scalings = scalings @ Vh.T[:, :rank]
    coef = (means - xbar) @ scalings
    intercept = -0.5 * (coef**2).sum(1) + torch.log(priors)
    coef = coef @ scalings.T
    intercept = intercept - xbar @ coef.T
    if K == 2:
        coef, intercept = (coef[1] - coef[0])[None], (intercept[1] - intercept[0]).reshape(1)
    return {"classes": classes, "coef": coef, "intercept": intercept}


def lda_predict(fit: dict, X: torch.Tensor) -> torch.Tensor:
    scores = X.double() @ fit["coef"].T + fit["intercept"]
    if scores.shape[1] == 1:
        return fit["classes"][(scores[:, 0] > 0).long()]
    return fit["classes"][torch.argmax(scores, dim=1)]


# ---------------------------------------------------------------------------
# MLP regression probe
# ---------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    return x.detach().float() if torch.is_tensor(x) else torch.from_numpy(np.array(x, dtype=np.float32))


class MLPProbe(nn.Module):
    """``Linear(d,d)-ReLU-Linear(d,d)-ReLU-Linear(d,out)`` in float64 (the
    JAX package's ``models/scrubbers.py`` ``MLP``); its layers are built
    without drawing from torch's global random stream and take their
    values from ``init``: three (weight (out, in), bias (out,)) pairs,
    rounded to float32 as the JAX probe's draws are."""

    def __init__(self, init: Sequence, device=None):
        super().__init__()
        device = resolve_device(device)
        self.layers = nn.ModuleList()
        for w, bias in init:
            w, bias = _f32(w), _f32(bias)
            lin = torch.nn.utils.skip_init(nn.Linear, w.shape[1], w.shape[0], device=device, dtype=torch.float64)
            with torch.no_grad():
                lin.weight.copy_(w)
                lin.bias.copy_(bias)
            self.layers.append(lin)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.layers[0](z))
        h = torch.relu(self.layers[1](h))
        return self.layers[2](h)


def probe_init(d: int, out_dim: int, seed: int = 0) -> list:
    """torch ``nn.Linear``'s default init, weight and bias both
    U(+-1/sqrt(fan_in)) in float32, drawn from a CPU generator seeded with
    ``seed`` (CUDA and CPU generators give different streams for one
    seed, and the card and the CPU must start alike)."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for fan_in, fan_out in ((d, d), (d, d), (d, out_dim)):
        bound = 1.0 / math.sqrt(fan_in)
        w = (torch.rand(fan_out, fan_in, generator=gen) * 2 - 1) * bound
        bias = (torch.rand(fan_out, generator=gen) * 2 - 1) * bound
        out.append((w, bias))
    return out


def train_mlp_probe(
    z, y, num_epochs: int = 200, lr: float = 1e-3, seed: int = 0, init: Optional[Sequence] = None, device=None
):
    """Fit the MLP probe full-batch on (z, y) in float64 with
    ``torch.optim.AdamW(lr, weight_decay=0.01)`` for ``num_epochs`` steps
    of the summed squared error, from ``init`` (three (weight, bias)
    pairs) or ``probe_init(d, out, seed)``; returns a function of z giving
    float64 predictions on ``device``."""
    dev = resolve_device(device)
    z = torch.as_tensor(z, device=dev).double()
    y = torch.as_tensor(y, device=dev).double()
    model = MLPProbe(init if init is not None else probe_init(z.shape[-1], y.shape[-1], seed), device=dev)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=0.01)
    with torch.enable_grad():
        for _ in range(num_epochs):
            opt.zero_grad(set_to_none=True)
            ((model(z) - y) ** 2).sum().backward()
            opt.step()
    model.eval()

    @torch.no_grad()
    def predict(x):
        return model(torch.as_tensor(x, device=dev).double())

    return predict
