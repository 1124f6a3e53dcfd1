"""Scrubbers (counterpart of the gradient-reversal, MLP-ensemble,
linear-projection, polynomial-expansion, moving-average-least-squares,
recursive-least-squares, moving-average class-mean, QDA, adversarial-net
and MCMI parts of ``scrubvae_tpu/models/scrubbers.py``; no loss reads the
recursive least squares, as in the JAX package).

Trainable heads are ``nn.Module``s inside the model, so the one outer
optimizer covers them. The streaming scrubbers keep explicit state:
``mals_loss``, ``ma_loss`` and ``qda_loss`` return the state with its
forgetting factors tuned, and ``mals_update``, ``ma_update`` and
``qda_update`` accumulate their statistics after the optimizer step. The
adversarial discriminator (``AdvNet``) is a module of its own, outside the
model, trained by ``adv_fit`` with its own AdamW; MCMI's kernel estimator (``MIState``) is rebuilt by ``mi_init``.

Every shuffle of the adversarial scrubber takes its permutation as an
argument; the callers draw it from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scrubvae_torch.device import device_constant, trace_safe_cache
from scrubvae_torch.models.layers import Linear, lecun_normal_
from scrubvae_torch.ops.smallsolve import factor_logdet, spd_factor, spd_solve

__all__ = [
    "grad_reverse",
    "MLPEnsemble",
    "LinearProjection",
    "GRScrubber",
    "polynomial_indices",
    "polynomial_expand",
    "poly_dim",
    "MALSState",
    "mals_init",
    "mals_forward",
    "mals_loss",
    "mals_update",
    "RLSState",
    "rls_init",
    "rls_forward",
    "rls_update",
    "MAFilterState",
    "ma_init",
    "ma_loss",
    "ma_update",
    "QDAState",
    "qda_init",
    "qda_loss",
    "qda_update",
    "AdvNet",
    "AdvState",
    "adv_shuffle",
    "adv_fit",
    "adv_generator_loss",
    "MIState",
    "mi_init",
    "mi_score",
]


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def grad_reverse(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Identity forward; gradient multiplied by -alpha backward."""
    return _GradReverse.apply(x, alpha)


class MLPEnsemble(nn.Module):
    """Four differently shaped ReLU MLP heads z -> out_dim; returns their
    outputs as a list."""

    def __init__(self, z_dim: int, out_dim: int):
        super().__init__()
        d = z_dim
        self.mlp1_0, self.mlp1_1, self.mlp1_2 = Linear(d, d), Linear(d, d), Linear(d, out_dim)
        self.mlp2_0, self.mlp2_1 = Linear(d, d), Linear(d, out_dim)
        self.mlp3_0, self.mlp3_1, self.mlp3_2 = Linear(d, d), Linear(d, d // 2), Linear(d // 2, out_dim)
        self.mlp4_0, self.mlp4_1, self.mlp4_2 = Linear(d, 2 * d), Linear(2 * d, 2 * d), Linear(2 * d, out_dim)

    def forward(self, z: torch.Tensor) -> list:
        a = self.mlp1_2(F.relu(self.mlp1_1(F.relu(self.mlp1_0(z)))))
        b = self.mlp2_1(F.relu(self.mlp2_0(z)))
        c = self.mlp3_2(F.relu(self.mlp3_1(F.relu(self.mlp3_0(z)))))
        e = self.mlp4_2(F.relu(self.mlp4_1(F.relu(self.mlp4_0(z)))))
        return [a, b, c, e]


class LinearProjection(nn.Module):
    """Trainable linear decoder z -> v plus the projection of z onto the
    null space of the decoder's rows."""

    def __init__(self, z_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, z_dim))
        # flax lecun_normal on an (out_dim, z_dim) kernel: fan_in = out_dim
        lecun_normal_(self.weight, out_dim, None)

    def forward(self, z: torch.Tensor) -> dict:
        w = self.weight
        v = z @ w.T
        z_null = z - spd_solve(w @ w.T, v.T).T @ w
        return {"v": v, "z_null": z_null}


class GRScrubber(nn.Module):
    """Gradient reversal -> MLP ensemble."""

    def __init__(self, z_dim: int, out_dim: int, alpha: float = 1.0):
        super().__init__()
        self.alpha = alpha
        self.ensemble = MLPEnsemble(z_dim, out_dim)

    def forward(self, z: torch.Tensor) -> list:
        return self.ensemble(grad_reverse(z, self.alpha))


@trace_safe_cache
def polynomial_indices(nx: int, order: int) -> tuple:
    """The index combinations (with replacement) of each degree 2..order,
    one (n_combos, degree) array per degree."""
    return tuple(
        torch.tensor(list(itertools.combinations_with_replacement(range(nx), deg)), dtype=torch.long)
        for deg in range(2, order + 1)
    )


@trace_safe_cache
def _polynomial_indices_on(nx: int, order: int, device: torch.device) -> tuple:
    return tuple(device_constant(idx, device) for idx in polynomial_indices(nx, order))


def polynomial_expand(x: torch.Tensor, order: int) -> torch.Tensor:
    """x (B, nx) and its monomials of degree 2..order, each degree's block
    scaled by nx over its number of monomials."""
    if order <= 1:
        return x
    nx = x.shape[-1]
    feats = [x]
    for idx in _polynomial_indices_on(nx, order, x.device):
        # the factors multiplied in turn: torch.prod's backward asks the
        # host whether a factor is zero, which a CUDA graph cannot capture
        cols = x[:, idx]
        mono = cols[..., 0]
        for j in range(1, idx.shape[1]):
            mono = mono * cols[..., j]
        feats.append(mono / idx.shape[0] * nx)
    return torch.cat(feats, dim=-1)


def poly_dim(nx: int, order: int) -> int:
    """Width of ``polynomial_expand``'s output: the monomials of degree
    1..order in nx variables."""
    return sum(math.comb(nx + deg - 1, deg) for deg in range(1, order + 1))


@dataclasses.dataclass
class MALSState:
    """Two exponentially forgotten normal-equation systems (forgetting
    factors lam0 < lam1) and their static settings."""

    Sxx0: torch.Tensor
    Sxy0: torch.Tensor
    Sxx1: torch.Tensor
    Sxy1: torch.Tensor
    lam0: torch.Tensor
    lam1: torch.Tensor
    bias: bool = False
    polynomial_order: int = 1
    l2_reg: float = 0.0
    lamdiff: float = 1e-1
    delta: float = 1e-4

    def replace(self, **kw) -> "MALSState":
        return dataclasses.replace(self, **kw)


def mals_init(
    nx: int,
    ny: int,
    lamdiff: float = 1e-1,
    delta: float = 1e-4,
    bias: bool = False,
    polynomial_order: int = 1,
    l2_reg: float = 0.0,
    device=None,
) -> MALSState:
    n = poly_dim(nx, polynomial_order) + int(bias)
    f32 = dict(dtype=torch.float32, device=device)
    return MALSState(
        Sxx0=torch.eye(n, **f32),
        Sxy0=torch.zeros((n, ny), **f32),
        Sxx1=torch.eye(n, **f32),
        Sxy1=torch.zeros((n, ny), **f32),
        lam0=torch.tensor(0.9, **f32),
        lam1=torch.tensor(0.9 + lamdiff, **f32),
        bias=bias,
        polynomial_order=polynomial_order,
        l2_reg=float(l2_reg or 0.0),
        lamdiff=lamdiff,
        delta=delta,
    )


def _mals_features(state: MALSState, x: torch.Tensor) -> torch.Tensor:
    x = polynomial_expand(x, state.polynomial_order)
    if state.bias:
        x = torch.cat([x, x.new_ones(x.shape[0], 1)], dim=-1)
    return x


def mals_forward(state: MALSState, x: torch.Tensor):
    """Solve both normal-equation decoders and predict y with each."""
    x = _mals_features(state, x)
    l2 = torch.full((x.shape[1],), state.l2_reg, dtype=x.dtype, device=x.device)
    if state.bias:
        l2[-1:].fill_(0.0)  # a fill on the device: an indexed store of a float would copy it from the host
    reg = torch.diag(l2)
    # both systems in one batched factor and solve
    W0, W1 = spd_solve(torch.stack([state.Sxx0 + reg, state.Sxx1 + reg]), torch.stack([state.Sxy0, state.Sxy1]))
    return x @ W0, x @ W1


def mals_loss(state: MALSState, yhat0: torch.Tensor, yhat1: torch.Tensor, y: torch.Tensor):
    """Sum-MSE of the two decoders; moves both forgetting factors toward the
    better one. Returns (loss, new_state)."""
    l0 = torch.sum((y - yhat0) ** 2)
    l1 = torch.sum((y - yhat1) ** 2)
    better0 = (l0 < l1).detach()
    down = torch.clamp(state.lam0 - state.delta, 0.0, 1.0)
    up = torch.clamp(state.lam1 + state.delta, 0.0, 1.0)
    lam0 = torch.where(better0, down, up - state.lamdiff)
    lam1 = torch.where(better0, down + state.lamdiff, up)
    return 0.5 * (l0 + l1), state.replace(lam0=lam0, lam1=lam1)


@torch.no_grad()
def mals_update(state: MALSState, x: torch.Tensor, y: torch.Tensor) -> MALSState:
    """Forget and accumulate the normal equations with this batch."""
    x = _mals_features(state, x.detach())
    y = y.detach()
    xx = x.T @ x
    xy = x.T @ y
    return state.replace(
        Sxx0=state.lam0 * state.Sxx0 + xx,
        Sxy0=state.lam0 * state.Sxy0 + xy,
        Sxx1=state.lam1 * state.Sxx1 + xx,
        Sxy1=state.lam1 * state.Sxy1 + xy,
    )


# ---------------------------------------------------------------------------
# Recursive least squares
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RLSState:
    """The recursive least-squares decoder ``theta`` (n, ny), its inverse
    correlation ``P`` (n, n), the forgetting factor and static settings."""

    theta: torch.Tensor
    P: torch.Tensor
    lam: torch.Tensor
    bias: bool = False
    polynomial_order: int = 1

    def replace(self, **kw) -> "RLSState":
        return dataclasses.replace(self, **kw)


def rls_init(nx: int, ny: int, bias: bool = False, polynomial_order: int = 1, device=None) -> RLSState:
    n = poly_dim(nx, polynomial_order) + int(bias)
    f32 = dict(dtype=torch.float32, device=device)
    return RLSState(
        theta=torch.zeros((n, ny), **f32),
        P=torch.eye(n, **f32),
        lam=torch.tensor(0.9, **f32),
        bias=bias,
        polynomial_order=polynomial_order,
    )


def _rls_features(state: RLSState, x: torch.Tensor) -> torch.Tensor:
    x = polynomial_expand(x, state.polynomial_order)
    if state.bias:
        x = torch.cat([x, x.new_ones(x.shape[0], 1)], dim=-1)
    return x


def rls_forward(state: RLSState, x: torch.Tensor) -> torch.Tensor:
    return _rls_features(state, x) @ state.theta


@torch.no_grad()
def rls_update(state: RLSState, x: torch.Tensor, y: torch.Tensor) -> RLSState:
    """One batch of the forgetting RLS recursion: P <- (P - P x^T (x P
    x^T + lam I)^-1 x P) / lam, theta <- theta + P x^T (y - x theta)."""
    x = _rls_features(state, x.detach())
    y = y.detach()
    A = x @ state.P @ x.T
    A = A + state.lam * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    # pivoted LU, not ``spd_solve``: P loses positive definiteness in f32
    # over long runs, which a Cholesky factor would not survive
    P = state.P - state.P @ x.T @ torch.linalg.solve(A, x @ state.P)
    P = P / state.lam
    theta = state.theta + P @ x.T @ (y - x @ state.theta)
    return state.replace(P=P, theta=theta)


# ---------------------------------------------------------------------------
# Moving-average per-class mean filter
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MAFilterState:
    """Two exponentially forgotten estimates of each class's mean latent
    (forgetting factors lam1 < lam2 per class) and their static settings."""

    classes: torch.Tensor  # (C,) class label values
    m1: torch.Tensor  # (C, nx)
    m2: torch.Tensor
    lam1: torch.Tensor  # (C,)
    lam2: torch.Tensor
    lamdiff: float = 1e-2
    delta: float = 1e-3

    def replace(self, **kw) -> "MAFilterState":
        return dataclasses.replace(self, **kw)


def ma_init(nx: int, classes, lamdiff: float = 1e-2, delta: float = 1e-3, device=None) -> MAFilterState:
    classes = torch.as_tensor(classes, device=device)
    C = classes.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    return MAFilterState(
        classes=classes,
        m1=torch.zeros((C, nx), **f32),
        m2=torch.zeros((C, nx), **f32),
        lam1=torch.full((C,), 0.5, **f32),
        lam2=torch.full((C,), 0.5 + lamdiff, **f32),
        lamdiff=lamdiff,
        delta=delta,
    )


def _class_means(x: torch.Tensor, y: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """Per-class batch means (C, nx); a class absent from the batch gets 0."""
    mask = (y.reshape(1, -1) == classes.reshape(-1, 1)).to(x.dtype)  # (C, B)
    counts = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    return (mask @ x) / counts


def ma_loss(state: MAFilterState, x: torch.Tensor, y: torch.Tensor):
    """Distance between the estimated class means (every pair); moves each
    class's forgetting factors toward the estimate nearer this batch's
    mean. Returns (loss, new_state). The norm is smoothed, sqrt(sum + 1e-12):
    a plain norm's gradient is nan where the class means coincide, as the
    zero means do at step 1."""
    xbar = _class_means(x, y, state.classes)
    m1, m2 = state.m1.detach(), state.m2.detach()
    closer1 = torch.linalg.vector_norm(xbar - m1, dim=-1) < torch.linalg.vector_norm(xbar - m2, dim=-1)
    down = torch.clamp(state.lam1 - state.delta, 0.0, 1.0)
    up = torch.clamp(state.lam2 + state.delta, 0.0, 1.0)
    lam1 = torch.where(closer1, down, up - state.lamdiff)
    lam2 = torch.where(closer1, down + state.lamdiff, up)
    m1 = (1 - lam1[:, None]) * xbar + lam1[:, None] * m1
    m2 = (1 - lam2[:, None]) * xbar + lam2[:, None] * m2
    mean_est = 0.5 * (m1 + m2)
    diff = mean_est.T[..., None] - mean_est.T[..., None, :]  # (nx, C, C)
    triu = torch.triu(diff, diagonal=1)
    loss = torch.sqrt(torch.sum(triu * triu) + 1e-12)
    return loss, state.replace(lam1=lam1, lam2=lam2)


@torch.no_grad()
def ma_update(state: MAFilterState, x: torch.Tensor, y: torch.Tensor) -> MAFilterState:
    """Forget and accumulate both class-mean estimates with this batch."""
    xbar = _class_means(x.detach(), y, state.classes)
    return state.replace(
        m1=(1 - state.lam1[:, None]) * xbar + state.lam1[:, None] * state.m1,
        m2=(1 - state.lam2[:, None]) * xbar + state.lam2[:, None] * state.m2,
    )


# ---------------------------------------------------------------------------
# Quadratic discriminant filter
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QDAState:
    """Per class c, two streaming Gaussian models of the latent, in the
    class (``m1*``, ``S1*``) and out of it (``m0*``, ``S0*``), each kept at
    two forgetting factors (``a``: ``lama``, ``b``: ``lamb``, ``lamdiff``
    apart); ``lama`` is the weight of the new batch."""

    classes: torch.Tensor  # (C,) class label values
    m0a: torch.Tensor  # (C, D)
    m1a: torch.Tensor
    m0b: torch.Tensor
    m1b: torch.Tensor
    S0a: torch.Tensor  # (C, D, D)
    S1a: torch.Tensor
    S0b: torch.Tensor
    S1b: torch.Tensor
    lama: torch.Tensor  # (C,)
    lamb: torch.Tensor
    lamdiff: float = 1e-2
    delta: float = 1e-3

    def replace(self, **kw) -> "QDAState":
        return dataclasses.replace(self, **kw)


def qda_init(nx: int, classes, lamdiff: float = 1e-2, delta: float = 1e-3, device=None) -> QDAState:
    """Means at 0, covariances at the identity, a distinct buffer per field."""
    classes = torch.as_tensor(classes, device=device)
    C = classes.shape[0]
    f32 = dict(dtype=torch.float32, device=device)

    def eye():
        return torch.eye(nx, **f32).repeat(C, 1, 1)

    def zeros():
        return torch.zeros((C, nx), **f32)

    return QDAState(
        classes=classes,
        m0a=zeros(), m1a=zeros(), m0b=zeros(), m1b=zeros(),
        S0a=eye(), S1a=eye(), S0b=eye(), S1b=eye(),
        lama=torch.full((C,), 0.2, **f32),
        lamb=torch.full((C,), 0.2 + lamdiff, **f32),
        lamdiff=lamdiff,
        delta=delta,
    )


def _cgll(x: torch.Tensor, m: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Gaussian log-likelihood up to constants of every sample under every
    model: x (B, D), m (K, D), S (K, D, D) -> (K, B). One Cholesky factor
    L of each S gives both terms: the Mahalanobis term ||L^-1 (x - m)||^2
    from one triangular solve, and log det S."""
    L = spd_factor(S)
    diff = x[None, :, :] - m[:, None, :]  # (K, B, D)
    half = torch.linalg.solve_triangular(L, diff.transpose(-1, -2), upper=False)  # (K, D, B)
    return -0.5 * (factor_logdet(L)[:, None] + (half * half).sum(-2))


def _masked_moments(x: torch.Tensor, mask: torch.Tensor):
    """Masked means and covariances (correction 0) of ``x`` (B, D) under
    each row of ``mask`` (C, B): (C, D) and (C, D, D); the count is clamped
    at 1."""
    cnt = torch.clamp(mask.sum(-1), min=1.0)[:, None]  # (C, 1)
    mean = (mask[:, :, None] * x).sum(1) / cnt
    centered = (x[None] - mean[:, None, :]) * mask[:, :, None]  # (C, B, D)
    cov = centered.transpose(-1, -2) @ centered / cnt[:, :, None]
    return mean, cov


def _class_mask(state: QDAState, y: torch.Tensor, dtype) -> torch.Tensor:
    return (y.reshape(-1)[None, :] == state.classes[:, None]).to(dtype)  # (C, B)


def qda_loss(state: QDAState, x: torch.Tensor, y: torch.Tensor):
    """Label-weighted log-likelihood ratio of the two streaming QDA
    classifiers, over the classes; the forgetting factors move toward the
    model that fits this batch better. The streaming moments are detached.
    Returns (loss, new_state)."""
    i1 = _class_mask(state, y, x.dtype)
    i0 = 1.0 - i1
    # the four models of every class as one batch of 4C: one factor, one solve
    m = torch.cat([state.m0a, state.m1a, state.m0b, state.m1b]).detach()
    S = torch.cat([state.S0a, state.S1a, state.S0b, state.S1b]).detach()
    lla0, lla1, llb0, llb1 = _cgll(x, m, S).split(state.classes.shape[0])

    batch_y = i1 * 2.0 - 1.0
    llra = torch.einsum("cb,cb->c", batch_y, lla1 - lla0)
    llrb = torch.einsum("cb,cb->c", batch_y, llb1 - llb0)
    loss = torch.sum((llra + llrb) * 0.5) / state.classes.shape[0]

    with torch.no_grad():
        lla = torch.sum(i0 * lla0 + i1 * lla1, dim=1)  # (C,)
        llb = torch.sum(i0 * llb0 + i1 * llb1, dim=1)
        a_better = lla > llb
        down = torch.clamp(state.lama - state.delta, 0.0, 1.0)
        up = torch.clamp(state.lamb + state.delta, 0.0, 1.0)
        state = state.replace(
            lama=torch.where(a_better, down, up - state.lamdiff),
            lamb=torch.where(a_better, down + state.lamdiff, up),
        )
    return loss, state


@torch.no_grad()
def qda_update(state: QDAState, x: torch.Tensor, y: torch.Tensor) -> QDAState:
    """EMA of the per-class masked moments of this batch (weight ``lama`` /
    ``lamb`` on the batch), all classes in one batched computation."""
    x = x.detach()
    i1 = _class_mask(state, y, x.dtype)
    x1m, x1S = _masked_moments(x, i1)
    x0m, x0S = _masked_moments(x, 1.0 - i1)
    la, lb = state.lama[:, None], state.lamb[:, None]
    laS, lbS = state.lama[:, None, None], state.lamb[:, None, None]
    return state.replace(
        m0a=(1 - la) * state.m0a + la * x0m,
        m1a=(1 - la) * state.m1a + la * x1m,
        S0a=(1 - laS) * state.S0a + laS * x0S,
        S1a=(1 - laS) * state.S1a + laS * x1S,
        m0b=(1 - lb) * state.m0b + lb * x0m,
        m1b=(1 - lb) * state.m1b + lb * x1m,
        S0b=(1 - lbS) * state.S0b + lbS * x0S,
        S1b=(1 - lbS) * state.S1b + lbS * x1S,
    )


# ---------------------------------------------------------------------------
# Adversarial discriminator
# ---------------------------------------------------------------------------


class AdvNet(nn.Module):
    """Softmaxed MLP ensemble telling real (z, v) pairs from pairs whose
    feature columns of v were shuffled across the batch."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.ensemble = MLPEnsemble(in_dim, 2)

    def forward(self, z: torch.Tensor, v: torch.Tensor) -> list:
        zv = torch.cat([z, v], dim=-1)
        return [torch.softmax(o, dim=-1) for o in self.ensemble(zv)]


@dataclasses.dataclass
class AdvState:
    """A discriminator and its AdamW state (``train.optim.AdamWState``,
    whose leaf table holds the net's parameters)."""

    net: AdvNet
    opt_state: object


def adv_shuffle(z: torch.Tensor, v: torch.Tensor, v_ind: torch.Tensor, perm: torch.Tensor) -> tuple:
    """Real pairs stacked over shuffled ones: (z; z) and (v; v with the
    columns ``v_ind`` taken from the rows ``perm``)."""
    v_shuffle = v.index_copy(1, v_ind, v[perm][:, v_ind])
    return torch.cat([z, z], dim=0), torch.cat([v, v_shuffle], dim=0)


def _adv_labels(batch: int, device) -> torch.Tensor:
    # made on the device: a host copy could not be captured in a CUDA graph
    y = (torch.arange(2 * batch, device=device) >= batch).long()
    return F.one_hot(y, 2).float()


def _softmax_ce(pred_probs: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    """The reference's cross-entropy on already-softmaxed outputs: the log
    of a second softmax."""
    return -torch.sum(y_onehot * F.log_softmax(pred_probs, dim=-1))


def adv_fit(tx, state: AdvState, z: torch.Tensor, v: torch.Tensor, v_ind: torch.Tensor, perms: Sequence[torch.Tensor]) -> AdvState:
    """One AdamW step of the discriminator per permutation in ``perms``, on
    the detached ``z`` and ``v``, each on a fresh shuffle; the net's
    parameters update in place."""
    z, v = z.detach(), v.detach()
    y = _adv_labels(z.shape[0], z.device)
    params = list(state.net.parameters())
    opt_state = state.opt_state
    for perm in perms:
        z_aug, v_aug = adv_shuffle(z, v, v_ind, perm)
        with torch.enable_grad():
            preds = state.net(z_aug, v_aug)
            loss = sum(_softmax_ce(p, y) for p in preds) / len(preds) / z.shape[0]
            grads = torch.autograd.grad(loss, params)
        opt_state = tx.update_and_apply(grads, opt_state, params)
    return dataclasses.replace(state, opt_state=opt_state)


def adv_generator_loss(state: AdvState, mu: torch.Tensor, var: torch.Tensor, v_ind: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Generator side: minus the mean cross-entropy of the frozen
    discriminator on real and shuffled pairs."""
    batch = mu.shape[0]
    z_aug, v_aug = adv_shuffle(mu, var, v_ind, perm)
    frozen = {k: p.detach() for k, p in state.net.named_parameters()}
    preds = torch.func.functional_call(state.net, frozen, (z_aug, v_aug))
    y = _adv_labels(batch, mu.device)
    total = sum(_softmax_ce(p, y) for p in preds)
    return total / (-(len(preds) * batch))


# ---------------------------------------------------------------------------
# Mutual-information (MCMI) kernel estimator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MIState:
    """Kernel density samples (x_s, y_s) with their bandwidths and the log
    normalisers; ``valid`` is 0 until the first refresh."""

    x_s: torch.Tensor  # (S, x_dim)
    y_s: torch.Tensor  # (S, y_dim)
    var_s: torch.Tensor  # scalar (sphere) or (S, x_dim) (diagonal)
    logA_x: torch.Tensor
    logA_y: torch.Tensor
    valid: torch.Tensor
    gamma: float = 1.0
    var_mode: str = "sphere"

    def replace(self, **kw) -> "MIState":
        return dataclasses.replace(self, **kw)


def mi_init(
    x_s: torch.Tensor,
    y_s: torch.Tensor,
    bandwidth: float,
    var_mode: str = "sphere",
    model_diag: Optional[torch.Tensor] = None,
    valid: float = 1.0,
) -> MIState:
    """The estimator of the samples ``x_s``, ``y_s`` (detached). In
    ``diagonal`` mode each x sample's kernel variance is ``model_diag``^2
    + bandwidth, ``model_diag`` (S, x_dim) being diag(L) of the samples'
    Cholesky factors."""
    f32 = dict(dtype=torch.float32, device=x_s.device)
    # filled on the device: a copy from the host could not be captured
    log2pi = torch.log(torch.full((), 2.0 * math.pi, **f32))
    bw = torch.full((), bandwidth, **f32)
    x_dim, y_dim = x_s.shape[1], y_s.shape[1]
    if var_mode == "sphere":
        var_s = bw
        logA_x = x_dim * (log2pi + torch.log(bw))
    elif var_mode == "diagonal":
        var_s = model_diag.detach() ** 2 + bandwidth
        logA_x = x_dim * log2pi + torch.sum(torch.log(var_s), dim=-1)
    else:
        raise ValueError(f"unknown var_mode {var_mode!r}")
    return MIState(
        x_s=x_s.detach(),
        y_s=y_s.detach(),
        var_s=var_s,
        logA_x=logA_x,
        logA_y=y_dim * (log2pi + torch.log(bw)),
        valid=torch.full((), float(valid), **f32),
        gamma=float(bandwidth),
        var_mode=var_mode,
    )


def mi_score(state: MIState, x: torch.Tensor, y: torch.Tensor, batch: Optional[int] = None) -> torch.Tensor:
    """KDE estimate of I(x; y): mean of log p(x, y) - log p(x) - log p(y)
    over the (B, S) pairwise kernels; with ``batch``, the sum over the rows
    given divided by it (a rank's share of the global batch's mean)."""
    dx = x[:, None, :] - state.x_s[None, :, :]
    dy = y[:, None, :] - state.y_s[None, :, :]
    sdx = torch.sum((dx / state.var_s) * dx, dim=-1)
    sdy = torch.sum((dy / state.gamma) * dy, dim=-1)
    log_pxy = -0.5 * (state.logA_x + state.logA_y + sdx + sdy)
    log_px = -0.5 * (state.logA_x + sdx)
    log_py = -0.5 * (state.logA_y + sdy)
    lse = torch.logsumexp
    per_row = lse(log_pxy, dim=-1) - lse(log_px, dim=-1) - lse(log_py, dim=-1)
    return torch.mean(per_row) if batch is None else torch.sum(per_row) / batch
