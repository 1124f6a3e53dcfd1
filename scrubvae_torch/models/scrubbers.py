"""Scrubbers of the flagship path (counterpart of the gradient-reversal,
MLP-ensemble, linear-projection and moving-average-least-squares parts of
``scrubvae_tpu/models/scrubbers.py``).

Trainable heads are ``nn.Module``s inside the model, so the one outer
optimizer covers them. MALS keeps explicit streaming state: ``mals_loss``
returns the state with its forgetting factors tuned, and ``mals_update``
accumulates the normal equations after the optimizer step.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from scrubvae_torch.models.layers import Linear, lecun_normal_
from scrubvae_torch.ops.smallsolve import spd_solve

__all__ = [
    "grad_reverse",
    "MLPEnsemble",
    "LinearProjection",
    "GRScrubber",
    "MALSState",
    "mals_init",
    "mals_forward",
    "mals_loss",
    "mals_update",
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
    if polynomial_order != 1:
        raise NotImplementedError("scrubvae_torch MALS supports polynomial order 1 only")
    n = nx + int(bias)
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
    if state.bias:
        x = torch.cat([x, x.new_ones(x.shape[0], 1)], dim=-1)
    return x


def mals_forward(state: MALSState, x: torch.Tensor):
    """Solve both normal-equation decoders and predict y with each."""
    x = _mals_features(state, x)
    l2 = torch.full((x.shape[1],), state.l2_reg, dtype=x.dtype, device=x.device)
    if state.bias:
        l2[-1] = 0.0
    W0 = spd_solve(state.Sxx0 + torch.diag(l2), state.Sxy0)
    W1 = spd_solve(state.Sxx1 + torch.diag(l2), state.Sxy1)
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
