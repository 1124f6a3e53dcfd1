"""Primitive losses of the train step (counterpart of the
``rotation_loss`` / ``stable_rotation_loss`` / ``prior_loss`` /
``prior_loss_packed`` / ``mpjpe_loss`` / ``direct_lsq_loss`` / ``mse_sum`` /
``total_correlation`` part of ``scrubvae_tpu/ops/losses.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from scrubvae_torch.ops.kinematics import KinematicTree, fwd_kin_cont6d
from scrubvae_torch.ops.rotation import rotation_6d_to_matrix
from scrubvae_torch.ops.smallsolve import spd_solve

__all__ = [
    "mse_sum",
    "rotation_loss",
    "stable_rotation_loss",
    "prior_loss",
    "prior_loss_packed",
    "mpjpe_loss",
    "direct_lsq_loss",
    "total_correlation",
]

LN2PI = math.log(2.0 * math.pi)


def mse_sum(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.sum((pred - target) ** 2)


def rotation_loss(x: torch.Tensor, x_hat: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Geodesic loss, acos form: the angle of every relative rotation,
    summed and divided by the batch."""
    m1 = rotation_6d_to_matrix(x).reshape(-1, 3, 3)
    m2 = rotation_6d_to_matrix(x_hat).reshape(-1, 3, 3)
    m = m1 @ m2.transpose(-1, -2)
    cos = (m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2] - 1.0) / 2.0
    cos = torch.clamp(cos, -1.0 + eps, 1.0 - eps)
    return torch.sum(torch.acos(cos)) / x.shape[0]


def stable_rotation_loss(x: torch.Tensor, x_hat: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Geodesic loss via asin of the chordal distance, summed over all
    rotations (not normalised, as in the reference). The +1e-14 keeps the
    sqrt's gradient finite at an exact zero difference."""
    m1 = rotation_6d_to_matrix(x)
    m2 = rotation_6d_to_matrix(x_hat)
    diff = m2 - m1
    sin = torch.sqrt(torch.sum(diff * diff, dim=(-1, -2)) + 1e-14) / (2.0**1.5)
    sin = torch.clamp(sin, -1.0 + eps, 1.0 - eps)
    return 2.0 * torch.sum(torch.asin(sin))


def prior_loss(mu: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, LL^T) || N(0, I)) for the dense Cholesky factor L (B, D, D),
    averaged over the batch."""
    var_diag = torch.sum(L * L, dim=-1)  # diag(L L^T)
    log_diag_L = torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
    kl = -0.5 * torch.sum(1.0 + 2.0 * log_diag_L - mu**2 - var_diag)
    return kl / mu.shape[0]


def prior_loss_packed(mu: torch.Tensor, Lp: torch.Tensor, diag_only: bool = False) -> torch.Tensor:
    """KL(N(mu, LL^T) || N(0, I)) averaged over the batch, on the packed
    tril factor: sum diag(LL^T) is the sum of squares of every packed entry
    and diag(L) a static column take."""
    from scrubvae_torch.models.layers import packed_diag, packed_sumsq

    D = mu.shape[1]
    log_diag = torch.log(packed_diag(Lp, D, diag_only))
    kl = -0.5 * (
        mu.shape[0] * D + 2.0 * torch.sum(log_diag) - torch.sum(mu**2) - packed_sumsq(Lp)
    )
    return kl / mu.shape[0]


def mpjpe_loss(
    target_pose: torch.Tensor,
    x6d_hat: torch.Tensor,
    tree: KinematicTree,
    offsets: torch.Tensor,
    root_hat: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean per-joint position error with FK inside the loss, normalised by
    B * 3 * J. target_pose (B, W, J, 3); x6d_hat (B, W, J, 6); offsets
    (B, W, J, 3)."""
    B, W, J = target_pose.shape[:3]
    if root_hat is None:
        root_hat = torch.zeros_like(target_pose[..., 0, :])
    pose_hat = fwd_kin_cont6d(
        x6d_hat.reshape(-1, J, 6),
        tree,
        offsets.reshape(-1, J, 3),
        root_pos=root_hat.reshape(-1, 3),
        do_root_R=True,
        eps=1e-8,
    ).reshape(target_pose.shape)
    return torch.sum((target_pose - pose_hat) ** 2) / (B * 3 * J)


def direct_lsq_loss(z: torch.Tensor, y: torch.Tensor, bias: bool = False) -> torch.Tensor:
    """Summed squared residual of the closed-form least-squares decoder of
    ``y`` from ``z`` (with a column of ones when ``bias``), through the
    normal equations ``z^T z``, as the JAX package solves them."""
    if bias:
        z = torch.cat([z, z.new_ones(z.shape[0], 1)], dim=-1)
    yhat = z @ spd_solve(z.T @ z, z.T @ y)
    return torch.sum((yhat - y) ** 2)


def _gaussian_log_density_unsummed(z: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    diff_sq = (z - mu) ** 2
    inv_var = torch.exp(-logvar)
    return -0.5 * (inv_var * diff_sq + logvar + LN2PI)


def total_correlation(z: torch.Tensor, mu: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """The beta-TCVAE minibatch estimator of the total correlation of q(z),
    from the (B, B, D) log-densities of every sample under every posterior;
    ``z`` is detached, as in the reference."""
    logvar = torch.log(torch.sum(L * L, dim=-1))
    log_qz_prob = _gaussian_log_density_unsummed(z.detach()[:, None], mu[None, :], logvar[None, :])
    log_qz_product = torch.sum(torch.logsumexp(log_qz_prob, dim=1), dim=1)
    log_qz = torch.logsumexp(torch.sum(log_qz_prob, dim=2), dim=1)
    return torch.mean(log_qz - log_qz_product)
