"""What the three model families share (``ResVAE``, ``MLPVAE``,
``TransformerVAE``): the data-dict interface of the JAX package's models.
A batch is a dict of (B, W, J, 6) ``x6d`` and (B, W, 3) ``root`` (and the
conditioned features); the encoder reads the pose with the root normalised
into the arena, the decoder emits (B, W, C) in (-1, 1) whose last three
channels are the normalised root, and decoding is conditional on one-hot
discrete and continuous features.

``forward(data, eps, mu_only, generator)`` samples z = mu + L eps in
training mode when ``eps`` is given (z = mu otherwise) and decodes it.
``generator`` draws the dropout masks in training mode; a model without
dropout never reads it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scrubvae_torch.models.layers import packed_matvec
from scrubvae_torch.ops.kinematics import inv_normalize_root, normalize_root

__all__ = ["PoseVAE"]


class PoseVAE(nn.Module):
    # the dense (B, z, z) Cholesky factor, "L"; ResVAE may pack it
    packed_sigma = False

    def __init__(
        self,
        z_dim: int,
        window: int,
        is_diag: bool,
        conditional_dim: int = 0,
        arena_size=None,
        conditional_keys: Sequence[str] = (),
        discrete_classes: Optional[Dict[str, int]] = None,
    ):
        super().__init__()
        self.z_dim, self.window, self.is_diag = z_dim, window, is_diag
        self.conditional_dim = conditional_dim
        self.conditional_keys = tuple(conditional_keys)
        self.discrete_classes = dict(discrete_classes or {})
        self.register_buffer(
            "arena",
            None if arena_size is None else torch.as_tensor(arena_size, dtype=torch.float32),
            persistent=False,
        )

    @property
    def sigma_key(self) -> str:
        """The key of the Cholesky factor in ``encode``'s output."""
        return "Lp" if self.packed_sigma else "L"

    def pose_input(self, x6d: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
        """(B, W, J*6) of the pose, with the arena-normalised root appended
        when the model has an arena."""
        B, W = x6d.shape[:2]
        x_in = x6d.reshape(B, W, -1)
        if self.arena is not None:
            x_in = torch.cat([x_in, normalize_root(root, self.arena.to(x6d.dtype))], dim=-1)
        return x_in

    def pose_output(self, x_hat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``x6d`` (B, W, J, 6) and, with an arena, ``root`` (B, W, 3) from
        the decoder's (B, W, C)."""
        out = {}
        x6d = x_hat
        if self.arena is not None:
            out["root"] = inv_normalize_root(x_hat[..., -3:], self.arena.to(x_hat.dtype))
            x6d = x_hat[..., :-3]
        out["x6d"] = x6d.reshape(x_hat.shape[0], self.window, -1, 6)
        return out

    def build_conditionals(self, data: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        """One-hot discrete + continuous conditionals, concatenated."""
        if self.conditional_dim <= 0:
            return None
        parts = []
        for k in self.conditional_keys:
            v = data[k]
            if k in self.discrete_classes:
                parts.append(F.one_hot(v.reshape(-1).long(), self.discrete_classes[k]).float())
            else:
                parts.append(v)
        return torch.cat(parts, dim=-1)

    def sample_z(self, mu: torch.Tensor, L: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """mu + L @ eps for standard-normal ``eps`` of mu's shape."""
        eps = eps.to(mu.dtype)
        if self.packed_sigma:
            return mu + packed_matvec(L, eps, self.z_dim, self.is_diag)
        return mu + torch.einsum("bij,bj->bi", L, eps)

    def forward(
        self,
        data: Dict[str, torch.Tensor],
        eps: Optional[torch.Tensor] = None,
        mu_only: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        out = self.encode(data, mu_only=mu_only, generator=generator)
        if self.training and eps is not None and not mu_only:
            z = self.sample_z(out["mu"], out[self.sigma_key], eps)
        else:
            z = out["mu"]
        out["z"] = z
        out.update(self.decode(z, data, generator=generator))
        return out
