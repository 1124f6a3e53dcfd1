"""Row-convention 6D rotations for the rotation loss (counterpart of the
``rotation_6d_to_matrix`` / ``_smooth_normalize`` part of
``scrubvae_tpu/ops/rotation.py``)."""

from __future__ import annotations

import torch

__all__ = ["rotation_6d_to_matrix"]


def _smooth_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(||x||^2 + eps^2): smooth where ``x / ||x||`` has a nan
    gradient at zero, and equal to it for any non-degenerate row."""
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(n2 + eps * eps)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Row-convention 6D -> rotation matrix via Gram-Schmidt (Zhou et al.):
    rows b1, b2, b3 = b1 x b2."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = _smooth_normalize(a1)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = _smooth_normalize(b2)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)
