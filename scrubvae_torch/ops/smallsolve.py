"""Small SPD solves for the scrubbers (counterpart of
``scrubvae_tpu/ops/smallsolve.py``).

The JAX package unrolls Gauss-Jordan to keep LU loops out of TPU programs
and takes ``jnp.linalg.solve`` / ``slogdet`` (pivoted LU) above 32 dims;
on the GPU a batched ``torch.linalg`` LU serves at every size. ``solve_ex``
and ``lu_factor_ex`` skip the error check so a train step never waits on
the host for it.
"""

from __future__ import annotations

import torch

__all__ = ["spd_solve", "spd_slogdet"]


def spd_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^-1 B`` for SPD ``A`` (..., n, n) and ``B`` (..., n, m) or (..., n)."""
    vec = B.dim() == A.dim() - 1
    if vec:
        B = B.unsqueeze(-1)
    out = torch.linalg.solve_ex(A, B, check_errors=False).result
    return out.squeeze(-1) if vec else out


def spd_slogdet(A: torch.Tensor) -> torch.Tensor:
    """log|det A| for SPD ``A`` (..., n, n): the log-abs of the pivots of
    its LU factorisation."""
    LU = torch.linalg.lu_factor_ex(A, check_errors=False).LU
    return torch.log(torch.abs(torch.diagonal(LU, dim1=-2, dim2=-1))).sum(-1)
