"""Small SPD solves for the scrubbers (counterpart of
``scrubvae_tpu/ops/smallsolve.py``).

The JAX package unrolls Gauss-Jordan to keep LU loops out of TPU programs;
on the GPU a batched ``torch.linalg`` solve serves. ``solve_ex`` skips the
error check so a train step never waits on the host for it.
"""

from __future__ import annotations

import torch

__all__ = ["spd_solve"]


def spd_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^-1 B`` for SPD ``A`` (..., n, n) and ``B`` (..., n, m) or (..., n)."""
    vec = B.dim() == A.dim() - 1
    if vec:
        B = B.unsqueeze(-1)
    out = torch.linalg.solve_ex(A, B, check_errors=False).result
    return out.squeeze(-1) if vec else out
