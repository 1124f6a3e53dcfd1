"""Small SPD solves for the scrubbers (counterpart of
``scrubvae_tpu/ops/smallsolve.py``).

Every matrix solved with here is symmetric positive definite by
construction: QDA's class covariances and MALS's normal equations are
forgotten sums seeded from the identity, the linear projection's
``w @ w.T`` is the Gram matrix of a full-rank decoder, and direct least
squares' ``z.T @ z`` that of a batch of more rows than latent dims
(``ops.losses.direct_lsq_loss``). So each is solved
through its Cholesky factor ``L`` (``A = L L^T``), which swaps no rows:
the same unpivoted elimination as the JAX package's small path
(Gauss-Jordan up to 32 dims), where a pivoted LU would spend most of its
time interchanging rows one at a time. The log-determinant is
``2 sum log diag L`` of the same factor, so a caller that needs both
factors once (``spd_factor``, then its triangular solves and
``factor_logdet``, as QDA's likelihoods do). On SPD input the results are
the LU results to roundoff.

``cholesky_ex`` skips the error check so a step never waits on the host
for it; each factorization is counted, and one that was not numerically
positive definite counted apart, on the device
(``utils.profiling.count_factorizations``), for the trainer to read with
its epoch's sums. Nothing else changes for such a matrix: no jitter, no
other route.
"""

from __future__ import annotations

import torch

from scrubvae_torch.utils.profiling import count_factorizations

__all__ = ["factor_logdet", "spd_factor", "spd_slogdet", "spd_solve"]


def spd_factor(A: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor ``L`` of SPD ``A`` (..., n, n)."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    count_factorizations(info)
    return L


def factor_logdet(L: torch.Tensor) -> torch.Tensor:
    """log det A from ``A``'s factor ``L`` (..., n, n)."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def spd_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A^-1 B`` for SPD ``A`` (..., n, n) and ``B`` (..., n, m) or (..., n):
    two triangular solves with its factor (on the card a batched trsm each,
    where ``cholesky_solve`` would solve a matrix at a time)."""
    vec = B.dim() == A.dim() - 1
    L = spd_factor(A)
    half = torch.linalg.solve_triangular(L, B.unsqueeze(-1) if vec else B, upper=False)
    out = torch.linalg.solve_triangular(L.mT, half, upper=True)
    return out.squeeze(-1) if vec else out


def spd_slogdet(A: torch.Tensor) -> torch.Tensor:
    """log det A for SPD ``A`` (..., n, n)."""
    return factor_logdet(spd_factor(A))
