"""The tolerances that hold one run of the first train steps against another
run from the same weights, MALS state, window rows and sample noise: the
port against the JAX package on the CPU (tests/test_torch_port_step.py) and
the card against the CPU (chip_smoke.py). Each ``check_*`` raises
AssertionError naming what differs and returns its readings. Tensors are
keyed by parameter name; ``want`` is the reference run.

Why these bounds. At a random init the rotation loss is ill-conditioned (its
asin nears 1 for rotations near 180 degrees apart), so the gradients of two
f32 runs differ at the f32 rounding of that loss: a median of about 2e-3
relative per leaf. The other loss terms, taken one at a time, agree at the
1e-5 level, and the rotation loss agrees to 1e-11 in float64
(tests/test_torch_port_step.py). Adam normalises each element, so an element
whose gradient sits in that noise around 0 gets an update of either sign.

- losses: relative ``rtol`` (1e-4 at step 1);
- step-1 gradients: relative norm per leaf <= 2.5e-2 (a size-1 leaf, a
  PReLU slope, <= 0.25 and of the same sign), median over leaves <= 1e-2;
  the 24 conv biases that feed BatchNorm have an exact gradient of 0 (the
  batch mean is subtracted) and must stay below 1e-6 of the largest leaf
  gradient on both sides;
- weights after step 1: every element to two f32 ulps, except where the
  reference gradient is below 5e-2 of its leaf's RMS (the noise band, where
  the update's sign may flip); fewer than 1e-3 of all weights flip;
- MALS state: the forgetting factors to rtol 1e-6, the normal equations by
  relative norm ``tol`` (1e-4 after step 1).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

__all__ = [
    "BN_FED_BIAS",
    "MALS_KEYS",
    "rel",
    "zero_grad_leaves",
    "check_losses",
    "check_grads",
    "check_weights",
    "check_mals",
]

BN_FED_BIAS = re.compile(r"vae\.(en|de)coder\.res_layers\.\d+\.(residual\.[03]|skip|skip\.1)\.bias")
MALS_KEYS = ("Sxx0", "Sxy0", "Sxx1", "Sxy1", "lam0", "lam1")

Tensors = Dict[str, torch.Tensor]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative L2 distance of ``a`` from ``b``."""
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def zero_grad_leaves(names) -> set:
    """The conv biases that feed BatchNorm (exact gradient 0)."""
    return {n for n in names if BN_FED_BIAS.fullmatch(n)}


def check_losses(want: Dict[str, float], got: Dict[str, float], rtol: float) -> float:
    """Every loss term finite and within ``rtol``; returns the largest
    relative difference."""
    if set(got) != set(want):
        raise AssertionError(f"loss terms differ: {sorted(got)} vs {sorted(want)}")
    worst = 0.0
    for k, v in want.items():
        if not np.isfinite(got[k]):
            raise AssertionError(f"loss {k} is {got[k]}")
        r = abs(got[k] - v) / abs(v)
        if r > rtol:
            raise AssertionError(f"loss {k}: {got[k]} vs {v}, {r:.3e} relative > {rtol}")
        worst = max(worst, r)
    return worst


def check_grads(want: Tensors, got: Tensors, leaf_tol: float = 2.5e-2, median_tol: float = 1e-2) -> dict:
    """Step-1 gradients per leaf: relative norm <= ``leaf_tol`` for a leaf
    of more than one element, <= 0.25 and of the same sign for a size-1
    leaf, median over leaves <= ``median_tol``. A leaf without gradient (a
    conv bias into BatchNorm, or one that ``want`` leaves below 1e-6 of its
    largest leaf) stays below 1e-6 of it on both sides."""
    if set(got) != set(want):
        raise AssertionError("gradients of different leaves")
    zero = zero_grad_leaves(want)
    gscale = max(float(g.norm()) for g in want.values())
    rels, scalar_rels, bad = [], [], []
    for n, w in want.items():
        g = got[n]
        if n in zero or float(w.norm()) < 1e-6 * gscale:
            if max(float(w.norm()), float(g.norm())) >= 1e-6 * gscale:
                bad.append(f"{n}: a gradient of 0 expected")
            continue
        r = rel(g, w)
        (scalar_rels if w.numel() == 1 else rels).append(r)
        if r > (0.25 if w.numel() == 1 else leaf_tol) or float((g * w).sum()) <= 0:
            bad.append(f"{n}: relative distance {r:.3e}")
    if bad:
        raise AssertionError("step-1 gradients differ:\n" + "\n".join(bad))
    median = float(np.median(rels + scalar_rels))
    if median > median_tol:
        raise AssertionError(f"median step-1 gradient difference {median:.3e} > {median_tol}")
    return {
        "median_grad_rel": median,
        "max_grad_rel": max(rels),
        "max_scalar_grad_rel": max(scalar_rels, default=0.0),
        "zero_grad_leaves": len(zero),
    }


def check_weights(want: Tensors, got: Tensors, want_grads: Tensors) -> dict:
    """Weights after step 1: w0 - lr (m / (sqrt(n) + eps) + wd w0) with
    m / sqrt(n) = +-1, so two f32 ulps (atol: two ulps of lr 1e-4) outside
    the noise band of the reference gradient."""
    zero = zero_grad_leaves(want)
    flips, total = 0, 0
    for n, w in want.items():
        total += w.numel()
        if n in zero:
            continue
        g = want_grads[n]
        noise_band = g.abs() < 5e-2 * torch.sqrt(torch.mean(g * g))
        same = torch.isclose(got[n], w, rtol=2.0**-22, atol=2.0**-22 * 1e-4)
        if not bool((same | noise_band).all()):
            raise AssertionError(f"weights of {n} differ after step 1 outside the noise band")
        flips += int((~same).sum())
    if flips >= 1e-3 * total:
        raise AssertionError(f"{flips} of {total} weights differ after step 1")
    return {"weight_flips": flips, "weights": total}


def check_mals(want: Tensors, got: Tensors, tol: float) -> float:
    """MALS state arrays; returns the largest relative distance of the
    normal equations."""
    worst = 0.0
    for k in MALS_KEYS:
        if k.startswith("lam"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)
            continue
        r = rel(got[k], want[k])
        if r > tol:
            raise AssertionError(f"MALS {k} differs by {r:.3e} relative > {tol}")
        worst = max(worst, r)
    return worst
