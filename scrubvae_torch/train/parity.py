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

- losses: relative ``rtol`` (1e-4 at step 1); a term of exactly 0 stays 0;
- step-1 gradients: relative norm per leaf <= 2.5e-2 (a size-1 leaf, a
  PReLU slope, <= 0.25 and of the same sign), median over leaves <= 1e-2;
  the 24 conv biases that feed BatchNorm have an exact gradient of 0 (the
  batch mean is subtracted) and must stay below 1e-6 of the largest leaf
  gradient on both sides;
- weights after step 1: every element to two f32 ulps, except where the
  reference gradient is below 5e-2 of its leaf's RMS (the noise band, where
  the update's sign may flip); fewer than 1e-3 of all weights flip. The
  full stack's card-against-CPU step (chip_smoke.py, the dense head's
  1.06 M-element ``fc_sigma`` at z 128) takes four ulps: where w0 is close
  to lr, w0 - lr * upd cancels, and an upd a few ulps below 1 on one side
  left 1 of its 1,056,768 weights 2.9e-11 (four ulps of lr) apart;
- MALS state: the forgetting factors to rtol 1e-6, the normal equations by
  relative norm ``tol`` (1e-4 after step 1).
- QDA state: the forgetting factors exactly: each step moves them by
  ``delta`` up or down, a comparison per class of two summed
  log-likelihoods, which a rounding difference flips only at a near tie;
  the means and covariances by relative norm ``tol`` (1e-4 after step 1:
  they are EMAs of the batch moments of mu, which agrees to f32 rounding).
- discriminator parameters (and their moments) after the inner fit: per
  leaf by relative norm ``tol``: 1e-4 against optax on the same inputs and
  after train step 1 at z 16 (port against JAX on the CPU); 1e-3 for the
  card against the CPU at z 128 (chip_smoke.py), whose mu, the
  discriminator's input, differs more (2.1e-4 measured on an H100). The
  inner AdamW runs at lr 0.1, so every step moves
  each parameter by about 0.1 whatever the size of its gradient: once the
  latents of two runs drift apart (steps 2 and on), the elements whose
  gradient is near 0 take steps of either sign, 0.1 each; after three
  train steps (15 inner steps) 0.25 per leaf and 0.1 median over leaves
  (``median_tol``), as for the model's updates.
- MCMI state: ``valid`` exactly, the samples, bandwidths and normalisers by
  relative norm ``tol``. After a train step the samples are the batch
  encoded in eval mode under the updated weights: BatchNorm's running
  statistics, still near their init after one step, do not normalise the
  activations, which amplifies the weights' step-1 differences (two ulps,
  and the flips of the noise band) to about 3e-3 in the samples; hence 1e-2
  after step 1 (the same encode from the same weights agrees to 1e-5).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

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
    "QDA_KEYS",
    "MI_KEYS",
    "check_qda",
    "check_adv",
    "check_mi",
]

BN_FED_BIAS = re.compile(r"vae\.(en|de)coder\.res_layers\.\d+\.(residual\.[03]|skip|skip\.1)\.bias")
MALS_KEYS = ("Sxx0", "Sxy0", "Sxx1", "Sxy1", "lam0", "lam1")
QDA_KEYS = ("m0a", "m1a", "m0b", "m1b", "S0a", "S1a", "S0b", "S1b", "lama", "lamb")
MI_KEYS = ("x_s", "y_s", "var_s", "logA_x", "logA_y", "valid")

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
        # a term that is exactly 0 (QDA's at step 1: both models alike) stays 0
        r = abs(got[k] - v) / abs(v) if v != 0 else abs(got[k])
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


def check_weights(want: Tensors, got: Tensors, want_grads: Tensors, ulps: int = 2) -> dict:
    """Weights after step 1: w0 - lr (m / (sqrt(n) + eps) + wd w0) with
    m / sqrt(n) = +-1, so ``ulps`` f32 ulps (atol: as many ulps of lr 1e-4)
    outside the noise band of the reference gradient."""
    zero = zero_grad_leaves(want)
    flips, total = 0, 0
    for n, w in want.items():
        total += w.numel()
        if n in zero:
            continue
        g = want_grads[n]
        noise_band = g.abs() < 5e-2 * torch.sqrt(torch.mean(g * g))
        tol = ulps * 2.0**-23
        same = torch.isclose(got[n], w, rtol=tol, atol=tol * 1e-4)
        out = ~(same | noise_band)
        if bool(out.any()):
            raise AssertionError(
                f"weights of {n} differ after step 1 outside the noise band: {int(out.sum())} of "
                f"{w.numel()}, by up to {float((got[n] - w).abs()[out].max()):.3e}, where the reference "
                f"gradient is {float((g.abs()[out] / torch.sqrt(torch.mean(g * g))).min()):.3e} of its RMS or more"
            )
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


def _rel_or_zero(a: torch.Tensor, b: torch.Tensor) -> float:
    """``rel``, or the norm of ``a`` where ``b`` is all 0."""
    if float(torch.linalg.vector_norm(b.double())) == 0.0:
        return float(torch.linalg.vector_norm(a.double()))
    return rel(a, b)


def check_qda(want: Tensors, got: Tensors, tol: float) -> float:
    """QDA state arrays; returns the largest relative distance of the
    means and covariances."""
    worst = 0.0
    for k in QDA_KEYS:
        if k.startswith("lam"):
            if not torch.equal(got[k].float(), want[k].float()):
                raise AssertionError(f"QDA {k}: {got[k].tolist()} vs {want[k].tolist()}")
            continue
        r = _rel_or_zero(got[k], want[k])
        if r > tol:
            raise AssertionError(f"QDA {k} differs by {r:.3e} relative > {tol}")
        worst = max(worst, r)
    return worst


def check_adv(want: Tensors, got: Tensors, tol: float, median_tol: Optional[float] = None) -> dict:
    """Discriminator leaves (parameters or moments) by name, each within
    ``tol`` by relative norm, and their median within ``median_tol`` when
    given; returns the largest and the median relative distance."""
    if set(got) != set(want):
        raise AssertionError(f"discriminator leaves differ: {sorted(got)} vs {sorted(want)}")
    rels = {k: _rel_or_zero(got[k].detach(), w) for k, w in want.items()}
    bad = {k: r for k, r in rels.items() if r > tol}
    if bad:
        raise AssertionError(f"discriminator leaves differ by more than {tol} relative: {bad}")
    median = float(np.median(list(rels.values())))
    if median_tol is not None and median > median_tol:
        raise AssertionError(f"discriminator leaves differ by {median:.3e} median > {median_tol}")
    return {"max_adv_rel": max(rels.values()), "median_adv_rel": median}


def check_mi(want: Tensors, got: Tensors, tol: float) -> float:
    """MCMI state arrays; returns the largest relative distance."""
    if not torch.equal(got["valid"].float(), want["valid"].float()):
        raise AssertionError(f"MCMI valid: {float(got['valid'])} vs {float(want['valid'])}")
    worst = 0.0
    for k in MI_KEYS[:-1]:
        if got[k].shape != want[k].shape:
            raise AssertionError(f"MCMI {k}: shape {tuple(got[k].shape)} vs {tuple(want[k].shape)}")
        r = _rel_or_zero(got[k], want[k])
        if r > tol:
            raise AssertionError(f"MCMI {k} differs by {r:.3e} relative > {tol}")
        worst = max(worst, r)
    return worst
