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
- the attention's exact zeros (``zero_grad_elements``): the key bias of
  every attention adds the same q . b_k to a query's every logit, which
  the softmax cancels, and a cross-attention to one memory token has a
  softmax of 1 whatever its q and k projections; their gradients are
  rounding noise on both sides, so their step-1 updates take either sign
  and are left out of the weights' check;
- weights after step 1: every element to two f32 ulps, except where the
  reference gradient is below 5e-2 of its leaf's RMS (the noise band, where
  the update's sign may flip); fewer than 1e-3 of all weights flip. The
  full stack's card-against-CPU step (chip_smoke.py, the dense head's
  1.06 M-element ``fc_sigma`` at z 128) takes four ulps: where w0 is close
  to lr, w0 - lr * upd cancels, and an upd a few ulps below 1 on one side
  left 1 of its 1,056,768 weights 2.9e-11 (four ulps of lr) apart.
  Where an f32 gradient is ill-conditioned element by element, a float64
  computation that the run under test has no part in may mark the
  elements whose sign is unsure (``check_weights``' ``unsure``): the
  reference's own float64 twin (``sign_unsure``; the card against the
  CPU), or the rows of an MLP's output layer that a rotation at the
  rotation loss's clip feeds (tests/test_torch_port_mlp.py). Only there
  is an update of either sign accepted, and only there do flips go
  uncounted;
- MALS state: the forgetting factors to rtol 1e-6, the normal equations by
  relative norm ``tol`` (1e-4 after step 1).
- moving-average class-mean state: the forgetting factors exactly (each
  step moves them by ``delta``, on a comparison of two distances per
  class), the class means by relative norm ``tol``.
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
    "zero_grad_elements",
    "check_losses",
    "check_grads",
    "check_weights",
    "grads_float64",
    "sign_unsure",
    "check_mals",
    "QDA_KEYS",
    "MA_KEYS",
    "MI_KEYS",
    "check_qda",
    "check_ma",
    "check_adv",
    "check_mi",
]

BN_FED_BIAS = re.compile(r"vae\.(en|de)coder\.res_layers\.\d+\.(residual\.[03]|skip|skip\.1)\.bias")
ATTN_IN_PROJ = re.compile(r".*\.(self_attn|multihead_attn)\.in_proj_(weight|bias)")
MALS_KEYS = ("Sxx0", "Sxy0", "Sxx1", "Sxy1", "lam0", "lam1")
QDA_KEYS = ("m0a", "m1a", "m0b", "m1b", "S0a", "S1a", "S0b", "S1b", "lama", "lamb")
MA_KEYS = ("m1", "m2", "lam1", "lam2")
MI_KEYS = ("x_s", "y_s", "var_s", "logA_x", "logA_y", "valid")
# the learning rate of every step checked, and Adam's eps
LR = 1e-4
ADAM_EPS = 1e-8

Tensors = Dict[str, torch.Tensor]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative L2 distance of ``a`` from ``b``."""
    return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))


def zero_grad_leaves(names) -> set:
    """The conv biases that feed BatchNorm (exact gradient 0)."""
    return {n for n in names if BN_FED_BIAS.fullmatch(n)}


def zero_grad_elements(name: str, like: torch.Tensor) -> torch.Tensor:
    """The elements of leaf ``name`` whose exact gradient is 0 besides the
    whole leaves of ``zero_grad_leaves``: the key third of every attention's
    ``in_proj_bias``, and the q and k thirds of a cross-attention's
    (``multihead_attn``) projections."""
    mask = torch.zeros(like.shape, dtype=torch.bool)
    if ATTN_IN_PROJ.fullmatch(name):
        d = like.shape[0] // 3
        if name.endswith("_bias"):
            mask[d : 2 * d] = True
        if ".multihead_attn." in name:
            mask[: 2 * d] = True
    return mask


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


def check_weights(
    want: Tensors,
    got: Tensors,
    want_grads: Tensors,
    ulps: int = 2,
    unsure: Optional[Tensors] = None,
    got_grads: Optional[Tensors] = None,
) -> dict:
    """Weights after step 1: w0 - LR (m / (sqrt(n) + ADAM_EPS) + wd w0)
    with m / sqrt(n) = +-1, so ``ulps`` f32 ulps (atol: as many ulps of LR)
    outside the noise band of the reference gradient and the exact zeros
    of ``zero_grad_elements``; fewer than 1e-3 of all weights flip.
    ``unsure[name]``, where given, marks the elements where the reference
    run's own gradient has an unsure sign (``sign_unsure``): they join the
    noise band and the flips' count leaves them out. An element where only
    the run under test strays from the reference's sure sign is counted.
    With ``got_grads``, an element whose gradient is not large beside
    ADAM_EPS may differ by twice what the two gradients' difference moves
    the update g / (|g| + eps): LR eps |dg| / (|g| + eps)^2, with the
    smaller |g| of the two."""
    zero = zero_grad_leaves(want)
    flips, excused, total = 0, 0, 0
    for n, w in want.items():
        total += w.numel()
        if n in zero:
            continue
        g = want_grads[n]
        exact_zero = zero_grad_elements(n, w).to(w.device)
        noise_band = g.abs() < 5e-2 * torch.sqrt(torch.mean(g * g))
        loose = torch.zeros_like(noise_band)
        if unsure is not None and n in unsure:
            loose = unsure[n].to(noise_band.device)
        tol = ulps * 2.0**-23
        atol = tol * LR
        if got_grads is not None:
            dg = (got_grads[n].to(g.device) - g).abs()
            small = torch.minimum(g.abs(), got_grads[n].abs().to(g.device))
            atol = atol + 2 * LR * ADAM_EPS * dg / (small + ADAM_EPS) ** 2
        same = ((got[n] - w).abs() <= atol + tol * w.abs()) | exact_zero
        out = ~(same | noise_band | loose)
        if bool(out.any()):
            raise AssertionError(
                f"weights of {n} differ after step 1 outside the noise band: {int(out.sum())} of "
                f"{w.numel()}, by up to {float((got[n] - w).abs()[out].max()):.3e}, where the reference "
                f"gradient is {float((g.abs()[out] / torch.sqrt(torch.mean(g * g))).min()):.3e} of its RMS or more"
            )
        flips += int((~same & ~loose).sum())
        excused += int((~same & loose).sum())
    if flips >= 1e-3 * total:
        raise AssertionError(f"{flips} of {total} weights differ after step 1")
    return {"weight_flips": flips, "weight_flips_unsure": excused, "weights": total}


def grads_float64(trainer, idx: torch.Tensor, eps: torch.Tensor) -> Tensors:
    """A trainer's step-1 gradient of every leaf in float64, on the CPU: a
    copy of its model, the batch of window indices ``idx``, the sample
    noise ``eps`` and the streaming states in double, through the losses of
    its train step (epoch 1's loss weights); the trainer is left as it
    was."""
    import copy
    import dataclasses

    from scrubvae_torch.train.losses import compute_batch_loss

    model = copy.deepcopy(trainer.model).cpu().double().train()
    data = {k: v.cpu().double() if v.is_floating_point() else v.cpu() for k, v in trainer.train_ds.batch(idx).items()}

    def double(st):
        return st.replace(**{
            f.name: getattr(st, f.name).cpu().double() if getattr(st, f.name).is_floating_point() else getattr(st, f.name).cpu()
            for f in dataclasses.fields(st) if isinstance(getattr(st, f.name), torch.Tensor)
        })

    scrub = {m: {k: double(st) for k, st in states.items()} for m, states in trainer.state.scrub_state.items()}
    out = model(data, eps=eps.cpu().double())
    bl, _ = compute_batch_loss(
        data, out, trainer.loss_scale_for_epoch(1), trainer.dis_cfg, trainer.train_ds.kinematic_tree, scrub,
        static_loss_scale=trainer.loss_cfg,
    )
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(bl["total"], list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}


def sign_unsure(grads: Tensors, g64: Tensors) -> Tensors:
    """Per leaf, the elements where a run's f32 gradient ``grads`` is at
    least as far from ``g64``, the same gradient in float64 from the same
    inputs, as ``g64`` is from 0: there its own rounding can have given it
    either sign. ``g64`` must not come from the run that the reference is
    held against, or that run's faults would mark their own elements."""
    return {n: (grads[n].double() - g).abs() >= g.abs() for n, g in g64.items()}


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


def _check_class_state(label: str, keys, want: Tensors, got: Tensors, tol: float) -> float:
    """Forgetting factors (``lam*``) exactly, the other arrays by relative
    norm ``tol``; returns the largest relative distance."""
    worst = 0.0
    for k in keys:
        if k.startswith("lam"):
            if not torch.equal(got[k].float(), want[k].float()):
                raise AssertionError(f"{label} {k}: {got[k].tolist()} vs {want[k].tolist()}")
            continue
        r = _rel_or_zero(got[k], want[k])
        if r > tol:
            raise AssertionError(f"{label} {k} differs by {r:.3e} relative > {tol}")
        worst = max(worst, r)
    return worst


def check_qda(want: Tensors, got: Tensors, tol: float) -> float:
    """QDA state arrays; returns the largest relative distance of the
    means and covariances."""
    return _check_class_state("QDA", QDA_KEYS, want, got, tol)


def check_ma(want: Tensors, got: Tensors, tol: float) -> float:
    """Moving-average state arrays; returns the largest relative distance
    of the class means."""
    return _check_class_state("moving average", MA_KEYS, want, got, tol)


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
