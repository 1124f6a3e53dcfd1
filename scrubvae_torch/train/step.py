"""The train and eval steps (counterparts of ``feature_slices``,
``make_train_step`` and ``make_eval_step`` of ``scrubvae_tpu/train/step.py``).
The train step runs in the JAX order: window assembly, forward, loss,
backward, fused optimizer, the MALS, moving-average and QDA updates on the
detached mu, the discriminators' inner fit, then the MCMI estimator rebuilt
from the batch encoded under the updated parameters. Every draw of a step
(the sample noise, the adversarial shuffles, the dropout masks, in that
order) comes from ``state.generator``.

On a data-parallel mesh (``mesh``, ``parallel.mesh``) ``idx`` holds this
rank's rows. Every rank draws the noise and the shuffles of the global
batch from the same generator and keeps its rows of the noise; the losses
follow ``compute_batch_loss``; the gradients are summed over ``data``; the
streaming scrubbers, the discriminators' inner fit and the MCMI estimator
run replicated on the latents and labels gathered over ``data``, so their
states stay the same on every rank.

``make_inplace_step`` is the form of the train step that a CUDA graph
captures (``train.graph``, ``Trainer.train_epoch`` under
``train.scan_epoch``): every state tensor the step produces lands in the
tensor it came from, the loss weights and the window indices are read from
device buffers and the metrics are summed on the device; it equals the
train step bit for bit on any device.

A traced step (``Trainer.set_tracing``; ``utils.profiling``) stamps where
it passes from one layer to the next: the in-place step's entry and end,
the batch's assembly, the backward and the optimizer here, the rest in the
model and the losses. Elsewhere a stamp does nothing."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.models.layers import packed_diag
from scrubvae_torch.parallel.mesh import data_parallel, gather_rows, reduce_sum, shard_batch, step_rows
from scrubvae_torch.train.losses import compute_batch_loss
from scrubvae_torch.train.state import TrainState, tree_map
from scrubvae_torch.utils.profiling import stamp

__all__ = [
    "feature_slices", "draw_adv_perms", "encode_mi_state", "make_train_step", "land_state", "make_inplace_step",
    "make_grad_step", "make_eval_step",
]

STREAMING_UPDATES = {"moving_avg_lsq": scr.mals_update, "moving_avg": scr.ma_update, "qda": scr.qda_update}


def feature_slices(conditional_keys: Sequence[str], fdims: dict) -> Dict[str, np.ndarray]:
    """Column indices of each conditional feature inside the concatenated
    ``var`` vector."""
    out, off = {}, 0
    for k in conditional_keys:
        out[k] = np.arange(off, off + fdims[k])
        off += fdims[k]
    return out


def draw_adv_perms(generator: torch.Generator, batch: int, features: Sequence[str], n_iter: int) -> dict:
    """The adversarial shuffles of one train step from ``generator``: one
    permutation for the generator losses of every feature, then ``n_iter``
    for each feature's inner fit, in ``features``' order."""
    dev = generator.device

    def perm():
        return torch.randperm(batch, generator=generator, device=dev)

    loss = perm()
    return {"loss": loss, "fit": {k: [perm() for _ in range(n_iter)] for k in features}}


@torch.no_grad()
def encode_mi_state(
    model: nn.Module, data: Dict[str, torch.Tensor], var: torch.Tensor, bandwidth: float, var_mode: str, mesh=None
) -> scr.MIState:
    """The MCMI estimator of ``data`` encoded in eval mode (BatchNorm's
    running statistics, which stay as they are; no dropout) and ``var``;
    the model returns to the mode it was in. With a data-parallel
    ``mesh``, ``data`` and ``var`` are this rank's rows and the estimator
    holds the global batch's."""
    was_training = model.training
    model.eval()
    try:
        enc = model.vae.encode(data, mu_only=var_mode == "sphere")
    finally:
        model.train(was_training)
    mu = enc["mu"]
    diag = None
    if var_mode == "diagonal":
        L = enc[model.vae.sigma_key]
        diag = packed_diag(L, mu.shape[1]) if model.vae.packed_sigma else torch.diagonal(L, dim1=-2, dim2=-1)
        diag = gather_rows(diag, mesh)
    return scr.mi_init(gather_rows(mu, mesh), gather_rows(var, mesh), bandwidth, var_mode, model_diag=diag, valid=1.0)


def _device_slices(feat_slices, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, dtype=torch.long, device=device) for k, v in (feat_slices or {}).items()}


def _loss_and_grads(
    model: nn.Module,
    tree,
    *,
    disentangle_config: dict,
    batch_fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
    feat_slices,
    adv_n_iter: int,
    static_loss_scale,
    mesh,
) -> Callable:
    """The forward, the losses and the backward of a train step, shared by
    ``make_train_step`` and ``make_grad_step``: ``run(state, idx,
    loss_scale, eps, perms, generator) -> (data, out, losses, new scrubber
    state, gradients, perms)``, the gradients summed over ``data``."""
    params = list(model.parameters())
    slices = _device_slices(feat_slices, params[0].device)
    dp = data_parallel(mesh)

    def run(state: TrainState, idx, loss_scale, eps, perms, generator: torch.Generator):
        data = batch_fn(idx)
        stamp("data")
        B = data["x6d"].shape[0] * (dp.data if dp else 1)
        # the beta prior draws its gamma variates in the forward, from the
        # same generator
        if eps is None and getattr(model.vae, "prior", "gaussian") == "gaussian":
            eps = torch.randn((B, model.vae.z_dim), generator=generator, device=data["x6d"].device)
        if eps is not None and dp is not None:
            eps = tuple(shard_batch(dp, e) for e in eps) if isinstance(eps, (tuple, list)) else shard_batch(dp, eps)
        if state.adv_states and perms is None:
            perms = draw_adv_perms(generator, B, list(state.adv_states), adv_n_iter)
        model.train()
        with step_rows(dp):
            out = model(data, eps=eps, generator=generator)
        bl, new_scrub = compute_batch_loss(
            data, out, loss_scale, disentangle_config, tree, state.scrub_state,
            adv_states=state.adv_states, mi_state=state.mi_state,
            adv_perm=perms["loss"] if perms else None, feat_slices=slices,
            static_loss_scale=static_loss_scale, mesh=dp,
        )
        grads = torch.autograd.grad(bl["total"], params, allow_unused=True)
        if dp is not None:
            grads = reduce_sum(grads, dp.data_group)
        stamp("backward")
        return data, out, bl, new_scrub, grads, perms

    return run


def make_train_step(
    model: nn.Module,
    tx,
    tree,
    *,
    disentangle_config: dict,
    batch_fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
    loss_keys: Sequence[str] = (),
    feat_slices: Optional[Dict[str, np.ndarray]] = None,
    adv_tx=None,
    adv_fit: bool = True,
    adv_n_iter: int = 5,
    mcmi_bandwidth: float = 1.0,
    mcmi_var_mode: str = "sphere",
    static_loss_scale: Optional[Dict[str, float]] = None,
    mesh=None,
) -> Callable:
    """Build ``step(state, idx, loss_scale, eps=None, perms=None) -> (state,
    metrics)``.

    ``idx`` are window indices (or what ``batch_fn`` takes: a host-streamed
    slab); ``eps`` (B, z) overrides the sample noise (under the beta prior,
    the pair of gamma draws, see ``ResVAE.forward``) and
    ``perms`` (``draw_adv_perms``' layout) the adversarial shuffles, both
    drawn from ``state.generator`` otherwise, both of the global batch on a
    ``mesh``. Parameters, moments, BatchNorm
    statistics and the discriminators update in place; metrics stay on the
    device. ``adv_tx`` is the discriminators' optimizer;
    ``static_loss_scale`` the configured loss weights (``compute_batch_loss``).
    """
    params = list(model.parameters())
    slices = _device_slices(feat_slices, params[0].device)
    use_mcmi = "mcmi" in loss_keys
    dp = data_parallel(mesh)
    run = _loss_and_grads(
        model, tree, disentangle_config=disentangle_config, batch_fn=batch_fn, feat_slices=feat_slices,
        adv_n_iter=adv_n_iter, static_loss_scale=static_loss_scale, mesh=mesh,
    )

    def step(state: TrainState, idx, loss_scale: Dict[str, float], eps: Optional[torch.Tensor] = None, perms=None):
        data, out, bl, new_scrub, grads, perms = run(state, idx, loss_scale, eps, perms, state.generator)
        opt_state = tx.update_and_apply(grads, state.opt_state, params)
        stamp("optimizer")
        mu_det = gather_rows(out["mu"].detach(), dp)
        for method, update in STREAMING_UPDATES.items():
            for k, st in new_scrub.get(method, {}).items():
                new_scrub[method][k] = update(st, mu_det, gather_rows(data[k], dp))
        new_adv = dict(state.adv_states)
        if adv_fit and new_adv:
            var = gather_rows(out["var"].detach(), dp)
            for k in new_adv:
                new_adv[k] = scr.adv_fit(adv_tx, new_adv[k], mu_det, var, slices[k], perms["fit"][k])
        mi_state = state.mi_state
        if use_mcmi:
            mi_state = encode_mi_state(model, data, out["var"].detach(), mcmi_bandwidth, mcmi_var_mode, mesh=dp)
        metrics = {k: v.detach() for k, v in bl.items()}
        new_state = state.replace(
            step=state.step + 1, opt_state=opt_state, scrub_state=new_scrub,
            adv_states=new_adv, mi_state=mi_state,
        )
        return new_state, metrics

    return step


def land_state(old, new):
    """``new`` (a state the train step produced from ``old``) carried in
    ``old``'s storage: every tensor of ``new`` that is not ``old``'s
    counterpart is copied into it, through dataclasses, dicts, lists and
    tuples of the same layout (``tree_map``). Returns ``old``'s layout with
    ``new``'s host values (step counts, settings); generators, modules and
    leaf tables are shared by both and kept."""

    def land(n, o):
        if not isinstance(n, torch.Tensor) or n is o:
            return n
        if o.shape != n.shape or o.dtype != n.dtype:
            raise ValueError(
                f"land_state: a {tuple(n.shape)} {n.dtype} state tensor does not fit the "
                f"{tuple(o.shape)} {o.dtype} one it replaces"
            )
        o.copy_(n)
        return o

    return tree_map(land, new, old)


def make_inplace_step(step: Callable) -> Callable:
    """``step`` (``make_train_step``'s) with its state carried in place:
    ``inplace(state, idx, loss_scale, sums) -> state``. The step runs on
    ``idx`` where it lies, with ``loss_scale`` mapping each loss key to a
    0-dim float64 tensor (this epoch's weights, on the device); every state
    tensor it produces is copied into the one of ``state`` it replaces
    (``land_state``: the streaming scrubbers', the MCMI estimator's; the
    parameters, moments, counts, BatchNorm statistics and discriminators
    update in place already) and its metrics are added into ``sums``
    (each created by its first step). Returns ``state``'s layout with the
    host step counts advanced. So the step reads and writes the same
    storage at every call, as a captured CUDA graph must, and computes
    what ``step`` computes bit for bit."""

    def inplace(state: TrainState, idx, loss_scale: Dict[str, torch.Tensor], sums: Dict[str, torch.Tensor]):
        stamp("replay_gap")
        new_state, metrics = step(state, idx, loss_scale)
        state = land_state(state, new_state)
        for k, v in metrics.items():
            if k in sums:
                sums[k].add_(v)
            else:
                sums[k] = v.clone()
        stamp("scrub_update")
        return state

    return inplace


def make_grad_step(
    model: nn.Module,
    tree,
    *,
    disentangle_config: dict,
    batch_fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
    feat_slices: Optional[Dict[str, np.ndarray]] = None,
    adv_n_iter: int = 5,
    static_loss_scale: Optional[Dict[str, float]] = None,
    mesh=None,
) -> Callable:
    """The pre-optimizer view of the train step (counterpart of JAX's
    ``make_grad_step``): ``grad_step(state, idx, loss_scale, eps=None,
    perms=None) -> (grads, losses, mu)`` through the train step's own
    forward, losses and backward, with nothing changed: the gradients by
    parameter name (summed over ``data``; this rank's slice of a split
    leaf), the loss terms and the detached mu of the global batch. The
    draws come from a copy of ``state.generator`` (so the train step that
    follows draws the same) and the BatchNorm statistics the forward
    updates are put back."""
    names = [n for n, _ in model.named_parameters()]
    dp = data_parallel(mesh)
    run = _loss_and_grads(
        model, tree, disentangle_config=disentangle_config, batch_fn=batch_fn, feat_slices=feat_slices,
        adv_n_iter=adv_n_iter, static_loss_scale=static_loss_scale, mesh=mesh,
    )

    def grad_step(state: TrainState, idx, loss_scale: Dict[str, float], eps: Optional[torch.Tensor] = None, perms=None):
        gen = torch.Generator(device=state.generator.device)
        gen.set_state(state.generator.get_state())
        buffers = [b.detach().clone() for b in model.buffers()]
        _, out, bl, _, grads, _ = run(state, idx, loss_scale, eps, perms, gen)
        with torch.no_grad():
            for b, saved in zip(model.buffers(), buffers):
                b.copy_(saved)
        losses = {k: v.detach() for k, v in bl.items()}
        return dict(zip(names, grads)), losses, gather_rows(out["mu"].detach(), dp)

    return grad_step


def make_eval_step(
    model: nn.Module,
    tree,
    *,
    disentangle_config: dict,
    loss_keys,
    batch_fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
    feat_slices: Optional[Dict[str, np.ndarray]] = None,
    static_loss_scale: Optional[Dict[str, float]] = None,
) -> Callable:
    """Build ``step(state, idx, loss_scale, data=None, generator=None,
    mesh=None) -> (losses, mu)``: the forward in eval mode (BatchNorm running statistics,
    no dropout, z = mu) and the loss terms, with no gradient and no state change; the
    scrubber state that the losses return is dropped. ``data`` is the
    assembled batch of ``idx`` when the caller has it already; the
    adversarial losses' shuffle is drawn from ``generator``. With a
    data-parallel ``mesh`` the batch is this rank's rows, the losses and mu
    the global batch's (``compute_batch_loss``).

    The Cholesky head runs only when a loss reads it: ``mu_only`` is fixed
    here, when neither ``prior`` nor ``total_correlation`` is a loss key.
    """
    mu_only = not any(k in loss_keys for k in ("prior", "total_correlation"))
    slices = _device_slices(feat_slices, next(model.parameters()).device)

    @torch.no_grad()
    def step(state: TrainState, idx, loss_scale: Dict[str, float], data=None, generator=None, mesh=None):
        if data is None:
            data = batch_fn(idx)
        dp = data_parallel(mesh)
        adv_perm = None
        if state.adv_states:
            B = data["x6d"].shape[0] * (dp.data if dp else 1)
            adv_perm = torch.randperm(B, generator=generator, device=generator.device)
        model.eval()
        out = model(data, mu_only=mu_only)
        bl, _ = compute_batch_loss(
            data, out, loss_scale, disentangle_config, tree, state.scrub_state,
            adv_states=state.adv_states, mi_state=state.mi_state, adv_perm=adv_perm, feat_slices=slices,
            static_loss_scale=static_loss_scale, mesh=dp,
        )
        return bl, gather_rows(out["mu"], dp)

    return step
