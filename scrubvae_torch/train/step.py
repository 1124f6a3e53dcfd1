"""The train and eval steps (counterparts of ``feature_slices``,
``make_train_step`` and ``make_eval_step`` of ``scrubvae_tpu/train/step.py``).
The train step runs in the JAX order: window assembly, forward, loss,
backward, fused optimizer, the MALS, moving-average and QDA updates on the
detached mu, the discriminators' inner fit, then the MCMI estimator rebuilt
from the batch encoded under the updated parameters. Every draw of a step
(the sample noise, the adversarial shuffles, the dropout masks, in that
order) comes from ``state.generator``."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.models.layers import packed_diag
from scrubvae_torch.train.losses import compute_batch_loss
from scrubvae_torch.train.state import TrainState

__all__ = ["feature_slices", "draw_adv_perms", "encode_mi_state", "make_train_step", "make_eval_step"]

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
def encode_mi_state(model: nn.Module, data: Dict[str, torch.Tensor], var: torch.Tensor, bandwidth: float, var_mode: str) -> scr.MIState:
    """The MCMI estimator of ``data`` encoded in eval mode (BatchNorm's
    running statistics, which stay as they are; no dropout) and ``var``;
    the model returns to the mode it was in."""
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
    return scr.mi_init(mu, var, bandwidth, var_mode, model_diag=diag, valid=1.0)


def _device_slices(feat_slices, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, dtype=torch.long, device=device) for k, v in (feat_slices or {}).items()}


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
) -> Callable:
    """Build ``step(state, idx, loss_scale, eps=None, perms=None) -> (state,
    metrics)``.

    ``idx`` are window indices; ``eps`` (B, z) overrides the sample noise and
    ``perms`` (``draw_adv_perms``' layout) the adversarial shuffles, both
    drawn from ``state.generator`` otherwise. Parameters, moments, BatchNorm
    statistics and the discriminators update in place; metrics stay on the
    device. ``adv_tx`` is the discriminators' optimizer;
    ``static_loss_scale`` the configured loss weights (``compute_batch_loss``).
    """
    params = list(model.parameters())
    slices = _device_slices(feat_slices, params[0].device)
    use_mcmi = "mcmi" in loss_keys

    def step(state: TrainState, idx, loss_scale: Dict[str, float], eps: Optional[torch.Tensor] = None, perms=None):
        data = batch_fn(idx)
        B = data["x6d"].shape[0]
        if eps is None:
            eps = torch.randn((B, model.vae.z_dim), generator=state.generator, device=data["x6d"].device)
        if state.adv_states and perms is None:
            perms = draw_adv_perms(state.generator, B, list(state.adv_states), adv_n_iter)
        model.train()
        out = model(data, eps=eps, generator=state.generator)
        bl, new_scrub = compute_batch_loss(
            data, out, loss_scale, disentangle_config, tree, state.scrub_state,
            adv_states=state.adv_states, mi_state=state.mi_state,
            adv_perm=perms["loss"] if perms else None, feat_slices=slices,
            static_loss_scale=static_loss_scale,
        )
        grads = torch.autograd.grad(bl["total"], params, allow_unused=True)
        opt_state = tx.update_and_apply(grads, state.opt_state, params)
        mu_det = out["mu"].detach()
        for method, update in STREAMING_UPDATES.items():
            for k, st in new_scrub.get(method, {}).items():
                new_scrub[method][k] = update(st, mu_det, data[k])
        new_adv = dict(state.adv_states)
        if adv_fit:
            for k in new_adv:
                new_adv[k] = scr.adv_fit(adv_tx, new_adv[k], mu_det, out["var"], slices[k], perms["fit"][k])
        mi_state = state.mi_state
        if use_mcmi:
            mi_state = encode_mi_state(model, data, out["var"].detach(), mcmi_bandwidth, mcmi_var_mode)
        metrics = {k: v.detach() for k, v in bl.items()}
        new_state = state.replace(
            step=state.step + 1, opt_state=opt_state, scrub_state=new_scrub,
            adv_states=new_adv, mi_state=mi_state,
        )
        return new_state, metrics

    return step


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
    """Build ``step(state, idx, loss_scale, data=None, generator=None) ->
    (losses, mu)``: the forward in eval mode (BatchNorm running statistics,
    no dropout, z = mu) and the loss terms, with no gradient and no state change; the
    scrubber state that the losses return is dropped. ``data`` is the
    assembled batch of ``idx`` when the caller has it already; the
    adversarial losses' shuffle is drawn from ``generator``.

    The Cholesky head runs only when a loss reads it: ``mu_only`` is fixed
    here, when neither ``prior`` nor ``total_correlation`` is a loss key.
    """
    mu_only = not any(k in loss_keys for k in ("prior", "total_correlation"))
    slices = _device_slices(feat_slices, next(model.parameters()).device)

    @torch.no_grad()
    def step(state: TrainState, idx, loss_scale: Dict[str, float], data=None, generator=None):
        if data is None:
            data = batch_fn(idx)
        adv_perm = None
        if state.adv_states:
            adv_perm = torch.randperm(data["x6d"].shape[0], generator=generator, device=generator.device)
        model.eval()
        out = model(data, mu_only=mu_only)
        bl, _ = compute_batch_loss(
            data, out, loss_scale, disentangle_config, tree, state.scrub_state,
            adv_states=state.adv_states, mi_state=state.mi_state, adv_perm=adv_perm, feat_slices=slices,
            static_loss_scale=static_loss_scale,
        )
        return bl, out["mu"]

    return step
