"""The train step (counterpart of ``make_train_step`` of
``scrubvae_tpu/train/step.py``), in the JAX order: window assembly,
forward, loss, backward, fused optimizer, then the MALS update on the
detached mu."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.train.losses import compute_batch_loss
from scrubvae_torch.train.state import TrainState

__all__ = ["make_train_step"]


def make_train_step(
    model: nn.Module,
    tx,
    tree,
    *,
    disentangle_config: dict,
    batch_fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
) -> Callable:
    """Build ``step(state, idx, loss_scale, eps=None) -> (state, metrics)``.

    ``idx`` are window indices; ``eps`` (B, z) overrides the sample noise
    drawn from ``state.generator``. Parameters, moments and BatchNorm
    statistics update in place; metrics stay on the device.
    """
    params = list(model.parameters())

    def step(state: TrainState, idx, loss_scale: Dict[str, float], eps: Optional[torch.Tensor] = None):
        data = batch_fn(idx)
        if eps is None:
            eps = torch.randn(
                (data["x6d"].shape[0], model.vae.z_dim), generator=state.generator,
                device=data["x6d"].device,
            )
        model.train()
        out = model(data, eps=eps)
        bl, new_scrub = compute_batch_loss(
            data, out, loss_scale, disentangle_config, tree, state.scrub_state
        )
        grads = torch.autograd.grad(bl["total"], params, allow_unused=True)
        opt_state = tx.update_and_apply(grads, state.opt_state, params)
        mu_det = out["mu"].detach()
        for k, st in new_scrub.get("moving_avg_lsq", {}).items():
            new_scrub["moving_avg_lsq"][k] = scr.mals_update(st, mu_det, data[k])
        metrics = {k: v.detach() for k, v in bl.items()}
        return state.replace(step=state.step + 1, opt_state=opt_state, scrub_state=new_scrub), metrics

    return step
