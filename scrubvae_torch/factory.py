"""Configs -> model and scrubber state (counterpart of ``feat_dims``,
``in_channels_for``, ``build_model`` and ``init_scrub_state`` in
``scrubvae_tpu/factory.py``; ``rcnn`` only)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from scrubvae_torch.device import resolve_device
from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.models.layers import (
    BatchNorm1d,
    Conv1d,
    ConvTranspose1d,
    Linear,
    PReLU,
    lecun_normal_,
)
from scrubvae_torch.models.residual import ResVAE
from scrubvae_torch.models.scrubvae import ScrubVAE

__all__ = ["feat_dims", "in_channels_for", "build_model", "init_weights", "init_scrub_state"]


def feat_dims(model_config: dict, discrete_classes: Optional[dict] = None) -> dict:
    """Feature-name -> dimension map."""
    window = model_config.get("window") or 51
    dims = {
        "avg_speed": 1,
        "part_speed": 4,
        "frame_speed": window - 1,
        "avg_speed_3d": 3,
        "heading": 2,
        "heading_change": 1,
        "fluorescence": 1,
    }
    if discrete_classes:
        dims.update({k: len(v) for k, v in discrete_classes.items()})
    return dims


def in_channels_for(n_keypts: int, direction_process: Optional[str]) -> int:
    """x6d channels, +3 root channels unless the representation drops the root."""
    c = n_keypts * 6
    if direction_process in ("x360", "midfwd", None):
        c += 3
    return c


def build_model(
    model_config: dict,
    disentangle_config: dict,
    n_keypts: int,
    direction_process: Optional[str],
    arena_size=None,
    discrete_classes: Optional[dict] = None,
    loss_keys=None,
    device="cuda",
) -> tuple:
    """Construct the ScrubVAE on ``device``. Returns (model, info)."""
    dev = resolve_device(device)
    mtype = model_config.get("type") or "rcnn"
    if mtype != "rcnn":
        raise NotImplementedError(f"scrubvae_torch builds the rcnn model only (got {mtype!r})")
    if loss_keys is not None and "total_correlation" in set(loss_keys):
        raise NotImplementedError("scrubvae_torch has no total_correlation loss yet")
    if model_config.get("packed_sigma") is False:
        raise NotImplementedError("scrubvae_torch implements the packed Cholesky head only")
    methods = disentangle_config.get("method") or {}
    fdims = feat_dims(model_config, discrete_classes)
    conditional_keys = list(methods.get("conditional", []))
    conditional_dim = sum(fdims[k] for k in conditional_keys)
    in_ch = in_channels_for(n_keypts, direction_process)
    if in_ch > n_keypts * 6 and arena_size is None:
        raise ValueError(
            f"direction_process={direction_process!r} includes the 3 root channels, "
            "which requires data.arena_size for root normalization"
        )
    z_dim = model_config.get("z_dim") or 128
    window = model_config.get("window") or 51
    vae = ResVAE(
        in_channels=in_ch,
        ch=tuple(model_config.get("channel") or (64, 128, 256, 512, 1024)),
        kernel=model_config.get("kernel") or 5,
        z_dim=z_dim,
        window=window,
        activation=model_config.get("activation") or "prelu",
        is_diag=bool(model_config.get("diag")),
        conditional_dim=conditional_dim,
        init_dilation=model_config.get("init_dilation"),
        prior=model_config.get("prior") or "gaussian",
        arena_size=None if arena_size is None else np.asarray(arena_size, np.float32),
        conditional_keys=conditional_keys,
        discrete_classes={k: len(v) for k, v in (discrete_classes or {}).items()} or None,
        precision=model_config.get("precision") or "fp32",
        sigma_head_rank=model_config.get("sigma_head_rank"),
    )
    model = ScrubVAE(
        vae,
        linear_dims={k: fdims[k] for k in methods.get("linear", [])},
        gr_dims={k: fdims[k] for k in methods.get("grad_reversal", [])},
        gr_alpha=float(disentangle_config.get("alpha") or 1.0),
    ).to(dev)
    info = dict(
        in_channels=in_ch,
        conditional_keys=conditional_keys,
        conditional_dim=conditional_dim,
        disentangle_keys=list(disentangle_config.get("features") or []),
        feat_dims=fdims,
        window=window,
        z_dim=z_dim,
    )
    return model, info


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Deterministic init from ``seed``, drawn on the CPU so every device
    gets the same weights: flax's defaults (lecun-normal kernels, zero
    biases, unit BatchNorm scales, PReLU 0.25) and fresh running stats."""
    gen = torch.Generator().manual_seed(seed)

    def lecun(w: torch.Tensor, fan_in: int) -> None:
        tmp = torch.empty(w.shape, dtype=torch.float32)
        lecun_normal_(tmp, fan_in, gen)
        w.copy_(tmp)

    for m in model.modules():
        if isinstance(m, (Conv1d, ConvTranspose1d, Linear)):
            fan_in = m.in_features if isinstance(m, Linear) else m.in_channels * m.kernel_size[0]
            lecun(m.weight, fan_in)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, scr.LinearProjection):
            lecun(m.weight, m.weight.shape[0])
        elif isinstance(m, BatchNorm1d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        elif isinstance(m, PReLU):
            m.weight.fill_(0.25)


def init_scrub_state(
    disentangle_config: dict, loss_config: dict, z_dim: int, fdims: dict, device="cuda"
) -> Dict[str, Dict]:
    """Streaming scrubber states per feature (MALS only in this port)."""
    dev = resolve_device(device)
    methods = disentangle_config.get("method") or {}
    scrub_state: Dict[str, Dict] = {}
    if "moving_avg_lsq" in methods:
        scrub_state["moving_avg_lsq"] = {
            feat: scr.mals_init(
                z_dim,
                fdims[feat],
                bias=(loss_config or {}).get(feat + "_mals", 0) < 0,
                polynomial_order=int(disentangle_config.get("polynomial") or 1),
                l2_reg=float(disentangle_config.get("l2_reg") or 0.0),
                device=dev,
            )
            for feat in methods["moving_avg_lsq"]
        }
    return scrub_state
