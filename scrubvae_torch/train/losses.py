"""Batch-loss assembly (counterpart of ``compute_batch_loss`` in
``scrubvae_tpu/train/losses.py``) for the flagship loss keys: rotation,
prior (packed head), jpe, root and the per-feature scrubber losses
``{feat}_lin``, ``{feat}_mals`` and ``{feat}_gr``. ``total`` is the
loss-scale weighted sum, in the order the terms were added."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.ops import losses as L
from scrubvae_torch.ops.kinematics import KinematicTree

__all__ = ["compute_batch_loss"]

SUPPORTED_METHODS = ("conditional", "linear", "moving_avg_lsq", "grad_reversal")


def compute_batch_loss(
    data: Dict[str, torch.Tensor],
    data_o: Dict,
    loss_scale: Dict[str, float],
    disentangle_config: dict,
    tree: KinematicTree,
    scrub_state: Dict[str, Dict],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Dict]]:
    """Returns (batch-loss dict incl. 'total', new scrub state)."""
    batch_size = data["x6d"].shape[0]
    bl: Dict[str, torch.Tensor] = {}
    new_state = {m: dict(v) for m, v in scrub_state.items()}

    if "rotation" in loss_scale:
        bl["rotation"] = L.stable_rotation_loss(data["x6d"], data_o["x6d"])
    if "prior" in loss_scale:
        bl["prior"] = L.prior_loss_packed(data_o["mu"], data_o["Lp"])
    if "jpe" in loss_scale:
        bl["jpe"] = L.mpjpe_loss(data["target_pose"], data_o["x6d"], tree, data["offsets"])
    if "root" in loss_scale:
        bl["root"] = L.mse_sum(data_o["root"], data["root"]) / batch_size

    methods = disentangle_config.get("method") or {}
    unknown = set(methods) - set(SUPPORTED_METHODS)
    if unknown or disentangle_config.get("gr_legacy_norm") or "ids" in (methods.get("grad_reversal") or ()):
        raise NotImplementedError(
            f"scrubvae_torch has no scrubber {sorted(unknown)}, gr_legacy_norm or "
            "gradient reversal on ids yet"
        )
    linear_keys = set(methods.get("linear") or ())
    for method, keys in methods.items():
        if method == "conditional":
            continue
        num_keys = len(keys)
        for key in keys:
            if key in linear_keys:
                latent = data_o["disentangle"]["linear"][key]["z_null"]
            else:
                latent = data_o["mu"]
            if method == "moving_avg_lsq":
                st = scrub_state["moving_avg_lsq"][key]
                yhat0, yhat1 = scr.mals_forward(st, latent)
                loss, st2 = scr.mals_loss(st, yhat0, yhat1, data[key])
                bl[key + "_mals"] = loss / batch_size
                new_state["moving_avg_lsq"][key] = st2
            elif method == "linear":
                bl[key + "_lin"] = (
                    L.mse_sum(data_o["disentangle"]["linear"][key]["v"], data[key])
                    / num_keys
                    / batch_size
                )
            elif method == "grad_reversal":
                heads = data_o["disentangle"]["grad_reversal"][key]
                total = sum(L.mse_sum(gr_e, data[key]) for gr_e in heads)
                bl[key + "_gr"] = total / (len(heads) * num_keys * batch_size)

    total = torch.zeros((), device=data["x6d"].device)
    for k, v in bl.items():
        w = loss_scale.get(k)
        if w is None:
            continue
        total = total + w * v
    bl["total"] = total
    return bl, new_state
