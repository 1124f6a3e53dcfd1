"""Batch-loss assembly (counterpart of ``compute_batch_loss`` in
``scrubvae_tpu/train/losses.py``): rotation, prior (packed or dense head),
jpe, root, mcmi, the per-feature scrubber losses ``{feat}_mals``,
``{feat}_qda``, ``{feat}_lin``, ``{feat}_gr`` and ``{feat}_an``, and
total_correlation. ``total`` is the loss-scale weighted sum, in the order
the terms were added, which is the JAX package's."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.models.layers import packed_to_L
from scrubvae_torch.ops import losses as L
from scrubvae_torch.ops.kinematics import KinematicTree

__all__ = ["compute_batch_loss"]

SUPPORTED_METHODS = (
    "conditional", "linear", "moving_avg_lsq", "grad_reversal", "adversarial_net", "qda",
)


def _check_methods(disentangle_config: dict) -> None:
    """Raise ``NotImplementedError`` for a scrubber the port does not have."""
    methods = disentangle_config.get("method") or {}
    unknown = sorted(set(methods) - set(SUPPORTED_METHODS))
    if unknown or disentangle_config.get("gr_legacy_norm") or "ids" in (methods.get("grad_reversal") or ()):
        raise NotImplementedError(
            f"scrubvae_torch has no scrubber {unknown}, gr_legacy_norm or gradient reversal "
            "on ids yet (ROADMAP.md A8)"
        )


def compute_batch_loss(
    data: Dict[str, torch.Tensor],
    data_o: Dict,
    loss_scale: Dict[str, float],
    disentangle_config: dict,
    tree: KinematicTree,
    scrub_state: Dict[str, Dict],
    adv_states: Optional[Dict[str, scr.AdvState]] = None,
    mi_state: Optional[scr.MIState] = None,
    adv_perm: Optional[torch.Tensor] = None,
    feat_slices: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Dict]]:
    """Returns (batch-loss dict incl. 'total', new scrub state).
    ``adv_perm`` is the batch permutation of every ``{feat}_an`` loss's
    shuffle, ``feat_slices[feat]`` the columns of ``feat`` in ``var``."""
    batch_size = data["x6d"].shape[0]
    bl: Dict[str, torch.Tensor] = {}
    new_state = {m: dict(v) for m, v in scrub_state.items()}

    if "rotation" in loss_scale:
        bl["rotation"] = L.stable_rotation_loss(data["x6d"], data_o["x6d"])
    if "prior" in loss_scale:
        if "Lp" in data_o:
            bl["prior"] = L.prior_loss_packed(data_o["mu"], data_o["Lp"])
        else:
            bl["prior"] = L.prior_loss(data_o["mu"], data_o["L"])
    if "jpe" in loss_scale:
        bl["jpe"] = L.mpjpe_loss(data["target_pose"], data_o["x6d"], tree, data["offsets"])
    if "root" in loss_scale:
        bl["root"] = L.mse_sum(data_o["root"], data["root"]) / batch_size
    if "mcmi" in loss_scale:
        if mi_state is not None:
            # valid is 0 until the estimator's first refresh
            bl["mcmi"] = mi_state.valid * scr.mi_score(mi_state, data_o["mu"], data_o["var"])
        else:
            bl["mcmi"] = torch.zeros((), device=data["x6d"].device)

    _check_methods(disentangle_config)
    methods = disentangle_config.get("method") or {}
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
            elif method == "qda":
                loss, st2 = scr.qda_loss(scrub_state["qda"][key], latent, data[key])
                bl[key + "_qda"] = loss / batch_size
                new_state["qda"][key] = st2
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
            elif method == "adversarial_net":
                bl[key + "_an"] = scr.adv_generator_loss(
                    adv_states[key], data_o["mu"], data_o["var"], feat_slices[key], adv_perm
                )

    if "total_correlation" in loss_scale:
        # a packed head forced together with the loss is materialised
        L_full = data_o["L"] if "L" in data_o else packed_to_L(data_o["Lp"], data_o["mu"].shape[1])
        bl["total_correlation"] = L.total_correlation(data_o["z"], data_o["mu"], L_full)

    total = torch.zeros((), device=data["x6d"].device)
    for k, v in bl.items():
        w = loss_scale.get(k)
        if w is None:
            continue
        total = total + w * v
    bl["total"] = total
    return bl, new_state
