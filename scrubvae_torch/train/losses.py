"""Batch-loss assembly (counterpart of ``compute_batch_loss`` in
``scrubvae_tpu/train/losses.py``): rotation, prior (packed or dense head),
jpe, root, mcmi, the per-feature scrubber losses ``{feat}_mals``,
``{feat}_qda``, ``{feat}_lsq``, ``{feat}_lin``, ``{feat}_gr``, ``{feat}_ma``
and ``{feat}_an``, and total_correlation. ``total`` is the loss-scale
weighted sum, in the order the terms were added, which is the JAX
package's."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.models.layers import packed_to_L
from scrubvae_torch.ops import losses as L
from scrubvae_torch.ops.kinematics import KinematicTree

__all__ = ["compute_batch_loss"]


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
    static_loss_scale: Optional[Dict[str, float]] = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Dict]]:
    """Returns (batch-loss dict incl. 'total', new scrub state).
    ``adv_perm`` is the batch permutation of every ``{feat}_an`` loss's
    shuffle, ``feat_slices[feat]`` the columns of ``feat`` in ``var``.
    ``static_loss_scale`` holds the configured loss weights: the sign of
    ``{feat}_lsq``'s there, not the weight of this step, decides the bias
    column of ``direct_lsq`` (none when it is not given)."""
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
            elif method == "direct_lsq":
                sls = static_loss_scale or {}
                bl[key + "_lsq"] = L.direct_lsq_loss(latent, data[key], bias=float(sls.get(key + "_lsq", 0.0)) < 0)
            elif method == "linear":
                bl[key + "_lin"] = (
                    L.mse_sum(data_o["disentangle"]["linear"][key]["v"], data[key])
                    / num_keys
                    / batch_size
                )
            elif method == "grad_reversal":
                heads = data_o["disentangle"]["grad_reversal"][key]
                # gr_legacy_norm: the reference divides the accumulated loss
                # inside the head loop, down-weighting the earlier heads
                legacy = bool(disentangle_config.get("gr_legacy_norm"))
                denom = len(heads) * num_keys * batch_size
                total = torch.zeros((), device=data["x6d"].device)
                for gr_e in heads:
                    if key == "ids":
                        # JAX's gather clamps a label past the last column
                        labels = data[key].reshape(-1).long().clamp(0, gr_e.shape[-1] - 1)
                        logp = torch.log_softmax(gr_e, dim=-1)
                        head_loss = -torch.sum(logp.gather(1, labels[:, None]))
                    else:
                        head_loss = L.mse_sum(gr_e, data[key])
                    total = total + head_loss
                    if legacy:
                        total = total / denom
                bl[key + "_gr"] = total if legacy else total / denom
            elif method == "moving_avg":
                loss, st2 = scr.ma_loss(scrub_state["moving_avg"][key], latent, data[key])
                bl[key + "_ma"] = loss
                new_state["moving_avg"][key] = st2
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
