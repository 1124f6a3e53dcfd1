"""Batch-loss assembly (counterpart of ``compute_batch_loss`` in
``scrubvae_tpu/train/losses.py``): rotation, prior (packed or dense head,
or the beta prior),
jpe, root, mcmi, the per-feature scrubber losses ``{feat}_mals``,
``{feat}_qda``, ``{feat}_lsq``, ``{feat}_lin``, ``{feat}_gr``, ``{feat}_ma``
and ``{feat}_an``, and total_correlation. ``total`` is the loss-scale
weighted sum, in the order the terms were added, which is the JAX
package's.

On a data-parallel mesh (``mesh`` with a data axis, ``parallel.mesh``)
``data`` and ``data_o`` hold this rank's rows of the global batch. The
per-row terms (rotation, prior, jpe, root, mcmi, ``_lin``, ``_gr``) are this
rank's sums over the global batch's divisor; their values are summed over
``data`` while their gradients stay this rank's. The terms that couple rows
(``_mals``, ``_qda``, ``_lsq``, ``_ma``, ``_an``, total correlation) run
replicated on the latents and labels gathered over ``data``, whose
backward keeps this rank's rows. So ``total`` has the global value on
every rank and its gradient, summed over ``data``, is the single-device
step's."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.models.layers import packed_to_L
from scrubvae_torch.ops import losses as L
from scrubvae_torch.ops.kinematics import KinematicTree
from scrubvae_torch.parallel.mesh import data_parallel, gather_rows, global_value, reduce_sum
from scrubvae_torch.utils.profiling import stamp

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
    mesh=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Dict]]:
    """Returns (batch-loss dict incl. 'total', new scrub state).
    ``loss_scale`` maps each loss key to its weight: a float, or a 0-dim
    float64 tensor on the device.
    ``adv_perm`` is the batch permutation of every ``{feat}_an`` loss's
    shuffle, ``feat_slices[feat]`` the columns of ``feat`` in ``var``.
    ``static_loss_scale`` holds the configured loss weights: the sign of
    ``{feat}_lsq``'s there, not the weight of this step, decides the bias
    column of ``direct_lsq`` (none when it is not given). ``mesh``: see
    the module docstring; ``adv_perm`` then permutes the global batch."""
    dp = data_parallel(mesh)
    batch_size = data["x6d"].shape[0] * (dp.data if dp else 1)
    divisor = batch_size if dp else None
    bl: Dict[str, torch.Tensor] = {}
    rowwise = []  # the keys of the per-row terms
    new_state = {m: dict(v) for m, v in scrub_state.items()}
    gathered: Dict[int, torch.Tensor] = {}

    def glob(t: torch.Tensor) -> torch.Tensor:
        """``t`` over the global batch (each tensor gathered once)."""
        if id(t) not in gathered:
            gathered[id(t)] = gather_rows(t, dp)
        return gathered[id(t)]

    def per_row(key: str, value: torch.Tensor) -> None:
        bl[key] = value
        rowwise.append(key)

    if "rotation" in loss_scale:
        per_row("rotation", L.stable_rotation_loss(data["x6d"], data_o["x6d"]))
    if "prior" in loss_scale:
        if "Lp" in data_o:
            per_row("prior", L.prior_loss_packed(data_o["mu"], data_o["Lp"], batch=divisor))
        elif "alpha" in data_o:
            per_row("prior", L.beta_prior_loss(data_o["alpha"], data_o["beta"], batch=divisor))
        else:
            per_row("prior", L.prior_loss(data_o["mu"], data_o["L"], batch=divisor))
    if "jpe" in loss_scale:
        per_row("jpe", L.mpjpe_loss(data["target_pose"], data_o["x6d"], tree, data["offsets"], batch=divisor))
    if "root" in loss_scale:
        per_row("root", L.mse_sum(data_o["root"], data["root"]) / batch_size)
    stamp("losses")  # a traced train step's reconstruction and prior terms end here
    if "mcmi" in loss_scale:
        if mi_state is not None:
            # valid is 0 until the estimator's first refresh
            per_row("mcmi", mi_state.valid * scr.mi_score(mi_state, data_o["mu"], data_o["var"], batch=divisor))
        else:
            per_row("mcmi", torch.zeros((), device=data["x6d"].device))

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
                yhat0, yhat1 = scr.mals_forward(st, glob(latent))
                loss, st2 = scr.mals_loss(st, yhat0, yhat1, glob(data[key]))
                bl[key + "_mals"] = loss / batch_size
                new_state["moving_avg_lsq"][key] = st2
            elif method == "qda":
                loss, st2 = scr.qda_loss(scrub_state["qda"][key], glob(latent), glob(data[key]))
                bl[key + "_qda"] = loss / batch_size
                new_state["qda"][key] = st2
            elif method == "direct_lsq":
                sls = static_loss_scale or {}
                bl[key + "_lsq"] = L.direct_lsq_loss(
                    glob(latent), glob(data[key]), bias=float(sls.get(key + "_lsq", 0.0)) < 0
                )
            elif method == "linear":
                per_row(
                    key + "_lin",
                    L.mse_sum(data_o["disentangle"]["linear"][key]["v"], data[key]) / num_keys / batch_size,
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
                per_row(key + "_gr", total if legacy else total / denom)
            elif method == "moving_avg":
                loss, st2 = scr.ma_loss(scrub_state["moving_avg"][key], glob(latent), glob(data[key]))
                bl[key + "_ma"] = loss
                new_state["moving_avg"][key] = st2
            elif method == "adversarial_net":
                bl[key + "_an"] = scr.adv_generator_loss(
                    adv_states[key], glob(data_o["mu"]), glob(data_o["var"]), feat_slices[key], adv_perm
                )

    if "total_correlation" in loss_scale:
        # a packed head forced together with the loss is materialised
        sigma = glob(data_o["L"] if "L" in data_o else data_o["Lp"])
        L_full = sigma if "L" in data_o else packed_to_L(sigma, data_o["mu"].shape[1])
        bl["total_correlation"] = L.total_correlation(glob(data_o["z"]), glob(data_o["mu"]), L_full)

    if dp is not None and rowwise:
        sums = reduce_sum([bl[k].detach() for k in rowwise], dp.data_group)
        for k, v in zip(rowwise, sums):
            bl[k] = global_value(bl[k], v)

    total = torch.zeros((), device=data["x6d"].device)
    for k, v in bl.items():
        w = loss_scale.get(k)
        if w is None:
            continue
        # a weight on the device (a captured step's, train.graph) is
        # rounded to the term's dtype, as a Python float weight is
        total = total + (w.to(v.dtype) if isinstance(w, torch.Tensor) else w) * v
    bl["total"] = total
    stamp("scrub_forward")
    return bl, new_state
