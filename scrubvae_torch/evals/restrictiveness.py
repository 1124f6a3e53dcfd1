"""Generative restrictiveness (counterpart of
``generative_restrictiveness_batch`` in
``scrubvae_tpu/evals/restrictiveness.py``): randomize a conditioned
factor, decode the same latent with it, and re-measure the factor from the
generated pose (reference eval/eval.py:22-120).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from scrubvae_torch.ops import kinematics as kin

__all__ = ["generative_restrictiveness_batch"]

# The reference's hardcoded speed jitter stats and clamps (eval/eval.py:41-56).
SPD_STD = (0.4038, 0.3586, 0.4169)
SPD_MIN = (-1.2323, -1.9734, -1.5858)
SPD_MAX = (4.6167, 4.6437, 4.2551)
SPEED_PARTS = (
    (0, 1, 2, 3, 4, 5),
    (1, 6, 7, 8, 9, 10, 11),
    (5, 12, 13, 14, 15, 16, 17),
)


@torch.no_grad()
def generative_restrictiveness_batch(
    model,
    z: torch.Tensor,
    data: Dict[str, torch.Tensor],
    key: str,
    tree,
    norm_params: Optional[dict] = None,
    draw: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Returns (pred, target) for the factor ``key`` (heading or
    avg_speed_3d), decoding with ``model`` in eval mode.

    ``draw`` (B, 1) is the random draw: standard uniform for heading (the
    yaw is ``(2 u - 1) pi``), standard normal for avg_speed_3d (the jitter
    is ``n * SPD_STD * 1.5 + 0.5``). Without it the draw comes from
    ``generator``.
    """
    B, W, J = data["x6d"].shape[:3]
    dev = z.device
    data = dict(data)
    var_true = data[key]

    if key == "heading":
        u = draw if draw is not None else torch.rand((B, 1), generator=generator, device=dev)
        rand_yaw = (u * 2.0 - 1.0) * math.pi
        data["heading"] = torch.cat([torch.sin(rand_yaw), torch.cos(rand_yaw)], dim=-1)
    elif key == "avg_speed_3d":
        n = draw if draw is not None else torch.randn((B, 1), generator=generator, device=dev)
        jitter = n * torch.tensor(SPD_STD, device=dev) * 1.5 + 0.5
        data["avg_speed_3d"] = torch.clamp(
            var_true + jitter, torch.tensor(SPD_MIN, device=dev), torch.tensor(SPD_MAX, device=dev)
        )
    else:
        raise ValueError(f"unsupported factor {key!r}")

    model.eval()
    out = model.vae.decode(z, data)
    pose = kin.fwd_kin_cont6d(
        out["x6d"].reshape(-1, J, 6),
        tree,
        data["offsets"].reshape(-1, J, 3),
        root_pos=out["root"].reshape(-1, 3),
        do_root_R=True,
        eps=1e-8,
    ).reshape(B, W, J, 3)

    if key == "heading":
        fwd = pose[:, W // 2, 1, :] - pose[:, W // 2, 0, :]
        fwd = fwd / torch.linalg.norm(fwd, dim=-1, keepdim=True)
        yaw = -torch.atan2(fwd[:, 1], fwd[:, 0])[:, None]
        pred = torch.cat([torch.sin(yaw), torch.cos(yaw)], dim=-1)
    else:
        root_d = torch.diff(pose[:, :, 0, :], n=1, dim=-2)
        root_spd = torch.sqrt((root_d**2).sum(-1)).mean(-1)
        cols = []
        for part in SPEED_PARTS:
            # the reference centres on the mid-frame part root here
            # (eval/eval.py:86-98), unlike preprocessing
            center = pose[:, W // 2, part[0], :][:, None, None, :]
            rel = torch.diff((pose - center)[..., list(part[1:]), :], n=1, dim=-3)
            cols.append(torch.sqrt((rel**2).sum(-1)).mean(dim=(-1, -2)))
        dxyz = torch.stack(cols, dim=-1)
        pred = torch.cat(
            [root_spd[:, None], dxyz[:, 0:1], dxyz[:, 1:].mean(dim=-1, keepdim=True)], dim=-1
        )
        stats = (norm_params or {}).get("avg_speed_3d")
        if stats is not None:
            pred = (pred - stats["mean"]) / stats["std"]

    return pred, data[key]
