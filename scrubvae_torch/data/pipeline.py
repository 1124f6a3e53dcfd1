"""Device-resident preprocessing pipeline (counterpart of
``scrubvae_tpu/data/pipeline.py``: ``build_frame_store``,
``assemble_windows`` and ``materialize``).

* Per-frame stage, once, on the device: IK to local quaternions, per-frame
  segment-length offsets and yaw, plus the cont6d representation and the
  zero-root forward kinematics of every frame.
* Per-window stage, inside each train step: gather the batch's (B, W)
  frames, centre on the mid frame and rotate into its heading (midfwd),
  centre only (x360) or neither (any other direction process), and
  compute the windowed speed features and, when asked for, the
  heading-free encoder view.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from scrubvae_torch.data.skeleton import Skeleton
from scrubvae_torch.data.windows import speed_outlier_mask, window_starts
from scrubvae_torch.device import resolve_device
from scrubvae_torch.ops import kinematics as kin
from scrubvae_torch.ops import quaternion as qtn

__all__ = ["FrameStore", "build_frame_store", "assemble_windows", "materialize"]

SPEED_PARTS = (
    (0, 1, 2, 3, 4, 5),  # spine and head
    (1, 6, 7, 8, 9, 10, 11),  # arms from front spine
    (5, 12, 13, 14, 15, 16, 17),  # legs from back spine
)

# Reference-dataset normalisation stats of avg_speed_3d.
AVG_SPEED_3D_MEAN = (0.4993, 0.7112, 0.6663)
AVG_SPEED_3D_STD = (0.4038, 0.3586, 0.4169)


@dataclasses.dataclass
class FrameStore:
    """Per-frame arrays on the device plus window start indices."""

    pose: torch.Tensor  # (T, J, 3) raw pose
    local_quat: torch.Tensor  # (T, J, 4) per-frame IK
    offsets: torch.Tensor  # (T, J, 3) per-frame scaled offsets
    yaw: torch.Tensor  # (T,) per-frame root yaw
    ids: torch.Tensor  # (T,) animal id per frame
    starts: torch.Tensor  # (N,) window start frames
    window: int
    norm_params: Dict[str, Dict[str, torch.Tensor]]
    x6d: torch.Tensor  # (T, J, 6) cont6d of local_quat
    tpose: torch.Tensor  # (T, J, 3) zero-root FK per frame
    part_centered_speed: bool = False

    @property
    def n_windows(self) -> int:
        return int(self.starts.shape[0])

    @property
    def device(self) -> torch.device:
        return self.pose.device


@torch.no_grad()
def build_frame_store(
    pose: np.ndarray,
    ids: np.ndarray,
    skeleton: Skeleton,
    window: int = 51,
    stride: int = 2,
    speed_threshold: Optional[float] = 2.25,
    norm_params: Optional[dict] = None,
    exact_offsets: bool = False,
    part_centered_speed: bool = False,
    device="cuda",
) -> FrameStore:
    """Per-frame preprocessing + window index build, on ``device``.

    By default the reference's integer-truncated scaled offsets (integer
    skeleton yaml) and its no-op speed part-centering are replicated;
    ``exact_offsets`` / ``part_centered_speed`` opt into the intended
    semantics.
    """
    dev = resolve_device(device)
    tree = skeleton.tree
    truncate_offsets = skeleton.int_offsets and not exact_offsets
    starts = window_starts(ids, stride, window)
    if speed_threshold is not None:
        starts = starts[speed_outlier_mask(pose, starts, window, speed_threshold)]

    p = torch.as_tensor(np.asarray(pose, dtype=np.float32), device=dev)
    local_q = kin.inv_kin(p, tree, forward_indices=[1, 0])
    offs = kin.segment_lengths(p, tree)
    if truncate_offsets:
        offs = torch.trunc(offs)
    yaw = kin.frame_yaw(p, 0, 1)
    x6d = qtn.quaternion_to_cont6d(local_q)
    tpose = kin.fwd_kin_cont6d(
        x6d, tree, offs, root_pos=p.new_zeros(p.shape[:-2] + (3,)), do_root_R=True, eps=1e-8
    )
    if norm_params is None:
        norm_params = {
            "avg_speed_3d": {
                "mean": torch.tensor(AVG_SPEED_3D_MEAN, device=dev),
                "std": torch.tensor(AVG_SPEED_3D_STD, device=dev),
            }
        }
    return FrameStore(
        pose=p,
        local_quat=local_q,
        offsets=offs,
        yaw=yaw,
        ids=torch.as_tensor(np.asarray(ids, dtype=np.int32), device=dev),
        starts=torch.as_tensor(starts, dtype=torch.int64, device=dev),
        window=window,
        norm_params=norm_params,
        x6d=x6d,
        tpose=tpose,
        part_centered_speed=part_centered_speed,
    )


SUPPORTED_KEYS = (
    "x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids",
    "raw_pose", "x6d_enc", "root_enc",
)


@torch.no_grad()
def assemble_windows(
    store: FrameStore,
    tree: kin.KinematicTree,
    start_idx: torch.Tensor,
    data_keys: Sequence[str],
    direction_process: str = "midfwd",
) -> Dict[str, torch.Tensor]:
    """Per-window stage for the windows starting at ``start_idx`` (B,):
    with midfwd and x360, mid-frame xy centering of the root; with midfwd,
    also the half-yaw rotation of the root quaternion, the root trajectory
    and the target pose into the mid-frame heading; with x360, none (the
    absolute representation); with any other process, neither (the root as
    recorded). Then the
    precomputed cont6d and target pose, the windowed speed features, the
    mid-frame heading and the raw pose window.

    ``x6d_enc``/``root_enc`` are a heading-free view of the same window for
    the encoder (``data.encoder_direction_process``): the root trajectory
    rotated into the mid-frame heading, and the IK of the pose window
    centred on the mid-frame root (all three coordinates) and rotated the
    same way. The IK is run again per window because its child-joint
    rotations are not yaw-equivariant, so rotating the per-frame cont6d
    would leave the heading in every limb row."""
    unknown = set(data_keys) - set(SUPPORTED_KEYS)
    if unknown:
        raise KeyError(f"no per-window key {sorted(unknown)} in a frame store; known: {SUPPORTED_KEYS}")
    W = store.window
    fidx = start_idx[:, None] + torch.arange(W, device=start_idx.device)[None, :]
    mid = start_idx + W // 2
    out: Dict[str, torch.Tensor] = {}
    yaw_mid = store.yaw[mid]  # (B,)
    need_pose = any(k in data_keys for k in ("avg_speed_3d", "raw_pose", "x6d_enc"))
    pose_w = store.pose[fidx] if need_pose else None  # (B, W, J, 3)

    if "heading" in data_keys:
        out["heading"] = kin.angle2D(yaw_mid[:, None])

    if "avg_speed_3d" in data_keys:
        spd = kin.speed_parts(pose_w, SPEED_PARTS, store.part_centered_speed)
        avg3 = torch.cat([spd[:, :2], spd[:, 2:].mean(dim=-1, keepdim=True)], dim=-1)
        stats = store.norm_params.get("avg_speed_3d")
        if stats is not None:
            avg3 = (avg3 - stats["mean"]) / stats["std"]
        out["avg_speed_3d"] = avg3

    want_enc = "x6d_enc" in data_keys or "root_enc" in data_keys
    if want_enc or any(k in data_keys for k in ("root", "x6d", "target_pose")):
        midfwd = direction_process == "midfwd"
        root0 = store.pose[:, 0, :]
        root = root0[fidx]
        if direction_process in ("midfwd", "x360"):
            center = root0[mid].clone()
            center[:, 2] = 0.0  # xy centering only
            root = root - center[:, None, :]
        fwd_q = qtn.yaw_quat(yaw_mid)[:, None, :] if midfwd or want_enc else None  # (B, 1, 4)
        if "root_enc" in data_keys:
            out["root_enc"] = qtn.qrot(fwd_q, root)
        if "x6d_enc" in data_keys:
            pw = qtn.qrot(fwd_q[:, :, None, :], pose_w - root0[mid][:, None, None, :])
            out["x6d_enc"] = qtn.quaternion_to_cont6d(kin.inv_kin(pw, tree, forward_indices=[1, 0]))
        x6d = store.x6d[fidx]  # (B, W, J, 6)
        if midfwd:
            root = qtn.qrot(fwd_q, root)
            root_q = qtn.qmul(fwd_q, store.local_quat[:, 0, :][fidx])
            x6d = torch.cat([qtn.quaternion_to_cont6d(root_q)[:, :, None, :], x6d[:, :, 1:]], dim=2)
        if "x6d" in data_keys:
            out["x6d"] = x6d
        if "root" in data_keys:
            out["root"] = root
        if "target_pose" in data_keys:
            # zero-root FK rotates rigidly with the yaw alignment
            tp = store.tpose[fidx]
            out["target_pose"] = qtn.qrot(fwd_q[:, :, None, :], tp) if midfwd else tp

    if "offsets" in data_keys:
        out["offsets"] = store.offsets[fidx]
    if "raw_pose" in data_keys:
        out["raw_pose"] = pose_w
    if "ids" in data_keys:
        out["ids"] = store.ids[mid]
    return out


def materialize(
    store: FrameStore,
    tree: kin.KinematicTree,
    data_keys: Sequence[str],
    direction_process: str = "midfwd",
    chunk: int = 4096,
) -> Dict[str, np.ndarray]:
    """Run the per-window stage over every window, ``chunk`` windows at a
    time, and return numpy arrays with one row per window."""
    outs: Dict[str, list] = {}
    for lo in range(0, store.n_windows, chunk):
        res = assemble_windows(store, tree, store.starts[lo : lo + chunk], tuple(data_keys), direction_process)
        for k, v in res.items():
            outs.setdefault(k, []).append(v.cpu().numpy())
    return {k: np.concatenate(v, axis=0) for k, v in outs.items()}
