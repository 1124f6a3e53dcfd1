"""The skeleton, the window index and the window assembly, plain PyTorch.

A frozen copy of what the measured program derives from a raw pose
stream: per-frame inverse kinematics, scaled offsets, yaw, cont6d and
zero-root forward kinematics; window starts within one animal's frames,
strided, with the speed-outlier filter; and per batch the midfwd
alignment (mid-frame xy centring, the half-yaw rotation of the root
quaternion, the root trajectory and the target pose), the speed features
normalised by the reference dataset's statistics, the heading and the ids.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import yaml

from benchmark.reference import geometry as geo

SPEED_PARTS = ((0, 1, 2, 3, 4, 5), (1, 6, 7, 8, 9, 10, 11), (5, 12, 13, 14, 15, 16, 17))
AVG_SPEED_3D_MEAN = (0.4993, 0.7112, 0.6663)
AVG_SPEED_3D_STD = (0.4038, 0.3586, 0.4169)


@dataclasses.dataclass(frozen=True)
class Skeleton:
    labels: list
    tree: geo.KinematicTree
    int_offsets: bool

    @property
    def n_keypts(self) -> int:
        return len(self.labels)


def load_skeleton(path) -> Skeleton:
    with open(path) as f:
        cfg = yaml.safe_load(f)
    tree = geo.KinematicTree.build(cfg["KINEMATIC_TREE"], cfg["OFFSET"])
    return Skeleton(list(cfg["LABELS"]), tree, bool(np.issubdtype(np.asarray(cfg["OFFSET"]).dtype, np.integer)))


def window_starts(ids: np.ndarray, stride: int, window: int) -> np.ndarray:
    ids = np.asarray(ids)
    bounds = np.concatenate([[0], np.nonzero(np.diff(ids) != 0)[0] + 1, [len(ids)]])
    starts = [np.arange(lo, hi - window + 1, stride, dtype=np.int64) for lo, hi in zip(bounds[:-1], bounds[1:])
              if hi - lo >= window]
    return np.concatenate(starts) if starts else np.zeros((0,), np.int64)


def speed_outlier_mask(pose: np.ndarray, starts: np.ndarray, window: int, threshold: float = 2.25) -> np.ndarray:
    disp = np.sqrt((np.diff(pose, axis=0) ** 2).sum(-1)).mean(-1)
    csum = np.concatenate([[0.0], np.cumsum(disp)])
    return (csum[starts + window - 1] - csum[starts]) / (window - 1) <= threshold


@dataclasses.dataclass
class FrameStore:
    pose: torch.Tensor
    local_quat: torch.Tensor
    offsets: torch.Tensor
    yaw: torch.Tensor
    ids: torch.Tensor
    starts: torch.Tensor
    window: int
    x6d: torch.Tensor
    tpose: torch.Tensor
    speed_mean: torch.Tensor
    speed_std: torch.Tensor

    def __len__(self) -> int:
        return int(self.starts.shape[0])


@torch.no_grad()
def build_frame_store(pose: np.ndarray, ids: np.ndarray, skeleton: Skeleton, window: int, stride: int,
                      device, speed_threshold: Optional[float] = 2.25) -> FrameStore:
    tree = skeleton.tree
    starts = window_starts(ids, stride, window)
    if speed_threshold is not None:
        starts = starts[speed_outlier_mask(pose, starts, window, speed_threshold)]
    p = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    local_q = geo.inv_kin(p, tree, forward_indices=[1, 0])
    offs = geo.segment_lengths(p, tree)
    if skeleton.int_offsets:
        offs = torch.trunc(offs)
    x6d = geo.quaternion_to_cont6d(local_q)
    tpose = geo.fwd_kin_cont6d(x6d, tree, offs, root_pos=p.new_zeros(p.shape[:-2] + (3,)), do_root_R=True, eps=1e-8)
    f32 = dict(dtype=torch.float32, device=device)
    return FrameStore(
        pose=p, local_quat=local_q, offsets=offs, yaw=geo.frame_yaw(p, 0, 1),
        ids=torch.as_tensor(np.asarray(ids, np.int32), device=device),
        starts=torch.as_tensor(starts, dtype=torch.int64, device=device), window=window, x6d=x6d, tpose=tpose,
        speed_mean=torch.tensor(AVG_SPEED_3D_MEAN, **f32), speed_std=torch.tensor(AVG_SPEED_3D_STD, **f32),
    )


@torch.no_grad()
def assemble(store: FrameStore, tree: geo.KinematicTree, idx: torch.Tensor, keys: Sequence[str],
             direction_process: str = "midfwd") -> Dict[str, torch.Tensor]:
    """The batch of the windows whose dataset indices are ``idx`` (B,)."""
    start = store.starts[idx]
    W = store.window
    fidx = start[:, None] + torch.arange(W, device=start.device)[None, :]
    mid = start + W // 2
    out: Dict[str, torch.Tensor] = {}
    yaw_mid = store.yaw[mid]
    if "heading" in keys:
        out["heading"] = geo.angle2D(yaw_mid[:, None])
    if "avg_speed_3d" in keys:
        spd = geo.speed_parts(store.pose[fidx], SPEED_PARTS)
        avg3 = torch.cat([spd[:, :2], spd[:, 2:].mean(dim=-1, keepdim=True)], dim=-1)
        out["avg_speed_3d"] = (avg3 - store.speed_mean) / store.speed_std
    midfwd = direction_process == "midfwd"
    root0 = store.pose[:, 0, :]
    root = root0[fidx]
    if direction_process in ("midfwd", "x360"):
        center = root0[mid].clone()
        center[:, 2] = 0.0
        root = root - center[:, None, :]
    x6d = store.x6d[fidx]
    tp = store.tpose[fidx]
    if midfwd:
        fwd_q = geo.yaw_quat(yaw_mid)[:, None, :]
        root = geo.qrot(fwd_q, root)
        root_q = geo.qmul(fwd_q, store.local_quat[:, 0, :][fidx])
        x6d = torch.cat([geo.quaternion_to_cont6d(root_q)[:, :, None, :], x6d[:, :, 1:]], dim=2)
        tp = geo.qrot(fwd_q[:, :, None, :], tp)
    out.update(x6d=x6d, root=root, target_pose=tp, offsets=store.offsets[fidx], ids=store.ids[mid])
    return {k: v for k, v in out.items() if k in keys}
