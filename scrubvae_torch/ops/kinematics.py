"""Skeleton kinematics in PyTorch (counterpart of
``scrubvae_tpu/ops/kinematics.py``).

The tree is compiled once into flat ``pos_parent``/``rot_parent`` index
arrays plus a level (topological-depth) grouping. IK is closed form and
parallel over joints; FK walks the static joints level by level with
batched 3x3 products. The first link of every chain composes its rotation
with the root's (``rot_parent`` = 0) while positions chain from the
previous joint (``pos_parent``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from scrubvae_torch.ops import quaternion as qtn

__all__ = [
    "KinematicTree",
    "inv_kin",
    "fwd_kin_cont6d",
    "segment_lengths",
    "speed_parts",
    "frame_yaw",
    "angle2D",
    "angle_from_2D",
    "normalize_root",
    "inv_normalize_root",
]


@dataclasses.dataclass(frozen=True)
class KinematicTree:
    """Compiled chain-list kinematic tree.

    chains: the original chain list; offsets: (J, 3) unit offset directions;
    pos_parent / rot_parent: (J,) position / rotation parent (-1 for the
    root); levels: per-depth tuples of joint indices (root excluded).
    """

    chains: tuple
    offsets: np.ndarray
    pos_parent: np.ndarray
    rot_parent: np.ndarray
    levels: tuple

    @staticmethod
    def build(chains: Sequence[Sequence[int]], offsets) -> "KinematicTree":
        offsets = np.asarray(offsets, dtype=np.float32)
        n = len(offsets)
        pos_parent = np.full(n, -1, dtype=np.int32)
        rot_parent = np.full(n, -1, dtype=np.int32)
        for chain in chains:
            for i in range(1, len(chain)):
                pos_parent[chain[i]] = chain[i - 1]
                rot_parent[chain[i]] = 0 if i == 1 else chain[i - 1]
        depth = np.zeros(n, dtype=np.int32)
        for chain in chains:
            for i in range(1, len(chain)):
                j = chain[i]
                depth[j] = (
                    max(
                        depth[pos_parent[j]],
                        depth[rot_parent[j]] if rot_parent[j] >= 0 else 0,
                    )
                    + 1
                )
        levels = []
        for d in range(1, int(depth.max()) + 1 if n > 1 else 1):
            idx = np.nonzero(depth == d)[0]
            if len(idx):
                levels.append(tuple(int(i) for i in idx))
        return KinematicTree(
            chains=tuple(tuple(int(j) for j in c) for c in chains),
            offsets=offsets,
            pos_parent=pos_parent,
            rot_parent=rot_parent,
            levels=tuple(levels),
        )


def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def inv_kin(
    pose: torch.Tensor, tree: KinematicTree, forward_indices: Sequence[int] = (0, 1)
) -> torch.Tensor:
    """Pose (..., J, 3) -> local joint quaternions (..., J, 4)."""
    dev = pose.device
    fwd = pose[..., forward_indices[1], :] - pose[..., forward_indices[0], :]
    fwd = fwd / torch.linalg.vector_norm(fwd, dim=-1, keepdim=True)
    target = fwd.new_tensor([1.0, 0.0, 0.0]).expand(fwd.shape)
    root_quat = qtn.qbetween(fwd, target)

    parent_pos = torch.index_select(pose, -2, _index(np.maximum(tree.pos_parent, 0), dev))
    bone = pose - parent_pos
    bone = bone / torch.clamp(torch.linalg.vector_norm(bone, dim=-1, keepdim=True), min=1e-12)
    offsets = torch.as_tensor(tree.offsets, dtype=pose.dtype, device=dev)
    g = qtn.qbetween(offsets.expand(pose.shape), bone)
    # global accumulated rotation: g_j for children (chain telescoping),
    # root_quat for the root
    g = torch.cat([root_quat.unsqueeze(-2), g[..., 1:, :]], dim=-2)
    g_parent = torch.index_select(g, -2, _index(np.maximum(tree.rot_parent, 0), dev))
    local = qtn.qmul(qtn.qinv(g_parent), g)
    return torch.cat([root_quat.unsqueeze(-2), local[..., 1:, :]], dim=-2)


def fwd_kin_cont6d(
    cont6d: torch.Tensor,
    tree: KinematicTree,
    offsets: torch.Tensor,
    root_pos: torch.Tensor,
    do_root_R: bool = True,
    eps: float = 0.0,
) -> torch.Tensor:
    """Forward kinematics from cont6d rotations.

    cont6d: (..., J, 6); offsets: (J, 3) or (..., J, 3); root_pos: (..., 3).
    Returns joint positions (..., J, 3).
    """
    batch_shape = cont6d.shape[:-2]
    J = cont6d.shape[-2]
    x = cont6d.reshape(-1, J, 6)
    N = x.shape[0]
    R = qtn.cont6d_to_matrix(x, eps)  # (N, J, 3, 3)
    offs = offsets.to(cont6d.dtype)
    offs = offs.unsqueeze(0).expand(N, J, 3) if offs.dim() == 2 else offs.reshape(-1, J, 3)
    root = root_pos.reshape(-1, 3)

    Rg = [None] * J
    pos = [None] * J
    if do_root_R:
        Rg[0] = R[:, 0]
    else:
        Rg[0] = torch.eye(3, dtype=cont6d.dtype, device=cont6d.device).expand(N, 3, 3)
    pos[0] = root.expand(N, 3)
    for level in tree.levels:
        for j in level:
            rp, pp = int(tree.rot_parent[j]), int(tree.pos_parent[j])
            Rg[j] = Rg[rp] @ R[:, j]
            pos[j] = pos[pp] + (Rg[j] @ offs[:, j].unsqueeze(-1)).squeeze(-1)
    return torch.stack(pos, dim=1).reshape(batch_shape + (J, 3))


def segment_lengths(pose: torch.Tensor, tree: KinematicTree) -> torch.Tensor:
    """Offsets scaled by observed segment lengths: offset_j * ||pose_j -
    pose_parent_j|| (root keeps its offset)."""
    dev = pose.device
    parent_pos = torch.index_select(pose, -2, _index(np.maximum(tree.pos_parent, 0), dev))
    seg = torch.linalg.vector_norm(pose - parent_pos, dim=-1, keepdim=True)
    offsets = torch.as_tensor(tree.offsets, dtype=pose.dtype, device=dev)
    mask = torch.as_tensor(tree.pos_parent >= 0, dtype=pose.dtype, device=dev)[..., None]
    return offsets * seg * mask + offsets * (1.0 - mask)


def speed_parts(
    pose: torch.Tensor, parts: Sequence[Sequence[int]], true_part_centering: bool = False
) -> torch.Tensor:
    """Average root / per-part relative speeds over a window.

    pose: (N, W, J, 3) -> (N, len(parts)+1). Default keeps the reference's
    no-op part centering (all parts root-centered); ``true_part_centering``
    subtracts the part-root joint instead.
    """
    root_d = torch.diff(pose[..., 0, :], n=1, dim=-2)
    root_spd = torch.sqrt(torch.sum(root_d**2, dim=-1)).mean(dim=-1)
    cols = [root_spd]
    centered = pose - pose[..., 0:1, :]
    for part in parts:
        if true_part_centering and part[0] != 0:
            pose_part = centered - centered[..., part[0] : part[0] + 1, :]
        else:
            pose_part = centered
        rel = torch.diff(pose_part[..., list(part[1:]), :], n=1, dim=-3)
        rel = torch.sqrt(torch.sum(rel**2, dim=-1))
        cols.append(rel.mean(dim=(-1, -2)))
    return torch.stack(cols, dim=-1)


def frame_yaw(pose: torch.Tensor, root_i: int = 0, front_i: int = 1) -> torch.Tensor:
    """Yaw (radians) of the root->front segment."""
    fwd = pose[..., front_i, :] - pose[..., root_i, :]
    fwd = fwd / torch.linalg.vector_norm(fwd, dim=-1, keepdim=True)
    return -torch.atan2(fwd[..., 1], fwd[..., 0])


def angle2D(angle: torch.Tensor) -> torch.Tensor:
    """Radians (..., K) -> interleaved [sin, cos] pairs (..., 2K)."""
    out = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1)
    return out.reshape(angle.shape[:-1] + (-1,))


def angle_from_2D(a2d: torch.Tensor) -> torch.Tensor:
    """Interleaved [sin, cos] pairs (..., 2K) -> radians (..., K)."""
    pairs = a2d.reshape(a2d.shape[:-1] + (-1, 2))
    return torch.atan2(pairs[..., 0], pairs[..., 1])


def normalize_root(root: torch.Tensor, arena_size: torch.Tensor) -> torch.Tensor:
    """Map arena coordinates into (-1, 1)."""
    lo, hi = arena_size[0], arena_size[1]
    return 2.0 * (root - lo) / (hi - lo) - 1.0


def inv_normalize_root(norm_root: torch.Tensor, arena_size: torch.Tensor) -> torch.Tensor:
    lo, hi = arena_size[0], arena_size[1]
    return 0.5 * (norm_root + 1.0) * (hi - lo) + lo
