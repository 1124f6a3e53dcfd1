"""Quaternions, 6D rotations and skeleton kinematics, plain PyTorch in f32.

A frozen copy of the arithmetic of the measured program's rotation and
kinematics code (scalar-first quaternions, column-convention cont6d,
row-convention 6D for the rotation loss, level-by-level forward
kinematics), with its device caches removed.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def _const(a, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=like.device, dtype=dtype if dtype is not None else like.dtype)


def qinv(q):
    return q * _const([1.0, -1.0, -1.0, -1.0], q)


def qnormalize(q, eps: float = 0.0):
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + eps)


def qmul(q, r):
    qw, qx, qy, qz = q.unbind(-1)
    rw, rx, ry, rz = r.unbind(-1)
    return torch.stack(
        [
            qw * rw - qx * rx - qy * ry - qz * rz,
            qw * rx + qx * rw + qy * rz - qz * ry,
            qw * ry - qx * rz + qy * rw + qz * rx,
            qw * rz + qx * ry - qy * rx + qz * rw,
        ],
        dim=-1,
    )


def qrot(q, v):
    w, u = q[..., :1], q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def qbetween(v0, v1):
    v0, v1 = torch.broadcast_tensors(v0, v1)
    v = torch.linalg.cross(v0, v1, dim=-1)
    w = torch.sqrt(torch.sum(v0 * v0, -1, keepdim=True) * torch.sum(v1 * v1, -1, keepdim=True)) + torch.sum(
        v0 * v1, -1, keepdim=True
    )
    return qnormalize(torch.cat([w, v], dim=-1))


def quaternion_to_matrix(q):
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    m = torch.stack(
        [
            1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
            two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
            two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quaternion_to_cont6d(q):
    m = quaternion_to_matrix(q)
    return torch.cat([m[..., 0], m[..., 1]], dim=-1)


def cont6d_to_matrix(c6d, eps: float = 0.0):
    e2 = max(float(eps), 1e-6) ** 2
    xr, yr = c6d[..., 0:3], c6d[..., 3:6]
    x = xr * torch.rsqrt(torch.sum(xr * xr, -1, keepdim=True) + e2)
    zr = torch.linalg.cross(x, yr, dim=-1)
    z = zr * torch.rsqrt(torch.sum(zr * zr, -1, keepdim=True) + e2)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def yaw_quat(yaw):
    half = 0.5 * yaw
    zeros = torch.zeros_like(yaw)
    return torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], dim=-1)


def _smooth_normalize(x, eps: float = 1e-6):
    return x * torch.rsqrt(torch.sum(x * x, -1, keepdim=True) + eps * eps)


def rotation_6d_to_matrix(d6):
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = _smooth_normalize(a1)
    b2 = _smooth_normalize(a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


@dataclasses.dataclass(frozen=True)
class KinematicTree:
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
                depth[j] = max(depth[pos_parent[j]], depth[rot_parent[j]] if rot_parent[j] >= 0 else 0) + 1
        levels = []
        for d in range(1, int(depth.max()) + 1 if n > 1 else 1):
            idx = np.nonzero(depth == d)[0]
            if len(idx):
                levels.append(tuple(int(i) for i in idx))
        return KinematicTree(
            tuple(tuple(int(j) for j in c) for c in chains), offsets, pos_parent, rot_parent, tuple(levels)
        )


def _index(a, like):
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=like.device)


def inv_kin(pose, tree: KinematicTree, forward_indices=(0, 1)):
    fwd = pose[..., forward_indices[1], :] - pose[..., forward_indices[0], :]
    fwd = fwd / torch.linalg.vector_norm(fwd, dim=-1, keepdim=True)
    root_quat = qbetween(fwd, _const([1.0, 0.0, 0.0], fwd).expand(fwd.shape))
    parent_pos = torch.index_select(pose, -2, _index(np.maximum(tree.pos_parent, 0), pose))
    bone = pose - parent_pos
    bone = bone / torch.clamp(torch.linalg.vector_norm(bone, dim=-1, keepdim=True), min=1e-12)
    g = qbetween(_const(tree.offsets, pose).expand(pose.shape), bone)
    g = torch.cat([root_quat.unsqueeze(-2), g[..., 1:, :]], dim=-2)
    g_parent = torch.index_select(g, -2, _index(np.maximum(tree.rot_parent, 0), pose))
    local = qmul(qinv(g_parent), g)
    return torch.cat([root_quat.unsqueeze(-2), local[..., 1:, :]], dim=-2)


def fwd_kin_cont6d(cont6d, tree: KinematicTree, offsets, root_pos, do_root_R: bool = True, eps: float = 0.0):
    batch_shape = cont6d.shape[:-2]
    J = cont6d.shape[-2]
    x = cont6d.reshape(-1, J, 6)
    N = x.shape[0]
    R = cont6d_to_matrix(x, eps)
    offs = offsets.to(cont6d.dtype)
    offs = offs.unsqueeze(0).expand(N, J, 3) if offs.dim() == 2 else offs.reshape(-1, J, 3)
    root = root_pos.reshape(-1, 3)
    Rg, pos = [None] * J, [None] * J
    Rg[0] = R[:, 0] if do_root_R else torch.eye(3, dtype=cont6d.dtype, device=cont6d.device).expand(N, 3, 3)
    pos[0] = root.expand(N, 3)
    for level in tree.levels:
        for j in level:
            rp, pp = int(tree.rot_parent[j]), int(tree.pos_parent[j])
            Rg[j] = Rg[rp] @ R[:, j]
            pos[j] = pos[pp] + (Rg[j] @ offs[:, j].unsqueeze(-1)).squeeze(-1)
    return torch.stack(pos, dim=1).reshape(batch_shape + (J, 3))


def segment_lengths(pose, tree: KinematicTree):
    parent_pos = torch.index_select(pose, -2, _index(np.maximum(tree.pos_parent, 0), pose))
    seg = torch.linalg.vector_norm(pose - parent_pos, dim=-1, keepdim=True)
    offsets = _const(tree.offsets, pose)
    mask = _const(tree.pos_parent >= 0, pose)[..., None]
    return offsets * seg * mask + offsets * (1.0 - mask)


def speed_parts(pose, parts, true_part_centering: bool = False):
    root_d = torch.diff(pose[..., 0, :], n=1, dim=-2)
    cols = [torch.sqrt(torch.sum(root_d**2, dim=-1)).mean(dim=-1)]
    centered = pose - pose[..., 0:1, :]
    for part in parts:
        if true_part_centering and part[0] != 0:
            pose_part = centered - centered[..., part[0] : part[0] + 1, :]
        else:
            pose_part = centered
        rel = torch.diff(torch.index_select(pose_part, -2, _index(part[1:], pose)), n=1, dim=-3)
        cols.append(torch.sqrt(torch.sum(rel**2, dim=-1)).mean(dim=(-1, -2)))
    return torch.stack(cols, dim=-1)


def frame_yaw(pose, root_i: int = 0, front_i: int = 1):
    fwd = pose[..., front_i, :] - pose[..., root_i, :]
    fwd = fwd / torch.linalg.vector_norm(fwd, dim=-1, keepdim=True)
    return -torch.atan2(fwd[..., 1], fwd[..., 0])


def angle2D(angle):
    out = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1)
    return out.reshape(angle.shape[:-1] + (-1,))


def normalize_root(root, arena):
    lo, hi = arena[0], arena[1]
    return 2.0 * (root - lo) / (hi - lo) - 1.0


def inv_normalize_root(norm_root, arena):
    lo, hi = arena[0], arena[1]
    return 0.5 * (norm_root + 1.0) * (hi - lo) + lo
