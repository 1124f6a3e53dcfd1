"""Quaternion algebra in PyTorch: the subset the data pipeline and the
kinematics need (counterpart of ``scrubvae_tpu/ops/quaternion.py``).

Scalar-first quaternions ``q = (w, x, y, z)``; rotation matrices act on
column vectors. Every function works over the last axis and broadcasts.
"""

from __future__ import annotations

import torch

__all__ = [
    "qinv",
    "qnormalize",
    "qmul",
    "qrot",
    "qbetween",
    "quaternion_to_matrix",
    "quaternion_to_cont6d",
    "yaw_quat",
]


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternion(s): (w, -x, -y, -z)."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def qnormalize(q: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + eps)


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*r over the last axis."""
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


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q: v + 2*(w*(u x v) + u x (u x v))."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return v + 2.0 * (w * uv + uuv)


def qbetween(v0: torch.Tensor, v1: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating v0 onto v1 (shortest arc)."""
    v0, v1 = torch.broadcast_tensors(v0, v1)
    v = torch.linalg.cross(v0, v1, dim=-1)
    w = torch.sqrt(
        torch.sum(v0 * v0, dim=-1, keepdim=True) * torch.sum(v1 * v1, dim=-1, keepdim=True)
    ) + torch.sum(v0 * v1, dim=-1, keepdim=True)
    return qnormalize(torch.cat([w, v], dim=-1))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) to rotation matrix(es), shape (..., 3, 3)."""
    r, i, j, k = q.unbind(-1)
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    m = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quaternion_to_cont6d(q: torch.Tensor) -> torch.Tensor:
    """First two columns of the rotation matrix, concatenated."""
    m = quaternion_to_matrix(q)
    return torch.cat([m[..., 0], m[..., 1]], dim=-1)


def yaw_quat(yaw: torch.Tensor) -> torch.Tensor:
    """Quaternion for a rotation about +z by ``yaw`` radians."""
    half = 0.5 * yaw
    zeros = torch.zeros_like(yaw)
    return torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], dim=-1)
