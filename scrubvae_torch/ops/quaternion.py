"""Quaternion algebra in PyTorch (counterpart of
``scrubvae_tpu/ops/quaternion.py``).

Scalar-first quaternions ``q = (w, x, y, z)``; rotation matrices act on
column vectors. Every function works over the last axis and broadcasts.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from scrubvae_torch.device import cached_constant

__all__ = [
    "qinv",
    "qnormalize",
    "qmul",
    "qrot",
    "qeuler",
    "qfix",
    "euler_to_quaternion",
    "expmap_to_quaternion",
    "quaternion_to_matrix",
    "quaternion_to_cont6d",
    "cont6d_to_matrix",
    "qpow",
    "qslerp",
    "qbetween",
    "lerp",
    "yaw_quat",
]


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of unit quaternion(s): (w, -x, -y, -z)."""
    return q * cached_constant(np.array([1.0, -1.0, -1.0, -1.0]), q.device, q.dtype)


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


def _asin_clamped(x: torch.Tensor, epsilon: float) -> torch.Tensor:
    return torch.asin(torch.clamp(x, -1.0 + epsilon, 1.0 - epsilon))


def qeuler(q: torch.Tensor, order: str, epsilon: float = 0.0, deg: bool = True) -> torch.Tensor:
    """Quaternion to Euler angles for the six Tait-Bryan orders."""
    q0, q1, q2, q3 = q.unbind(-1)
    if order == "xyz":
        x = torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = _asin_clamped(2 * (q1 * q3 + q0 * q2), epsilon)
        z = torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    elif order == "yzx":
        x = torch.atan2(2 * (q0 * q1 - q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = torch.atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = _asin_clamped(2 * (q1 * q2 + q0 * q3), epsilon)
    elif order == "zxy":
        x = _asin_clamped(2 * (q0 * q1 + q2 * q3), epsilon)
        y = torch.atan2(2 * (q0 * q2 - q1 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        z = torch.atan2(2 * (q0 * q3 - q1 * q2), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == "xzy":
        x = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
        y = torch.atan2(2 * (q0 * q2 + q1 * q3), 1 - 2 * (q2 * q2 + q3 * q3))
        z = _asin_clamped(2 * (q0 * q3 - q1 * q2), epsilon)
    elif order == "yxz":
        x = _asin_clamped(2 * (q0 * q1 - q2 * q3), epsilon)
        y = torch.atan2(2 * (q1 * q3 + q0 * q2), 1 - 2 * (q1 * q1 + q2 * q2))
        z = torch.atan2(2 * (q1 * q2 + q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3))
    elif order == "zyx":
        x = torch.atan2(2 * (q0 * q1 + q2 * q3), 1 - 2 * (q1 * q1 + q2 * q2))
        y = _asin_clamped(2 * (q0 * q2 - q1 * q3), epsilon)
        z = torch.atan2(2 * (q0 * q3 + q1 * q2), 1 - 2 * (q2 * q2 + q3 * q3))
    else:
        raise ValueError(f"unknown euler order {order!r}")
    out = torch.stack([x, y, z], dim=-1)
    return out * (180.0 / math.pi) if deg else out


def qfix(q: torch.Tensor) -> torch.Tensor:
    """Sign continuity along the leading (time) axis: each frame whose dot
    product with the previous one is negative flips the sign of every
    later frame, as a cumulative product of +-1."""
    dots = torch.sum(q[1:] * q[:-1], dim=-1)
    flips = torch.where(dots < 0, -1.0, 1.0).to(q.dtype)
    signs = torch.cat([torch.ones_like(flips[:1]), torch.cumprod(flips, dim=0)], dim=0)
    return q * signs[..., None]


def _axis_quat(angle: torch.Tensor, axis: int) -> torch.Tensor:
    """Quaternion for a rotation by ``angle`` about base axis 0=x, 1=y, 2=z."""
    half = 0.5 * angle
    zeros = torch.zeros_like(angle)
    comps = [torch.cos(half), zeros, zeros, zeros]
    comps[axis + 1] = torch.sin(half)
    return torch.stack(comps, dim=-1)


def euler_to_quaternion(e: torch.Tensor, order: str, deg: bool = False) -> torch.Tensor:
    """Per-axis quaternions composed in ``order``, negated for the cyclic
    orders xyz, yzx and zxy."""
    if deg:
        e = e * (math.pi / 180.0)
    axis_of = {"x": 0, "y": 1, "z": 2}
    result = None
    for coord in order:
        ax = axis_of[coord]
        r = _axis_quat(e[..., ax], ax)
        result = r if result is None else qmul(result, r)
    if order in ("xyz", "yzx", "zxy"):
        result = -result
    return result


def expmap_to_quaternion(e: torch.Tensor) -> torch.Tensor:
    """Axis-angle (exponential map) to quaternion, stable near zero."""
    theta = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    w = torch.cos(0.5 * theta)
    xyz = 0.5 * torch.sinc(0.5 * theta / math.pi) * e
    return torch.cat([w, xyz], dim=-1)


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


def cont6d_to_matrix(c6d: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Column-convention 6D to rotation matrix (..., 3, 3), completed by
    cross products, with the smooth normalisation v * rsqrt(|v|^2 +
    eps'^2), eps' = max(eps, 1e-6), whose gradient stays finite at |v| = 0."""
    eps_eff = max(float(eps), 1e-6)
    e2 = eps_eff * eps_eff
    xr, yr = c6d[..., 0:3], c6d[..., 3:6]
    x = xr * torch.rsqrt(torch.sum(xr * xr, dim=-1, keepdim=True) + e2)
    zr = torch.linalg.cross(x, yr, dim=-1)
    z = zr * torch.rsqrt(torch.sum(zr * zr, dim=-1, keepdim=True) + e2)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-1)


def qpow(q0: torch.Tensor, t) -> torch.Tensor:
    """Unit quaternion(s) raised to power(s) ``t``; for a tensor ``t`` the
    result has shape ``t.shape + q0.shape``."""
    q0 = qnormalize(q0)
    theta0 = torch.acos(torch.clamp(q0[..., 0], -1.0, 1.0))
    theta0 = torch.where(torch.abs(theta0) <= 1e-9, torch.full_like(theta0, 1e-9), theta0)
    v0 = q0[..., 1:] / torch.sin(theta0)[..., None]
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    theta = t.reshape(t.shape + (1,) * theta0.dim()) * theta0
    w = torch.cos(theta)[..., None]
    xyz = v0.expand(theta.shape + (3,)) * torch.sin(theta)[..., None]
    return torch.cat([w, xyz], dim=-1)


def qslerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation from q0 to q1 at points ``t``."""
    q0 = qnormalize(q0)
    q1 = qnormalize(q1)
    q_ = qpow(qmul(q1, qinv(q0)), t)
    return qmul(q_, q0.expand(q_.shape))


def lerp(p0: torch.Tensor, p1: torch.Tensor, t) -> torch.Tensor:
    t = torch.as_tensor(t, dtype=p0.dtype, device=p0.device)
    return p0 + t.reshape(t.shape + (1,) * p0.dim()) * (p1 - p0)


def yaw_quat(yaw: torch.Tensor) -> torch.Tensor:
    """Quaternion for a rotation about +z by ``yaw`` radians."""
    half = 0.5 * yaw
    zeros = torch.zeros_like(yaw)
    return torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], dim=-1)
