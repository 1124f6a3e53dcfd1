"""Rotation-representation conversions in PyTorch (counterpart of
``scrubvae_tpu/ops/rotation.py``): PyTorch3D semantics, scalar-first
quaternions, matrices acting on column vectors, branch-free over the batch.

The 6D representation here is the *row* convention of Zhou et al. (first
two matrix rows + Gram-Schmidt), used by the rotation loss; the column-wise
``cont6d`` of ``ops.quaternion`` is the kinematics' convention.
"""

from __future__ import annotations

from typing import Optional

import torch

from scrubvae_torch.ops.quaternion import qinv, qmul, qrot, quaternion_to_matrix

__all__ = [
    "quaternion_to_matrix",
    "matrix_to_quaternion",
    "axis_angle_to_quaternion",
    "quaternion_to_axis_angle",
    "axis_angle_to_matrix",
    "matrix_to_axis_angle",
    "euler_angles_to_matrix",
    "matrix_to_euler_angles",
    "rotation_6d_to_matrix",
    "matrix_to_rotation_6d",
    "random_quaternions",
    "random_rotations",
    "standardize_quaternion",
    "quaternion_multiply",
    "quaternion_invert",
    "quaternion_apply",
    "canonicalize_smplh",
]


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=0.0))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> scalar-first quaternions (..., 4).

    Branch-free: the four candidate quaternions, one from each diagonal
    combination, and the one with the largest denominator picked by a
    one-hot mask; the real part made non-negative."""
    m = matrix
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    q_abs = torch.stack(
        [
            _sqrt_positive_part(1.0 + m00 + m11 + m22),
            _sqrt_positive_part(1.0 + m00 - m11 - m22),
            _sqrt_positive_part(1.0 - m00 + m11 - m22),
            _sqrt_positive_part(1.0 - m00 - m11 + m22),
        ],
        dim=-1,
    )
    m21_12 = m[..., 2, 1] - m[..., 1, 2]
    m02_20 = m[..., 0, 2] - m[..., 2, 0]
    m10_01 = m[..., 1, 0] - m[..., 0, 1]
    p10_01 = m[..., 1, 0] + m[..., 0, 1]
    p02_20 = m[..., 0, 2] + m[..., 2, 0]
    p21_12 = m[..., 2, 1] + m[..., 1, 2]
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21_12, m02_20, m10_01], dim=-1),
            torch.stack([m21_12, q_abs[..., 1] ** 2, p10_01, p02_20], dim=-1),
            torch.stack([m02_20, p10_01, q_abs[..., 2] ** 2, p21_12], dim=-1),
            torch.stack([m10_01, p02_20, p21_12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    quat_candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    onehot = torch.nn.functional.one_hot(torch.argmax(q_abs, dim=-1), 4).bool()
    out = torch.sum(torch.where(onehot[..., None], quat_candidates, 0.0), dim=-2)
    return standardize_quaternion(out)


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Flip the sign so the real part is non-negative."""
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return qmul(a, b)


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    return qinv(q)


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    return qrot(q, point)


def _sin_half_over_angle(angles: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """sin(angle / 2) / angle, by its Taylor series below an angle of 1e-6."""
    small = torch.abs(angles) < 1e-6
    return torch.where(small, 0.5 - (angles * angles) / 48.0, torch.sin(half) / torch.where(small, 1.0, angles))


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> quaternion, Taylor-stable near zero angle."""
    angles = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    half = 0.5 * angles
    return torch.cat([torch.cos(half), axis_angle * _sin_half_over_angle(angles, half)], dim=-1)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, q[..., :1])
    return q[..., 1:] / _sin_half_over_angle(2.0 * half_angles, half_angles)


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def _axis_rotation_matrix(axis: str, angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == "X":
        flat = (one, zero, zero, zero, c, -s, zero, s, c)
    elif axis == "Y":
        flat = (c, zero, s, zero, one, zero, -s, zero, c)
    elif axis == "Z":
        flat = (c, -s, zero, s, c, zero, zero, zero, one)
    else:
        raise ValueError(f"invalid axis {axis!r}")
    return torch.stack(flat, dim=-1).reshape(angle.shape + (3, 3))


def _check_convention(convention: str) -> None:
    if len(convention) != 3 or any(c not in "XYZ" for c in convention):
        raise ValueError(f"invalid convention {convention!r}")


def euler_angles_to_matrix(euler_angles: torch.Tensor, convention: str) -> torch.Tensor:
    """Composition R = R_c0(a0) @ R_c1(a1) @ R_c2(a2)."""
    _check_convention(convention)
    mats = [_axis_rotation_matrix(c, euler_angles[..., i]) for i, c in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def _angle_from_tan(axis: str, other_axis: str, data: torch.Tensor, horizontal: bool, tait_bryan: bool) -> torch.Tensor:
    i1, i2 = {"X": (2, 1), "Y": (0, 2), "Z": (1, 0)}[axis]
    if horizontal:
        i1, i2 = i2, i1
    even = (axis + other_axis) in ("XY", "YZ", "ZX")
    if horizontal == even:
        return torch.atan2(data[..., i1], data[..., i2])
    if tait_bryan:
        return torch.atan2(-data[..., i2], data[..., i1])
    return torch.atan2(data[..., i2], -data[..., i1])


def matrix_to_euler_angles(matrix: torch.Tensor, convention: str) -> torch.Tensor:
    _check_convention(convention)
    i0 = "XYZ".index(convention[0])
    i2 = "XYZ".index(convention[2])
    tait_bryan = i0 != i2
    if tait_bryan:
        central = torch.asin(torch.clamp(matrix[..., i0, i2] * (-1.0 if i0 - i2 in (-1, 2) else 1.0), -1, 1))
    else:
        central = torch.acos(torch.clamp(matrix[..., i0, i0], -1, 1))
    a0 = _angle_from_tan(convention[0], convention[1], matrix[..., i2], False, tait_bryan)
    a2 = _angle_from_tan(convention[2], convention[1], matrix[..., i0, :], True, tait_bryan)
    return torch.stack([a0, central, a2], dim=-1)


def random_quaternions(generator: torch.Generator, n: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``n`` quaternions uniform on the unit sphere (normal draws from
    ``generator``, normalised; the sign is left as drawn, as the JAX
    package leaves it), on the generator's device."""
    q = torch.randn((n, 4), generator=generator, dtype=dtype, device=generator.device)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def random_rotations(generator: torch.Generator, n: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``n`` rotation matrices uniform on SO(3), on the generator's device."""
    return quaternion_to_matrix(random_quaternions(generator, n, dtype))


def _smooth_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(||x||^2 + eps^2): smooth where ``x / ||x||`` has a nan
    gradient at zero, and equal to it for any non-degenerate row."""
    n2 = torch.sum(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(n2 + eps * eps)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Row-convention 6D -> rotation matrix via Gram-Schmidt (Zhou et al.):
    rows b1, b2, b3 = b1 x b2."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = _smooth_normalize(a1)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = _smooth_normalize(b2)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """First two rows of the rotation matrix, flattened."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def canonicalize_smplh(poses: torch.Tensor, trans: Optional[torch.Tensor] = None):
    """Rotate every frame's global orientation by frame 0's, so sequences
    start from a canonical heading, and with ``trans`` re-integrate the
    translation velocity in the rotated frame from the origin.

    poses: (B, T, J, 3, 3) rotation matrices; trans: (B, T, 3).
    """
    global_orient = poses[:, :, 0]
    rot2d = axis_angle_to_matrix(matrix_to_axis_angle(global_orient[:, 0]))
    # R0^T @ R_t per frame
    global_orient = torch.einsum("ikj,imkl->imjl", rot2d, global_orient)
    xc = torch.cat([global_orient[:, :, None], poses[:, :, 1:]], dim=2)
    if trans is None:
        return xc
    vel = trans[:, 1:] - trans[:, :-1]
    vel = torch.einsum("ikj,ilk->ilj", rot2d, vel)
    trans_c = torch.cat([torch.zeros_like(trans[:, :1]), torch.cumsum(vel, dim=1)], dim=1)
    return xc, trans_c
