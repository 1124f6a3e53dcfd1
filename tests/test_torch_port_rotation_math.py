"""The rest of the port's quaternion and rotation math and
``angle_from_2D`` against the JAX package's functions on the same f32 numpy
inputs: values at rtol 1e-5 with atol 1e-5 (angles in degrees: atol 1e-3,
1e-5 of a degree per unit of the inputs' scale), ``qfix`` along time
bitwise. The random rotations cannot match JAX's draws bit for bit, so
they are held by their properties: unit norm, both signs of the real part
drawn (JAX leaves the sign as drawn; ``standardize_quaternion`` fixes it),
and the rotation angle's distribution on SO(3), (theta - sin theta) / pi,
by a Kolmogorov-Smirnov test at 20,000 draws that JAX's draws pass too."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu.ops import kinematics as jkin
from scrubvae_tpu.ops import quaternion as jq
from scrubvae_tpu.ops import rotation as jrot
from scrubvae_torch.ops import kinematics as tkin
from scrubvae_torch.ops import quaternion as tq
from scrubvae_torch.ops import rotation as trot

torch.set_num_threads(1)

RNG = np.random.default_rng(11)
Q = RNG.normal(size=(64, 4)).astype(np.float32)
QN = (Q / np.linalg.norm(Q, axis=-1, keepdims=True)).astype(np.float32)
Q2N = RNG.normal(size=(64, 4)).astype(np.float32)
Q2N /= np.linalg.norm(Q2N, axis=-1, keepdims=True)
V = RNG.normal(size=(64, 3)).astype(np.float32)
AA = (V / np.linalg.norm(V, axis=-1, keepdims=True) * RNG.uniform(0.0, 3.0, (64, 1))).astype(np.float32)
AA[:2] = [[0.0, 0.0, 0.0], [1e-8, 0.0, 2e-8]]  # the Taylor branch
D6 = RNG.normal(size=(64, 6)).astype(np.float32)
E = RNG.uniform(-1.4, 1.4, size=(64, 3)).astype(np.float32)
T = np.linspace(0.0, 1.0, 7).astype(np.float32)
A2D = RNG.normal(size=(64, 8)).astype(np.float32)
ORDERS = ("xyz", "yzx", "zxy", "xzy", "yxz", "zyx")
CONVENTIONS = tuple("".join(c) for c in itertools.product("XYZ", repeat=3) if c[0] != c[1] and c[1] != c[2])


def _rotations(q):
    return np.array(jq.quaternion_to_matrix(jnp.asarray(q)), np.float32)


R = _rotations(QN)
# one matrix for each of matrix_to_quaternion's four candidates, and 180-degree turns
R_SPECIAL = np.stack(
    [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])]
).astype(np.float32)
POSES = _rotations(RNG.normal(size=(2, 5, 4, 4)))  # (B, T, J, 3, 3)
TRANS = RNG.normal(size=(2, 5, 3)).astype(np.float32)


def _qfix_input():
    """Slowly turning unit quaternions along time (dim 0) with random sign
    flips, whose frame-to-frame dot products are far from zero."""
    steps = RNG.normal(scale=0.05, size=(40, 6, 4))
    q = np.cumsum(steps, axis=0) + np.asarray([1.0, 0.2, -0.3, 0.1])
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    flips = np.where(RNG.uniform(size=(40, 6, 1)) < 0.3, -1.0, 1.0)
    return (q * flips).astype(np.float32)


CASES = {
    **{f"qeuler_{o}": (lambda m, q, o=o: m.qeuler(q, o), (QN,), 1e-3) for o in ORDERS},
    "qeuler_radians_eps": (lambda m, q: m.qeuler(q, "zyx", epsilon=1e-6, deg=False), (QN,), 1e-5),
    **{f"euler_to_quaternion_{o}": (lambda m, e, o=o: m.euler_to_quaternion(e, o), (E,), 1e-5) for o in ORDERS},
    "euler_to_quaternion_deg": (lambda m, e: m.euler_to_quaternion(e * 50.0, "yxz", deg=True), (E,), 1e-5),
    "expmap_to_quaternion": (lambda m, e: m.expmap_to_quaternion(e), (AA,), 1e-5),
    "cont6d_to_matrix": (lambda m, d: m.cont6d_to_matrix(d), (D6,), 1e-5),
    "qpow_scalar": (lambda m, q: m.qpow(q, 0.3), (QN,), 1e-5),
    "qpow_array": (lambda m, q, t: m.qpow(q, t), (QN, T), 1e-5),
    "qslerp": (lambda m, a, b, t: m.qslerp(a, b, t), (QN, Q2N, T), 1e-5),
    "lerp": (lambda m, a, b, t: m.lerp(a, b, t), (V, AA, T), 1e-5),
}

ROT_CASES = {
    "matrix_to_quaternion": (lambda m, r: m.matrix_to_quaternion(r), (R,)),
    "matrix_to_quaternion_special": (lambda m, r: m.matrix_to_quaternion(r), (R_SPECIAL,)),
    "standardize_quaternion": (lambda m, q: m.standardize_quaternion(q), (Q,)),
    "quaternion_multiply": (lambda m, a, b: m.quaternion_multiply(a, b), (QN, Q2N)),
    "quaternion_invert": (lambda m, q: m.quaternion_invert(q), (QN,)),
    "quaternion_apply": (lambda m, q, v: m.quaternion_apply(q, v), (QN, V)),
    "axis_angle_to_quaternion": (lambda m, a: m.axis_angle_to_quaternion(a), (AA,)),
    "quaternion_to_axis_angle": (lambda m, q: m.quaternion_to_axis_angle(q), (QN,)),
    "axis_angle_to_matrix": (lambda m, a: m.axis_angle_to_matrix(a), (AA,)),
    "matrix_to_axis_angle": (lambda m, r: m.matrix_to_axis_angle(r), (_rotations(np.array(
        jrot.axis_angle_to_quaternion(jnp.asarray(AA[2:])))),)),
    **{f"euler_angles_to_matrix_{c}": (lambda m, e, c=c: m.euler_angles_to_matrix(e, c), (E,)) for c in CONVENTIONS},
    **{f"matrix_to_euler_angles_{c}": (lambda m, r, c=c: m.matrix_to_euler_angles(r, c), (R,)) for c in CONVENTIONS},
    "matrix_to_rotation_6d": (lambda m, r: m.matrix_to_rotation_6d(r), (R,)),
    "canonicalize_smplh": (lambda m, p: m.canonicalize_smplh(p), (POSES,)),
    "canonicalize_smplh_trans": (lambda m, p, t: m.canonicalize_smplh(p, t), (POSES, TRANS)),
}


def close(got, want, atol):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, atol)
        return
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_quaternion_functions_match_jax(name):
    fn, args, atol = CASES[name]
    close(fn(tq, *map(torch.from_numpy, args)), fn(jq, *map(jnp.asarray, args)), atol)


@pytest.mark.parametrize("name", sorted(ROT_CASES))
def test_rotation_functions_match_jax(name):
    fn, args = ROT_CASES[name]
    close(fn(trot, *map(torch.from_numpy, args)), fn(jrot, *map(jnp.asarray, args)), 1e-5)


def test_qfix_along_time_matches_jax_bitwise():
    q = _qfix_input()
    got = tq.qfix(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.qfix(jnp.asarray(q))))
    # every frame now turns less than 90 degrees from the one before
    assert (np.sum(got[1:] * got[:-1], axis=-1) > 0).all()
    assert (np.abs(got) == np.abs(q)).all()


def test_angle_from_2d_matches_jax_and_inverts_angle2d():
    np.testing.assert_allclose(
        tkin.angle_from_2D(torch.from_numpy(A2D)).numpy(), np.asarray(jkin.angle_from_2D(jnp.asarray(A2D))),
        rtol=1e-5, atol=1e-6,
    )
    ang = torch.from_numpy(E)
    np.testing.assert_allclose(tkin.angle_from_2D(tkin.angle2D(ang)).numpy(), E, rtol=0, atol=1e-6)


def test_invalid_orders_and_conventions_raise():
    with pytest.raises(ValueError):
        tq.qeuler(torch.from_numpy(QN), "xxy")
    with pytest.raises(ValueError):
        trot.euler_angles_to_matrix(torch.from_numpy(E), "XWY")
    with pytest.raises(ValueError):
        trot.matrix_to_euler_angles(torch.from_numpy(R), "XY")


def _so3_angle_ks(quats: np.ndarray) -> float:
    """p-value of the rotation angle 2 acos|w| against uniform SO(3)'s
    CDF (theta - sin theta) / pi."""
    from scipy import stats

    theta = 2.0 * np.arccos(np.clip(np.abs(quats[:, 0]).astype(np.float64), 0.0, 1.0))
    return stats.kstest(theta, lambda t: (t - np.sin(t)) / np.pi).pvalue


def test_random_quaternions_and_rotations_by_their_properties():
    n = 20000
    q = trot.random_quaternions(torch.Generator().manual_seed(3), n)
    assert q.shape == (n, 4) and q.dtype == torch.float32 and q.device.type == "cpu"
    np.testing.assert_allclose(torch.linalg.vector_norm(q, dim=-1).numpy(), 1.0, rtol=0, atol=1e-6)
    # the sign is left as drawn, as in JAX; standardizing makes the real part non-negative
    jq_draws = np.asarray(jrot.random_quaternions(jax.random.PRNGKey(3), n))
    for draws in (q.numpy(), jq_draws):
        neg = (draws[:, 0] < 0).mean()
        assert 0.48 < neg < 0.52, neg
    assert (trot.standardize_quaternion(q)[:, 0] >= 0).all()
    # uniform on SO(3): the port's draws and JAX's pass the same test, a
    # uniform draw of the angle itself fails it
    assert _so3_angle_ks(q.numpy()) > 1e-3
    assert _so3_angle_ks(jq_draws) > 1e-3
    bad = np.random.default_rng(0).uniform(0, np.pi, n)
    assert _so3_angle_ks(np.cos(bad / 2)[:, None]) < 1e-6
    # the same generator state gives the same draws; rotations are their matrices
    again = trot.random_quaternions(torch.Generator().manual_seed(3), n)
    assert torch.equal(q, again)
    rots = trot.random_rotations(torch.Generator().manual_seed(3), n)
    assert torch.equal(rots, trot.quaternion_to_matrix(q))
    rots = trot.random_rotations(torch.Generator().manual_seed(4), 100, dtype=torch.float64)
    assert rots.dtype == torch.float64
    eye = (rots @ rots.mT - torch.eye(3, dtype=torch.float64)).abs().max()
    assert float(eye) < 1e-12 and bool((torch.linalg.det(rots) > 0).all())
