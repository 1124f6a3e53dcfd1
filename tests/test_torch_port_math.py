"""The port's quaternion, rotation and kinematics ops against the JAX
package's, on the same numpy inputs: values at rtol 1e-5 (atol 1e-6 for
entries near zero), FK gradients by relative norm <= 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu.data.skeleton import load_skeleton as jax_load_skeleton
from scrubvae_tpu.ops import kinematics as jkin
from scrubvae_tpu.ops import quaternion as jq
from scrubvae_tpu.ops import rotation as jrot
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.ops import kinematics as tkin
from scrubvae_torch.ops import quaternion as tq
from scrubvae_torch.ops import rotation as trot

torch.set_num_threads(1)

SKEL = load_skeleton("configs/mouse_skeleton.yaml")
JSKEL = jax_load_skeleton("configs/mouse_skeleton.yaml")
RNG = np.random.default_rng(0)
Q = RNG.normal(size=(64, 4)).astype(np.float32)
Q2 = RNG.normal(size=(64, 4)).astype(np.float32)
V = RNG.normal(size=(64, 3)).astype(np.float32)
V2 = RNG.normal(size=(64, 3)).astype(np.float32)
D6 = RNG.normal(size=(64, 6)).astype(np.float32)
YAW = RNG.uniform(-np.pi, np.pi, size=(64,)).astype(np.float32)
# poses: the synthetic stream's, root-centred (local coordinates keep f32 IK
# well conditioned)
POSE = np.stack(
    [
        np.cumsum(RNG.normal(size=(18, 3)), axis=0) * 5.0 for _ in range(48)
    ]
).astype(np.float32)


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


CASES = {
    "qmul": (lambda m, q, r: m.qmul(q, r), (Q, Q2)),
    "qinv": (lambda m, q: m.qinv(q), (Q,)),
    "qrot": (lambda m, q, v: m.qrot(m.qnormalize(q), v), (Q, V)),
    "qbetween": (lambda m, a, b: m.qbetween(a, b), (V, V2)),
    "quaternion_to_matrix": (lambda m, q: m.quaternion_to_matrix(q), (Q,)),
    "quaternion_to_cont6d": (lambda m, q: m.quaternion_to_cont6d(q), (Q,)),
    "yaw_quat": (lambda m, y: m.yaw_quat(y), (YAW,)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_quaternion_ops(name):
    fn, args = CASES[name]
    want = fn(jq, *map(jnp.asarray, args))
    got = fn(tq, *map(torch.from_numpy, args))
    close(got, want)


def test_rotation_6d_to_matrix():
    close(trot.rotation_6d_to_matrix(torch.from_numpy(D6)), jrot.rotation_6d_to_matrix(jnp.asarray(D6)))


def test_inv_kin():
    got = tkin.inv_kin(torch.from_numpy(POSE), SKEL.tree, forward_indices=[1, 0])
    want = jkin.inv_kin(jnp.asarray(POSE), JSKEL.tree, forward_indices=[1, 0])
    close(got, want)


@pytest.mark.parametrize(
    "name",
    ["segment_lengths", "frame_yaw", "angle2D", "normalize_root", "speed_parts"],
)
def test_pose_features(name):
    arena = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)
    windows = POSE.reshape(4, 12, 18, 3)
    fns = {
        "segment_lengths": lambda k, sk, x: k.segment_lengths(x(POSE), sk.tree),
        "frame_yaw": lambda k, sk, x: k.frame_yaw(x(POSE), 0, 1),
        "angle2D": lambda k, sk, x: k.angle2D(x(YAW)[:, None]),
        "normalize_root": lambda k, sk, x: k.inv_normalize_root(
            k.normalize_root(x(POSE[:, 0]), x(arena)), x(arena)
        ),
        "speed_parts": lambda k, sk, x: k.speed_parts(
            x(windows), ((0, 1, 2, 3, 4, 5), (1, 6, 7, 8, 9, 10, 11), (5, 12, 13, 14, 15, 16, 17))
        ),
    }
    close(fns[name](tkin, SKEL, torch.from_numpy), fns[name](jkin, JSKEL, jnp.asarray))


def _fk_inputs():
    rng = np.random.default_rng(1)
    x6d = rng.normal(size=(40, 18, 6)).astype(np.float32)
    offs = (rng.normal(size=(40, 18, 3)) * 5.0).astype(np.float32)
    root = rng.normal(size=(40, 3)).astype(np.float32)
    cot = rng.normal(size=(40, 18, 3)).astype(np.float32)
    return x6d, offs, root, cot


def test_fwd_kin_values():
    x6d, offs, root, _ = _fk_inputs()
    got = tkin.fwd_kin_cont6d(
        torch.from_numpy(x6d), SKEL.tree, torch.from_numpy(offs), torch.from_numpy(root), eps=1e-8
    )
    want = np.asarray(jkin.fwd_kin_cont6d(
        jnp.asarray(x6d), JSKEL.tree, jnp.asarray(offs), jnp.asarray(root), eps=1e-8
    ))
    # positions sum along chains of ~30 units: near-zero coordinates come
    # out of cancelling sums, so atol scales with the positions' magnitude
    close(got, want, atol=1e-6 * np.abs(want).max())


def test_fwd_kin_gradients():
    """d<FK(x6d, offsets), cot>/d(x6d, offsets) by relative norm <= 1e-4."""
    x6d, offs, root, cot = _fk_inputs()

    def jloss(x, o):
        p = jkin.fwd_kin_cont6d(x, JSKEL.tree, o, jnp.asarray(root), eps=1e-8)
        return jnp.sum(p * jnp.asarray(cot))

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x6d), jnp.asarray(offs))
    tx = torch.from_numpy(x6d).requires_grad_()
    to = torch.from_numpy(offs).requires_grad_()
    p = tkin.fwd_kin_cont6d(tx, SKEL.tree, to, torch.from_numpy(root), eps=1e-8)
    tg = torch.autograd.grad(torch.sum(p * torch.from_numpy(cot)), (tx, to))
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= 1e-4 * np.linalg.norm(b)
