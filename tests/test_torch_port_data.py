"""The port's frame store and on-device window assembly against the JAX
``build_frame_store`` + ``StreamDataset.batch`` on the same synthetic stream
and window indices, key by key.

Tolerance: atol 1e-5. The two keys built from the per-frame IK of raw
arena coordinates (x6d, target_pose) carry f32 conditioning noise: the JAX
pipeline's own per-frame x6d sits ~3.5e-5 from a float64 evaluation of the
same formulas, and FK over segment lengths ~10 grows that on target_pose.
For those two keys the port may differ from JAX by 1e-5 plus twice the JAX
pipeline's own distance from float64, which the fixture measures.

These are midfwd windows through ``StreamDataset.batch``. The x360
windows and the heading-free encoder view are held against the JAX
``materialize()`` output in tests/test_torch_port_x360.py (the JAX x360
pipeline differs from upstream in tests/test_preprocess_composition.py,
ROADMAP C1, so JAX is the reference).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu.data.dataset import StreamDataset as JaxStreamDataset
from scrubvae_tpu.data.pipeline import build_frame_store as jax_build_frame_store
from scrubvae_tpu.data.skeleton import load_skeleton as jax_load_skeleton
from scrubvae_tpu.data.synthetic import synthetic_pose_stream as jax_stream
from scrubvae_torch.data.dataset import StreamDataset, epoch_index_matrix
from scrubvae_torch.data.pipeline import build_frame_store
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.ops import kinematics as tkin
from scrubvae_torch.ops import quaternion as tq

torch.set_num_threads(1)

KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids")
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)


@pytest.fixture(scope="module")
def pair():
    jskel = jax_load_skeleton("configs/mouse_skeleton.yaml")
    skel = load_skeleton("configs/mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=1200, n_ids=3, seed=0)
    jpose, jids = jax_stream(jskel, n_frames=1200, n_ids=3, seed=0)
    np.testing.assert_array_equal(pose, jpose)
    np.testing.assert_array_equal(ids, jids)
    jds = JaxStreamDataset(
        jax_build_frame_store(pose, ids, jskel, window=51, stride=2), jskel, KEYS, "midfwd",
        arena_size=ARENA,
    )
    tds = StreamDataset(
        build_frame_store(pose, ids, skel, window=51, stride=2, device="cpu"), skel, KEYS,
        "midfwd", arena_size=ARENA, device="cpu",
    )
    idx = np.random.default_rng(0).integers(0, len(jds), 64)
    # float64 evaluation of the per-frame precompute (integer offsets are
    # exact in both, so JAX's are reused)
    p64 = torch.from_numpy(pose.astype(np.float64))
    x6d64 = tq.quaternion_to_cont6d(tkin.inv_kin(p64, skel.tree, forward_indices=[1, 0]))
    offs = torch.from_numpy(np.array(jds.store.offsets)).double()
    tpose64 = tkin.fwd_kin_cont6d(x6d64, skel.tree, offs, p64.new_zeros(len(pose), 3), eps=1e-8)
    f32_noise = {
        "x6d": float(np.abs(np.asarray(jds.store.x6d) - x6d64.numpy()).max()),
        "target_pose": float(np.abs(np.asarray(jds.store.tpose) - tpose64.numpy()).max()),
    }
    return jds, tds, jds.batch(jnp.asarray(idx)), tds.batch(idx), f32_noise


def test_frame_store_windows(pair):
    jds, tds = pair[:2]
    assert len(tds) == len(jds) > 0
    np.testing.assert_array_equal(tds.store.starts.numpy(), np.asarray(jds.store.starts))
    np.testing.assert_array_equal(tds.store.offsets.numpy(), np.asarray(jds.store.offsets))


@pytest.mark.parametrize("key", KEYS)
def test_batch_key(pair, key):
    _, _, want, got, f32_noise = pair
    a, b = got[key].numpy(), np.asarray(want[key])
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_allclose(a, b, atol=1e-5 + 2 * f32_noise.get(key, 0.0), rtol=0)


def test_epoch_index_matrix_covers_a_permutation():
    m = epoch_index_matrix(103, 16, np.random.default_rng(0))
    assert m.shape == (6, 16) and len(np.unique(m)) == 96
