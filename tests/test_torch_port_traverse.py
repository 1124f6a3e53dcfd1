"""Latent traversal and the null-space projection
(``scrubvae_torch/evals/traverse.py``) against the JAX package's
``scrubvae_tpu/evals/traverse.py`` on the CPU, at the bench's ``--small``
widths (channels 8-8-16-16-32, z 16, window 51) with decoding conditional
on avg_speed_3d and heading.

The port's model carries the JAX model's weights and BatchNorm running
statistics (``from_jax_variables``). The poses of the graded and the
circle sweeps must hold JAX's within 1e-4 of the largest coordinate: one
eval-mode f32 decoder pass (the latents test holds the encoder's to 1e-5)
and an 18-joint FK chain, whose products and sums add a few f32 roundings
a joint. ``project_to_null`` must equal JAX's (the same scipy call). The
static render: the port's PNG traces must equal, pixel for pixel, what the
JAX package's renderer draws from the same poses.
"""

from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu import factory as jfactory
from scrubvae_tpu.data.dataset import StreamDataset as JaxStreamDataset
from scrubvae_tpu.data.pipeline import build_frame_store as jax_build_frame_store
from scrubvae_tpu.data.skeleton import load_skeleton as jax_load_skeleton
from scrubvae_tpu.evals.traverse import project_to_null as jax_project_to_null
from scrubvae_tpu.evals.traverse import traverse_latent as jax_traverse_latent
from scrubvae_tpu.plot import trace as jax_trace
from scrubvae_torch import factory
from scrubvae_torch.data.dataset import StreamDataset
from scrubvae_torch.data.pipeline import build_frame_store
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.evals.traverse import project_to_null, traverse_latent
from scrubvae_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids")
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)
MODEL = {
    "type": "rcnn", "z_dim": 16, "window": 51, "channel": [8, 8, 16, 16, 32], "kernel": 5,
    "prior": "gaussian", "activation": "prelu", "precision": "fp32",
}
DIS = {
    "method": {"conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"]},
    "features": ["avg_speed_3d", "heading"], "alpha": 1.0,
}
POSE_TOL = 1e-4


@pytest.fixture(scope="module")
def carried():
    """The same stream as a JAX and a port StreamDataset, a JAX model's
    variables with running statistics away from their initial values, the
    port's model holding them, and latents and sweep weights."""
    jax.config.update("jax_default_matmul_precision", "highest")
    jskel = jax_load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=400, n_ids=2, seed=5)
    classes = {"ids": np.unique(ids)}
    jds = JaxStreamDataset(
        jax_build_frame_store(pose, ids, jskel, window=51, stride=2), jskel, KEYS, "midfwd",
        arena_size=ARENA, discrete_classes=classes, label="val",
    )
    tds = StreamDataset(
        build_frame_store(pose, ids, skel, window=51, stride=2, device="cpu"), skel, KEYS, "midfwd",
        arena_size=ARENA, discrete_classes=classes, device="cpu", label="val",
    )
    jmodel, _ = jfactory.build_model(MODEL, DIS, 18, "midfwd", arena_size=ARENA, discrete_classes=classes)
    key = jax.random.PRNGKey(2)
    variables = dict(jmodel.init({"params": key, "dropout": key}, jds.batch(jnp.arange(2)), rng=key, train=True))
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree.map(
        lambda x: jnp.asarray(
            rng.uniform(0.5, 1.5, x.shape) if np.all(np.asarray(x) == 1) else rng.normal(0.0, 0.2, x.shape),
            jnp.float32,
        ),
        variables["batch_stats"],
    )
    model, _ = factory.build_model(MODEL, DIS, 18, "midfwd", arena_size=ARENA, discrete_classes=classes, device="cpu")
    flat = {k: np.array(v, copy=True) for k, v in flax.traverse_util.flatten_dict(variables, sep="/").items()}
    model.load_state_dict(from_jax_variables(flat), strict=True)
    z = rng.normal(size=(len(tds), MODEL["z_dim"])).astype(np.float32)
    weights = {1: rng.normal(size=(1, MODEL["z_dim"])).astype(np.float32),
               2: rng.normal(size=(2, MODEL["z_dim"])).astype(np.float32)}
    return jmodel, variables, jds, model, tds, z, weights


@pytest.mark.parametrize("circle", [False, True], ids=["graded", "circle"])
def test_traverse_latent_matches_jax(carried, circle):
    jmodel, variables, jds, model, tds, z, weights = carried
    w = weights[2 if circle else 1]
    kw = dict(index=7, n_shifts=5, minmax=3.0, circle=circle, grid_vis=False, arena_vis=False, sample_index=30)
    want = jax_traverse_latent(jmodel, variables, jds, z, w, **kw)
    model.train()
    got = traverse_latent(model, tds, z, w, **kw)
    assert model.training  # the mode is restored
    assert got.shape == want.shape == (5 * 51, 18, 3) and got.dtype == np.float32
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"traverse ({'circle' if circle else 'graded'}): max |port - JAX| / max |JAX| = {err:.2e}")
    assert err <= POSE_TOL
    # the decoder really saw the sweep: the first and the middle shift differ
    assert np.abs(got[:51] - got[2 * 51 : 3 * 51]).max() > 1e-3 * np.abs(got).max()
    # tensors on the dataset's device are taken as numpy arrays are
    again = traverse_latent(model, tds, torch.from_numpy(z), torch.from_numpy(w), **kw)
    np.testing.assert_array_equal(again, got)


def test_project_to_null_matches_jax():
    rng = np.random.default_rng(4)
    z = rng.normal(size=(50, 8))
    w = rng.normal(size=(3, 8))
    got, basis = project_to_null(torch.from_numpy(z), w)
    want, jbasis = jax_project_to_null(z, w)
    np.testing.assert_array_equal(basis, jbasis)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose((got @ basis.T) @ w.T, np.zeros((50, 3)), atol=1e-12)


def test_static_render_equals_the_jax_renderer(carried, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.image as mpimg

    _, _, _, model, tds, z, weights = carried
    out = tmp_path / "port"
    pose = traverse_latent(
        model, tds, z, weights[1], index=3, n_shifts=3, grid_vis=False, arena_vis=False, static_vis=True,
        save_path=str(out) + "/", sample_index=10,
    )
    # the JAX renderer on the same poses, as the JAX traversal calls it for
    # its last plane (each plane writes the same file name)
    ref = tmp_path / "jax"
    pose_trans = pose.reshape(3, 51, 18, 3).copy()
    pose_trans[..., 1] += (np.linspace(-20, 20, 3) * 3)[:, None, None]
    jax_trace(
        pose_trans.reshape(-1, 18, 3), jax_load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml"),
        frames=np.arange(3) * 51, n_full_pose=3, vis_plane="xy", centered=False, N_FRAMES=51,
        FIG_NAME="val_trace_3.png", SAVE_ROOT=str(ref) + "/",
    )
    got, want = mpimg.imread(out / "val_trace_3.png"), mpimg.imread(ref / "val_trace_3.png")
    assert got.shape == want.shape and got.shape[0] > 100
    np.testing.assert_array_equal(got, want)
