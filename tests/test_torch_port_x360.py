"""The x360 windows and the heading-free encoder view, the port against the
JAX package.

- ``materialize`` key by key against JAX's, for the midfwd and x360
  processes, with and without the speed-outlier threshold (the stream has
  a burst that the threshold drops), over every key the port assembles,
  ``raw_pose``, ``x6d_enc`` and ``root_enc`` included. Held to JAX's
  ``materialize`` and not to the upstream pipeline, from which the JAX x360
  path differs (tests/test_preprocess_composition.py).
- ``x6d_enc``/``root_enc`` are invariant under a global yaw of the stream,
  while the x360 target moves with it.
- ``ResVAE.encode`` reads the view: with weights carried from JAX, mu and
  the Cholesky factor equal JAX's encode of the same batch; perturbing
  ``x6d_enc`` moves mu, perturbing ``x6d`` does not.
- ``data_and_model`` with ``data.encoder_direction_process`` puts the view
  in every split, as JAX's does.

Tolerance: atol 1e-5, and for the keys in arena units (root, root_enc,
raw_pose) 2e-6 of the vector's length beside it (a few f32 ulps: the
rounding of a rotation moves every entry by the vector's length).
The keys built from IK of arena coordinates carry f32 conditioning noise:
for x6d, target_pose and x6d_enc the port may differ from JAX by 1e-5 plus
twice JAX's own distance from a float64 evaluation of the same formulas
(the rule of tests/test_torch_port_data.py).
"""

import dataclasses
import shutil
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu import factory as jfactory
from scrubvae_tpu.data.pipeline import build_frame_store as jax_build_frame_store
from scrubvae_tpu.data.pipeline import materialize as jax_materialize
from scrubvae_tpu.data.skeleton import load_skeleton as jax_load_skeleton
from scrubvae_torch import factory
from scrubvae_torch.data.pipeline import SUPPORTED_KEYS, assemble_windows, build_frame_store, materialize
from scrubvae_torch.data.pose_io import write_pose_h5
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.ops import kinematics as tkin
from scrubvae_torch.ops import quaternion as tq
from scrubvae_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SKEL = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
JSKEL = jax_load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)
ENC_KEYS = ("x6d_enc", "root_enc")
CASES = [(dp, th) for dp in ("midfwd", "x360") for th in (2.25, None)]


def burst_stream():
    """600 frames of 3 ids with a 40-frame burst at 12 units a frame, so
    the speed threshold drops the windows around it."""
    pose, ids = synthetic_pose_stream(SKEL, n_frames=600, n_ids=3, seed=0)
    pose = pose.copy()
    pose[250:290] += (12.0 * np.arange(40, dtype=np.float32))[:, None, None] * np.float32([1.0, 0.0, 0.0])
    return pose, ids


def f64_noise(tstore, jstore, jout, direction_process) -> dict:
    """JAX's distance from float64 for the keys built from IK: the per-frame
    x6d and zero-root FK, and the per-window x6d_enc."""
    p64 = tstore.pose.double()
    x6d64 = tq.quaternion_to_cont6d(tkin.inv_kin(p64, SKEL.tree, forward_indices=[1, 0]))
    offs = torch.from_numpy(np.array(jstore.offsets)).double()
    tpose64 = tkin.fwd_kin_cont6d(x6d64, SKEL.tree, offs, p64.new_zeros(len(p64), 3), eps=1e-8)
    s64 = dataclasses.replace(tstore, pose=p64, yaw=tkin.frame_yaw(p64, 0, 1))
    enc64 = assemble_windows(s64, SKEL.tree, tstore.starts, ("x6d_enc",), direction_process)["x6d_enc"]
    return {
        "x6d": float(np.abs(np.asarray(jstore.x6d) - x6d64.numpy()).max()),
        "target_pose": float(np.abs(np.asarray(jstore.tpose) - tpose64.numpy()).max()),
        "x6d_enc": float(np.abs(jout["x6d_enc"] - enc64.numpy()).max()),
    }


@pytest.fixture(scope="module")
def materialized():
    """(port, JAX, float64 noise, windows) per (direction_process, threshold)."""
    pose, ids = burst_stream()
    out = {}
    for dp, th in CASES:
        js = jax_build_frame_store(pose, ids, JSKEL, window=51, stride=2, speed_threshold=th)
        ts = build_frame_store(pose, ids, SKEL, window=51, stride=2, speed_threshold=th, device="cpu")
        want = jax_materialize(js, JSKEL.tree, SUPPORTED_KEYS, dp)
        out[dp, th] = (materialize(ts, SKEL.tree, SUPPORTED_KEYS, dp, chunk=100), want, f64_noise(ts, js, want, dp), ts.n_windows)
    return out


def test_threshold_drops_the_burst(materialized):
    assert materialized["x360", 2.25][3] < materialized["x360", None][3]


@pytest.mark.parametrize("key", SUPPORTED_KEYS)
@pytest.mark.parametrize("dp,th", CASES)
def test_materialize_matches_jax(materialized, dp, th, key):
    got, want, noise, n = materialized[dp, th]
    assert set(got) == set(want) == set(SUPPORTED_KEYS)
    a, b = got[key], want[key]
    assert a.shape == b.shape and a.shape[0] == n and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    # a rotation's rounding moves a vector's every entry by its length
    length = np.linalg.norm(b, axis=-1, keepdims=True) if key in ("root", "root_enc", "raw_pose") else 0.0
    assert (np.abs(a - b) <= 1e-5 + 2 * noise.get(key, 0.0) + 2e-6 * length).all(), np.abs(a - b).max()


def test_x360_leaves_the_heading_in_place(materialized):
    """x360 and midfwd share the view, centering and heading; only the
    midfwd target is rotated into the mid-frame heading."""
    x360, midfwd = materialized["x360", None][0], materialized["midfwd", None][0]
    for k in ("x6d_enc", "root_enc", "heading", "offsets", "raw_pose", "avg_speed_3d"):
        np.testing.assert_array_equal(x360[k], midfwd[k], err_msg=k)
    np.testing.assert_array_equal(x360["x6d"][..., 1:, :], midfwd["x6d"][..., 1:, :])
    np.testing.assert_array_equal(x360["root"][..., 2], midfwd["root"][..., 2])
    assert np.abs(x360["root"][..., :2] - midfwd["root"][..., :2]).max() > 1.0


def test_enc_view_is_heading_invariant():
    """Under a global 90-degree yaw of the stream the view stays (up to a
    few near-singular IK frames in f32, as JAX's own test allows) while the
    x360 target's root row moves."""
    pose, ids = synthetic_pose_stream(SKEL, n_frames=160, n_ids=2, seed=12)
    c, s = np.cos(np.pi / 2), np.sin(np.pi / 2)
    R = np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    keys = ("x6d", "root", "x6d_enc", "root_enc")
    a, b = (
        materialize(build_frame_store(p, ids, SKEL, window=21, stride=3, device="cpu"), SKEL.tree, keys, "x360")
        for p in (pose, pose @ R.T)
    )
    d = np.abs(a["x6d_enc"] - b["x6d_enc"])
    assert float(d.mean()) < 1e-5, d.mean()
    assert float((d > 1e-3).mean()) < 1e-3, (d > 1e-3).mean()
    np.testing.assert_allclose(a["root_enc"], b["root_enc"], atol=1e-3)
    assert np.abs(a["x6d"][..., 0, :] - b["x6d"][..., 0, :]).max() > 0.5
    assert np.abs(a["root"] - b["root"]).max() > 1.0


MODEL = {
    "type": "rcnn", "z_dim": 6, "window": 51, "channel": [8, 8, 16, 16, 32], "kernel": 5,
    "precision": "fp32",
}
DIS = {"method": {"conditional": ["heading"]}, "features": ["heading"]}


def test_encode_reads_the_enc_view(materialized):
    got = materialized["x360", None][0]
    batch = {k: got[k][:4] for k in ("x6d", "root", "x6d_enc", "root_enc", "heading")}
    jmodel, _ = jfactory.build_model(MODEL, DIS, 18, "x360", arena_size=ARENA, loss_keys=("rotation", "prior"))
    jdata = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)}, jdata, rng=jax.random.PRNGKey(0), train=True
    )
    want = jmodel.apply(variables, jdata, method=lambda m, d: m.vae.encode(d, train=False))
    model, _ = factory.build_model(MODEL, DIS, 18, "x360", arena_size=ARENA, loss_keys=("rotation", "prior"), device="cpu")
    flat = {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(variables, sep="/").items()}
    model.load_state_dict(from_jax_variables(flat), strict=True)
    model.eval()
    data = {k: torch.from_numpy(v) for k, v in batch.items()}

    def encode(d):
        with torch.no_grad():
            return model.vae.encode(d)

    base = encode(data)
    assert set(base) == set(want) == {"mu", "Lp"}
    for k in base:
        np.testing.assert_allclose(base[k].numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    target_moved = encode(dict(data, x6d=data["x6d"] + 0.1, root=data["root"] + 5.0))["mu"]
    torch.testing.assert_close(target_moved, base["mu"], rtol=0, atol=0)
    view_moved = encode(dict(data, x6d_enc=data["x6d_enc"] + 0.1))["mu"]
    assert float((view_moved - base["mu"]).abs().max()) > 1e-4
    # without the view the encoder reads the target's representation
    plain = encode({k: v for k, v in data.items() if k not in ENC_KEYS})["mu"]
    assert float((plain - base["mu"]).abs().max()) > 1e-4


def test_data_and_model_puts_the_view_in_every_split(tmp_path):
    data = tmp_path / "data"
    (data / "synthetic").mkdir(parents=True)
    shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
    for split, seed, n, k in (("train", 0, 300, 2), ("val", 1, 200, 2)):
        pose, ids = synthetic_pose_stream(SKEL, n_frames=n, n_ids=k, seed=seed)
        write_pose_h5(data / "synthetic" / split / "pose.h5", pose, ids)
    cfg = {
        "data": {
            "data_path": str(data) + "/", "dataset": "synthetic", "batch_size": 8, "stride": 2,
            "direction_process": "x360", "encoder_direction_process": "midfwd", "arena_size": ARENA.tolist(),
        },
        "disentangle": {"method": {"conditional": ["avg_speed_3d", "heading"]}, "features": ["avg_speed_3d", "heading"]},
        "model": {"type": "rcnn", "z_dim": 8, "window": 51, "channel": [8, 8, 16, 16, 32]},
        "loss": {"rotation": 1.0, "prior": 0.001},
    }
    keys = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading")
    jds, _, jinfo = jfactory.data_and_model(cfg, data_keys=keys)
    tds, _, info = factory.data_and_model(cfg, data_keys=keys, device="cpu")
    assert info == jinfo
    for split in ("train", "val"):
        assert set(ENC_KEYS) <= set(tds[split].data_keys)
        assert set(tds[split].data_keys) == set(jds[split].data_keys)
        assert tds[split].direction_process == "x360"
        idx = np.arange(min(8, len(tds[split])))
        got, want = tds[split].batch(idx), jds[split].batch(jnp.asarray(idx))
        assert set(got) == set(want)
        np.testing.assert_allclose(got["root_enc"].numpy(), np.asarray(want["root_enc"]), atol=1e-4)
    # the same process for the encoder: no view
    cfg["data"]["encoder_direction_process"] = "x360"
    tds, _, _ = factory.data_and_model(cfg, train_val_test=("train",), data_keys=keys, device="cpu")
    assert not set(ENC_KEYS) & set(tds["train"].data_keys)
