"""``factory.data_and_model`` from raw pose files on disk, the port against
the JAX package: the same splits (length, discrete classes, batches key by
key for the train keys and the val keys), the same model description; and
the data paths that are not ported yet raise ``NotImplementedError``.

Batches are held to the tolerances of ``tests/test_torch_port_data.py``:
atol 1e-5, plus twice the JAX pipeline's own distance from float64 for the
two keys built from the per-frame IK (x6d, target_pose).
"""

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu import factory as jfactory
from scrubvae_torch import factory
from scrubvae_torch.data.pose_io import write_pose_h5
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.ops import kinematics as tkin
from scrubvae_torch.ops import quaternion as tq

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TRAIN_KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading")


def write_data(root: Path) -> Path:
    data = root / "data"
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    (data / "synthetic").mkdir(parents=True)
    shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
    for split, seed, n, k in (("train", 0, 600, 3), ("val", 1, 300, 2)):
        pose, ids = synthetic_pose_stream(skel, n_frames=n, n_ids=k, seed=seed)
        write_pose_h5(data / "synthetic" / split / "pose.h5", pose, ids)
    return data


def config(data: Path) -> dict:
    return {
        "data": {
            "data_path": str(data) + "/", "dataset": "synthetic", "batch_size": 16,
            "direction_process": "midfwd", "arena_size": [[-290, -290, 0], [290, 290, 120]],
            "window": None, "stride": 2,
        },
        "disentangle": {
            "method": {"conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"]},
            "features": ["avg_speed_3d", "heading"],
        },
        "model": {"type": "rcnn", "z_dim": 16, "window": 51, "channel": [8, 8, 16, 16, 32]},
        "train": {"precision": "bf16"},
        "loss": {"rotation": 1.0, "prior": 0.001},
    }


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    data = write_data(tmp_path_factory.mktemp("factory"))
    cfg = config(data)
    jds, _, jinfo = jfactory.data_and_model(cfg, data_keys=TRAIN_KEYS)
    tds, model, info = factory.data_and_model(cfg, data_keys=TRAIN_KEYS, device="cpu")
    return cfg, jds, jinfo, tds, model, info


def _f32_noise(jds, skel) -> dict:
    """The JAX pipeline's own distance from a float64 evaluation of its
    per-frame x6d and zero-root FK."""
    p64 = torch.from_numpy(np.asarray(jds.store.pose, np.float64))
    x6d64 = tq.quaternion_to_cont6d(tkin.inv_kin(p64, skel.tree, forward_indices=[1, 0]))
    offs = torch.from_numpy(np.array(jds.store.offsets)).double()
    tpose64 = tkin.fwd_kin_cont6d(x6d64, skel.tree, offs, p64.new_zeros(len(p64), 3), eps=1e-8)
    return {
        "x6d": float(np.abs(np.asarray(jds.store.x6d) - x6d64.numpy()).max()),
        "target_pose": float(np.abs(np.asarray(jds.store.tpose) - tpose64.numpy()).max()),
    }


@pytest.mark.parametrize("split", ["train", "val"])
def test_splits_match(pair, split):
    _, jds, _, tds, _, _ = pair
    j, t = jds[split], tds[split]
    assert len(t) == len(j) > 0
    assert t.label == split and t.n_keypts == j.n_keypts == 18
    assert t.discrete_classes.keys() == j.discrete_classes.keys()
    for k in j.discrete_classes:
        np.testing.assert_array_equal(t.discrete_classes[k], np.asarray(j.discrete_classes[k]))
    assert set(t.data_keys) == set(j.data_keys)
    np.testing.assert_array_equal(np.asarray(t.arena_size), np.asarray(j.arena_size))
    for k in ("mean", "std"):
        np.testing.assert_array_equal(
            t.norm_params["avg_speed_3d"][k].numpy(), np.asarray(j.norm_params["avg_speed_3d"][k])
        )
    idx = np.random.default_rng(0).integers(0, len(j), 32)
    want, got = j.batch(jnp.asarray(idx)), t.batch(idx)
    assert set(got) == set(want)
    noise = _f32_noise(j, t.skeleton)
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_allclose(a, b, atol=1e-5 + 2 * noise.get(k, 0.0), rtol=0, err_msg=k)


def test_model_description_matches(pair):
    _, _, jinfo, _, model, info = pair
    assert info == jinfo
    assert model.vae.window == 51 and model.vae.encoder.compute_dtype == torch.bfloat16


def test_all_saved_epochs(tmp_path):
    (tmp_path / "weights").mkdir()
    for name in ("epoch_20.pt", "epoch_5.pt", "epoch_5.pth", "epoch_15.pt"):
        (tmp_path / "weights" / name).touch()
    assert list(factory.all_saved_epochs(tmp_path)) == [5, 15, 20]


@pytest.mark.parametrize("what", ["host_stream", "preprocessed_layout", "parkinsons"])
def test_unported_paths_raise(pair, tmp_path, what):
    cfg = config(Path(pair[0]["data"]["data_path"]))
    if what == "host_stream":
        cfg["data"]["host_stream"] = True
        match = "host streaming"
    elif what == "preprocessed_layout":
        (tmp_path / "synthetic" / "train").mkdir(parents=True)
        shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", tmp_path / "mouse_skeleton.yaml")
        cfg["data"]["data_path"] = str(tmp_path) + "/"
        match = "preprocessed per-key"
    else:
        data = Path(cfg["data"]["data_path"])
        shutil.copytree(data / "synthetic", data / "parkinsons", dirs_exist_ok=True)
        cfg["data"]["dataset"] = "parkinsons"
        match = "parkinsons"
    with pytest.raises(NotImplementedError, match=match):
        factory.data_and_model(cfg, data_keys=TRAIN_KEYS, device="cpu")
