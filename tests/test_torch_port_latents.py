"""Latent extraction (``scrubvae_torch/evals/latents.py``) against the JAX
package's ``scrubvae_tpu/evals/latents.py``, and the offline per-epoch
decodability sweep (``epoch_regression``) with its caches, on the CPU at
the bench's ``--small`` widths (channels 8-8-16-16-32, z 16, window 51).

The port's model carries the JAX model's weights and non-trivial BatchNorm
running statistics (``from_jax_variables``); ``encode_dataset`` must give
JAX's mu within 1e-5 relative (one eval-mode f32 encoder pass).
"""

import shutil
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from scrubvae_tpu import factory as jfactory
from scrubvae_tpu.data.dataset import StreamDataset as JaxStreamDataset
from scrubvae_tpu.data.pipeline import build_frame_store as jax_build_frame_store
from scrubvae_tpu.data.skeleton import load_skeleton as jax_load_skeleton
from scrubvae_tpu.evals.latents import encode_dataset as jax_encode_dataset
from scrubvae_torch import factory
from scrubvae_torch.data.dataset import StreamDataset
from scrubvae_torch.data.pipeline import build_frame_store
from scrubvae_torch.data.pose_io import write_pose_h5
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.evals import latents as lat
from scrubvae_torch.evals import metrics as em
from scrubvae_torch.utils import checkpoint as ckpt
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
    "method": {
        "conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"],
        "moving_avg_lsq": ["avg_speed_3d"], "grad_reversal": ["avg_speed_3d"],
    },
    "features": ["avg_speed_3d", "heading"], "alpha": 1.0,
}


def flat(tree) -> dict:
    return {k: np.array(v, copy=True) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def carried():
    """The same stream as a JAX and a port StreamDataset (2 ids of 300
    frames: 250 windows, a tail at batch 64), a JAX model's variables with
    running statistics away from their initial values, and the port's
    model holding them."""
    jax.config.update("jax_default_matmul_precision", "highest")
    jskel = jax_load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=600, n_ids=2, seed=4)
    classes = {"ids": np.unique(ids)}
    jds = JaxStreamDataset(
        jax_build_frame_store(pose, ids, jskel, window=51, stride=2), jskel, KEYS, "midfwd",
        arena_size=ARENA, discrete_classes=classes,
    )
    tds = StreamDataset(
        build_frame_store(pose, ids, skel, window=51, stride=2, device="cpu"), skel, KEYS, "midfwd",
        arena_size=ARENA, discrete_classes=classes, device="cpu",
    )
    jmodel, _ = jfactory.build_model(MODEL, DIS, 18, "midfwd", arena_size=ARENA, discrete_classes=classes)
    key = jax.random.PRNGKey(1)
    variables = jmodel.init({"params": key, "dropout": key}, jds.batch(jnp.arange(2)), rng=key, train=True)
    rng = np.random.default_rng(0)
    variables = dict(variables)
    variables["batch_stats"] = jax.tree.map(
        lambda x: jnp.asarray(
            rng.uniform(0.5, 1.5, x.shape) if np.all(np.asarray(x) == 1) else rng.normal(0.0, 0.2, x.shape),
            jnp.float32,
        ),
        variables["batch_stats"],
    )
    model, _ = factory.build_model(MODEL, DIS, 18, "midfwd", arena_size=ARENA, discrete_classes=classes, device="cpu")
    model.load_state_dict(from_jax_variables(flat(variables)), strict=True)
    return jmodel, variables, jds, model, tds


def test_encode_dataset_matches_jax(carried):
    jmodel, variables, jds, model, tds = carried
    assert len(tds) % 64 and len(tds) == len(jds)
    want = jax_encode_dataset(jmodel, variables, jds, batch_size=64)
    model.train()
    got = lat.encode_dataset(model, tds, batch_size=64)
    assert model.training  # the mode is restored
    assert got.shape == want.shape == (len(tds), MODEL["z_dim"]) and got.dtype == np.float32
    rel = np.abs(got - want).max() / np.abs(want).max()
    print(f"encode_dataset: max |port - JAX| / max |JAX| = {rel:.2e}")
    assert rel <= 1e-5
    # batching does not change the answer
    np.testing.assert_allclose(lat.encode_dataset(model, tds, batch_size=len(tds)), got, rtol=0, atol=1e-5)


def test_latents_writes_and_rereads_the_cache(carried, tmp_path, monkeypatch, capsys):
    _, _, _, model, tds = carried
    cfg = {"out_path": str(tmp_path), "model": dict(MODEL), "disentangle": DIS, "data": {"direction_process": "midfwd"}}
    z = lat.latents(cfg, model=model, epoch=3, dataset=tds, label="val")
    path = tmp_path / "latents" / "val_3.npy"
    np.testing.assert_array_equal(np.load(path), z)
    active = int((z.std(axis=0) > 0.1).sum())
    assert f"Latent dims with std > 0.1 over dataset: {active}" in capsys.readouterr().out

    def no_encoding(*a, **k):
        raise AssertionError("the cache should have been read")

    with monkeypatch.context() as mp:
        mp.setattr(lat, "encode_dataset", no_encoding)
        np.testing.assert_array_equal(lat.latents(cfg, epoch=3, dataset=tds, label="val"), z)
    # a cache of another dataset's length is refused
    np.save(path, z[:-1])
    with pytest.raises(ValueError, match="latents for a dataset"):
        lat.latents(cfg, epoch=3, dataset=tds, label="val")
    # without a model: built from the config, weights loaded from out_path
    ckpt.save_weights(tmp_path, 3, model)
    again = lat.latents(cfg, epoch=3, dataset=tds, label="val", overwrite=True, device="cpu")
    np.testing.assert_array_equal(again, z)
    np.testing.assert_array_equal(np.load(path), z)


# ---------------------------------------------------------------------------
# the offline per-epoch sweep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def saved_run(tmp_path_factory):
    """A run folder with a config, raw pose files and weights at epochs 5
    and 10 (two different random inits)."""
    root = tmp_path_factory.mktemp("epochs")
    data = root / "data"
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    (data / "synthetic").mkdir(parents=True)
    shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=2400, n_ids=3, seed=7)
    write_pose_h5(data / "synthetic" / "val" / "pose.h5", pose, ids)
    run = root / "run"
    run.mkdir()
    cfg = {
        "data": {
            "data_path": str(data) + "/", "dataset": "synthetic", "direction_process": "midfwd",
            "arena_size": ARENA.tolist(),
        },
        "disentangle": {"method": DIS["method"]},
        "model": dict(MODEL),
        "train": {"seed": 0},
    }
    with open(run / "model_config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    model, _ = factory.build_model(
        MODEL, DIS, 18, "midfwd", arena_size=ARENA, discrete_classes={"ids": np.unique(ids)}, device="cpu"
    )
    for epoch in (5, 10):
        factory.init_weights(model, epoch)
        ckpt.save_weights(run, epoch, model)
    return run, model


def test_epoch_regression_sweeps_caches_and_extends(saved_run, monkeypatch):
    run, model = saved_run
    res = em.epoch_regression(str(run), "linear_rand_cv", "val", start_epoch=0, device="cpu")
    assert list(res["epochs"]) == [5, 10]
    assert (run / "linear_rand_cv_val.p").is_file()
    assert sorted(p.name for p in (run / "latents").iterdir()) == ["val_10.npy", "val_5.npy"]
    ds = factory.mouse_data(
        {"data_path": str(run.parent / "data") + "/", "dataset": "synthetic", "direction_process": "midfwd",
         "arena_size": ARENA.tolist()},
        "val", data_keys=("x6d", "root", "avg_speed_3d", "heading"), window=51, device="cpu",
    )
    full = ds.batch(torch.arange(len(ds)))
    for i, epoch in enumerate((5, 10)):
        z = np.load(run / "latents" / f"val_{epoch}.npy")
        for key in ("avg_speed_3d", "heading"):
            want = em.linear_rand_cv(z, full[key], 51, 5, device="cpu")
            np.testing.assert_array_equal(res[key]["R2"][i], want)
            assert np.isfinite(want).all()
    # the pickle is read back; only new epochs are computed
    calls = []
    real = lat.latents

    def counting(config, epoch=None, **kw):
        calls.append(epoch)
        return real(config, epoch=epoch, **kw)

    monkeypatch.setattr(lat, "latents", counting)
    again = em.epoch_regression(str(run), "linear_rand_cv", "val", start_epoch=0, device="cpu")
    assert calls == [] and list(again["epochs"]) == [5, 10]
    factory.init_weights(model, 15)
    ckpt.save_weights(run, 15, model)
    more = em.epoch_regression(str(run), "linear_rand_cv", "val", start_epoch=0, device="cpu")
    assert calls == [15] and list(more["epochs"]) == [5, 10, 15]
    assert len(more["heading"]["R2"]) == 3


def test_epoch_regression_classification_uses_the_class_window(saved_run):
    run, _ = saved_run
    res = em.epoch_regression(
        str(run), "qda_rand_cv", "val", save_load=False, disentangle_keys=("ids",), start_epoch=6, device="cpu"
    )
    assert res["epochs"][0] == 10 and all(e > 6 for e in res["epochs"])
    z = np.load(run / "latents" / "val_10.npy")
    ds = factory.mouse_data(
        {"data_path": str(run.parent / "data") + "/", "dataset": "synthetic", "direction_process": "midfwd",
         "arena_size": ARENA.tolist()},
        "val", data_keys=("x6d", "root", "ids"), window=51, device="cpu",
    )
    y = ds.batch(torch.arange(len(ds)))["ids"].long()
    want = em.qda_rand_cv(z, y, em.decodability_class_window("synthetic", 51), 5, device="cpu")
    np.testing.assert_array_equal(res["ids"]["Accuracy"][0], want)
    assert not (run / "qda_rand_cv_val.p").exists()
