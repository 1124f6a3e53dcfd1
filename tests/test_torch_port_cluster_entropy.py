"""The offline cross-model cluster entropy (``epoch_cluster_entropy``) of
the port against the JAX package's, on the CPU: both read the same run
folder (config, raw pose file, saved epochs) and the same cached
``latents/val_{epoch}.npy``, under the same ``np.random.seed``, and must
agree within 1e-6 at every epoch, for the full and the diagonal
covariance (``model.diag``)."""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from scrubvae_tpu.evals.metrics import epoch_cluster_entropy as jax_entropy
from scrubvae_torch import factory
from scrubvae_torch.data.pose_io import write_pose_h5
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.evals import cluster
from scrubvae_torch.evals.metrics import epoch_cluster_entropy

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARENA = [[-290, -290, 0], [290, 290, 120]]
MODEL = {"type": "rcnn", "z_dim": 8, "window": 51, "channel": [8, 8, 16, 16, 32]}
N_COMPONENTS = 6
EPOCHS = (5, 10)


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """One run folder per ``model.diag``: a config, the val split's raw pose
    file, weights files at epochs 5 and 10 (only their names are read) and
    cached float32 latents of separated blobs at both epochs, plus the
    comparison clustering: the port's GMM labels of epoch 5."""
    root = tmp_path_factory.mktemp("entropy")
    data = root / "data"
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    (data / "synthetic").mkdir(parents=True)
    shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=1600, n_ids=2, seed=3)
    write_pose_h5(data / "synthetic" / "val" / "pose.h5", pose, ids)
    data_cfg = {"data_path": str(data) + "/", "dataset": "synthetic", "direction_process": "midfwd", "arena_size": ARENA}
    n = len(factory.mouse_data(data_cfg, "val", data_keys=("x6d", "root"), window=51, device="cpu"))
    rng = np.random.default_rng(0)
    runs = {}
    for diag in (False, True):
        run = root / f"run_diag{int(diag)}"
        (run / "weights").mkdir(parents=True)
        (run / "latents").mkdir()
        cfg = {"data": data_cfg, "disentangle": {"method": {}}, "model": dict(MODEL, diag=diag), "train": {"seed": 0}}
        with open(run / "model_config.yaml", "w") as f:
            yaml.safe_dump(cfg, f)
        for epoch in EPOCHS:
            (run / "weights" / f"epoch_{epoch}.pt").touch()
            centers = rng.normal(size=(N_COMPONENTS, MODEL["z_dim"])) * 8
            z = centers[rng.integers(0, N_COMPONENTS, n)] + rng.normal(size=(n, MODEL["z_dim"]))
            np.save(run / "latents" / f"val_{epoch}.npy", z.astype(np.float32))
        np.random.seed(1)
        cluster.gmm(np.load(run / "latents" / "val_5.npy"), label="val_5", path=str(run) + "/",
                    n_components=N_COMPONENTS, covariance_type="diag" if diag else "full", device="cpu")
        runs[diag] = run
    return runs


@pytest.mark.parametrize("diag", [False, True])
def test_epoch_cluster_entropy_matches_jax(run_dirs, diag):
    run = run_dirs[diag]
    kw = dict(comparison_clustering=str(run / "val_5_gmm.npy"), n_components=N_COMPONENTS, start_epoch=0)
    np.random.seed(4)
    want = jax_entropy(str(run), "cluster_entropy", "val", save_load=False, **kw)
    np.random.seed(4)
    got = epoch_cluster_entropy(str(run), "cluster_entropy", "val", save_load=False, device="cpu", **kw)
    assert list(got["epochs"]) == list(want["epochs"]) == list(EPOCHS)
    np.testing.assert_allclose(got["Entropy"], want["Entropy"], rtol=0, atol=1e-6)
    assert all(0.0 <= e <= np.log2(N_COMPONENTS) for e in got["Entropy"])


def test_epoch_cluster_entropy_caches_its_result(run_dirs, monkeypatch):
    run = run_dirs[False]
    kw = dict(comparison_clustering=str(run / "val_5_gmm.npy"), n_components=N_COMPONENTS, start_epoch=0)
    np.random.seed(4)
    first = epoch_cluster_entropy(str(run), "cluster_entropy", "val", device="cpu", **kw)
    assert (run / "cluster_entropy_val.p").is_file()

    def no_fit(*a, **k):
        raise AssertionError("the pickle should have been read")

    monkeypatch.setattr(cluster.GaussianMixture, "fit_predict", no_fit)
    again = epoch_cluster_entropy(str(run), "cluster_entropy", "val", device="cpu", **kw)
    assert again["Entropy"] == first["Entropy"]
    (run / "cluster_entropy_val.p").unlink()


def test_comparison_clustering_must_cover_the_dataset(run_dirs, tmp_path):
    run = run_dirs[True]
    short = tmp_path / "short.npy"
    np.save(short, np.load(run / "val_5_gmm.npy")[:-1])
    with pytest.raises(AssertionError, match="comparison clustering has"):
        epoch_cluster_entropy(str(run), "cluster_entropy", "val", save_load=False, device="cpu",
                              comparison_clustering=str(short), n_components=N_COMPONENTS, start_epoch=0)
