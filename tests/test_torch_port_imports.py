"""The port stands alone: no JAX, flax or scrubvae_tpu in its imports, and
its entry points refuse to run on a missing GPU unless asked for the CPU."""

import pkgutil
import subprocess
import sys
import pathlib

import numpy as np
import pytest
import torch

import scrubvae_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_importing_every_module_pulls_in_no_jax():
    mods = [m.name for m in pkgutil.walk_packages(scrubvae_torch.__path__, "scrubvae_torch.")]
    for m in (
        "ops.fused_adamw", "train.trainer", "params.read", "params.param_keys", "evals.restrictiveness",
        "train_model", "utils.checkpoint", "utils.logging", "data.pose_io", "evals.metrics", "evals.probes",
        "evals.latents", "bench", "models.base", "models.mlp_vae", "models.transformer",
        "data.hoststream", "preprocess_data", "evals.cluster", "evals.traverse", "plot", "plot.plot",
        "plot.eval", "plot.pose_viz", "plot.constants", "utils.profiling", "models.mi",
        "utils.export", "utils.torch_export", "utils.torch_import", "export_model", "serve_bench", "export_torch",
        "parallel", "parallel.mesh", "utils.step_cost", "utils.retry", "utils.cuda_build",
    ):
        assert "scrubvae_torch." + m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'scrubvae_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_decodability_runs_without_sklearn_or_jax():
    """The evals and the trainer import, and a small decodability call
    runs, with sklearn unimportable and without pulling in JAX or the JAX
    package."""
    code = (
        "import sys, types\n"
        "sys.modules['sklearn'] = None\n"
        "import numpy as np, torch\n"
        "import scrubvae_torch.evals.metrics, scrubvae_torch.evals.latents\n"
        "from scrubvae_torch.train.trainer import Trainer\n"
        "rng = np.random.default_rng(0)\n"
        "n = 400\n"
        "ids = rng.integers(0, 3, n)\n"
        "z = rng.normal(size=(n, 6)).astype(np.float32) + ids[:, None]\n"
        "labels = {'avg_speed_3d': torch.from_numpy(z[:, :3] * 2), 'heading': torch.from_numpy(z[:, 3:5]),\n"
        "          'ids': torch.from_numpy(ids)}\n"
        "class Val:\n"
        "    def __len__(self): return n\n"
        "    def batch(self, idx): return {k: v[idx] for k, v in labels.items()}\n"
        "me = types.SimpleNamespace(info={'window': 10}, config={'data': {'dataset': 'synthetic'}},\n"
        "    train_cfg={}, val_ds=Val(), device=torch.device('cpu'), _fold_summary=Trainer._fold_summary)\n"
        "out = Trainer.decodability_metrics(me, z)\n"
        "assert len(out) == 12 and all(np.isfinite(v) for v in out.values()), out\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'scrubvae_tpu')\n"
        "       or (m.startswith('sklearn') and sys.modules[m] is not None)]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_analysis_runs_without_sklearn_or_matplotlib():
    """``evals.cluster``, ``evals.traverse`` and ``plot`` import, and a small
    GMM and HDBSCAN run, with sklearn and matplotlib unimportable and
    without pulling in JAX or the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "import scrubvae_torch.plot, scrubvae_torch.evals.traverse, scrubvae_torch.utils.profiling\n"
        "from scrubvae_torch.evals import cluster\n"
        "rng = np.random.default_rng(0)\n"
        "z = np.concatenate([rng.normal(size=(60, 3)), rng.normal(size=(60, 3)) + 8.0])\n"
        "k, model = cluster.gmm(z, n_components=2, device='cpu')\n"
        "assert sorted(np.bincount(k)) == [60, 60], k\n"
        "labels = cluster.dbscan(z, min_samples=10, path=None, device='cpu')\n"
        "assert len(set(labels[:60]) - {-1}) == 1 and len(set(labels[60:]) - {-1}) == 1, labels\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'scrubvae_tpu')\n"
        "       or (m.split('.')[0] in ('sklearn', 'matplotlib') and sys.modules[m] is not None)]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_pose_io_imports_without_h5py():
    """h5py is imported when a file is read or written, not before; pandas
    never (the parkinsons metadata is read with csv)."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import scrubvae_torch.data.pose_io, scrubvae_torch.factory, scrubvae_torch.train_model\n"
        "import scrubvae_torch.data.hoststream, scrubvae_torch.preprocess_data\n"
        "try:\n"
        "    scrubvae_torch.data.pose_io.read_pose_h5('missing.h5')\n"
        "except ImportError:\n"
        "    sys.exit(0)\n"
        "sys.exit(1)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_need_a_gpu_unless_cpu_is_asked_for(monkeypatch):
    from scrubvae_torch import factory
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream
    from scrubvae_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=300, n_ids=2, seed=0)
    arena = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_frame_store(pose, ids, skel, window=31)
    store = build_frame_store(pose, ids, skel, window=31, device="cpu")
    keys = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamDataset(store, skel, keys, "midfwd", arena)
    ds = StreamDataset(store, skel, keys, "midfwd", arena, device="cpu")
    model_cfg = {"type": "rcnn", "z_dim": 8, "window": 31, "channel": [8, 8, 16, 16, 32]}
    dis = {"method": {}, "features": []}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory.build_model(model_cfg, dis, 18, "midfwd", arena_size=arena)
    model, info = factory.build_model(model_cfg, dis, 18, "midfwd", arena_size=arena, device="cpu")
    cfg = {
        "data": {"batch_size": 4},
        "disentangle": dis,
        "train": {"optimizer": "adamw", "lr": 1e-4, "minimal_test": True},
        "loss": {"rotation": 1.0},
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, {"train": ds}, model, info)
    trainer = Trainer(cfg, {"train": ds}, model, info, device="cpu")
    assert np.isfinite(trainer.train_epoch(1, np.arange(8).reshape(2, 4))["total"])


def test_bench_needs_a_gpu_unless_cpu_is_asked_for(monkeypatch):
    """``python -m scrubvae_torch.bench`` runs on the card by default and
    raises before building anything when there is none; ``--device cpu``
    is the only way onto the CPU."""
    from scrubvae_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = ["--small", "--steps", "1", "--warmup", "0"]
    assert bench.parse_args(small).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.run(bench.parse_args(small))
    out = bench.run(bench.parse_args(small + ["--device", "cpu"]))
    assert out["device_kind"] == "cpu" and np.isfinite(out["total"])


def test_serving_needs_a_gpu_unless_cpu_is_asked_for(monkeypatch):
    """``serve_bench`` and ``load_exported`` run on the card by default
    and raise without one before building anything."""
    from scrubvae_torch import serve_bench
    from scrubvae_torch.utils.export import load_exported

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_bench.main(["--flagship", "--batches", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_exported(b"", "cuda")


def test_bare_cuda_resolves_to_the_current_device_index(monkeypatch):
    """Tensors on the card report ``cuda:0``; entry points compare devices,
    so ``"cuda"`` must resolve to the same indexed device."""
    from scrubvae_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_a_rank_resolves_to_its_local_card(monkeypatch):
    """Under a launcher that sets ``LOCAL_RANK`` a bare ``"cuda"`` is this
    rank's card; a named card (ranks sharing one) stays as named."""
    from scrubvae_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device("cuda") == resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_parallel_imports_no_jax():
    """``scrubvae_torch.parallel`` alone pulls in neither JAX nor the JAX
    package (its counterpart there imports JAX)."""
    code = (
        "import sys\n"
        "import scrubvae_torch.parallel, scrubvae_torch.parallel.mesh\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'scrubvae_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_analysis_entry_points_need_a_gpu_unless_cpu_is_asked_for(monkeypatch, tmp_path):
    """``gmm``, ``dbscan``, ``GaussianMixture.predict`` and ``latents``
    default to CUDA and raise without a GPU; ``device="cpu"`` runs them."""
    from scrubvae_torch.evals import cluster
    from scrubvae_torch.evals.latents import latents

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.random.default_rng(1).normal(size=(40, 3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster.gmm(z, n_components=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cluster.dbscan(z, min_samples=5, path=None)
    k, model = cluster.gmm(z, n_components=2, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.predict(z)
    assert (model.predict(z, device="cpu") == k).all()
    assert cluster.dbscan(z, min_samples=5, path=None, device="cpu").shape == (40,)

    class Data:
        n_keypts, arena_size, discrete_classes = 18, None, {}

        def __len__(self):
            return 4

    config = {
        "out_path": str(tmp_path), "model": {"type": "rcnn", "z_dim": 4, "window": 31, "channel": [8, 8, 16, 16, 32]},
        "disentangle": {"method": {}, "features": []}, "data": {"direction_process": "midfwd"},
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        latents(config, epoch=5, dataset=Data())
