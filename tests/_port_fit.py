"""Both packages' ``train`` from one YAML config, for the port's
trainer-level tests: each package reads its own copy of the config with
its own reader, from the same pose files on disk, and the port starts from
the JAX model's initial weights, taken from the JAX trainer when its
``train`` calls ``fit`` and loaded through ``from_jax_variables`` in place
of the port's weight init. Both draw the batch order from
``np.random.default_rng(seed)`` permutations.

What cannot agree bit for bit, and so is held by a band per column: the
sample noise of the reparameterisation (JAX's key stream against the
port's ``torch.Generator``), the per-epoch re-init of the
gradient-reversal heads (the same two initializers, different random
streams) and the restrictiveness draws of the validation epochs.
"""

import csv
import shutil
from pathlib import Path

import flax
import jax
import numpy as np
import pytest
import yaml

from scrubvae_tpu.params import read as jread
from scrubvae_tpu.train.trainer import Trainer as JaxTrainer
from scrubvae_tpu.train.trainer import train as jax_train
from scrubvae_torch import factory
from scrubvae_torch.data.pose_io import write_pose_h5
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.models.scrubvae import ScrubVAE
from scrubvae_torch.params import read
from scrubvae_torch.train.trainer import train
from scrubvae_torch.utils.weights import from_jax_variables

ROOT = Path(__file__).resolve().parent.parent


def write_pose_files(data: Path, stream, splits) -> Path:
    """``{data}/synthetic/{split}/pose.h5`` from ``stream(skel, n_frames=n,
    n_ids=k, seed=seed)`` for each ``(split, seed, n, k)``, and the
    skeleton beside them."""
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    (data / "synthetic").mkdir(parents=True)
    shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
    for split, seed, n, k in splits:
        pose, ids = stream(skel, n_frames=n, n_ids=k, seed=seed)
        write_pose_h5(data / "synthetic" / split / "pose.h5", pose, ids)
    return data


def read_csv(path: Path):
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return list(reader.fieldnames), list(reader)


def run_both(root: Path, cfg: dict):
    """Write ``cfg`` to ``root/runs/{jax,port}/model_config.yaml`` and train
    each package from its copy (the port on the CPU). Returns the run
    folders and the port's trainer."""
    jax.config.update("jax_default_matmul_precision", "highest")
    paths = {}
    for side in ("jax", "port"):
        paths[side] = root / "runs" / side
        paths[side].mkdir(parents=True)
        with open(paths[side] / "model_config.yaml", "w") as f:
            yaml.safe_dump(cfg, f)

    captured = {}
    jax_fit = JaxTrainer.fit

    def fit_from_known_weights(self, num_epochs=None):
        captured["weights"] = from_jax_variables({
            k: np.array(v) for k, v in flax.traverse_util.flatten_dict(
                {"params": self.state.params, "batch_stats": self.state.batch_stats}, sep="/"
            ).items()
        })
        return jax_fit(self, num_epochs)

    original = factory.init_weights

    def carried(module, seed):
        """The JAX initial weights; the GR re-init keeps the port's own."""
        if isinstance(module, ScrubVAE):
            module.load_state_dict(captured["weights"], strict=True)
        else:
            original(module, seed)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTrainer, "fit", fit_from_known_weights)
        mp.setattr(factory, "init_weights", carried)
        jax_train(jread.config(paths["jax"] / "model_config.yaml"))
        trainer = train(read.config(paths["port"] / "model_config.yaml"), device="cpu")
    return paths, trainer


def check_bands(paths: dict, band) -> dict:
    """Every column of the port's ``metrics.csv`` finite and within
    ``band(epoch, column)`` relative of the JAX package's, epoch by epoch
    (the readings are printed with ``-s``); returns the worst gap per
    column."""
    _, jrows = read_csv(paths["jax"] / "metrics.csv")
    _, rows = read_csv(paths["port"] / "metrics.csv")
    assert len(rows) == len(jrows) > 0
    worst = {}
    for jr, r in zip(jrows, rows):
        for k, v in jr.items():
            if k in ("epoch", "time") or v == "":
                continue
            rel = abs(float(r[k]) - float(v)) / max(abs(float(v)), 1e-12)
            print(f"epoch {jr['epoch']} {k}: port {float(r[k]):.6g} JAX {float(v):.6g} rel {rel:.3e}")
            worst[k] = max(worst.get(k, 0.0), rel)
            assert np.isfinite(float(r[k])), (jr["epoch"], k)
            assert rel <= band(int(jr["epoch"]), k), (jr["epoch"], k, float(r[k]), float(v), rel)
    print("worst relative gap per column:", {k: f"{v:.3e}" for k, v in worst.items()})
    return worst
