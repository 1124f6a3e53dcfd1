"""The shared harness of the port's trainer-level tests.

``run_both``: both packages' ``train`` from one YAML config: each package
reads its own copy of the config with
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

``step_pair`` and ``run_steps``: the first train steps of the port's
``Trainer`` against the JAX ``Trainer.train_step`` from the same weights
(carried with ``from_jax_variables``), window rows and sample noise (JAX's
own, ``jax.random.normal(split(state.rng, 5)[1], mu.shape)``), on a
synthetic stream; with ``scrubvae_torch.train.parity``, ``check_updates``
and ``check_states`` hold them as ``tests/test_torch_port_step.py`` holds
the flagship's.
"""

import csv
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
from scrubvae_tpu.params import read as jread
from scrubvae_tpu.train.trainer import Trainer as JaxTrainer
from scrubvae_tpu.train.trainer import train as jax_train
from scrubvae_torch import factory
from scrubvae_torch.data.dataset import StreamDataset
from scrubvae_torch.data.pipeline import build_frame_store
from scrubvae_torch.data.pose_io import write_pose_h5
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.models.scrubvae import ScrubVAE
from scrubvae_torch.params import read
from scrubvae_torch.train import parity
from scrubvae_torch.train.trainer import Trainer, train
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
        variables = {"params": self.state.params}
        if self.state.batch_stats is not None:
            variables["batch_stats"] = self.state.batch_stats
        captured["weights"] = from_jax_variables(flat(variables))
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


# ---------------------------------------------------------------------------
# the first train steps, port against JAX
# ---------------------------------------------------------------------------

STEP_KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids")
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)
# the streaming scrubber states compared after the steps, with their arrays
STATE_KEYS = {"moving_avg_lsq": parity.MALS_KEYS, "moving_avg": parity.MA_KEYS}


def flat(tree) -> dict:
    """A flax tree as '/'-joined numpy copies (the JAX step donates its state)."""
    return {k: np.array(v, copy=True) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def step_pair(cfg: dict, n_frames: int = 800, jax_vae=None, port_model=None) -> tuple:
    """The JAX trainer and the port's (on the CPU) for ``cfg`` on the same
    synthetic stream (4 ids, midfwd windows of the model's window), the
    port's carrying the JAX initial weights. ``jax_vae(vae)`` replaces the
    JAX model's VAE and ``port_model(model)`` adjusts the port's before its
    trainer is built. Returns (JAX trainer, port trainer)."""
    jax.config.update("jax_default_matmul_precision", "highest")
    window = cfg["model"]["window"]
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    jskel = jax_load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=n_frames, n_ids=4, seed=0)
    classes = {"ids": np.unique(ids)}
    jds = JaxStreamDataset(
        jax_build_frame_store(pose, ids, jskel, window=window, stride=2), jskel, STEP_KEYS, "midfwd",
        arena_size=ARENA, discrete_classes=classes,
    )
    tds = StreamDataset(
        build_frame_store(pose, ids, skel, window=window, stride=2, device="cpu"), skel, STEP_KEYS,
        "midfwd", arena_size=ARENA, discrete_classes=classes, device="cpu",
    )
    build = dict(
        n_keypts=18, direction_process="midfwd", arena_size=ARENA, discrete_classes=classes,
        loss_keys=cfg["loss"].keys(),
    )
    jmodel, jinfo = jfactory.build_model(cfg["model"], cfg["disentangle"], **build)
    if jax_vae is not None:
        jmodel = jmodel.clone(vae=jax_vae(jmodel.vae))
    jt = JaxTrainer(cfg, {"train": jds}, jmodel, jinfo)
    variables = {"params": jt.state.params}
    if jt.state.batch_stats is not None:
        variables["batch_stats"] = jt.state.batch_stats
    model, info = factory.build_model(cfg["model"], cfg["disentangle"], device="cpu", **build)
    if port_model is not None:
        port_model(model)
    trainer = Trainer(cfg, {"train": tds}, model, info, device="cpu")
    trainer.model.load_state_dict(from_jax_variables(flat(variables)), strict=True)
    return jt, trainer


def _states(scrub_state, to_tensor) -> dict:
    return {
        f"{method}/{feat}": {k: to_tensor(getattr(st, k)) for k in keys}
        for method, keys in STATE_KEYS.items()
        for feat, st in scrub_state.get(method, {}).items()
    }


def run_steps(jt, trainer, rows: np.ndarray) -> tuple:
    """``len(rows)`` steps of each side on the window rows ``rows[s]``, the
    port with JAX's sample noise. Returns (JAX run, port run): each step's
    losses, the step-1 gradients (from the first moment, m = (1 - b1) g) and
    weights, the streaming states after step 1 and after the last, and the
    update of every leaf over all the steps, and the port's initial weights
    (``port["w0"]``)."""
    B = rows.shape[1]
    ref, port = {"losses": []}, {"losses": []}
    p0 = flat({"params": jt.state.params})
    loss_scale = jt.loss_scale_for_epoch(1)
    noises = []
    Z = trainer.info["z_dim"]
    for s, row in enumerate(rows):
        noises.append(np.array(jax.random.normal(jax.random.split(jt.state.rng, 5)[1], (B, Z))))
        jt.state, metrics = jt.train_step(jt.state, jnp.asarray(row, jnp.int32), loss_scale)
        ref["losses"].append({k: float(v) for k, v in metrics.items()})
        if s == 0:
            mu = flat({"params": jt.state.opt_state.mu})
            ref["grads"] = from_jax_variables({k: v / (1.0 - jt.tx.b1) for k, v in mu.items()})
            ref["w1"] = from_jax_variables(flat({"params": jt.state.params}))
        if s in (0, len(rows) - 1):
            ref[f"states{s + 1}"] = _states(jt.state.scrub_state, lambda a: torch.from_numpy(np.array(a)))
    p3 = flat({"params": jt.state.params})
    ref["dw"] = from_jax_variables({k: p3[k] - p0[k] for k in p3})

    names = [n for n, _ in trainer.model.named_parameters()]
    w0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    port["w0"] = w0
    port_scale = trainer.loss_scale_for_epoch(1)
    for s, row in enumerate(rows):
        trainer.state, metrics = trainer.train_step(
            trainer.state, torch.as_tensor(row), port_scale, eps=torch.from_numpy(noises[s])
        )
        port["losses"].append({k: float(v) for k, v in metrics.items()})
        if s == 0:
            b1 = trainer.tx.b1
            port["grads"] = {n: m / (1.0 - b1) for n, m in zip(names, trainer.state.opt_state.mu)}
            port["w1"] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        if s in (0, len(rows) - 1):
            port[f"states{s + 1}"] = _states(trainer.state.scrub_state, lambda t: t.detach().clone())
    port["dw"] = {n: p.detach() - w0[n] for n, p in trainer.model.named_parameters()}
    return ref, port


def check_updates(ref: dict, port: dict) -> dict:
    """The update of every leaf over the steps, by relative norm: <= 0.25
    per leaf and <= 0.1 median over leaves (size-1 leaves, leaves the
    reference leaves at exactly 0 and the elements of exact zero gradient,
    ``parity.zero_grad_elements``, left out). Returns the readings."""
    zero = parity.zero_grad_leaves(ref["dw"])
    rels = {}
    for n, w in ref["dw"].items():
        keep = ~parity.zero_grad_elements(n, w)
        if n not in zero and w.numel() > 1 and float(w[keep].norm()) > 0:
            rels[n] = parity.rel(port["dw"][n][keep], w[keep])
    bad = {n: r for n, r in rels.items() if r > 0.25}
    assert not bad, bad
    median = float(np.median(list(rels.values())))
    assert median <= 0.1, median
    return {"max_update_rel": max(rels.values()), "median_update_rel": median}


def check_states(ref: dict, port: dict, after: int, tol: float) -> float:
    """Every MALS and moving-average state after step ``after``."""
    want, got = ref[f"states{after}"], port[f"states{after}"]
    assert want.keys() == got.keys()
    worst = 0.0
    for name, arrays in want.items():
        check = parity.check_mals if name.startswith("moving_avg_lsq/") else parity.check_ma
        worst = max(worst, check(arrays, got[name], tol))
    return worst
