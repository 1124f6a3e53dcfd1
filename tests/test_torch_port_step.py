"""The slice as a whole: three train steps of the port's ``Trainer`` against
three of the JAX ``Trainer.train_step``, on the bench's configuration at its
``--small`` widths (channels 8-8-16-16-32, z 16, window 51, batch 16, f32).

Both start from the same weights (carried with ``from_jax_variables``), the
same MALS state, the same window index rows and JAX's own sample noise,
``jax.random.normal(split(state.rng, 5)[1], mu.shape)``. No leaf reaches
65536 elements, so no stochastic rounding happens.

Step 1 is held to ``scrubvae_torch.train.parity``, whose docstring gives the
bounds and why: the rotation loss's f32 rounding sets them. Three witnesses
show that the gap they allow is rounding and hides no fault:

- each loss term alone (the same jitted JAX step with the other weights at
  0): every leaf of more than one element within 1e-4 relative, except for
  the rotation and jpe terms, whose f32 rounding is larger;
- the rotation, jpe and prior losses in float64 on both sides
  (``jax.enable_x64``, torch double): gradients within 1e-10 relative;
- each term's step-1 gradient, and the whole loss's, in float64 through the
  port's model, as the reference for the JAX package's f32 gradient: within
  1e-4 per leaf for the terms other than rotation and jpe, within the
  bounds of ``parity.check_grads`` for those two and the whole loss. The
  JAX package casts its heads and its data to f32, so it has no float64
  step of its own.

After step 1 the two weight sets drift apart at the 1e-3 level, hence:
losses rtol 1e-2 at steps 2 and 3; updates after three steps by relative
norm per leaf <= 0.25, median over leaves <= 0.1, size-1 leaves left out
(their three +-lr steps can cancel to nearly 0); MALS state 1e-2 after
step 3.
"""

import types

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
from scrubvae_tpu.ops import losses as jax_losses
from scrubvae_tpu.train.trainer import Trainer as JaxTrainer
from scrubvae_torch import factory
from scrubvae_torch.data.dataset import StreamDataset
from scrubvae_torch.data.pipeline import build_frame_store
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.models.scrubbers import MALSState
from scrubvae_torch.ops import losses as port_losses
from scrubvae_torch.train import parity
from scrubvae_torch.train.losses import compute_batch_loss
from scrubvae_torch.train.trainer import Trainer
from scrubvae_torch.utils.weights import from_jax_variables, mals_state_from_numpy

torch.set_num_threads(1)

B, Z, STEPS = 16, 16, 3
KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids")
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)
MALS_KEYS = parity.MALS_KEYS
TERMS = ("rotation", "prior", "root", "jpe", "avg_speed_3d_mals", "avg_speed_3d_lin", "avg_speed_3d_gr")
ROUNDING_TERMS = ("rotation", "jpe")


def bench_config(out_path) -> dict:
    """bench.py's build() configuration at its --small widths."""
    return {
        "data": {
            "batch_size": B, "dataset": "synthetic", "direction_process": "midfwd",
            "arena_size": ARENA.tolist(),
        },
        "disentangle": {
            "method": {
                "conditional": ["avg_speed_3d", "heading"],
                "linear": ["avg_speed_3d"],
                "moving_avg_lsq": ["avg_speed_3d"],
                "grad_reversal": ["avg_speed_3d"],
            },
            "features": ["avg_speed_3d", "heading"], "alpha": 1.0, "balance_loss": None,
            "bandwidth": 1.0, "polynomial": 1, "var_mode": "sphere", "l2_reg": 0.0, "n_iter": 2,
        },
        "model": {
            "type": "rcnn", "z_dim": Z, "window": 51, "diag": False,
            "channel": [8, 8, 16, 16, 32], "kernel": 5, "start_epoch": 0, "load_model": None,
            "prior": "gaussian", "activation": "prelu", "init_dilation": None,
            "sigma_head_rank": None, "precision": "fp32",
        },
        "train": {
            "lr": 1e-4, "optimizer": "adamw", "lr_schedule": "cawr", "num_epochs": 1, "seed": 0,
            "mesh": None, "donate": True, "clip_norm": 0, "fused_optimizer": True,
            "param_dtype": "f32",
        },
        "loss": {
            "rotation": 1.0, "prior": 0.001, "root": 0.01, "jpe": 1.0,
            "avg_speed_3d_mals": 0.1, "avg_speed_3d_lin": 1.0, "avg_speed_3d_gr": 1.0,
        },
        "out_path": str(out_path),
    }


def flat(tree) -> dict:
    """A flax tree as '/'-joined numpy copies (the JAX step donates its state)."""
    return {k: np.array(v, copy=True) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _port_trainer(cfg, ds, weights, mals):
    model, info = factory.build_model(
        cfg["model"], cfg["disentangle"], 18, "midfwd", arena_size=ARENA,
        discrete_classes=ds.discrete_classes, loss_keys=cfg["loss"].keys(), device="cpu",
    )
    trainer = Trainer(cfg, {"train": ds}, model, info, device="cpu")
    trainer.model.load_state_dict(weights, strict=True)
    st = trainer.state.scrub_state["moving_avg_lsq"]
    st["avg_speed_3d"] = mals_state_from_numpy(mals, st["avg_speed_3d"])
    return trainer


def _port_run(trainer, rows, noises) -> dict:
    names = [n for n, _ in trainer.model.named_parameters()]
    w0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    loss_scale = trainer.loss_scale_for_epoch(1)
    run = {"losses": []}
    for s in range(STEPS):
        trainer.state, metrics = trainer.train_step(
            trainer.state, torch.as_tensor(rows[s]), loss_scale, eps=torch.from_numpy(noises[s])
        )
        run["losses"].append({k: float(v) for k, v in metrics.items()})
        if s == 0:
            b1 = trainer.tx.b1
            run["grads"] = {n: m / (1.0 - b1) for n, m in zip(names, trainer.state.opt_state.mu)}
            run["w1"] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        if s in (0, STEPS - 1):
            mals = trainer.state.scrub_state["moving_avg_lsq"]["avg_speed_3d"]
            run[f"mals{s + 1}"] = {k: getattr(mals, k).clone() for k in MALS_KEYS}
    run["dw3"] = {n: p.detach() - w0[n] for n, p in trainer.model.named_parameters()}
    return run


def _jax_grads(jt, state) -> dict:
    """Step-1 gradients from the first moment (m = (1 - b1) g)."""
    mu = flat({"params": state.opt_state.mu})
    return from_jax_variables({k: v / (1.0 - jt.tx.b1) for k, v in mu.items()})


def _jax_run(jt, rows) -> tuple:
    """Three JAX steps; returns (run, the sample noise of each step)."""
    p0 = flat({"params": jt.state.params})
    loss_scale = jt.loss_scale_for_epoch(1)
    run, noises = {"losses": []}, []
    for s in range(STEPS):
        noises.append(np.array(jax.random.normal(jax.random.split(jt.state.rng, 5)[1], (B, Z))))
        jt.state, metrics = jt.train_step(jt.state, jnp.asarray(rows[s], jnp.int32), loss_scale)
        run["losses"].append({k: float(v) for k, v in metrics.items()})
        if s == 0:
            run["grads"] = _jax_grads(jt, jt.state)
            run["w1"] = from_jax_variables(flat({"params": jt.state.params}))
        if s in (0, STEPS - 1):
            mals = jt.state.scrub_state["moving_avg_lsq"]["avg_speed_3d"]
            run[f"mals{s + 1}"] = {k: torch.from_numpy(np.array(getattr(mals, k))) for k in MALS_KEYS}
    p3 = flat({"params": jt.state.params})
    run["dw3"] = from_jax_variables({k: p3[k] - p0[k] for k in p3})
    return run, noises


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX trainer, a copy of its initial state, the port's dataset and
    what carries the JAX weights and MALS state across."""
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg = bench_config(tmp_path_factory.mktemp("jax_trainer"))
    skel = load_skeleton("configs/mouse_skeleton.yaml")
    jskel = jax_load_skeleton("configs/mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=800, n_ids=4, seed=0)
    classes = {"ids": np.unique(ids)}
    jds = JaxStreamDataset(
        jax_build_frame_store(pose, ids, jskel, window=51, stride=2), jskel, KEYS, "midfwd",
        arena_size=ARENA, discrete_classes=classes,
    )
    tds = StreamDataset(
        build_frame_store(pose, ids, skel, window=51, stride=2, device="cpu"), skel, KEYS,
        "midfwd", arena_size=ARENA, discrete_classes=classes, device="cpu",
    )
    jmodel, jinfo = jfactory.build_model(
        cfg["model"], cfg["disentangle"], n_keypts=18, direction_process="midfwd",
        arena_size=ARENA, discrete_classes=jds.discrete_classes, loss_keys=cfg["loss"].keys(),
    )
    jt = JaxTrainer(cfg, {"train": jds}, jmodel, jinfo)
    jmals = jt.state.scrub_state["moving_avg_lsq"]["avg_speed_3d"]
    return types.SimpleNamespace(
        cfg=cfg, jt=jt, jds=jds, tds=tds,
        state0=jax.tree.map(lambda x: jnp.array(x, copy=True), jt.state),
        weights=from_jax_variables(flat({"params": jt.state.params, "batch_stats": jt.state.batch_stats})),
        mals={k: np.array(getattr(jmals, k)) for k in MALS_KEYS},
        rows=np.random.default_rng(0).integers(0, len(jds), (STEPS, B)),
    )


@pytest.fixture(scope="module")
def runs(setup):
    ref, noises = _jax_run(setup.jt, setup.rows)
    port = _port_run(_port_trainer(setup.cfg, setup.tds, setup.weights, setup.mals), setup.rows, noises)
    return ref, port


def _port_term_grads(setup, eps, scale: dict, dtype) -> dict:
    """The port's step-1 gradient of ``sum scale[k] * loss[k]`` with the model,
    the batch, the noise and the MALS state in ``dtype``."""
    trainer = _port_trainer(setup.cfg, setup.tds, setup.weights, setup.mals)
    model = trainer.model.to(dtype).train()
    data = {
        k: v.to(dtype) if v.is_floating_point() else v
        for k, v in setup.tds.batch(torch.as_tensor(setup.rows[0])).items()
    }
    scrub = {
        m: {
            k: st.replace(**{f: getattr(st, f).to(dtype) for f in MALS_KEYS}) if isinstance(st, MALSState) else st
            for k, st in states.items()
        }
        for m, states in trainer.state.scrub_state.items()
    }
    out = model(data, eps=torch.from_numpy(eps).to(dtype))
    bl, _ = compute_batch_loss(data, out, scale, setup.cfg["disentangle"], setup.tds.kinematic_tree, scrub)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(bl["total"], list(params.values()), allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).detach() for (n, p), g in zip(params.items(), grads)}


@pytest.fixture(scope="module")
def per_term(setup):
    """For each loss term alone and for the whole loss: the JAX f32 step-1
    gradient (the module's jitted step, loss weights of the other terms at
    0) and the port's in f32 and in float64."""
    jt, s0 = setup.jt, setup.state0
    eps = np.array(jax.random.normal(jax.random.split(s0.rng, 5)[1], (B, Z)))
    full = jt.loss_scale_for_epoch(1)
    out = {}
    for term in TERMS + ("total",):
        state = jax.tree.map(lambda x: jnp.array(x, copy=True), s0)
        state, _ = jt.train_step(
            state, jnp.asarray(setup.rows[0], jnp.int32),
            {k: v if term in (k, "total") else jnp.zeros_like(v) for k, v in full.items()},
        )
        scale = {k: float(v) if term in (k, "total") else 0.0 for k, v in full.items()}
        out[term] = {
            "jax32": _jax_grads(jt, state),
            "port32": _port_term_grads(setup, eps, scale, torch.float32),
            "port64": _port_term_grads(setup, eps, scale, torch.float64),
        }
    return out


@pytest.mark.parametrize("step", range(STEPS))
def test_losses_per_step(runs, step):
    ref, port = runs
    parity.check_losses(ref["losses"][step], port["losses"][step], 1e-4 if step == 0 else 1e-2)


def test_step1_gradients_per_leaf(runs):
    ref, port = runs
    readings = parity.check_grads(ref["grads"], port["grads"])
    assert readings["zero_grad_leaves"] == 24


def test_step1_weights_per_element(runs):
    ref, port = runs
    parity.check_weights(ref["w1"], port["w1"], ref["grads"])


def test_updates_after_three_steps(runs):
    ref, port = runs
    zero = parity.zero_grad_leaves(ref["dw3"])
    rels = {
        n: parity.rel(port["dw3"][n], w)
        for n, w in ref["dw3"].items()
        if n not in zero and w.numel() > 1
    }
    bad = {n: r for n, r in rels.items() if r > 0.25}
    assert not bad, bad
    assert np.median(list(rels.values())) <= 0.1


@pytest.mark.parametrize("after,tol", [(1, 1e-4), (STEPS, 1e-2)])
def test_mals_state(runs, after, tol):
    ref, port = runs
    parity.check_mals(ref[f"mals{after}"], port[f"mals{after}"], tol)


@pytest.mark.parametrize("term", [t for t in TERMS if t not in ROUNDING_TERMS])
def test_step1_gradients_per_term(per_term, term):
    """One loss term alone, the port against JAX, both in f32: every leaf of
    more than one element within 1e-4 relative (a size-1 leaf, a PReLU
    slope, is one sum over a whole activation whose terms cancel: 0.25 and
    the same sign). The MALS loss has a gradient of exactly 0 at step 1 on
    both sides."""
    want, got = per_term[term]["jax32"], per_term[term]["port32"]
    if term == "avg_speed_3d_mals":
        assert all(float(w.abs().max()) == 0.0 for w in want.values())
        assert all(float(g.abs().max()) == 0.0 for g in got.values())
        return
    readings = parity.check_grads(want, got, leaf_tol=1e-4, median_tol=1e-4)
    print(f"{term}: port f32 vs JAX f32, per leaf: {readings}")


@pytest.mark.parametrize("term", [t for t in TERMS if t != "avg_speed_3d_mals"] + ["total"])
def test_step1_gradients_float64(per_term, term):
    """The port's float64 gradient as the reference for both f32 gradients,
    the JAX package's and the port's. For a term other than rotation and
    jpe, every leaf of more than one element within 1e-4 relative of it.
    For rotation, jpe and the whole loss, each f32 gradient within the
    bounds of ``parity.check_grads`` of it: JAX's own f32 rounding needs
    those bounds."""
    g = per_term[term]
    want = g["port64"]
    readings = {}
    for side in ("jax32", "port32"):
        got = {n: v.double() for n, v in g[side].items()}
        if term in ROUNDING_TERMS + ("total",):
            readings[side] = parity.check_grads(want, got)
        else:
            readings[side] = parity.check_grads(want, got, leaf_tol=1e-4, median_tol=1e-4)
    gscale = max(float(v.norm()) for v in want.values())
    gap = [
        parity.rel(g["port32"][n], g["jax32"][n])
        for n, v in want.items()
        if n not in parity.zero_grad_leaves(want) and float(v.norm()) >= 1e-6 * gscale
    ]
    print(
        f"{term}: f32 from the port's float64, per leaf: {readings}; "
        f"port f32 vs JAX f32: median {np.median(gap):.3e}"
    )


def _loss_inputs(setup):
    """The step-1 batch and the port's f32 forward on it (numpy)."""
    trainer = _port_trainer(setup.cfg, setup.tds, setup.weights, setup.mals)
    data = setup.tds.batch(torch.as_tensor(setup.rows[0]))
    eps = np.array(jax.random.normal(jax.random.split(setup.state0.rng, 5)[1], (B, Z)))
    with torch.no_grad():
        out = trainer.model.train()(data, eps=torch.from_numpy(eps))
    arrays = {k: data[k].numpy() for k in ("x6d", "target_pose", "offsets")}
    arrays.update(x6d_hat=out["x6d"].numpy(), mu=out["mu"].numpy(), Lp=out["Lp"].numpy())
    return arrays


LOSSES = {
    # name: (inputs differentiated, port loss, JAX loss), each taking (arrays, tree)
    "rotation": (
        ("x6d_hat",),
        lambda a, tree: port_losses.stable_rotation_loss(a["x6d"], a["x6d_hat"]),
        lambda a, tree: jax_losses.stable_rotation_loss(a["x6d"], a["x6d_hat"]),
    ),
    "jpe": (
        ("x6d_hat",),
        lambda a, tree: port_losses.mpjpe_loss(a["target_pose"], a["x6d_hat"], tree, a["offsets"]),
        lambda a, tree: jax_losses.mpjpe_loss(a["target_pose"], a["x6d_hat"], tree, a["offsets"]),
    ),
    "prior": (
        ("mu", "Lp"),
        lambda a, tree: port_losses.prior_loss_packed(a["mu"], a["Lp"]),
        lambda a, tree: jax_losses.prior_loss_packed(a["mu"], a["Lp"]),
    ),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_gradients_float64(setup, name):
    """On the step-1 inputs, the loss's gradient in float64 on both sides
    agrees to 1e-10 relative: the f32 gaps above are rounding."""
    wrt, port_fn, jax_fn = LOSSES[name]
    arrays = _loss_inputs(setup)
    t = {k: torch.from_numpy(v).double().requires_grad_(k in wrt) for k, v in arrays.items()}
    port = torch.autograd.grad(port_fn(t, setup.tds.kinematic_tree), [t[k] for k in wrt])
    with jax.enable_x64(True):
        ja = {k: jnp.asarray(v, jnp.float64) for k, v in arrays.items()}

        def f(*xs):
            return jax_fn({**ja, **dict(zip(wrt, xs))}, setup.jds.kinematic_tree)

        ref = jax.grad(f, argnums=tuple(range(len(wrt))))(*[ja[k] for k in wrt])
        assert all(r.dtype == jnp.float64 for r in ref)
    for k, p, r in zip(wrt, port, ref):
        d = parity.rel(p, torch.from_numpy(np.asarray(r)))
        print(f"{name}: d/d{k} float64, port vs JAX {d:.3e}")
        assert d <= 1e-10, (k, d)
