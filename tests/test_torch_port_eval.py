"""The validation path, the port against the JAX package: the eval step,
generative restrictiveness and ``Trainer.test_epoch``, at the bench's
``--small`` widths (channels 8-8-16-16-32, z 16, window 51, batch 16, f32).

Both sides hold the same weights (carried with ``from_jax_variables``),
BatchNorm running statistics and MALS state, made non-trivial from a numpy
seed so that eval mode and the MALS loss are exercised. The val split has
two full batches and a tail. Restrictiveness draws one random number a
sample; the port takes JAX's own draws (``jax.random.uniform`` for the
heading, ``jax.random.normal`` for the speed jitter, from the key JAX
splits for that batch and factor).

Tolerances: the loss terms 1e-4 relative and mu 1e-5 absolute (one f32
forward in eval mode; the step-1 loss bound of
``scrubvae_torch.train.parity``); restrictiveness pred 1e-4 absolute (the
decoder, FK over 18 joints, a normalisation); the R^2 values 1e-4
relative, absolute below 1 (at random weights the speed R^2 is far below
-1).
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
from scrubvae_tpu.evals.restrictiveness import generative_restrictiveness_batch as jax_gr_batch
from scrubvae_tpu.train.step import make_eval_step as jax_make_eval_step
from scrubvae_tpu.train.trainer import Trainer as JaxTrainer
from scrubvae_torch import factory
from scrubvae_torch.data.dataset import StreamDataset
from scrubvae_torch.data.pipeline import build_frame_store
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.evals.restrictiveness import generative_restrictiveness_batch
from scrubvae_torch.train import parity
from scrubvae_torch.train.step import make_eval_step
from scrubvae_torch.train.trainer import Trainer
from scrubvae_torch.utils.weights import from_jax_variables, mals_state_from_numpy

torch.set_num_threads(1)

B, Z = 16, 16
KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids")
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)
GR_KEYS = ("avg_speed_3d", "heading")
LOSS = {
    "rotation": 1.0, "prior": 0.001, "root": 0.01, "jpe": 1.0,
    "avg_speed_3d_mals": 0.1, "avg_speed_3d_lin": 1.0, "avg_speed_3d_gr": 1.0,
}


def config(out_path, loss=LOSS) -> dict:
    return {
        "data": {
            "batch_size": B, "dataset": "synthetic", "direction_process": "midfwd",
            "arena_size": ARENA.tolist(),
        },
        "disentangle": {
            "method": {
                "conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"],
                "moving_avg_lsq": ["avg_speed_3d"], "grad_reversal": ["avg_speed_3d"],
            },
            "features": ["avg_speed_3d", "heading"], "alpha": 1.0,
        },
        "model": {
            "type": "rcnn", "z_dim": Z, "window": 51, "channel": [8, 8, 16, 16, 32], "kernel": 5,
            "prior": "gaussian", "activation": "prelu", "precision": "fp32",
        },
        "train": {
            "lr": 1e-4, "optimizer": "adamw", "lr_schedule": "cawr", "num_epochs": 1, "seed": 0,
            "clip_norm": 0, "param_dtype": "f32", "minimal_test": True, "scan_epoch": False,
        },
        "loss": dict(loss),
        "out_path": str(out_path),
    }


def flat(tree) -> dict:
    return {k: np.array(v, copy=True) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def datasets(seed: int, n_frames: int, n_ids: int):
    """The same stream as a JAX and a port StreamDataset."""
    jskel = jax_load_skeleton("configs/mouse_skeleton.yaml")
    skel = load_skeleton("configs/mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=n_frames, n_ids=n_ids, seed=seed)
    classes = {"ids": np.unique(ids)}
    jds = JaxStreamDataset(
        jax_build_frame_store(pose, ids, jskel, window=51, stride=2), jskel, KEYS, "midfwd",
        arena_size=ARENA, discrete_classes=classes,
    )
    tds = StreamDataset(
        build_frame_store(pose, ids, skel, window=51, stride=2, device="cpu"), skel, KEYS,
        "midfwd", arena_size=ARENA, discrete_classes=classes, device="cpu",
    )
    return jds, tds


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg = config(tmp_path_factory.mktemp("eval"))
    jtrain, ttrain = datasets(0, 400, 2)
    jval, tval = datasets(1, 200, 2)
    assert len(jval) % B and len(jval) // B >= 2
    jmodel, jinfo = jfactory.build_model(
        cfg["model"], cfg["disentangle"], n_keypts=18, direction_process="midfwd",
        arena_size=ARENA, discrete_classes=jtrain.discrete_classes, loss_keys=cfg["loss"].keys(),
    )
    jt = JaxTrainer(cfg, {"train": jtrain, "val": jval}, jmodel, jinfo)
    # running statistics and a MALS state away from their initial values
    rng = np.random.default_rng(0)
    bs = jax.tree.map(
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, x.shape) if np.all(np.asarray(x) == 1)
                              else rng.normal(0.0, 0.2, x.shape), jnp.float32),
        jt.state.batch_stats,
    )
    mals = jt.state.scrub_state["moving_avg_lsq"]["avg_speed_3d"]
    a = rng.normal(size=(Z, Z)).astype(np.float32)
    mals_np = {
        "Sxx0": np.eye(Z, dtype=np.float32) * 4 + a @ a.T, "Sxy0": rng.normal(size=(Z, 3)).astype(np.float32),
        "Sxx1": np.eye(Z, dtype=np.float32) * 5 + a.T @ a, "Sxy1": rng.normal(size=(Z, 3)).astype(np.float32),
        "lam0": np.float32(0.9), "lam1": np.float32(1.0),
    }
    jt.state = jt.state.replace(
        batch_stats=bs,
        scrub_state={"moving_avg_lsq": {"avg_speed_3d": mals.replace(**{k: jnp.asarray(v) for k, v in mals_np.items()})}},
    )
    weights = from_jax_variables(flat({"params": jt.state.params, "batch_stats": jt.state.batch_stats}))

    model, info = factory.build_model(
        cfg["model"], cfg["disentangle"], 18, "midfwd", arena_size=ARENA,
        discrete_classes=ttrain.discrete_classes, loss_keys=cfg["loss"].keys(), device="cpu",
    )
    tt = Trainer(cfg, {"train": ttrain, "val": tval}, model, info, device="cpu")
    tt.model.load_state_dict(weights, strict=True)
    st = tt.state.scrub_state["moving_avg_lsq"]
    st["avg_speed_3d"] = mals_state_from_numpy(mals_np, st["avg_speed_3d"])
    idx = np.arange(B)
    return types.SimpleNamespace(
        cfg=cfg, jt=jt, tt=tt, jval=jval, tval=tval, jinfo=jinfo, idx=idx,
        jdata=jval.batch(jnp.asarray(idx)), tdata=tval.batch(torch.as_tensor(idx)),
    )


def _jax_eval_step(setup, loss):
    if loss is LOSS:
        return setup.jt.eval_step
    return jax_make_eval_step(
        setup.jt.model, setup.jval.kinematic_tree, disentangle_config=setup.cfg["disentangle"],
        loss_keys=tuple(loss), disentangle_keys=tuple(setup.jinfo["disentangle_keys"]),
        conditional_keys=tuple(setup.jinfo["conditional_keys"]), feat_slices=setup.jt.feat_slices,
        static_loss_scale=dict(loss), batch_fn=setup.jval.batch,
    )


@pytest.mark.parametrize("with_prior", [True, False])
def test_eval_step(setup, with_prior):
    """Every loss term and mu against JAX's eval step; the Cholesky head
    (``fc_sigma``) runs only when the prior is a loss."""
    loss = LOSS if with_prior else {k: v for k, v in LOSS.items() if k != "prior"}
    scale = {k: jnp.asarray(v, jnp.float32) for k, v in loss.items()}
    want, jmu = _jax_eval_step(setup, loss)(setup.jt.state, jnp.asarray(setup.idx), scale)
    tt = setup.tt
    step = make_eval_step(
        tt.model, tt.val_ds.kinematic_tree, disentangle_config=setup.cfg["disentangle"],
        loss_keys=tuple(loss), batch_fn=tt.val_ds.batch,
    )
    calls = []
    hook = tt.model.vae.encoder.fc_sigma.register_forward_hook(lambda *a: calls.append(1))
    try:
        got, mu = step(tt.state, torch.as_tensor(setup.idx), dict(loss))
    finally:
        hook.remove()
    assert len(calls) == (1 if with_prior else 0)
    assert set(got) == set(want)
    worst = parity.check_losses({k: float(v) for k, v in want.items()}, {k: float(v) for k, v in got.items()}, 1e-4)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=1e-5, rtol=0)
    print(f"eval step, prior={with_prior}: loss terms max rel {worst:.3e}, "
          f"mu max abs {np.abs(mu.numpy() - np.asarray(jmu)).max():.3e}")
    assert not tt.model.training


@pytest.mark.parametrize("key", GR_KEYS)
def test_generative_restrictiveness(setup, key):
    jt, tt = setup.jt, setup.tt
    variables = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    _, jmu = jt.eval_step(jt.state, jnp.asarray(setup.idx), jt.loss_scale_for_epoch(1))
    sub = jax.random.PRNGKey(7)
    draw = (jax.random.uniform if key == "heading" else jax.random.normal)(sub, (B, 1))
    want_pred, want_target = jax_gr_batch(
        jt.model, variables, jmu, setup.jdata, key, setup.jval.kinematic_tree, sub,
        norm_params=setup.jval.norm_params,
    )
    _, mu = tt.eval_step(tt.state, torch.as_tensor(setup.idx), tt.loss_scale_for_epoch(1))
    pred, target = generative_restrictiveness_batch(
        tt.model, mu, setup.tdata, key, tt.val_ds.kinematic_tree,
        norm_params=tt.val_ds.norm_params, draw=torch.from_numpy(np.array(draw)),
    )
    np.testing.assert_allclose(target.numpy(), np.asarray(want_target), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), atol=1e-4, rtol=0)
    print(f"restrictiveness {key}: pred max abs {np.abs(pred.numpy() - np.asarray(want_pred)).max():.3e}")


def jax_draws(n: int, epoch: int) -> dict:
    """The draws JAX's test_epoch makes: PRNGKey(1000 + epoch), split once a
    batch per factor, in factor order, full batches then the tail."""
    rng = jax.random.PRNGKey(1000 + epoch)
    out = {k: [] for k in GR_KEYS}
    for lo in range(0, n, B):
        nb = min(B, n - lo)
        for key in GR_KEYS:
            rng, sub = jax.random.split(rng)
            d = (jax.random.uniform if key == "heading" else jax.random.normal)(sub, (nb, 1))
            out[key].append(torch.from_numpy(np.array(d)))
    return out


def test_test_epoch(setup):
    """The whole val split (two full batches and a tail): every ``*_test``
    metric and both ``r2_gen_restrict_*``."""
    want, jz = setup.jt.test_epoch(5)
    got, z = setup.tt.test_epoch(5, draws=jax_draws(len(setup.tval), 5))
    assert set(got) == set(want)
    r2 = [k for k in want if k.startswith("r2_gen_restrict_")]
    assert sorted(r2) == ["r2_gen_restrict_avg_speed_3d", "r2_gen_restrict_heading"]
    worst = parity.check_losses({k: want[k] for k in want if k not in r2}, {k: got[k] for k in got if k not in r2}, 1e-4)
    for k in r2:
        assert abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])), (k, got[k], want[k])
    assert z.shape == jz.shape == (len(setup.tval), Z)
    np.testing.assert_allclose(z, jz, atol=1e-5, rtol=0)
    print(f"test_epoch: loss terms max rel {worst:.3e}; " + ", ".join(f"{k} {got[k]:.6f} vs {want[k]:.6f}" for k in r2))
