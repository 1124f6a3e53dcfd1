"""The MLP VAE, the port against the JAX package, f32 at the highest matmul
precision:

- the forward from carried weights in training mode with JAX's own sample
  noise injected, and in eval mode with ``mu_only``, with one-hot discrete
  and continuous conditionals: atol 1e-5 (1e-5 of the arena's size on the
  root), the dense and the diagonal Cholesky head;
- the carried weights under the JAX package's names (``enc_{i}``,
  ``fc_mu``, ``fc_sigma``, ``dec_{i}``, ``dec_out``);
- three train steps of ``configs/ladder/1_vanilla_mlp.yaml``'s model
  against JAX's, with the flagship's scrubbers, held as
  ``tests/test_torch_port_step.py`` holds the flagship's, the rows of
  ``dec_out`` at the rotation loss's clip (from JAX's float64 forward)
  excused in the step-1 weights; a planted sign error in the update is
  caught;
- ``configs/ladder/1_vanilla_mlp.yaml`` through both packages' ``train``
  from pose files on disk, one epoch of one step (``tests/_port_fit.py``):
  the same ``metrics.csv`` columns, every column within ``band`` of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from _port_fit import (
    ARENA, ROOT, check_bands, check_states, check_updates, flat, read_csv, run_both, run_steps, step_pair,
    write_pose_files,
)

from scrubvae_tpu import factory as jfactory
from scrubvae_torch import factory
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.models.mlp_vae import MLPVAE
from scrubvae_torch.train import parity
from scrubvae_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

Z, W, B = 8, 51, 8
DIS = {
    "method": {"conditional": ["avg_speed_3d", "heading", "ids"], "linear": ["avg_speed_3d"]},
    "features": ["avg_speed_3d", "heading"],
}
CLASSES = {"ids": np.asarray([0, 3, 4])}


def _batch(rng, n=B):
    return {
        "x6d": rng.standard_normal((n, W, 18, 6)).astype(np.float32),
        "root": (rng.standard_normal((n, W, 3)) * 50).astype(np.float32),
        "avg_speed_3d": rng.standard_normal((n, 3)).astype(np.float32),
        "heading": rng.standard_normal((n, 2)).astype(np.float32),
        "ids": rng.integers(0, 3, (n, 1)).astype(np.int32),
    }


def _pair(diag):
    jax.config.update("jax_default_matmul_precision", "highest")
    model_cfg = {"type": "mlp", "z_dim": Z, "window": W, "hidden": [32, 16], "diag": diag}
    jmodel, _ = jfactory.build_model(model_cfg, DIS, 18, "midfwd", arena_size=ARENA, discrete_classes=CLASSES)
    model, _ = factory.build_model(model_cfg, DIS, 18, "midfwd", arena_size=ARENA, discrete_classes=CLASSES, device="cpu")
    data = _batch(np.random.default_rng(0))
    variables = jmodel.init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in data.items()}, rng=jax.random.PRNGKey(1), train=True
    )
    model.load_state_dict(from_jax_variables(flat(variables)), strict=True)
    return jmodel, variables, model, data


def _check(got, want, keys):
    for k in keys:
        atol = 1e-5 * (580.0 if k == "root" else 1.0)
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("diag", [False, True])
def test_forward_train_with_jax_noise(diag):
    """z = mu + L eps with the eps JAX draws from its rng; the decoded pose,
    root and conditionals (ids one-hot over its 3 classes) agree."""
    jmodel, variables, model, data = _pair(diag)
    rng = jax.random.PRNGKey(7)
    want = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in data.items()}, rng=rng, train=True)
    eps = np.asarray(jax.random.normal(rng, (B, Z)))
    model.train()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()}, eps=torch.from_numpy(eps))
    _check(got, want, ("mu", "L", "z", "x6d", "root", "var"))
    assert got["var"].shape == (B, 3 + 2 + 3)
    L = got["L"]
    assert torch.equal(L, torch.tril(L)) and bool((torch.diagonal(L, dim1=-2, dim2=-1) > 0).all())
    if diag:
        assert torch.equal(L, torch.diag_embed(torch.diagonal(L, dim1=-2, dim2=-1)))


def test_forward_eval_mu_only():
    jmodel, variables, model, data = _pair(False)
    want = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in data.items()}, train=False, mu_only=True)
    model.eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()}, mu_only=True)
    assert "L" not in got and "L" not in want
    _check(got, want, ("mu", "z", "x6d", "root", "var"))


def test_carried_weights_keep_the_jax_names():
    _, variables, model, _ = _pair(False)
    sd = from_jax_variables(flat(variables))
    vae = {k for k in model.state_dict() if k.startswith("vae.")}
    assert vae == {f"vae.{m}.{p}" for m in ("enc_0", "enc_1", "fc_mu", "fc_sigma", "dec_0", "dec_1", "dec_out") for p in ("weight", "bias")}
    for m in ("enc_0", "fc_sigma", "dec_out"):
        np.testing.assert_array_equal(sd[f"vae.{m}.weight"].numpy(), np.asarray(variables["params"]["vae"][m]["kernel"]).T)
    assert sd["vae.enc_0.weight"].shape == (32, W * 111)
    assert sd["vae.fc_sigma.weight"].shape == (Z * (Z + 1) // 2, 16)


def test_diag_default_follows_the_jax_reader():
    """``bool(get("diag", True))``: absent, the diagonal head; None (the
    config reader's fill), the dense one."""
    for cfg, diag in (({}, True), ({"diag": None}, False), ({"diag": True}, True)):
        mc = {"type": "mlp", "z_dim": Z, "window": W, "hidden": [32, 16], **cfg}
        model, _ = factory.build_model(mc, DIS, 18, "midfwd", arena_size=ARENA, discrete_classes=CLASSES, device="cpu")
        jmodel, _ = jfactory.build_model(mc, DIS, 18, "midfwd", arena_size=ARENA, discrete_classes=CLASSES)
        assert isinstance(model.vae, MLPVAE) and model.vae.is_diag == jmodel.vae.is_diag == diag
        assert model.vae.hidden == tuple(jmodel.vae.hidden) == (32, 16)


# ---------------------------------------------------------------------------
# three train steps against JAX
# ---------------------------------------------------------------------------

STEPS, STEP_B = 3, 16


def _vanilla() -> dict:
    with open(ROOT / "configs" / "ladder" / "1_vanilla_mlp.yaml") as f:
        return yaml.safe_load(f)


def jax_rotations_float64(jt, idx: np.ndarray, eps: np.ndarray) -> dict:
    """The 6D rotations of JAX's step-1 forward in float64 (``{"x6d":
    target, "x6d_hat": decoded}``, numpy): ``jt``'s model in training mode
    on the window rows ``idx``, every floating array in double and the
    sample noise ``eps`` in place of the model's draw. Taken before ``jt``
    steps."""
    from unittest import mock

    kw = jt._step_kwargs
    with jax.enable_x64(True):
        def f64(a):
            a = jnp.asarray(a)
            return a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a

        data = jax.tree.map(f64, kw["batch_fn"](jnp.asarray(idx, jnp.int32)))
        noise = jnp.asarray(eps, jnp.float64)
        variables = {"params": jax.tree.map(f64, jt.state.params)}
        mutable = False
        if jt.state.batch_stats is not None:
            variables["batch_stats"] = jax.tree.map(f64, jt.state.batch_stats)
            mutable = ["batch_stats"]

        def normal(key, shape, dtype=None):
            assert tuple(shape) == noise.shape, shape
            return noise

        with mock.patch.object(jax.random, "normal", normal):
            out = jt.model.apply(variables, data, rng=jax.random.PRNGKey(0), train=True, mutable=mutable)
        if mutable:
            out = out[0]
        return {"x6d": np.asarray(data["x6d"]), "x6d_hat": np.asarray(out["x6d"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """1_vanilla_mlp's model (z 16, hidden 256-128, its diagonal head) with
    the flagship's scrubbers on avg_speed_3d, batch 16, lr 1e-4, f32, and
    f32 moments: its two 1.45 M-element kernels would otherwise keep bf16
    moments, whose rounding the gradients read back from the first moment
    would carry."""
    cfg = _vanilla()
    cfg["data"].update(batch_size=STEP_B, arena_size=ARENA.tolist())
    cfg["disentangle"] = {
        "method": {
            "conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"],
            "moving_avg_lsq": ["avg_speed_3d"], "grad_reversal": ["avg_speed_3d"],
        },
        "features": ["avg_speed_3d", "heading"], "alpha": 1.0, "polynomial": 1,
    }
    cfg["train"].update(lr=1e-4, num_epochs=1, clip_norm=0, param_dtype="f32", moment_dtype="f32", minimal_test=True)
    cfg["loss"].update(jpe=1.0, avg_speed_3d_mals=0.1, avg_speed_3d_lin=1.0, avg_speed_3d_gr=1.0)
    cfg["out_path"] = str(tmp_path_factory.mktemp("mlp_steps"))
    jt, trainer = step_pair(cfg)
    assert isinstance(trainer.model.vae, MLPVAE) and trainer.model.vae.hidden == (256, 128)
    rows = np.random.default_rng(0).integers(0, len(trainer.train_ds), (STEPS, STEP_B))
    # step 1's sample noise, as run_steps draws it
    eps = np.array(jax.random.normal(jax.random.split(jt.state.rng, 5)[1], (STEP_B, trainer.info["z_dim"])))
    rotations64 = jax_rotations_float64(jt, rows[0], eps)
    ref, port = run_steps(jt, trainer, rows)
    ref["rotations64"] = rotations64
    return ref, port


@pytest.mark.parametrize("step", range(STEPS))
def test_losses_per_step(runs, step):
    ref, port = runs
    parity.check_losses(ref["losses"][step], port["losses"][step], 1e-4 if step == 0 else 1e-2)


# f32 spacings (2^-24) below 1 within which a rotation's chordal sine counts
# as at the rotation loss's clip; the f32 sine of the port's forward on this
# batch was read 3.2 spacings from float64 at most, near 1
CLIP_SPACINGS = 16


def clip_unsure(ref) -> dict:
    """The rows of ``dec_out`` (weight and bias) of every rotation whose
    chordal sine, in JAX's float64 forward of step 1, lies within
    ``CLIP_SPACINGS`` f32 spacings of the clip of ``stable_rotation_loss``
    (1 - 1e-7). There the asin's slope (about 2236) enters an f32 run's
    gradient or not, by which side of the clip that run's rounding puts
    the sine: that sample's term in the row's gradient is there on one
    side and 0 on the other, so the row's elements may take either sign.
    Taken from float64 alone, so neither f32 run can mark its own
    elements."""
    from scrubvae_tpu.ops.rotation import rotation_6d_to_matrix

    with jax.enable_x64(True):
        rot = ref["rotations64"]
        d = rotation_6d_to_matrix(jnp.asarray(rot["x6d_hat"])) - rotation_6d_to_matrix(jnp.asarray(rot["x6d"]))
        sin = np.asarray(jnp.sqrt(jnp.sum(d * d, axis=(-1, -2)) + 1e-14) / 2.0**1.5)
    near = np.abs(sin - (1.0 - 1e-7)) < CLIP_SPACINGS * 2.0**-24
    _, W, J = near.shape
    rows = np.zeros((W, J * 6 + 3), bool)
    rows[:, : J * 6] = np.repeat(near.any(0), 6, axis=1)
    rows = torch.from_numpy(rows.reshape(-1))
    w = ref["w1"]["vae.dec_out.weight"]
    assert w.shape[0] == rows.numel()
    return {"vae.dec_out.weight": rows[:, None].expand_as(w), "vae.dec_out.bias": rows}


def test_step1_gradients_and_weights(runs):
    """The step-1 bounds of ``parity``, with the rows of ``dec_out`` that a
    rotation at the rotation loss's clip feeds (``clip_unsure``) added to
    the weights' noise band and left out of the flips' count: there an
    f32 run's gradient departs from float64 by up to the row's own size
    (read on this batch: a row of the port's 1.04 of its norm away, of
    JAX's 0.65), where the noise band relative to the leaf's RMS alone
    does not reach."""
    ref, port = runs
    readings = parity.check_grads(ref["grads"], port["grads"])
    unsure = clip_unsure(ref)
    readings.update(parity.check_weights(ref["w1"], port["w1"], ref["grads"], unsure=unsure))
    readings["clip_rows"] = int(unsure["vae.dec_out.bias"].sum())
    print("mlp step 1, port against JAX:", readings)


@pytest.mark.parametrize("where", ["noise_band", "leaf"])
def test_step1_weights_catch_a_sign_error(runs, where):
    """A planted fault: the port's step-1 update of ``enc_0``'s kernel with
    its sign reversed, in the noise band of the reference gradient only
    (each element alone is excused, their number is not) or in the whole
    leaf. The check of ``test_step1_gradients_and_weights`` raises."""
    ref, port = runs
    n = "vae.enc_0.weight"
    g = ref["grads"][n]
    mask = g.abs() < 5e-2 * torch.sqrt(torch.mean(g * g)) if where == "noise_band" else torch.ones_like(g, dtype=bool)
    faulty = dict(port["w1"])
    faulty[n] = torch.where(mask, 2 * port["w0"][n] - port["w1"][n], port["w1"][n])
    match = "weights differ after step 1" if where == "noise_band" else "outside the noise band"
    with pytest.raises(AssertionError, match=match):
        parity.check_weights(ref["w1"], faulty, ref["grads"], unsure=clip_unsure(ref))


def test_updates_and_mals_after_three_steps(runs):
    ref, port = runs
    readings = check_updates(ref, port)
    readings["mals_step1"] = check_states(ref, port, 1, 1e-4)
    readings["mals_step3"] = check_states(ref, port, STEPS, 1e-2)
    print("mlp after three steps, port against JAX:", readings)


# ---------------------------------------------------------------------------
# configs/ladder/1_vanilla_mlp.yaml through both packages' train
# ---------------------------------------------------------------------------

def band(epoch: int, column: str) -> float:
    """The relative gap allowed between the port's and JAX's value of a
    ``metrics.csv`` column: the prior is computed from mu and L alone (same
    weights and batch), so 1e-4 (read 1.4e-7); the other terms, which the
    sample noise moves, 0.08 (read 2.8e-2 on the root). A second step would
    start from weights that one step at lr 1e-3 moved with different noise
    (its prior read 20% apart)."""
    return 1e-4 if column.startswith("prior") else 0.08


@pytest.fixture(scope="module")
def fit_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit_mlp")
    # one step: 25 train windows at batch 16
    data = write_pose_files(root / "data", synthetic_pose_stream, (("train", 0, 100, 1), ("val", 1, 120, 1)))
    cfg = _vanilla()
    cfg["data"].update(data_path=str(data) + "/", batch_size=16)
    cfg["train"].update(num_epochs=1, minimal_test=True, scan_epoch=False)
    return run_both(root, cfg)


def test_vanilla_mlp_metrics_csv(fit_runs):
    paths, trainer = fit_runs
    jcols, jrows = read_csv(paths["jax"] / "metrics.csv")
    cols, rows = read_csv(paths["port"] / "metrics.csv")
    assert cols == jcols and {"rotation_train", "prior_train", "root_train", "total_train"} <= set(cols)
    assert [r["epoch"] for r in rows] == ["1"]
    assert isinstance(trainer.model.vae, MLPVAE) and trainer.model.vae.is_diag
    assert trainer.steps_per_epoch == 1 and trainer.state.opt_state.step == 1
    check_bands(paths, band)
