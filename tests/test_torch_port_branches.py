"""The scrubber branches no shipped config uses, the port against the JAX
package on the CPU, f32 at the highest matmul precision (float64 where a
test says so):

- ``polynomial_indices``, ``poly_dim`` and ``polynomial_expand`` exactly
  and to 1e-6, and MALS at polynomial orders 2 and 3 (with and without the
  bias column) over three forward/loss/update rounds: predictions and loss
  to 1e-5 relative, forgetting factors to 1e-6, normal equations to 1e-5;
- the moving-average class-mean filter (``ma_init``, ``ma_loss``,
  ``ma_update``) over three rounds with a class absent from a batch: loss
  to 1e-5 relative, forgetting factors exactly, class means to 1e-6, and
  the step-1 gradient of the loss (all class means still 0, where a plain
  norm's gradient is nan) to 1e-5 relative;
- ``direct_lsq_loss`` with and without the bias column, value and gradient
  in float64 to 1e-10 relative;
- ``rotation_loss`` (the acos form), value and gradient in float64 to
  1e-10 relative;
- gradient reversal on the ids (cross-entropy of each head) with and
  without ``gr_legacy_norm``, through ``compute_batch_loss``, value and
  gradient to 1e-6 relative;
- ``init_scrub_state`` for MALS at order 2 and the moving average;
- three train steps of a method map that uses them all, against JAX's
  step, held as ``tests/test_torch_port_step.py`` holds the flagship's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_fit import ARENA, check_states, check_updates, run_steps, step_pair

from scrubvae_tpu import factory as jfactory
from scrubvae_tpu.models import scrubbers as jscr
from scrubvae_tpu.ops import losses as jlosses
from scrubvae_tpu.train.losses import compute_batch_loss as jax_batch_loss
from scrubvae_torch import factory
from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.ops import losses as tlosses
from scrubvae_torch.train import parity
from scrubvae_torch.train.losses import compute_batch_loss

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _highest_precision():
    jax.config.update("jax_default_matmul_precision", "highest")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# ---------------------------------------------------------------------------
# polynomial expansion and MALS above order 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nx,order", [(3, 1), (3, 2), (4, 3), (16, 2)])
def test_polynomial_indices_and_width(nx, order):
    want = jscr.polynomial_indices(nx, order)
    got = scr.polynomial_indices(nx, order)
    assert len(got) == len(want) == order - 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert scr.poly_dim(nx, order) == jscr.poly_dim(nx, order)
    x = np.random.default_rng(nx).standard_normal((5, nx)).astype(np.float32)
    out = scr.polynomial_expand(torch.from_numpy(x), order)
    assert out.shape == (5, scr.poly_dim(nx, order))
    np.testing.assert_allclose(out.numpy(), np.asarray(jscr.polynomial_expand(jnp.asarray(x), order)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("order,bias", [(2, False), (2, True), (3, True)])
def test_mals_above_order_one(order, bias):
    nx, ny, B = 4, 3, 32
    rng = np.random.default_rng(order)
    jst = jscr.mals_init(nx, ny, bias=bias, polynomial_order=order, l2_reg=1e-3)
    tst = scr.mals_init(nx, ny, bias=bias, polynomial_order=order, l2_reg=1e-3)
    assert tst.Sxx0.shape == jst.Sxx0.shape == (jscr.poly_dim(nx, order) + bias,) * 2
    for _ in range(3):
        x = rng.standard_normal((B, nx)).astype(np.float32)
        y = (x[:, :ny] ** 2 + 0.1 * rng.standard_normal((B, ny))).astype(np.float32)
        jy0, jy1 = jscr.mals_forward(jst, jnp.asarray(x))
        ty0, ty1 = scr.mals_forward(tst, torch.from_numpy(x))
        assert _rel(ty0, jy0) <= 1e-5 and _rel(ty1, jy1) <= 1e-5
        jl, jst = jscr.mals_loss(jst, jy0, jy1, jnp.asarray(y))
        tl, tst = scr.mals_loss(tst, ty0, ty1, torch.from_numpy(y))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        jst = jscr.mals_update(jst, jnp.asarray(x), jnp.asarray(y))
        tst = scr.mals_update(tst, torch.from_numpy(x), torch.from_numpy(y))
        for k in ("lam0", "lam1"):
            np.testing.assert_allclose(float(getattr(tst, k)), float(getattr(jst, k)), rtol=1e-6)
        for k in ("Sxx0", "Sxy0", "Sxx1", "Sxy1"):
            assert _rel(getattr(tst, k), getattr(jst, k)) <= 1e-5, k


# ---------------------------------------------------------------------------
# the moving-average class-mean filter
# ---------------------------------------------------------------------------


def test_moving_average_filter():
    nx, B = 5, 24
    classes = np.asarray([0, 3, 4])
    rng = np.random.default_rng(0)
    jst, tst = jscr.ma_init(nx, classes), scr.ma_init(nx, classes)
    for step in range(3):
        x = (rng.standard_normal((B, nx)) + 0.5).astype(np.float32)
        # class 4 is absent from the second batch
        y = rng.choice(classes[:2] if step == 1 else classes, (B, 1)).astype(np.int32)
        if step == 0:
            jg = jax.grad(lambda v: jscr.ma_loss(jst, v, jnp.asarray(y))[0])(jnp.asarray(x))
            xt = torch.from_numpy(x).requires_grad_(True)
            (tg,) = torch.autograd.grad(scr.ma_loss(tst, xt, torch.from_numpy(y))[0], xt)
            assert np.isfinite(tg.numpy()).all() and _rel(tg, jg) <= 1e-5
        jl, jst = jscr.ma_loss(jst, jnp.asarray(x), jnp.asarray(y))
        tl, tst = scr.ma_loss(tst, torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
        jst = jscr.ma_update(jst, jnp.asarray(x), jnp.asarray(y))
        tst = scr.ma_update(tst, torch.from_numpy(x), torch.from_numpy(y))
        for k in ("lam1", "lam2"):
            np.testing.assert_array_equal(getattr(tst, k).numpy(), np.asarray(getattr(jst, k)), err_msg=k)
        for k in ("m1", "m2"):
            np.testing.assert_allclose(getattr(tst, k).numpy(), np.asarray(getattr(jst, k)), rtol=0, atol=1e-6, err_msg=k)


def test_init_scrub_state_matches_jax():
    dis = {"method": {"moving_avg_lsq": ["avg_speed_3d"], "moving_avg": ["ids"]}, "polynomial": 2}
    classes = {"ids": np.asarray([0, 3, 4])}
    fdims = factory.feat_dims({}, classes)
    loss = {"avg_speed_3d_mals": -0.1}
    jscrub, _ = jfactory.init_scrub_state(jax.random.PRNGKey(0), dis, loss, 16, fdims, classes)
    scrub = factory.init_scrub_state(dis, loss, 16, fdims, "cpu", discrete_classes=classes)
    assert scrub.keys() == jscrub.keys() == {"moving_avg_lsq", "moving_avg"}
    jm, m = jscrub["moving_avg_lsq"]["avg_speed_3d"], scrub["moving_avg_lsq"]["avg_speed_3d"]
    assert (m.polynomial_order, m.bias) == (jm.polynomial_order, jm.bias) == (2, True)
    assert m.Sxx0.shape == jm.Sxx0.shape == (16 + 136 + 1,) * 2
    ja, a = jscrub["moving_avg"]["ids"], scrub["moving_avg"]["ids"]
    for k in ("classes", "m1", "m2", "lam1", "lam2"):
        np.testing.assert_array_equal(getattr(a, k).numpy(), np.asarray(getattr(ja, k)), err_msg=k)


# ---------------------------------------------------------------------------
# direct least squares, the acos rotation loss, gradient reversal on ids
# ---------------------------------------------------------------------------


def _grads64(port_fn, jax_fn, arrays, wrt):
    t = {k: torch.from_numpy(v).double().requires_grad_(k in wrt) for k, v in arrays.items()}
    value = port_fn(t)
    port = torch.autograd.grad(value, [t[k] for k in wrt])
    with jax.enable_x64(True):
        ja = {k: jnp.asarray(v, jnp.float64) for k, v in arrays.items()}

        def f(*xs):
            return jax_fn({**ja, **dict(zip(wrt, xs))})

        jvalue, ref = jax.value_and_grad(f, argnums=tuple(range(len(wrt))))(*[ja[k] for k in wrt])
        ref = [np.asarray(r) for r in ref]
        jvalue = float(jvalue)
    return float(value), jvalue, port, ref


@pytest.mark.parametrize("bias", [False, True])
def test_direct_lsq_loss(bias):
    rng = np.random.default_rng(1)
    arrays = {"z": rng.standard_normal((64, 16)), "y": rng.standard_normal((64, 2))}
    value, jvalue, port, ref = _grads64(
        lambda a: tlosses.direct_lsq_loss(a["z"], a["y"], bias=bias),
        lambda a: jlosses.direct_lsq_loss(a["z"], a["y"], bias=bias),
        arrays, ("z", "y"),
    )
    assert abs(value - jvalue) <= 1e-10 * abs(jvalue)
    for p, r in zip(port, ref):
        assert _rel(p, r) <= 1e-10
    f32 = tlosses.direct_lsq_loss(*(torch.from_numpy(v).float() for v in arrays.values()), bias=bias)
    assert abs(float(f32) - jvalue) <= 1e-4 * abs(jvalue)


def test_rotation_loss():
    rng = np.random.default_rng(2)
    arrays = {"x": rng.standard_normal((4, 5, 18, 6)), "x_hat": rng.standard_normal((4, 5, 18, 6))}
    value, jvalue, port, ref = _grads64(
        lambda a: tlosses.rotation_loss(a["x"], a["x_hat"]),
        lambda a: jlosses.rotation_loss(a["x"], a["x_hat"]),
        arrays, ("x", "x_hat"),
    )
    assert abs(value - jvalue) <= 1e-10 * abs(jvalue)
    for p, r in zip(port, ref):
        assert _rel(p, r) <= 1e-10


@pytest.mark.parametrize("legacy", [False, True])
def test_gradient_reversal_on_ids(legacy):
    """Each head's summed cross-entropy against the ids, normalised once by
    heads x features x batch, or (``gr_legacy_norm``) with the running sum
    divided after every head."""
    rng = np.random.default_rng(3)
    B, C = 16, 3
    heads = [rng.standard_normal((B, C)).astype(np.float32) for _ in range(4)]
    ids = rng.integers(0, C, (B, 1)).astype(np.int32)
    dis = {"method": {"grad_reversal": ["ids"]}, "gr_legacy_norm": legacy}

    def jloss(hs):
        data = {"x6d": jnp.zeros((B, 1)), "ids": jnp.asarray(ids)}
        out = {"mu": jnp.zeros((B, 1)), "disentangle": {"grad_reversal": {"ids": list(hs)}}}
        bl, _ = jax_batch_loss(None, data, out, {}, dis, None, {})
        return bl["ids_gr"]

    jvalue, jgrads = jax.value_and_grad(jloss)([jnp.asarray(h) for h in heads])
    th = [torch.from_numpy(h).requires_grad_(True) for h in heads]
    data = {"x6d": torch.zeros(B, 1), "ids": torch.from_numpy(ids)}
    out = {"mu": torch.zeros(B, 1), "disentangle": {"grad_reversal": {"ids": th}}}
    bl, _ = compute_batch_loss(data, out, {}, dis, None, {})
    tgrads = torch.autograd.grad(bl["ids_gr"], th)
    assert abs(float(bl["ids_gr"]) - float(jvalue)) <= 1e-6 * abs(float(jvalue))
    for t, j in zip(tgrads, jgrads):
        assert _rel(t, j) <= 1e-6
    # the legacy normalisation weights the heads unequally
    norms = [float(g.norm()) for g in tgrads]
    assert (norms[0] < 1e-3 * norms[-1]) == legacy


# ---------------------------------------------------------------------------
# three train steps of a method map with every branch
# ---------------------------------------------------------------------------

STEPS, B, Z = 3, 32, 16


def branches_config(out_path) -> dict:
    """The bench's ``--small`` rcnn (channels 8-8-16-16-32, z 16, window 51)
    at batch 32, f32, lr 1e-4, no clip, with MALS at polynomial 2 on
    avg_speed_3d, direct least squares on heading (a negative weight: the
    bias column), gradient reversal on the ids under ``gr_legacy_norm`` and
    the moving-average class means of the ids, decoding conditional on
    avg_speed_3d and heading. Batch 32, not 16: the least-squares system of
    16 latents and the bias column needs more rows than columns."""
    return {
        "data": {"batch_size": B, "dataset": "synthetic", "direction_process": "midfwd", "arena_size": ARENA.tolist()},
        "disentangle": {
            "method": {
                "conditional": ["avg_speed_3d", "heading"],
                "moving_avg_lsq": ["avg_speed_3d"],
                "direct_lsq": ["heading"],
                "grad_reversal": ["ids"],
                "moving_avg": ["ids"],
            },
            "features": ["avg_speed_3d", "heading"], "alpha": 1.0, "polynomial": 2, "gr_legacy_norm": True,
        },
        "model": {
            "type": "rcnn", "z_dim": Z, "window": 51, "diag": False, "channel": [8, 8, 16, 16, 32],
            "kernel": 5, "prior": "gaussian", "activation": "prelu", "precision": "fp32",
        },
        "train": {
            "lr": 1e-4, "optimizer": "adamw", "lr_schedule": "cawr", "num_epochs": 1, "seed": 0,
            "clip_norm": 0, "fused_optimizer": True, "param_dtype": "f32", "minimal_test": True,
        },
        "loss": {
            "rotation": 1.0, "prior": 0.001, "root": 0.01, "jpe": 1.0,
            "avg_speed_3d_mals": 0.1, "heading_lsq": -0.1, "ids_gr": 1.0, "ids_ma": 0.1,
        },
        "out_path": str(out_path),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = branches_config(tmp_path_factory.mktemp("branches_steps"))
    jt, trainer = step_pair(cfg, n_frames=1200)
    st = trainer.state.scrub_state
    assert st.keys() == {"moving_avg_lsq", "moving_avg"}
    # mu's 16 columns and their 136 products, no bias (a positive weight)
    assert st["moving_avg_lsq"]["avg_speed_3d"].Sxx0.shape == (16 + 136,) * 2
    rows = np.random.default_rng(0).integers(0, len(trainer.train_ds), (STEPS, B))
    return run_steps(jt, trainer, rows)


@pytest.mark.parametrize("step", range(STEPS))
def test_losses_per_step(runs, step):
    ref, port = runs
    assert {"avg_speed_3d_mals", "heading_lsq", "ids_gr", "ids_ma"} <= set(port["losses"][step])
    parity.check_losses(ref["losses"][step], port["losses"][step], 1e-4 if step == 0 else 1e-2)


def test_step1_gradients_and_weights(runs):
    """The step-1 bounds of ``parity``, the weights given both runs'
    gradients: under ``gr_legacy_norm`` the first gradient-reversal heads'
    losses are divided by heads x batch (128) up to four times, so their
    gradients (down to about 1e-9) are no longer large beside Adam's eps of
    1e-8, and their step-1 update follows the gradient's value, f32
    rounding included, not only its sign (read without that allowance: a
    weight of ``mlp2_0`` 4.1e-10 apart)."""
    ref, port = runs
    readings = parity.check_grads(ref["grads"], port["grads"])
    readings.update(parity.check_weights(ref["w1"], port["w1"], ref["grads"], got_grads=port["grads"]))
    print("branches step 1, port against JAX:", readings)


def test_updates_and_states_after_three_steps(runs):
    ref, port = runs
    readings = check_updates(ref, port)
    readings["states_step1"] = check_states(ref, port, 1, 1e-4)
    readings["states_step3"] = check_states(ref, port, STEPS, 1e-2)
    print("branches after three steps, port against JAX:", readings)
