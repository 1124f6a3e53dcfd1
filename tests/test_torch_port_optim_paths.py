"""The optimizers other than the fused kernel, and the recursive least
squares, the port against the JAX package.

- ``train.optimizer: sgd`` (optax's ``sgd(lr, momentum=0.2,
  nesterov=True)``) and ``train.fused_optimizer: false`` with adam and
  adamw (``scale_by_adam_lowp``, ``add_decayed_weights(0.01)``,
  ``scale_by_learning_rate``), each under the global-norm clip and the cawr
  schedule, over 3 steps of fixed gradients against JAX's
  ``make_optimizer``: a 76,800-element leaf (bf16 moments under the
  65,536-element rule) and two small ones. sgd holds bitwise. The moments
  hold bitwise, f32 and bf16 alike, the bf16 stores with JAX's rounding
  bits injected. The weights hold to two f32 spacings plus ``lr * 1e-6``:
  XLA's vectorized f32 division on the CPU is not correctly rounded (on the
  large leaf about one update in seven is an ulp off; its scalar loop on
  the small leaves is bitwise). One small leaf's gradients are of the order
  of Adam's eps, so that eps inside the square root would show.
- the stochastic rounding alone, bitwise against JAX's on negative values,
  values at bf16's largest finite and beyond; a planted round to nearest,
  and JAX's bits given to the wrong moment, fail the bitwise checks.
- a resume of each new optimizer state, bit for bit: the moments or the
  trace, the counts and the rounding bits' generator.
- ``rls_init``, ``rls_forward`` and ``rls_update`` over three batches.
- ``train.mesh`` with one device visible: accepted, as in JAX.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scrubvae_tpu.models import scrubbers as jscr
from scrubvae_tpu.train import optim as jopt
from scrubvae_torch import bench, factory
from scrubvae_torch.data.dataset import StreamDataset
from scrubvae_torch.data.pipeline import build_frame_store
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.train import optim as topt
from scrubvae_torch.train.trainer import Trainer
from scrubvae_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {"a": (256, 300), "b": (16,), "c": (8, 5)}  # sorted: JAX's leaf order
KEYS = sorted(SHAPES)
# leaf c's gradients are of the order of Adam's eps, so where eps enters
# the update shows
GRAD_SCALE = {"a": 1e-2, "b": 1e-2, "c": 1e-8}
LR = 1e-3
STEPS = 3


def _lowp_state(state):
    return next(
        x for x in jax.tree.leaves(state, is_leaf=lambda x: isinstance(x, jopt.ScaleByAdamLowpState))
        if isinstance(x, jopt.ScaleByAdamLowpState)
    )


def jax_rounding_bits(state) -> list:
    """The bits of JAX's next update, per leaf: (mu bits, nu bits) for a
    leaf with bf16 moments, else None (``scale_by_adam_lowp``'s key
    split)."""
    st = _lowp_state(state)
    _, sub = jax.random.split(st.key)
    keys = jax.random.split(sub, 2 * len(KEYS))
    out = []
    for i, k in enumerate(KEYS):
        if st.mu[k].dtype != jnp.bfloat16:
            out.append(None)
            continue
        draw = [jax.random.randint(keys[j], SHAPES[k], 0, jnp.uint32(1 << 16), dtype=jnp.uint32) for j in (i, len(KEYS) + i)]
        out.append(tuple(torch.from_numpy(np.asarray(d).astype(np.int64)) for d in draw))
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


CASES = {
    "sgd": {"optimizer": "sgd"},
    "adam_f32": {"optimizer": "adam", "fused_optimizer": False, "moment_dtype": "f32"},
    "adamw_f32": {"optimizer": "adamw", "fused_optimizer": False, "moment_dtype": "f32"},
    "adam_bf16": {"optimizer": "adam", "fused_optimizer": False},
    "adamw_bf16": {"optimizer": "adamw", "fused_optimizer": False},
}


def three_steps(case: str, swap_bits: bool = False) -> None:
    """3 steps of each side; ``swap_bits`` plants a fault: each bf16 leaf
    rounds its first moment with the second's bits and the other way
    round."""
    cfg = {"lr": LR, "lr_schedule": "cawr", **CASES[case]}
    jtx, ttx = jopt.make_optimizer(cfg, 4), topt.make_optimizer(cfg, 4)
    assert isinstance(ttx, topt.SGD if case == "sgd" else topt.AdamLowp)
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jtx.init(jp)
    tp = [torch.from_numpy(p0[k].copy()) for k in KEYS]
    ts = ttx.init(tp)
    for step in range(STEPS):
        g = {k: rng.normal(size=s).astype(np.float32) * GRAD_SCALE[k] for k, s in SHAPES.items()}
        kw = {}
        if case != "sgd":
            bits = jax_rounding_bits(js)
            kw["noise"] = [b[::-1] if swap_bits and b is not None else b for b in bits]
        u, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        ts = ttx.update_and_apply([torch.from_numpy(g[k]) for k in KEYS], ts, tp, **kw)
        assert int(ts.count) == step + 1
        for i, k in enumerate(KEYS):
            want, got = np.asarray(jp[k]), tp[i].numpy()
            if case == "sgd":
                np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=f"step {step} {k}")
                np.testing.assert_array_equal(
                    _bits(ts.trace[i].numpy()), _bits(np.asarray(js[1][0].trace[k])), err_msg=f"trace {k}"
                )
                continue
            st = _lowp_state(js)
            for name, j, t in (("mu", st.mu[k], ts.mu[i]), ("nu", st.nu[k], ts.nu[i])):
                assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16 else torch.float32), (k, t.dtype, j.dtype)
                np.testing.assert_array_equal(
                    _bits(t.float().numpy()), _bits(np.asarray(j.astype(jnp.float32))), err_msg=f"step {step} {name} {k}"
                )
            np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=LR * 1e-6, err_msg=f"step {step} {k}")
    if case.endswith("bf16"):
        assert ts.mu[KEYS.index("a")].dtype == torch.bfloat16 and ts.mu[KEYS.index("b")].dtype == torch.float32


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_against_jax(case):
    three_steps(case)


def test_swapped_rounding_bits_fail_the_bitwise_check():
    with pytest.raises(AssertionError, match="mu a"):
        three_steps("adam_bf16", swap_bits=True)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(1)
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    for max_norm in (1e6, 10.0):
        want, _ = optax.clip_by_global_norm(max_norm).update({k: jnp.asarray(v) for k, v in g.items()}, None)
        got = topt._clip_by_global_norm([torch.from_numpy(g[k]) for k in KEYS], max_norm)
        for i, k in enumerate(KEYS):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=k)


def _round_inputs() -> np.ndarray:
    rng = np.random.default_rng(2)
    bf16_max = float(torch.finfo(torch.bfloat16).max)
    x = np.concatenate([
        rng.normal(size=4000).astype(np.float32) * 10.0 ** rng.integers(-30, 30, 4000),
        np.float32([-0.0, 0.0, 1e-40, -1e-40, bf16_max, -bf16_max, 3.4e38, -3.4e38, np.float32(3.4028235e38)]),
    ]).astype(np.float32)
    return np.concatenate([x, -x])


def test_stochastic_rounding_matches_jax_bitwise():
    x = _round_inputs()
    bits = jax.random.randint(jax.random.PRNGKey(5), x.shape, 0, jnp.uint32(1 << 16), dtype=jnp.uint32)
    want = np.asarray(jopt._stochastic_round_bf16(jnp.asarray(x), jax.random.PRNGKey(5)))
    got = topt.stochastic_round_bf16(torch.from_numpy(x), torch.from_numpy(np.asarray(bits).astype(np.int64)))
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    assert np.isinf(want.astype(np.float32)).any(), "no value rounded past bf16's largest finite"


def test_round_to_nearest_fails_the_bitwise_check():
    """A planted rounding that drops the bits (round to nearest) differs
    from JAX's stochastic rounding."""
    x = _round_inputs()
    want = np.asarray(jopt._stochastic_round_bf16(jnp.asarray(x), jax.random.PRNGKey(5)))
    planted = torch.from_numpy(x).to(torch.bfloat16)
    with pytest.raises(AssertionError):
        np.testing.assert_array_equal(planted.view(torch.int16).numpy(), want.view(np.int16))


# ---------------------------------------------------------------------------
# a resume of each new optimizer state
# ---------------------------------------------------------------------------


def _trainer(train: dict) -> Trainer:
    """A tiny flagship at z 16 with a last channel of 128, so fc_sigma
    (512 x 136) keeps bf16 moments under the unfused Adam, on the CPU."""
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=600, n_ids=2, seed=0)
    store = build_frame_store(pose, ids, skel, window=51, stride=2, device="cpu")
    ds = StreamDataset(store, skel, bench.KEYS, "midfwd", arena_size=bench.ARENA,
                       discrete_classes={"ids": np.unique(ids)}, device="cpu")
    cfg = bench.bench_config(8, 51, 16, (8, 8, 16, 16, 128), False, precision="fp32")
    cfg["train"].update(train, clip_norm=None)
    model, info = factory.build_model(cfg["model"], cfg["disentangle"], 18, "midfwd", arena_size=bench.ARENA,
                                      discrete_classes=ds.discrete_classes, loss_keys=cfg["loss"].keys(), device="cpu")
    return Trainer(cfg, {"train": ds}, model, info, device="cpu")


def _snapshot(trainer) -> dict:
    # copies: on the CPU, the checkpoint's .cpu() aliases the live tensors
    opt = ckpt._opt_tensors(trainer.state.opt_state)
    return {
        "params": [p.detach().clone() for p in trainer.model.parameters()],
        "opt": {k: [t.clone() for t in v] if isinstance(v, list) else torch.as_tensor(v).clone() for k, v in opt.items()},
        "generator": trainer.state.generator.get_state().clone(),
    }


def _same(a: dict, b: dict) -> None:
    for x, y in zip(a["params"], b["params"]):
        assert torch.equal(x, y)
    assert a["opt"].keys() == b["opt"].keys()
    for k, v in a["opt"].items():
        w = b["opt"][k]
        if isinstance(v, list):
            assert all(torch.equal(x, y) for x, y in zip(v, w)), k
        else:
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(w)), k
    assert torch.equal(a["generator"], b["generator"])


@pytest.mark.parametrize("case", ["sgd", "adam_bf16"])
def test_resume_bit_for_bit(case, tmp_path):
    train = CASES[case]
    t = _trainer(train)
    rows = np.random.default_rng(3).integers(0, len(t.train_ds), (3, 8))
    t.train_epoch(1, rows[:2])
    ckpt.save_train_state(str(tmp_path), 20, t.model, t.state, t.np_rng)
    saved = _snapshot(t)
    t.train_epoch(1, rows[2:])
    after = _snapshot(t)
    if case == "adam_bf16":
        assert "generator" in saved["opt"] and t.state.opt_state.mu[0].dtype in (torch.float32, torch.bfloat16)
        assert any(m.dtype == torch.bfloat16 for m in t.state.opt_state.mu)

    r = _trainer(train)
    r.state = ckpt.load_train_state(str(tmp_path), 20, r.model, r.state, r.np_rng)
    _same(_snapshot(r), saved)
    r.train_epoch(1, rows[2:])
    _same(_snapshot(r), after)


# ---------------------------------------------------------------------------
# recursive least squares
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias,order", [(False, 1), (True, 1), (True, 2)])
def test_rls_against_jax(bias, order):
    nx, ny, B = 4, 3, 12
    rng = np.random.default_rng(order + 2 * bias)
    jst = jscr.rls_init(nx, ny, bias=bias, polynomial_order=order)
    tst = scr.rls_init(nx, ny, bias=bias, polynomial_order=order)
    for k in ("theta", "P", "lam"):
        np.testing.assert_array_equal(getattr(tst, k).numpy(), np.asarray(getattr(jst, k)), err_msg=k)
    for _ in range(3):
        x = rng.standard_normal((B, nx)).astype(np.float32)
        y = (x[:, :ny] * 2.0 + 0.1 * rng.standard_normal((B, ny))).astype(np.float32)
        np.testing.assert_allclose(
            scr.rls_forward(tst, torch.from_numpy(x)).numpy(), np.asarray(jscr.rls_forward(jst, jnp.asarray(x))),
            rtol=1e-4, atol=1e-5,
        )
        jst = jscr.rls_update(jst, jnp.asarray(x), jnp.asarray(y))
        tst = scr.rls_update(tst, torch.from_numpy(x), torch.from_numpy(y))
        for k in ("theta", "P"):
            np.testing.assert_allclose(getattr(tst, k).numpy(), np.asarray(getattr(jst, k)), rtol=1e-4, atol=1e-5, err_msg=k)


def test_mesh_on_one_device_is_accepted():
    """``train.mesh`` with one device visible trains on it, as the JAX
    trainer does when ``jax.device_count()`` is 1."""
    t = _trainer({"mesh": {"data": -1}})
    rows = np.random.default_rng(4).integers(0, len(t.train_ds), (1, 8))
    assert np.isfinite(t.train_epoch(1, rows)["total"])
