"""The transformer VAE, the port against the JAX package, at z 16, window
16, 2 heads, ``ff_size`` 32 and 2 layers, f32 at the highest matmul
precision:

- ``sinusoidal_positions`` exactly;
- the forward in eval mode from the same (carried) weights: atol 1e-5 on
  mu, L and x6d, and 1e-5 of the arena's size on the root;
- the carried weights key by key against ``export_transformer_state_dict``
  (the reference layout), plus ``cond_proj``, which the exporter leaves
  out;
- three train steps against JAX's with dropout off on both sides (the JAX
  side through a flax subclass defined here, with the same encoder and
  decoder at ``dropout=0.0``), held as ``tests/test_torch_port_step.py``
  holds the flagship's;
- the port's dropout at its 0.1 rate: the kept share of each residual and
  positional mask, the 1/0.9 scaling of the kept entries, one attention
  mask for the whole batch and every head, masks drawn from the generator
  alone, and no dropout in eval mode.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _port_fit import ARENA, check_states, check_updates, flat, run_steps, step_pair

from scrubvae_tpu import factory as jfactory
from scrubvae_tpu.models import transformer as jtr
from scrubvae_tpu.utils.torch_export import export_transformer_state_dict
from scrubvae_torch import factory
from scrubvae_torch.models import transformer as ttr
from scrubvae_torch.train import parity
from scrubvae_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

Z, W, B = 16, 16, 16
MODEL = {"type": "transformer", "z_dim": Z, "window": W, "n_heads": 2, "ff_size": 32, "n_layers": 2, "diag": False}
DIS = {
    "method": {
        "conditional": ["avg_speed_3d", "heading", "ids"],
        "linear": ["avg_speed_3d"],
        "moving_avg_lsq": ["avg_speed_3d"],
        "grad_reversal": ["avg_speed_3d"],
    },
    "features": ["avg_speed_3d", "heading"], "alpha": 1.0, "polynomial": 1, "n_iter": 2,
}
CLASSES = {"ids": np.arange(3)}


class NoDropoutTransformerVAE(jtr.TransformerVAE):
    """The JAX package's TransformerVAE with its encoder and decoder built
    at dropout 0 (the package's own sets no rate: 0.1 in training)."""

    def setup(self):
        kw = dict(
            z_dim=self.z_dim, window=self.window, activation=self.activation, n_heads=self.n_heads,
            ff_size=self.ff_size, n_layers=self.n_layers, dropout=0.0,
        )
        self.encoder = jtr.TransformerEncoder(is_diag=self.is_diag, **kw)
        self.decoder = jtr.TransformerDecoder(out_channels=self.in_channels, **kw)
        if self.conditional_dim > 0:
            self.cond_proj = fnn.Dense(self.z_dim, name="cond_proj")


def no_dropout_jax(vae):
    fields = (
        "in_channels", "z_dim", "window", "activation", "n_heads", "ff_size", "n_layers", "is_diag",
        "conditional_dim", "prior", "arena_size", "conditional_keys", "discrete_classes",
    )
    return NoDropoutTransformerVAE(**{f: getattr(vae, f) for f in fields})


def no_dropout_port(model):
    for m in model.modules():
        if isinstance(m, ttr._Dropping):
            m.dropout = 0.0


def _batch(rng, n=B):
    return {
        "x6d": rng.standard_normal((n, W, 18, 6)).astype(np.float32),
        "root": (rng.standard_normal((n, W, 3)) * 50).astype(np.float32),
        "avg_speed_3d": rng.standard_normal((n, 3)).astype(np.float32),
        "heading": rng.standard_normal((n, 2)).astype(np.float32),
        "ids": rng.integers(0, 3, (n, 1)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def pair():
    """The JAX model and variables, the port's model with them carried, a batch."""
    jax.config.update("jax_default_matmul_precision", "highest")
    jmodel, _ = jfactory.build_model(MODEL, DIS, 18, "midfwd", arena_size=ARENA, discrete_classes=CLASSES)
    model, _ = factory.build_model(MODEL, DIS, 18, "midfwd", arena_size=ARENA, discrete_classes=CLASSES, device="cpu")
    data = _batch(np.random.default_rng(0))
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jd, rng=jax.random.PRNGKey(2), train=True
    )
    model.load_state_dict(from_jax_variables(flat(variables)), strict=True)
    return jmodel, variables, model, data


@pytest.mark.parametrize("length,d", [(16, 16), (51, 128), (7, 6)])
def test_sinusoidal_positions(length, d):
    np.testing.assert_array_equal(ttr.sinusoidal_positions(length, d), jtr.sinusoidal_positions(length, d))


@pytest.mark.parametrize("mu_only", [False, True])
def test_forward_eval_mode_matches_jax(pair, mu_only):
    jmodel, variables, model, data = pair
    want = jmodel.apply(variables, {k: jnp.asarray(v) for k, v in data.items()}, train=False, mu_only=mu_only)
    model.eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in data.items()}, mu_only=mu_only)
    keys = ("mu", "z", "x6d", "root", "var") + (() if mu_only else ("L",))
    assert ("L" in got) != mu_only
    for k in keys:
        w = np.asarray(want[k])
        atol = 1e-5 * (580.0 if k == "root" else 1.0)
        np.testing.assert_allclose(got[k].numpy(), w, atol=atol, rtol=0, err_msg=k)
    for k in ("avg_speed_3d",):
        np.testing.assert_allclose(
            got["disentangle"]["linear"][k]["v"].numpy(), np.asarray(want["disentangle"]["linear"][k]["v"]),
            atol=1e-5, rtol=0,
        )


def test_carried_weights_match_the_reference_export(pair):
    """``from_jax_variables`` of the VAE's tree, key by key, equals the JAX
    package's reference-layout export under ``vae.``; ``cond_proj``, which
    the export leaves out, is the transposed dense kernel."""
    _, variables, model, _ = pair
    vae_tree = {"params": variables["params"]["vae"]}
    want, unexported = export_transformer_state_dict(vae_tree)
    assert unexported == ["params/cond_proj/bias", "params/cond_proj/kernel"]
    got = {k: v for k, v in from_jax_variables(flat(vae_tree)).items()}
    assert set(got) == {f"vae.{k}" for k in want} | {"vae.cond_proj.weight", "vae.cond_proj.bias"}
    for k, v in want.items():
        np.testing.assert_array_equal(got[f"vae.{k}"].numpy(), v, err_msg=k)
    kernel = np.asarray(variables["params"]["vae"]["cond_proj"]["kernel"])
    np.testing.assert_array_equal(got["vae.cond_proj.weight"].numpy(), kernel.T)
    sd = model.state_dict()
    assert {k for k in sd if k.startswith("vae.")} == set(got)
    assert sd["vae.encoder.transformer_encoder.layers.0.self_attn.in_proj_weight"].shape == (3 * Z, Z)


# ---------------------------------------------------------------------------
# three train steps against JAX, dropout off
# ---------------------------------------------------------------------------

STEPS = 3


def step_config(out_path) -> dict:
    """The flagship's method map and losses on the transformer at this
    file's widths, f32, lr 1e-4 (as the flagship's step test), no clip."""
    return {
        "data": {"batch_size": B, "dataset": "synthetic", "direction_process": "midfwd", "arena_size": ARENA.tolist()},
        "disentangle": {
            "method": {
                "conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"],
                "moving_avg_lsq": ["avg_speed_3d"], "grad_reversal": ["avg_speed_3d"],
            },
            "features": ["avg_speed_3d", "heading"], "alpha": 1.0, "polynomial": 1, "n_iter": 2,
        },
        "model": dict(MODEL),
        "train": {
            "lr": 1e-4, "optimizer": "adamw", "lr_schedule": "cawr", "num_epochs": 1, "seed": 0,
            "clip_norm": 0, "fused_optimizer": True, "param_dtype": "f32", "minimal_test": True,
        },
        "loss": {
            "rotation": 1.0, "prior": 0.001, "root": 0.01, "jpe": 1.0,
            "avg_speed_3d_mals": 0.1, "avg_speed_3d_lin": 1.0, "avg_speed_3d_gr": 1.0,
        },
        "out_path": str(out_path),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = step_config(tmp_path_factory.mktemp("transformer_steps"))
    jt, trainer = step_pair(cfg, jax_vae=no_dropout_jax, port_model=no_dropout_port)
    rows = np.random.default_rng(0).integers(0, len(trainer.train_ds), (STEPS, B))
    return run_steps(jt, trainer, rows)


@pytest.mark.parametrize("step", range(STEPS))
def test_losses_per_step(runs, step):
    ref, port = runs
    parity.check_losses(ref["losses"][step], port["losses"][step], 1e-4 if step == 0 else 1e-2)


def test_step1_gradients_and_weights(runs):
    ref, port = runs
    readings = parity.check_grads(ref["grads"], port["grads"])
    readings.update(parity.check_weights(ref["w1"], port["w1"], ref["grads"]))
    print("transformer step 1, port against JAX:", readings)


def test_updates_and_mals_after_three_steps(runs):
    ref, port = runs
    readings = check_updates(ref, port)
    readings["mals_step1"] = check_states(ref, port, 1, 1e-4)
    readings["mals_step3"] = check_states(ref, port, STEPS, 1e-2)
    print("transformer after three steps, port against JAX:", readings)


# ---------------------------------------------------------------------------
# dropout at its rate
# ---------------------------------------------------------------------------


class _Recorder:
    """Wraps the transformer module's dropout functions and keeps each
    call's input and output. A residual tail (``residual_norm``) must give,
    bit for bit, flax's LayerNorm of ``x`` plus its branch, written out
    here; with a mask it counts as a dropout of ``y`` whose output is the
    branch ``where(keep, y / (1 - rate), 0)``."""

    def __init__(self, mp):
        self.calls = {"dropout": [], "attention": []}
        for name, label in (("dropout", "dropout"), ("attention_dropout", "attention")):
            fn = getattr(ttr, name)

            def wrapped(x, rate, generator, fn=fn, label=label):
                out = fn(x, rate, generator)
                self.calls[label].append((x.detach().clone(), out.detach().clone(), rate))
                return out

            mp.setattr(ttr, name, wrapped)
        tail = ttr.residual_norm

        def wrapped_tail(x, y, keep, rate, weight, bias, eps):
            got = tail(x, y, keep, rate, weight, bias, eps)
            branch = y if keep is None else torch.where(keep, y / (1.0 - rate), torch.zeros(()))
            s = x + branch
            mean = s.mean(-1, keepdim=True)
            var = torch.clamp((s * s).mean(-1, keepdim=True) - mean * mean, min=0.0)
            assert torch.equal(got, (s - mean) * (torch.rsqrt(var + eps) * weight) + bias)
            if keep is not None:
                self.calls["dropout"].append((y.detach().clone(), branch.detach().clone(), rate))
            return got

        mp.setattr(ttr, "residual_norm", wrapped_tail)


def _train_forward(model, data, seed):
    model.train()
    with torch.no_grad():
        return model(data, eps=torch.zeros(len(data["x6d"]), Z), generator=torch.Generator().manual_seed(seed))


def test_dropout_masks_at_rate(pair):
    """Residual and positional masks keep 0.9 of the entries (of the
    nonzero ones, as sin(0) of the positions is 0; within 0.01 over these
    (64, 16, 16) tensors: 5 standard deviations) and scale the
    kept ones by exactly 1/0.9; each attention mask is one (q, kv) mask for
    all 64 batch entries and both heads; 2 layers a side give 2 positional,
    4 + 6 residual and 2 + 4 attention masks."""
    _, _, model, _ = pair
    data = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(1), 64).items()}
    assert all(m.dropout == 0.1 for m in model.modules() if isinstance(m, ttr._Dropping))
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)
        _train_forward(model, data, 0)
    assert (len(rec.calls["dropout"]), len(rec.calls["attention"])) == (12, 6)
    for x, out, rate in rec.calls["dropout"]:
        assert rate == 0.1 and x.shape == (64, W, Z)
        kept = out != 0
        assert abs(float(kept[x != 0].float().mean()) - 0.9) <= 0.01
        torch.testing.assert_close(out[kept], x[kept] / 0.9, rtol=0, atol=0)
    for x, out, rate in rec.calls["attention"]:
        assert rate == 0.1 and x.shape[:2] == (64, 2)
        kept = out != 0
        assert torch.equal(kept, kept[:1, :1].expand_as(kept))
        # a multiplier of 1/0.9 in f32: within one ulp of x / 0.9
        torch.testing.assert_close(out[kept], x[kept] / 0.9, rtol=1.2e-7, atol=0)


def test_dropout_draws_from_the_generator_alone(pair):
    """The same generator seed gives the same training forward, another
    seed another; eval mode draws nothing and is deterministic."""
    _, _, model, data = pair
    data = {k: torch.from_numpy(v) for k, v in data.items()}
    a, b, c = (_train_forward(model, data, s)["x6d"] for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    with pytest.MonkeyPatch.context() as mp:
        rec = _Recorder(mp)
        with torch.no_grad():
            e1, e2 = (model(data)["x6d"] for _ in range(2))
    assert rec.calls == {"dropout": [], "attention": []}
    assert torch.equal(e1, e2)
    with pytest.raises(ValueError, match="generator"):
        model.train()(data, eps=torch.zeros(B, Z))
