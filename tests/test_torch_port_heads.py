"""The rcnn's two other heads, the port against the JAX package, at the
bench's --small widths (channels 8-8-16-16-32, z 16, window 51, f32):

- the low-rank sigma head (``model.sigma_head_rank``): ``fc_sigma_u``
  (flatten -> rank) then ``fc_sigma_v`` (rank -> L entries), kept only
  for the full head and a rank below both widths, as JAX decides; the
  forward and the gradients after the weights are carried, with the
  packed and the dense Cholesky head;
- the beta prior (``model.prior: beta``): ``alpha``/``beta`` heads, their
  mode as mu, ``beta_prior_loss`` and the gamma rsample, with JAX's own
  gamma draws injected; the gradients through the draws are the implicit
  ones (``torch._standard_gamma_grad``), and a sampler that takes the
  draws as constants fails the gradient check;
- three train steps of each against JAX's in
  ``tests/test_torch_port_heads_steps.py``.

Bounds: forward rtol 1e-4 (the convolutions' summation order); gradients
per leaf by relative norm 1e-4, and 2e-3 on the beta prior's encoder,
whose gradient runs through JAX's gamma derivative, itself up to 6.2e-4
from its float64 value (torch's is within 6e-8), read on 2000 draws.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_fit import ARENA
from scrubvae_tpu import factory as jfactory
from scrubvae_tpu.ops import losses as jlosses
from scrubvae_torch import factory
from scrubvae_torch.models import residual
from scrubvae_torch.ops import losses as tlosses
from scrubvae_torch.train import parity
from scrubvae_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

B, W, Z = 8, 51, 16
RANK = 8  # below min(sig_dim 136, flatten 128)
MODEL = {
    "type": "rcnn", "z_dim": Z, "window": W, "diag": False, "channel": [8, 8, 16, 16, 32],
    "kernel": 5, "prior": "gaussian", "activation": "prelu", "precision": "fp32",
}
DIS = {
    "method": {
        "conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"],
        "moving_avg_lsq": ["avg_speed_3d"], "grad_reversal": ["avg_speed_3d"],
    },
    "features": ["avg_speed_3d", "heading"], "alpha": 1.0,
}
LOSS_KEYS = ("rotation", "prior", "root", "jpe", "avg_speed_3d_mals", "avg_speed_3d_lin", "avg_speed_3d_gr")
BETA_HEADS = ("vae.encoder.fc_alpha.weight", "vae.encoder.fc_alpha.bias", "vae.encoder.fc_beta.weight", "vae.encoder.fc_beta.bias")


@pytest.fixture(autouse=True)
def _highest_precision():
    jax.config.update("jax_default_matmul_precision", "highest")


def flatten(tree) -> dict:
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _data():
    rng = np.random.default_rng(0)
    return {
        "x6d": rng.normal(size=(B, W, 18, 6)).astype(np.float32) * 0.5,
        "root": rng.uniform(-200, 200, size=(B, W, 3)).astype(np.float32),
        "avg_speed_3d": rng.normal(size=(B, 3)).astype(np.float32),
        "heading": rng.normal(size=(B, 2)).astype(np.float32),
    }


def build_pair(model: dict, loss_keys=LOSS_KEYS):
    """The JAX model with its initial variables and the port's carrying
    them; the data as both take it."""
    data = _data()
    jmodel, _ = jfactory.build_model({**MODEL, **model}, DIS, 18, "midfwd", arena_size=ARENA, loss_keys=loss_keys)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)}, jdata, rng=jax.random.PRNGKey(0), train=True,
    )
    tmodel, _ = factory.build_model({**MODEL, **model}, DIS, 18, "midfwd", arena_size=ARENA, loss_keys=loss_keys, device="cpu")
    tmodel.load_state_dict(from_jax_variables(flatten(variables)), strict=True)
    return jmodel, variables, tmodel, jdata, {k: torch.from_numpy(v) for k, v in data.items()}


def _port_grads(tmodel, loss) -> dict:
    names = [n for n, p in tmodel.named_parameters()]
    grads = torch.autograd.grad(loss, list(tmodel.parameters()), allow_unused=True)
    return {n: g for n, g in zip(names, grads) if g is not None}


def _check_grads(want: dict, got: dict, tol: float, tols: dict = None) -> dict:
    """Every leaf that JAX's gradient reaches, by relative norm; the conv
    biases into BatchNorm, whose gradient is 0 but for rounding, left out."""
    worst = {}
    zero = parity.zero_grad_leaves(want)
    for n, w in want.items():
        if n in zero or float(w.norm()) == 0.0:
            continue
        r = _rel(got[n], w)
        worst[n] = r
        assert r <= (tols or {}).get(n, tol), (n, r)
    return worst


# ---------------------------------------------------------------------------
# the low-rank sigma head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "rank,diag,low",
    [(RANK, False, True), (None, False, False), (128, False, False), (200, False, False), (RANK, True, False)],
    ids=["rank8", "unset", "rank_eq_flatten", "rank_above", "diag"],
)
def test_low_rank_rule_matches_jax(rank, diag, low):
    """fc_sigma_u/fc_sigma_v only for the full head and a rank below both
    the flatten (128) and the L entries (136); the dense fc_sigma else."""
    model = {**MODEL, "sigma_head_rank": rank, "diag": diag}
    jmodel, _ = jfactory.build_model(model, DIS, 18, "midfwd", arena_size=ARENA, loss_keys=LOSS_KEYS)
    jdata = {k: jnp.asarray(v) for k, v in _data().items()}
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)}, jdata,
                            rng=jax.random.PRNGKey(0), train=True)
    )
    jnames = {k for k in flatten(jax.tree.map(lambda s: np.zeros(0), shapes["params"])) if "/fc_sigma" in k}
    tmodel, _ = factory.build_model(model, DIS, 18, "midfwd", arena_size=ARENA, loss_keys=LOSS_KEYS, device="cpu")
    names = {n for n, _ in tmodel.named_parameters() if ".fc_sigma" in n}
    if low:
        assert jnames == {f"vae/encoder/fc_sigma_{f}/{p}" for f in "uv" for p in ("kernel", "bias")}
        assert names == {f"vae.encoder.fc_sigma_{f}.{p}" for f in "uv" for p in ("weight", "bias")}
        assert tuple(tmodel.vae.encoder.fc_sigma_u.weight.shape) == (RANK, 128)
        assert tuple(tmodel.vae.encoder.fc_sigma_v.weight.shape) == (Z * (Z + 1) // 2, RANK)
    else:
        assert jnames == {"vae/encoder/fc_sigma/kernel", "vae/encoder/fc_sigma/bias"}
        assert names == {"vae.encoder.fc_sigma.0.weight", "vae.encoder.fc_sigma.0.bias"}


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_low_rank_head_forward_and_grads(packed):
    """Eval-mode mu and Cholesky factor, then the gradient of the prior KL
    plus the reconstruction's sum of squares in training mode with the
    same sample noise, every leaf within 1e-4."""
    loss_keys = LOSS_KEYS if packed else LOSS_KEYS + ("total_correlation",)
    jmodel, variables, tmodel, jdata, tdata = build_pair({"sigma_head_rank": RANK}, loss_keys)
    key = "Lp" if packed else "L"
    assert tmodel.vae.packed_sigma is packed and jmodel.vae.packed_sigma is packed
    jout = jax.jit(lambda v: jmodel.apply(v, jdata, rng=None, train=False))(variables)
    tmodel.eval()
    with torch.no_grad():
        tout = tmodel(tdata)
    for k in ("mu", key, "x6d"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-4, atol=1e-5, err_msg=k)

    rng = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.normal(rng, (B, Z)))
    jprior = jlosses.prior_loss_packed if packed else jlosses.prior_loss
    tprior = tlosses.prior_loss_packed if packed else tlosses.prior_loss

    def jloss(params):
        out, _ = jmodel.apply({**variables, "params": params}, jdata, rng=rng, train=True, mutable=["batch_stats"])
        return jprior(out["mu"], out[key]) + jnp.sum(out["x6d"] ** 2)

    want = from_jax_variables(flatten({"params": jax.jit(jax.grad(jloss))(variables["params"])}))
    tmodel.train()
    out = tmodel(tdata, eps=torch.from_numpy(eps))
    got = _port_grads(tmodel, tprior(out["mu"], out[key]) + torch.sum(out["x6d"] ** 2))
    worst = _check_grads(want, got, 1e-4)
    assert {"vae.encoder.fc_sigma_u.weight", "vae.encoder.fc_sigma_v.weight"} <= set(worst)
    print(f"low-rank head ({'packed' if packed else 'dense'}): largest gradient gap {max(worst.values()):.3e}")


# ---------------------------------------------------------------------------
# the beta prior
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def beta_pair():
    return build_pair({"prior": "beta"})


def test_beta_prior_is_never_packed():
    for loss_keys in (LOSS_KEYS, None):
        model, _ = factory.build_model({**MODEL, "prior": "beta"}, DIS, 18, "midfwd", arena_size=ARENA,
                                       loss_keys=loss_keys, device="cpu")
        jmodel, _ = jfactory.build_model({**MODEL, "prior": "beta"}, DIS, 18, "midfwd", arena_size=ARENA,
                                         loss_keys=loss_keys)
        assert model.vae.packed_sigma is False and jmodel.vae.packed_sigma is False


def test_beta_encode_and_loss(beta_pair):
    """alpha, beta and their mode as mu in eval mode (z = mu), whatever
    ``mu_only``; the KL against Beta(1, 1) at JAX's alpha and beta."""
    jmodel, variables, tmodel, jdata, tdata = beta_pair
    jout = jax.jit(lambda v: jmodel.apply(v, jdata, rng=None, train=False))(variables)
    tmodel.eval()
    with torch.no_grad():
        tout = tmodel(tdata)
        enc = tmodel.vae.encode(tdata, mu_only=True)
    assert set(enc) == {"alpha", "beta", "mu"}
    for k in ("alpha", "beta", "mu", "z", "x6d"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(tout["z"].numpy(), tout["mu"].numpy())
    a, b = np.asarray(jout["alpha"]), np.asarray(jout["beta"])
    want = float(jlosses.beta_prior_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(tlosses.beta_prior_loss(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= 1e-5 * abs(want)


def _beta_grads(beta_pair):
    """JAX's and the port's gradients of the beta KL plus the
    reconstruction's sum of squares in training mode, the port with JAX's
    gamma draws."""
    jmodel, variables, tmodel, jdata, tdata = beta_pair
    rng = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(rng)
    out, _ = jax.jit(lambda v: jmodel.apply(v, jdata, rng=rng, train=True, mutable=["batch_stats"]))(variables)
    draws = tuple(torch.from_numpy(np.asarray(jax.random.gamma(k, out[n]))) for k, n in ((k1, "alpha"), (k2, "beta")))

    def jloss(params):
        o, _ = jmodel.apply({**variables, "params": params}, jdata, rng=rng, train=True, mutable=["batch_stats"])
        return jlosses.beta_prior_loss(o["alpha"], o["beta"]) + jnp.sum(o["x6d"] ** 2)

    want = from_jax_variables(flatten({"params": jax.jit(jax.grad(jloss))(variables["params"])}))
    tmodel.train()
    tout = tmodel(tdata, eps=draws)
    np.testing.assert_allclose(tout["z"].detach().numpy(), np.asarray(out["z"]), rtol=1e-4, atol=1e-5)
    got = _port_grads(tmodel, tlosses.beta_prior_loss(tout["alpha"], tout["beta"]) + torch.sum(tout["x6d"] ** 2))
    return want, got


def _beta_tols(want: dict) -> dict:
    """2e-3 on the encoder, upstream of the gamma derivative; the decoder
    keeps 1e-4."""
    return {n: 2e-3 for n in want if n.startswith("vae.encoder.")}


def test_beta_gradients_with_jax_draws(beta_pair):
    want, got = _beta_grads(beta_pair)
    worst = _check_grads(want, got, 1e-4, _beta_tols(want))
    print("beta prior: gradient gaps of the heads", {n: f"{worst[n]:.3e}" for n in BETA_HEADS})


def test_constant_draws_fail_the_gradient_check(beta_pair, monkeypatch):
    """A planted sampler that takes the injected draws as constants: no
    gradient reaches alpha and beta through z, so the heads' gradients
    leave the bound."""

    def constant(alpha, generator=None, draw=None):
        return draw.detach().to(alpha.dtype)

    monkeypatch.setattr(residual, "gamma_rsample", constant)
    want, got = _beta_grads(beta_pair)
    with pytest.raises(AssertionError):
        _check_grads(want, got, 1e-4, _beta_tols(want))


def test_gamma_rsample_draws_from_the_generator():
    alpha = torch.tensor([1.5, 2.0, 4.0], requires_grad=True)
    a = residual.gamma_rsample(alpha, torch.Generator().manual_seed(3))
    b = torch._standard_gamma(alpha.detach(), generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.detach(), b)
    (g,) = torch.autograd.grad(a.sum(), alpha)
    assert torch.equal(g, torch._standard_gamma_grad(alpha.detach(), b))
