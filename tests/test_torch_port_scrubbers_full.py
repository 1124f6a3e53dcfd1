"""The port's full-stack scrubbers and losses against the JAX package's, on
the same numpy inputs, function by function: QDA (``qda_init``,
``qda_loss``, ``qda_update``, the lama walk), the adversarial net
(``adv_shuffle``, ``adv_generator_loss``, ``adv_fit``), MCMI (``mi_init``,
``mi_score``), the dense Cholesky head (``CholeskyL``, ``packed_to_L``),
``prior_loss`` and ``total_correlation``.

Tolerances:

- ``packed_to_L``, ``adv_shuffle``: exact (a scatter, a gather);
  ``CholeskyL``: exact off the diagonal, the diagonal's softplus to two
  f32 ulps (torch's and XLA's softplus round differently);
- the losses and estimators: values at rtol 1e-5, gradients by relative
  norm <= 1e-5;
- QDA over three (loss, update) steps at D = 8 (JAX's unrolled
  Gauss-Jordan) and D = 40 (beyond ``SMALL_N_MAX`` = 32, so JAX's pivoted
  LU, as the port's at every size): the forgetting factors exactly (their
  walk is a comparison per class), the loss at rtol 1e-4, the moments and
  covariances by relative norm <= 1e-5, the loss's gradient in x by
  relative norm <= 1e-4;
- five inner ``adv_fit`` steps from carried JAX parameters, the port's
  fused AdamW (its plain version on the CPU) against ``optax.adamw(0.1)``
  with JAX's own permutations: parameters and moments per leaf by relative
  norm <= 1e-4. At lr 0.1 every step moves each parameter by about 0.1
  whatever its gradient's size, so f32 rounding of the gradients barely
  shows in the parameters.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu.models import layers as jlayers
from scrubvae_tpu.models import scrubbers as jscr
from scrubvae_tpu.ops import losses as jlosses
from scrubvae_torch.models import layers
from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.ops import losses
from scrubvae_torch.train import parity
from scrubvae_torch.train.optim import FusedAdamW
from scrubvae_torch.utils.weights import adv_from_jax, mi_state_from_numpy, qda_state_from_numpy

torch.set_num_threads(1)

CLASSES = np.array([2, 5, 7, 9])


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def flat(tree) -> dict:
    return {k: np.array(v) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# QDA
# ---------------------------------------------------------------------------


def _qda_batches(D, steps=3, B=48, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        y = rng.choice(CLASSES, size=B).astype(np.int32)
        # class-dependent means so the two classifiers disagree
        x = rng.standard_normal((B, D)).astype(np.float32) + 0.5 * (y[:, None] % 3).astype(np.float32)
        out.append((x, y))
    return out


def test_qda_init_matches():
    want = jscr.qda_init(6, CLASSES)
    got = scr.qda_init(6, CLASSES, device="cpu")
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    for f in ("m0a", "m1a", "m0b", "m1b", "S0a", "S1a", "S0b", "S1b", "lama", "lamb"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert len({getattr(got, f).data_ptr() for f in ("S0a", "S1a", "S0b", "S1b")}) == 4
    assert (got.lamdiff, got.delta) == (want.lamdiff, want.delta)


@pytest.mark.parametrize("D", [8, 40])
def test_qda_three_steps_match(D):
    jst = jscr.qda_init(D, CLASSES)
    tst = scr.qda_init(D, CLASSES, device="cpu")
    walked = False
    for x, y in _qda_batches(D):
        jl, jst = jscr.qda_loss(jst, jnp.asarray(x), jnp.asarray(y))
        tl, tst = scr.qda_loss(tst, t(x), t(y))
        close(float(tl), float(jl), rtol=1e-4)
        np.testing.assert_array_equal(tst.lama.numpy(), np.asarray(jst.lama))
        np.testing.assert_array_equal(tst.lamb.numpy(), np.asarray(jst.lamb))
        walked |= bool(np.any(np.asarray(jst.lama) != 0.2))
        jst = jscr.qda_update(jst, jnp.asarray(x), jnp.asarray(y))
        tst = scr.qda_update(tst, t(x), t(y))
        readings = parity.check_qda({f: t(getattr(jst, f)) for f in parity.QDA_KEYS}, {f: getattr(tst, f) for f in parity.QDA_KEYS}, 1e-5)
    print(f"QDA D={D}: {readings}")
    assert walked


@pytest.mark.parametrize("D", [8, 40])
def test_qda_loss_gradient_in_x(D):
    """From a state of three updates (covariances no longer the identity)."""
    batches = _qda_batches(D, steps=4, seed=1)
    jst = jscr.qda_init(D, CLASSES)
    for x, y in batches[:3]:
        jst = jscr.qda_update(jst, jnp.asarray(x), jnp.asarray(y))
    tst = qda_state_from_numpy({f: np.asarray(getattr(jst, f)) for f in parity.QDA_KEYS}, scr.qda_init(D, CLASSES, device="cpu"))
    x, y = batches[3]
    jg = jax.grad(lambda xx: jscr.qda_loss(jst, xx, jnp.asarray(y))[0])(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    (tg,) = torch.autograd.grad(scr.qda_loss(tst, xt, t(y))[0], [xt])
    r = parity.rel(tg, t(jg))
    print(f"QDA D={D}: d loss / d x, relative {r:.3e}")
    assert r <= 1e-4


# ---------------------------------------------------------------------------
# adversarial net
# ---------------------------------------------------------------------------

B, Z, C = 24, 6, 5
V_IND = np.arange(0, 3)  # avg_speed_3d's columns of (avg_speed_3d, heading)


@pytest.fixture(scope="module")
def adv():
    rng = np.random.default_rng(2)
    state, model, tx = jscr.adv_init(jax.random.PRNGKey(4), Z + C)
    z = rng.standard_normal((B, Z)).astype(np.float32)
    v = rng.standard_normal((B, C)).astype(np.float32)
    net = scr.AdvNet(Z + C)
    net.load_state_dict(adv_from_jax(flat(state.params)))
    return state, model, tx, z, v, net


def test_adv_shuffle_with_jax_permutation(adv):
    _, _, _, z, v, _ = adv
    rng = jax.random.PRNGKey(7)
    jz, jv = jscr.adv_shuffle(rng, jnp.asarray(z), jnp.asarray(v), jnp.asarray(V_IND))
    perm = t(jax.random.permutation(rng, B))
    tz, tv = scr.adv_shuffle(t(z), t(v), t(V_IND), perm)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_adv_generator_loss_and_gradient(adv):
    state, model, _, z, v, net = adv
    rng = jax.random.PRNGKey(8)
    jl, jg = jax.value_and_grad(
        lambda mu: jscr.adv_generator_loss(model, state, rng, mu, jnp.asarray(v), jnp.asarray(V_IND))
    )(jnp.asarray(z))
    mu = t(z).requires_grad_(True)
    st = scr.AdvState(net=net, opt_state=None)
    tl = scr.adv_generator_loss(st, mu, t(v), t(V_IND), t(jax.random.permutation(rng, B)))
    (tg,) = torch.autograd.grad(tl, [mu])
    close(float(tl.detach()), float(jl))
    assert parity.rel(tg, t(jg)) <= 1e-5
    assert all(p.grad is None for p in net.parameters())


def test_adv_fit_five_steps_against_optax(adv):
    """Five inner steps from the same parameters with JAX's permutations:
    the fused AdamW's plain version against ``optax.adamw(0.1)``."""
    state, model, tx, z, v, net0 = adv
    rng = jax.random.PRNGKey(9)
    new = jscr.adv_fit(model, tx, state, rng, jnp.asarray(z), jnp.asarray(v), jnp.asarray(V_IND), n_iter=5)
    perms = [t(jax.random.permutation(r, B)) for r in jax.random.split(rng, 5)]
    net = scr.AdvNet(Z + C)
    net.load_state_dict(net0.state_dict())
    ttx = FusedAdamW(0.1, weight_decay=1e-4, moment_dtype=torch.float32)
    st = scr.AdvState(net=net, opt_state=ttx.init(list(net.parameters())))
    st = scr.adv_fit(ttx, st, t(z), t(v), t(V_IND), perms)
    assert int(st.opt_state.count) == 5 and st.opt_state.step == 5
    adam = new.opt_state[0]
    assert int(adam.count) == 5
    want = {
        "params": adv_from_jax(flat(new.params)),
        "mu": adv_from_jax(flat(adam.mu)),
        "nu": adv_from_jax(flat(adam.nu)),
    }
    names = [n for n, _ in net.named_parameters()]
    got = {
        "params": dict(net.named_parameters()),
        "mu": dict(zip(names, st.opt_state.mu)),
        "nu": dict(zip(names, st.opt_state.nu)),
    }
    readings = {part: parity.check_adv(want[part], got[part], 1e-4) for part in want}
    print(f"adv_fit, 5 steps against optax: {readings}")


# ---------------------------------------------------------------------------
# MCMI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("var_mode", ["sphere", "diagonal"])
def test_mi_init_and_score(var_mode):
    rng = np.random.default_rng(3)
    S, D, Y = 20, 6, 5
    xs = rng.standard_normal((S, D)).astype(np.float32)
    ys = rng.standard_normal((S, Y)).astype(np.float32)
    L = np.tril(rng.standard_normal((S, D, D))).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    y = rng.standard_normal((B, Y)).astype(np.float32)
    jst = jscr.mi_init(jnp.asarray(xs), jnp.asarray(ys), 0.7, var_mode, model_L=jnp.asarray(L))
    tst = scr.mi_init(t(xs), t(ys), 0.7, var_mode, model_diag=torch.diagonal(t(L), dim1=-2, dim2=-1))
    assert (tst.gamma, tst.var_mode) == (jst.gamma, jst.var_mode)
    parity.check_mi({f: t(getattr(jst, f)) for f in parity.MI_KEYS}, {f: getattr(tst, f) for f in parity.MI_KEYS}, 1e-6)
    jl, jg = jax.value_and_grad(lambda xx: jscr.mi_score(jst, xx, jnp.asarray(y)))(jnp.asarray(x))
    xt = t(x).requires_grad_(True)
    carried = mi_state_from_numpy({f: np.asarray(getattr(jst, f)) for f in parity.MI_KEYS}, tst)
    tl = scr.mi_score(carried, xt, t(y))
    (tg,) = torch.autograd.grad(tl, [xt])
    close(float(tl.detach()), float(jl))
    assert parity.rel(tg, t(jg)) <= 1e-5


# ---------------------------------------------------------------------------
# dense Cholesky head, prior, total correlation
# ---------------------------------------------------------------------------

D = 7


@pytest.mark.parametrize("is_diag", [False, True])
def test_cholesky_l_and_packed_to_l(is_diag):
    rng = np.random.default_rng(4)
    K = D if is_diag else D * (D + 1) // 2
    x = (rng.standard_normal((5, K)) * 3).astype(np.float32)
    x[0, 0] = -200.0  # softplus underflows: the 1e-6 floor
    want = jlayers.CholeskyL(D, is_diag).apply({}, jnp.asarray(x))
    got = layers.CholeskyL(D, is_diag)(t(x))
    off = ~np.eye(D, dtype=bool)
    np.testing.assert_array_equal(got.numpy()[:, off], np.asarray(want)[:, off])
    np.testing.assert_allclose(got.numpy()[:, ~off], np.asarray(want)[:, ~off], rtol=2.4e-7, atol=0)
    assert float(got[0, 0, 0]) == pytest.approx(1e-6)
    xp = np.asarray(jlayers.packed_softplus_diag(jnp.asarray(x), D, is_diag))
    np.testing.assert_array_equal(
        layers.packed_to_L(t(xp), D).numpy(), np.asarray(jlayers.packed_to_L(jnp.asarray(xp), D))
    )


def _head(seed=5, Bh=12):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((Bh, D)).astype(np.float32)
    sig = (rng.standard_normal((Bh, D * (D + 1) // 2)) * 0.5).astype(np.float32)
    L = np.asarray(jlayers.CholeskyL(D, False).apply({}, jnp.asarray(sig)))
    eps = rng.standard_normal((Bh, D)).astype(np.float32)
    z = mu + np.einsum("bij,bj->bi", L, eps)
    return mu, L, z.astype(np.float32)


@pytest.mark.parametrize("name", ["prior_loss", "total_correlation"])
def test_dense_losses_value_and_gradient(name):
    mu, L, z = _head()
    if name == "prior_loss":
        jfn, tfn = (lambda m, l: jlosses.prior_loss(m, l)), (lambda m, l: losses.prior_loss(m, l))
    else:
        jfn = lambda m, l: jlosses.total_correlation(jnp.asarray(z), m, l)  # noqa: E731
        tfn = lambda m, l: losses.total_correlation(t(z).requires_grad_(True), m, l)  # noqa: E731
    jl, (jgm, jgl) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(L))
    m, l = t(mu).requires_grad_(True), t(L).requires_grad_(True)
    tl = tfn(m, l)
    gm, gl = torch.autograd.grad(tl, [m, l])
    close(float(tl.detach()), float(jl))
    for g, w in ((gm, jgm), (gl, jgl)):
        assert parity.rel(g, t(w)) <= 1e-5


def test_total_correlation_detaches_z():
    mu, L, z = _head()
    zt = t(z).requires_grad_(True)
    out = losses.total_correlation(zt, t(mu), t(L))
    assert not out.requires_grad
