"""The port's fused AdamW (scrubvae_torch/ops/fused_adamw.py,
train/optim.py FusedAdamW) against the JAX package's.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel is
held bitwise against that plain version on the GPU by chip_smoke.py. Here
the plain version is held against JAX:

- f32 path: rtol 1e-6 against ``leaf_update_reference`` (f32 op-order
  noise only), and against the Pallas kernel in interpret mode at the JAX
  package's own kernel-vs-fallback tolerance (see that test);
- bf16 stores with injected noise: bitwise equal to JAX ``_sround_bits``
  of the same f32 values;
- stochastic rounding unbiased in the mean;
- the optimizer over a small tree: 3 steps against JAX
  ``FusedAdamW.update_and_apply``, clip on and off (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu.ops.fused_adamw import (
    _sround_bits,
    fused_adamw_leaf as jax_fused_adamw_leaf,
    leaf_update_reference,
)
from scrubvae_tpu.train import optim as joptim
from scrubvae_torch.ops import fused_adamw as fa
from scrubvae_torch.train import optim as toptim

torch.set_num_threads(1)

HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
SCAL = dict(lr=3e-4, b1c=0.19, b2c=0.002, gscale=0.5)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _leaf(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    g = (rng.normal(size=shape) * 3.0).astype(np.float32)
    mu = (rng.normal(size=shape) * 0.1).astype(np.float32)
    nu = (np.abs(rng.normal(size=shape)) * 0.01).astype(np.float32)
    return w, g, mu, nu


def _port_reference(w, g, mu, nu, **kw):
    t = [torch.from_numpy(np.asarray(a)) for a in (w, g, mu, nu)]
    return fa.fused_adamw_leaf_reference(*t, **SCAL, **HYPER, **kw)


def _bits(x) -> np.ndarray:
    x = np.asarray(x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(torch.int32))
    return x


@pytest.mark.parametrize("shape", [(130, 200), (7,), (3, 5, 11)])
def test_plain_matches_jax_reference_f32(shape):
    w, g, mu, nu = _leaf(shape, 1)
    ref = leaf_update_reference(
        *map(jnp.asarray, (w, g, mu, nu)),
        lr=jnp.float32(SCAL["lr"]), b1c=jnp.float32(SCAL["b1c"]), b2c=jnp.float32(SCAL["b2c"]),
        gscale=jnp.float32(SCAL["gscale"]), key=None, lowp=False, **HYPER,
    )
    got = _port_reference(w, g, mu, nu)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_plain_matches_pallas_interpret_f32():
    """Same as the JAX package's own kernel-vs-fallback test (grad clip
    factor, a shape off every block multiple), against the Pallas kernel.
    The Pallas kernel forms (1 - b1) and (1 - b2) in f32 from its stored
    betas, where its own fallback and the port round them once from double:
    1 - f32(0.999) is 4.7e-5 relative off 0.001. Hence the JAX package's
    own kernel-vs-fallback tolerance, rtol 5e-5 (its test_fused_optim.py)."""
    w, g, mu, nu = _leaf((130, 200), 2)
    ref = jax_fused_adamw_leaf(
        *map(jnp.asarray, (w, g, mu, nu)),
        lr=jnp.float32(SCAL["lr"]), b1c=SCAL["b1c"], b2c=SCAL["b2c"],
        gscale=jnp.float32(SCAL["gscale"]), seed=jnp.int32(5), interpret=True,
        lowp=False, wd=HYPER["wd"],
    )
    got = _port_reference(w, g, mu, nu)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-5, atol=1e-7)


@pytest.mark.parametrize("wk,mk", [("f32", "f32"), ("f32", "bf16"), ("bf16", "f32"), ("bf16", "bf16")])
def test_bf16_stores_bitwise_match_jax_sround(wk, mk):
    """Each dtype variant: the plain version and the CPU wrapper over a
    one-leaf table (in place) store exactly JAX's stochastic rounding of the
    f32 result."""
    shape = (37, 29)
    w, g, mu, nu = _leaf(shape, 3)
    wt, mt = DTYPES[wk], DTYPES[mk]
    ins = [
        torch.from_numpy(w).to(wt), torch.from_numpy(g).to(wt),
        torch.from_numpy(mu).to(mt), torch.from_numpy(nu).to(mt),
    ]
    noise = torch.from_numpy(
        np.random.default_rng(4).integers(0, 1 << 16, (3, w.size)).astype(np.int32)
    )
    got = fa.fused_adamw_leaf_reference(*ins, **SCAL, **HYPER, noise=noise)
    exact = fa.fused_adamw_leaf_reference(*[t.float() for t in ins], **SCAL, **HYPER)
    for row, (out, x, dt) in enumerate(zip(got, exact, (wt, mt, mt))):
        assert out.dtype == dt
        if dt == torch.bfloat16:
            want = _sround_bits(
                jnp.asarray(x.numpy()), jnp.asarray(noise[row].numpy().reshape(shape), jnp.uint32)
            )
            np.testing.assert_array_equal(
                _bits(out), np.asarray(want).view(np.int16)
            )
        else:
            np.testing.assert_array_equal(_bits(out), _bits(x))
    scal = torch.tensor([SCAL["lr"], SCAL["b1c"], SCAL["b2c"], SCAL["gscale"]])
    w_, g_, m_, n_ = (t.clone() for t in ins)
    fa.fused_adamw_multi(fa.LeafTable([w_], [m_], [n_], leaf_ids=[0], noise=[noise]), [g_], scal, **HYPER)
    for a, b in zip((w_, m_, n_), got):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_stochastic_rounding_unbiased():
    """The mean of many rounded copies approaches the unrounded value
    (round-to-nearest would pin it to the nearest bf16)."""
    x = torch.full((4096,), 1.0 + 1e-3)  # 1e-3 << bf16 ulp (~8e-3)
    zeros = torch.zeros_like(x)
    acc = 0.0
    for s in range(16):
        # b1 = 0: the new first moment is g itself, stored in bf16
        _, m, _ = fa.fused_adamw_leaf_reference(
            zeros, x, zeros.to(torch.bfloat16), zeros.to(torch.bfloat16),
            lr=0.0, b1c=1.0, b2c=1.0, gscale=1.0, b1=0.0, b2=1.0, wd=0.0,
            generator=torch.Generator().manual_seed(s),
        )
        acc += float(m.float().mean())
    assert abs(acc / 16 - 1.001) < 2e-4


def _one_leaf(w, g, mu, nu, scal, noise=None):
    fa.fused_adamw_multi(fa.LeafTable([w], [mu], [nu], leaf_ids=[0], noise=[noise]), [g], scal)


def test_wrapper_rejects_mismatched_inputs():
    w = torch.zeros(8)
    scal = torch.ones(4)
    with pytest.raises(ValueError):
        _one_leaf(w, torch.zeros(9), torch.zeros(8), torch.zeros(8), scal)
    with pytest.raises(TypeError):
        _one_leaf(w, torch.zeros(8, dtype=torch.bfloat16), torch.zeros(8), torch.zeros(8), scal)
    with pytest.raises(ValueError):
        _one_leaf(w, torch.zeros(8), torch.zeros(8), torch.zeros(8), scal, noise=torch.zeros((3, 8), dtype=torch.int64))


@pytest.mark.parametrize("clip", [None, 1.0])
def test_fused_adamw_matches_jax_over_three_steps(clip):
    """Schedule, bias correction, decoupled decay and the global-norm clip
    (1.0 clips these gradients, norm ~60) over a mixed-size tree."""
    rng = np.random.default_rng(0)
    tree = {
        "dense": {"bias": np.zeros(96, np.float32), "kernel": rng.normal(size=(64, 96)).astype(np.float32)},
        "prelu": np.full((1,), 0.25, np.float32),
    }
    leaves = jax.tree.leaves(tree)  # bias, kernel, prelu
    jtx = joptim.FusedAdamW(
        joptim.make_lr_schedule(1e-3, "cawr", steps_per_epoch=4),
        weight_decay=0.01, clip_norm=clip, use_pallas=False,
    )
    ttx = toptim.FusedAdamW(
        toptim.make_lr_schedule(1e-3, "cawr", steps_per_epoch=4), weight_decay=0.01, clip_norm=clip
    )
    jp = jax.tree.map(jnp.asarray, tree)
    js = jtx.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in leaves]
    ts = ttx.init(tp)
    for t in range(3):
        grads = [rng.normal(size=a.shape).astype(np.float32) for a in leaves]
        jg = jax.tree.unflatten(jax.tree.structure(tree), [jnp.asarray(x) for x in grads])
        jp, js = jtx.update_and_apply(jg, js, jp)
        ts = ttx.update_and_apply([torch.from_numpy(x) for x in grads], ts, tp)
        for a, b in zip(tp, jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
    assert int(ts.count) == int(js.count) == 3
    assert [m.dtype for m in ts.mu] == [torch.float32] * 3  # all leaves < 65536
