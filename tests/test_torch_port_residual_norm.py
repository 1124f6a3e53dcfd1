"""The transformer's post-norm tail, ``norm(x + drop(y))``
(``scrubvae_torch/ops/residual_norm.py``), on the CPU.

- The plain path, which the CPU runs, is the model's arithmetic from before
  the kernels (``dropout``, the add, ``LayerNorm``) bit for bit, forward
  and backward, with masks at rate 0.1 and without.
- The kernels' backward formula (``csrc/residual_norm.cu``), written here in
  plain torch as the kernel computes it from the forward's mean and signed
  rstd, against autograd of the flax form in float64: with and without a
  mask, with ``x`` that needs no gradient, and with constant rows where the
  clamp holds the variance at 0 and where it reads exactly 0.
- A training forward of a 4 + 4 layer ``TransformerVAE`` goes through the
  tail 20 times with a mask (eval: without), and no kernel launches on the
  CPU, forward or backward.
- The card's path refuses what the kernels do not take.

The kernels themselves run on the card only (``chip_smoke.py --phases
norm``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from _port_fit import ARENA

from scrubvae_torch import factory
from scrubvae_torch.models import transformer as ttr
from scrubvae_torch.ops import residual_norm as rn

RATE = 0.1


def _old_encoder(layer, x, generator):
    """``EncoderLayer.forward`` as the model wrote it before the kernels."""
    x = layer.norm1(x + layer.drop(layer.self_attn(x, x, generator), generator))
    return layer.norm2(x + layer.drop(ttr._feedforward(layer, x), generator))


def _old_decoder(layer, tgt, memory, generator):
    tgt = layer.norm1(tgt + layer.drop(layer.self_attn(tgt, tgt, generator), generator))
    tgt = layer.norm2(tgt + layer.drop(layer.multihead_attn(tgt, memory, generator), generator))
    return layer.norm3(tgt + layer.drop(ttr._feedforward(layer, tgt), generator))


@pytest.mark.parametrize("training", [True, False], ids=["masks", "no_mask"])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_plain_path_is_the_models_former_arithmetic(kind, training):
    torch.manual_seed(0)
    d = 16
    if kind == "encoder":
        layer = ttr.EncoderLayer(d, 2, 32, RATE)
        args = (torch.randn(4, 7, d, requires_grad=True),)
        old, new = _old_encoder, type(layer).forward
    else:
        layer = ttr.DecoderLayer(d, 2, 32, RATE)
        args = (torch.randn(4, 7, d, requires_grad=True), torch.randn(4, 1, d, requires_grad=True))
        old, new = _old_decoder, type(layer).forward
    with torch.no_grad():
        for m in layer.modules():  # weights and biases away from 1 and 0
            if isinstance(m, ttr.LayerNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
    layer.train(training)
    outs = []
    for fn in (old, new):
        out = fn(layer, *args, generator=torch.Generator().manual_seed(3))
        g = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
        grads = torch.autograd.grad(out, [*args, *layer.parameters()], g)
        outs.append((out.detach(), grads))
    (o1, g1), (o2, g2) = outs
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    if training:  # the masks acted
        layer.eval()
        assert not torch.equal(o1, new(layer, *args).detach())


def _stats(s: torch.Tensor, eps: float):
    """The forward's per-row mean and rstd, rstd negated where the clamp
    holds the variance at 0 (below it)."""
    mean = s.mean(-1, keepdim=True)
    var = (s * s).mean(-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(torch.clamp(var, min=0.0) + eps)
    return mean, torch.where(var < 0, -rstd, rstd)


def _kernel_grads(g, x, y, keep, rate, weight, mean, signed_rstd):
    """The backward kernel's formula: (dx, dy, dweight, dbias)."""
    d = x.shape[-1]
    inv = 1.0 / (1.0 - rate)
    s = x + (torch.where(keep, y * inv, 0.0) if keep is not None else y)
    rstd = signed_rstd.abs()
    xh = (s - mean) * rstd
    gw = g * weight
    A = gw.sum(-1, keepdim=True)
    B = torch.where(signed_rstd < 0, 0.0, (gw * xh).sum(-1, keepdim=True))
    ds = rstd * (gw - (A + B * xh) / d)
    dy = torch.where(keep, ds * inv, 0.0) if keep is not None else ds
    return ds, dy, (g * xh).reshape(-1, d).sum(0), g.reshape(-1, d).sum(0)


def _flat_rows(d: int):
    """A row of d whose variance reads below 0 in float64 (values within
    1e-12 of each other, so E[s^2] - E[s]^2 is rounding alone) and a
    constant row, whose variance reads exactly 0."""
    rng = np.random.default_rng(0)
    c = rng.uniform(0.1, 10.0, (200, 1)) * (1.0 + 1e-12 * rng.standard_normal((200, d)))
    s = torch.from_numpy(c)
    mean = s.mean(-1, keepdim=True)
    var = ((s * s).mean(-1, keepdim=True) - mean * mean)[:, 0]
    return s[var < 0][0], torch.full((d,), float(c[0, 0]), dtype=torch.float64)


@pytest.mark.parametrize("x_grad", [True, False], ids=["dx", "no_dx"])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no_mask"])
def test_backward_formula_against_autograd_float64(masked, x_grad):
    d, eps = 16, ttr.LN_EPS
    gen = torch.Generator().manual_seed(1)
    f64 = torch.float64
    x = torch.randn(3, 9, d, generator=gen, dtype=f64)
    y = torch.randn(3, 9, d, generator=gen, dtype=f64)
    held, zero = _flat_rows(d)
    x[0, 0], y[0, 0] = held, 0.0  # var reads below 0: the clamp holds it at 0
    x[0, 1], y[0, 1] = zero, 0.0  # a constant row: var reads 0, the gradient passes
    keep = torch.rand(3, 9, d, generator=gen) < 1.0 - RATE if masked else None
    weight = torch.rand(d, generator=gen, dtype=f64) + 0.5
    bias = torch.rand(d, generator=gen, dtype=f64) - 0.5
    g = torch.randn(3, 9, d, generator=gen, dtype=f64)

    leaves = [t.requires_grad_() for t in (x, y, weight, bias)] if x_grad else [
        t.requires_grad_() for t in (y, weight, bias)]
    out = rn.residual_norm_reference(x, y, keep, RATE, weight, bias, eps)
    want = dict(zip(("x", "y", "weight", "bias")[-len(leaves):], torch.autograd.grad(out, leaves, g)))

    with torch.no_grad():
        s = x + (torch.where(keep, y / (1.0 - RATE), 0.0) if masked else y)
        mean, signed_rstd = _stats(s, eps)
        assert bool(signed_rstd[0, 0] < 0) and bool(signed_rstd[0, 1] > 0)
        assert bool((signed_rstd[1:] > 0).all())
        got = dict(zip(("x", "y", "weight", "bias"), _kernel_grads(g, x, y, keep, RATE, weight, mean, signed_rstd)))
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=1e-10, atol=1e-10, msg=k)


MODEL = {"type": "transformer", "z_dim": 16, "window": 8, "n_heads": 2, "ff_size": 32, "n_layers": 4, "diag": False}
DIS = {"method": {"conditional": ["avg_speed_3d"]}, "features": ["avg_speed_3d"], "alpha": 1.0, "polynomial": 1}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_transformer_forward_runs_every_tail_through_the_wrapper(training, monkeypatch):
    """4 encoder layers of 2 tails and 4 decoder layers of 3: 20 tails, each
    with a mask in training and without in eval; the CPU launches no
    kernel, forward or backward."""
    model, _ = factory.build_model(MODEL, DIS, 18, "midfwd", arena_size=ARENA, device="cpu")
    rng = np.random.default_rng(0)
    n, w = 4, MODEL["window"]
    data = {
        "x6d": torch.from_numpy(rng.standard_normal((n, w, 18, 6)).astype(np.float32)),
        "root": torch.from_numpy((rng.standard_normal((n, w, 3)) * 50).astype(np.float32)),
        "avg_speed_3d": torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)),
    }
    tails, wrapper = [], ttr.residual_norm

    def counting(x, y, keep, *args):
        tails.append(keep is not None)
        return wrapper(x, y, keep, *args)

    monkeypatch.setattr(ttr, "residual_norm", counting)
    launches = rn.residual_norm.launches, rn.residual_norm_grad.launches
    model.train(training)
    out = model(data, eps=torch.zeros(n, MODEL["z_dim"]), generator=torch.Generator().manual_seed(0))
    out["x6d"].square().sum().backward()
    assert tails == [training] * 20
    assert (rn.residual_norm.launches, rn.residual_norm_grad.launches) == launches == (0, 0)
    assert all(p.grad is not None for n_, p in model.named_parameters() if ".norm" in n_)


def _tail_inputs(**changes):
    x = torch.zeros(2, 3, 8)
    args = {"x": x, "y": torch.zeros(2, 3, 8), "keep": torch.ones(2, 3, 8, dtype=torch.bool),
            "weight": torch.ones(8), "bias": torch.zeros(8)}
    args.update(changes)
    return args


@pytest.mark.parametrize("change,error", [
    ({"x": torch.zeros(2, 3, 8, dtype=torch.float64)}, TypeError),
    ({"weight": torch.ones(8, dtype=torch.bfloat16)}, TypeError),
    ({"y": torch.zeros(2, 3, 4)}, ValueError),
    ({"bias": torch.zeros(4)}, ValueError),
    ({"keep": torch.ones(2, 3, 8, dtype=torch.uint8)}, ValueError),
    ({"x": torch.zeros(1, rn.MAX_D + 4), "y": torch.zeros(1, rn.MAX_D + 4), "keep": None,
      "weight": torch.ones(rn.MAX_D + 4), "bias": torch.zeros(rn.MAX_D + 4)}, ValueError),
], ids=["x_f64", "weight_bf16", "y_shape", "bias_shape", "keep_dtype", "too_wide"])
def test_the_card_path_refuses_what_the_kernels_do_not_take(change, error):
    a = _tail_inputs(**change)
    with pytest.raises(error, match="residual_norm"):
        rn._check(a["x"], a["y"], a["keep"], a["weight"], a["bias"])
    good = _tail_inputs()
    rn._check(good["x"], good["y"], good["keep"], good["weight"], good["bias"])
