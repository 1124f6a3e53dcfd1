"""The port's transformer VAE against the benchmark's plain f32 reference
(``benchmark/reference/vae_transformer.py``) on the CPU, at the
reference's ``SMALL`` model keys (z 16, 2 heads, ``ff_size`` 32, 2
encoder and 2 decoder layers) with the ``transformer`` configuration's
scrubbers and conditionals, on seeded random weights that the benchmark
makes and hands to both by name:

- the forward in eval mode and in training mode, with the dropout masks
  drawn from two generators of one seed;
- the whole ``transformer.b512`` cell at ``--small`` (``benchmark.run``),
  correct on three seeds;
- the values the dropout masks draw against the masks' sizes, in a
  training forward and in a train step, and none in eval mode;
- the nested ``attention`` and ``feedforward`` spans of a traced step,
  and none on the rcnn;
- two planted faults, each caught by the forward's comparison: a
  reference that draws the attention weights' mask per head and a program
  that skips the feed-forward branch's dropout.
"""

import numpy as np
import pytest
import torch

from benchmark import manifest, run
from benchmark import weights as bw
from benchmark.reference import model as rm
from benchmark.reference import vae_transformer as rt
from benchmark.reference.step import load
from scrubvae_torch import factory
from scrubvae_torch.models import transformer as ttr

torch.set_num_threads(1)

CELL = "transformer.b512"
SEED = 2**31 + 907
B, W, J = 8, 51, 18
# f32 on both sides, the same operations in another grouping (einsum
# against matmul, F.linear against x @ w.T): the outputs differ by
# rounding alone, a few units of f32's 1.2e-7 through 2 + 2 layers
MU_TOL = 1e-5  # mu is of order 1: lecun-normal layers keep unit scale
L_TOL = 1e-5  # the Cholesky factor's entries are of order 1 (softplus of order-1 logits on the diagonal)
X6D_TOL = 1e-5  # tanh outputs in (-1, 1)
ROOT_TOL = 1e-5 * 580.0  # the root is the tanh output scaled to the arena's 580-unit side
TOLS = {"mu": MU_TOL, "L": L_TOL, "x6d": X6D_TOL, "root": ROOT_TOL}


def _sections():
    sections = manifest.sections("transformer", B)
    sections["model"].update(rt.SMALL)
    return sections


def _models():
    """(program's VAE, reference's VAE), the same weights by name."""
    sections = _sections()
    model_cfg, dis = sections["model"], sections["disentangle"]
    arena = np.asarray(sections["data"]["arena_size"], np.float32)
    classes = {"ids": np.arange(4)}
    prog, _ = factory.build_model(dict(model_cfg), dis, n_keypts=J, direction_process="midfwd", arena_size=arena,
                                  discrete_classes=classes, loss_keys=sections["loss"].keys(), device="cpu")
    ref = rm.build(dict(model_cfg), dis, sections["loss"].keys(), J, arena, {"ids": 4})
    w = bw.make(ref, SEED, "cpu")
    bw.load_into(prog, w)
    load(ref, w)
    return prog.vae, ref.vae


def _data(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return {
        "x6d": torch.randn((B, W, J, 6), generator=g),
        "root": torch.rand((B, W, 3), generator=g) * 500.0 - 250.0,
        "avg_speed_3d": torch.randn((B, 3), generator=g),
        "heading": torch.randn((B, 2), generator=g),
    }


def _forwards(prog, ref, training: bool):
    """Both forwards on one batch and one noise; in training mode each side
    draws its masks from a generator of the same seed."""
    data = _data()
    eps = torch.randn((B, rt.SMALL["z_dim"]), generator=torch.Generator().manual_seed(1))
    outs = []
    for vae in (prog, ref):
        vae.train(training)
        with torch.no_grad():
            outs.append(vae(data, eps=eps, generator=torch.Generator().manual_seed(SEED)))
    return outs


def _gaps(a, b):
    return {k: float((a[k] - b[k]).abs().max()) for k in TOLS}


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_forward_against_the_reference(training):
    prog, ref = _models()
    p, r = _forwards(prog, ref, training)
    gaps = _gaps(p, r)
    assert all(gaps[k] <= TOLS[k] for k in TOLS), gaps
    if training:  # dropout acted: the eval forward differs from the training one
        e = _forwards(*_models(), training=False)[1]
        assert float((e["x6d"] - r["x6d"]).abs().max()) > 100 * X6D_TOL


def _per_head_mask(self, x, memory, generator):
    """The reference's attention with a mask of the weights per head and
    batch entry (torch's ``nn.MultiheadAttention``), in place of the one
    (q, kv) mask of the program."""
    Bq, Lq, d = x.shape
    H, hd = self.n_heads, d // self.n_heads
    wq, wk, wv = self.in_proj_weight.split(d)
    bq, bk, bv = self.in_proj_bias.split(d)
    q = (x @ wq.T + bq).reshape(Bq, Lq, H, hd).transpose(1, 2) / hd**0.5
    k = (memory @ wk.T + bk).reshape(Bq, -1, H, hd).transpose(1, 2)
    v = (memory @ wv.T + bv).reshape(Bq, -1, H, hd).transpose(1, 2)
    weights = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    if self.training:
        weights = weights * (rt.keep_mask(weights.shape, generator, weights.device).float() / (1.0 - rt.RATE))
    return self.out_proj((weights @ v).transpose(1, 2).reshape(Bq, Lq, d))


def _encoder_without_ff_dropout(self, x, generator=None):
    x = self.norm1(x + self.drop(self.self_attn(x, x, generator), generator))
    return self.norm2(x + ttr._feedforward(self, x))


def _decoder_without_ff_dropout(self, tgt, memory, generator=None):
    tgt = self.norm1(tgt + self.drop(self.self_attn(tgt, tgt, generator), generator))
    tgt = self.norm2(tgt + self.drop(self.multihead_attn(tgt, memory, generator), generator))
    return self.norm3(tgt + ttr._feedforward(self, tgt))


FAULTS = {
    "reference_mask_per_head": [(rt.Attention, "forward", _per_head_mask)],
    "program_skips_ff_dropout": [(ttr.EncoderLayer, "forward", _encoder_without_ff_dropout),
                                 (ttr.DecoderLayer, "forward", _decoder_without_ff_dropout)],
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_training_forward(fault, monkeypatch):
    """Each fault moves some output of the training forward past its
    tolerance, so the comparison above catches it."""
    for cls, name, fn in FAULTS[fault]:
        monkeypatch.setattr(cls, name, fn)
    p, r = _forwards(*_models(), training=True)
    gaps = _gaps(p, r)
    assert any(gaps[k] > 100 * TOLS[k] for k in TOLS), gaps


@pytest.mark.parametrize("seed", [SEED + 1, SEED + 2, 7 * 10**9 + 3])
def test_the_cell_at_the_cpu_size_is_correct(seed):
    """The whole run of the cell, the card's look skipped: set-up, a warm
    and a window epoch, and the comparison under the cell's own limits.
    Both sides compute in f32 here, so the gaps are rounding alone; the
    median leaf's change still reads up to about 5e-4, since gradients of
    thousands (the root loss is of order 1e6 at the start) leave some
    elements' first Adam step to the sign of their rounding."""
    result, lines = run.run_cell(CELL, seed, 0.1, False, device="cpu", small=True)
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0, lines


def _draws_a_step(batch: int, z: int, n_layers: int) -> int:
    """The values a training forward's masks draw: every (B, W, z) branch
    (the encoder's input, two residuals an encoder layer, the decoder's
    queries, three residuals a decoder layer), a (W, W) mask a
    self-attention and a (W, 1) mask a cross-attention."""
    return batch * W * z * (2 + 5 * n_layers) + 2 * n_layers * W * W + n_layers * W


class _CountRand:
    """Counts the values ``torch.rand`` draws while it is entered."""

    def __init__(self, monkeypatch):
        self.n, self._mp, self._rand = 0, monkeypatch, torch.rand

    def _counting(self, *args, **kwargs):
        out = self._rand(*args, **kwargs)
        self.n += out.numel()
        return out

    def __enter__(self):
        self._mp.setattr(torch, "rand", self._counting)
        return self

    def __exit__(self, *exc):
        self._mp.setattr(torch, "rand", self._rand)


def test_dropout_draws_count_the_masks(monkeypatch):
    su = run.set_up(CELL, SEED, "cpu", small=True)
    trainer, B_small = su.trainer, su.batch
    per_step = _draws_a_step(B_small, rt.SMALL["z_dim"], rt.SMALL["n_layers"])
    rows = np.arange(B_small).reshape(1, B_small)
    vae = trainer.model.vae
    data = trainer.train_ds.batch(torch.as_tensor(rows[0]))
    with torch.no_grad():
        with _CountRand(monkeypatch) as drawn:
            vae.eval()
            vae(data, eps=None, generator=torch.Generator().manual_seed(0))
        assert drawn.n == 0
        with _CountRand(monkeypatch) as drawn:
            vae.train()
            vae(data, eps=None, generator=torch.Generator().manual_seed(0))
        assert drawn.n == per_step
    with _CountRand(monkeypatch) as drawn:
        trainer.train_epoch(1, rows)
    assert drawn.n == per_step
    run.free_program(su)


def test_nested_spans_of_a_traced_step():
    """A traced step of the transformer charges every attention block (a
    self-attention an encoder layer, a self- and a cross-attention a
    decoder layer) and every feed-forward block once, within the encoder
    and decoder slots, and still stamps its ten slot stamps; an untraced
    step charges nothing."""
    su = run.set_up(CELL, SEED, "cpu", small=True)
    trainer, n = su.trainer, rt.SMALL["n_layers"]
    steps = 2
    rows = np.arange(steps * su.batch).reshape(steps, su.batch)
    trainer.train_epoch(1, rows)
    assert not trainer.spans.nested_buf.any()
    trainer.set_tracing(True)
    trainer.train_epoch(1, rows)
    spans = trainer.spans
    assert spans.nested_counts == {"attention": steps * 3 * n, "feedforward": steps * 2 * n}
    assert all(v > 0 for v in spans.nested_totals_ns.values())
    assert sum(spans.counts.values()) == 10 * steps - 1  # the epoch's first stamp charges nothing
    assert sum(spans.nested_totals_ns.values()) < spans.totals_ns["encoder"] + spans.totals_ns["decoder"]
    ms = spans.nested_ms_per_step()
    assert ms["attention"] == pytest.approx(spans.nested_totals_ns["attention"] / steps / 1e6)
    run.free_program(su)


def test_the_rcnn_has_no_nested_spans():
    su = run.set_up("flagship.b512", SEED, "cpu", small=True)
    trainer = su.trainer
    trainer.set_tracing(True)
    trainer.train_epoch(1, np.arange(2 * su.batch).reshape(2, su.batch))
    assert trainer.spans.nested_counts == {"attention": 0, "feedforward": 0}
    assert sum(trainer.spans.counts.values()) == 10 * 2 - 1
    assert trainer.spans.nested_ms_per_step() == {"attention": None, "feedforward": None}
    run.free_program(su)
