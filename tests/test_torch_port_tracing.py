"""The port's tracing on the CPU (``utils.profiling``, ``Trainer.set_tracing``
and the trainer's counters) at the bench's ``--small`` sizes (channels
8-8-16-16-32, z 16, batch 16, f32), for the flagship (linear, MALS and
gradient-reversal scrubbers, packed head) and ``configs/ladder/5_full.yaml``
(QDA, the adversarial discriminator, MCMI, total correlation).

On the CPU a stamp adds ``time.perf_counter_ns()`` deltas into a CPU
buffer; the stamp kernel that the card runs in its place is held by
``benchmark/tests/test_benchmark_spans.py``'s card tests. The graph epochs'
counters run here through a stand-in for ``StepGraph`` whose replay calls
the captured step.
"""

import contextlib
import itertools
import warnings

import numpy as np
import pytest
import torch

from scrubvae_torch import bench, profile_step
from scrubvae_torch.train import graph as graph_mod
from scrubvae_torch.train import trainer as trainer_mod
from scrubvae_torch.train.state import tree_map
from scrubvae_torch.utils import profiling

torch.set_num_threads(1)

STEPS = 3
CONFIGS = ("flagship", "full5")
# one step's stamps after its first, in the step's order
ORDER = ("data", "encoder", "decoder", "scrub_forward", "losses", "scrub_forward", "backward", "optimizer",
         "scrub_update")


def _build(kind: str, val_frames: int = 0):
    if kind == "flagship":
        return bench.build(16, 51, 16, bench.SMALL_CH, "cpu", precision="fp32", bf16_params=False)
    return profile_step.build_from_config(
        profile_step.ROOT / "configs" / "ladder" / "5_full.yaml", "cpu", small=True, val_frames=val_frames,
    )


def _rows(ds, steps: int = STEPS, width: int = 16, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, len(ds), (steps, width))


@pytest.fixture
def stamps(monkeypatch):
    """The slots of every stamp made, in order."""
    calls = []
    orig = profiling.StepSpans.stamp

    def record(self, slot):
        calls.append(slot)
        orig(self, slot)

    monkeypatch.setattr(profiling.StepSpans, "stamp", record)
    return calls


def _bits(trainer) -> list:
    """Every tensor of the model and the train state (integer views of the
    floats, so bits compare), the host counts and the generators' states."""
    out = []

    def visit(o):
        if isinstance(o, torch.nn.Module):
            out.extend(t.detach() for t in itertools.chain(o.parameters(), o.buffers()))
        elif isinstance(o, torch.Tensor):
            out.append(o.detach())
        elif isinstance(o, torch.Generator):
            out.append(o.get_state())
        elif isinstance(o, int) and not isinstance(o, bool):
            out.append(torch.tensor(o))
        return o

    tree_map(visit, [trainer.model, trainer.state])
    return [t.clone().view(torch.int32) if t.dtype == torch.float32 else t.clone() for t in out]


@pytest.mark.parametrize("kind", CONFIGS)
def test_tracing_off_calls_no_stamp(kind, stamps):
    trainer, ds = _build(kind)
    trainer.train_epoch(1, _rows(ds))
    assert stamps == [] and not trainer.tracing
    assert not trainer.spans.buf.any()


@pytest.mark.parametrize("kind", CONFIGS)
def test_tracing_on_and_off_train_bitwise_alike(kind):
    """Three steps from the same start, traced and not: the same losses,
    model and train state, bit for bit."""
    runs = {}
    for tracing in (False, True):
        trainer, ds = _build(kind)
        trainer.set_tracing(tracing)
        losses = trainer.train_epoch(1, _rows(ds))
        runs[tracing] = losses, _bits(trainer)
    assert runs[False][0] == runs[True][0]
    assert len(runs[False][1]) == len(runs[True][1])
    assert all(torch.equal(a, b) for a, b in zip(runs[False][1], runs[True][1]))


@pytest.mark.parametrize("kind", CONFIGS)
def test_traced_step_stamps_in_the_steps_order(kind, stamps):
    """Every step stamps its entry (``replay_gap``, charged from the
    previous step's last stamp) and then each layer in order, whatever the
    config's scrubbers; each slot is charged once a step, ``scrub_forward``
    twice, and the epoch's first stamp charges nothing."""
    trainer, ds = _build(kind)
    trainer.set_tracing(True)
    trainer.train_epoch(1, _rows(ds, steps=2))
    assert stamps == (["replay_gap"] + list(ORDER)) * 2
    counts = trainer.spans.counts
    assert counts["replay_gap"] == 1 and counts["scrub_forward"] == 4
    assert all(counts[s] == 2 for s in ORDER if s != "scrub_forward")


@pytest.mark.parametrize("kind", CONFIGS)
def test_slots_split_the_step_exactly(kind, monkeypatch):
    """One traced step: every slot at least 0, and together the span from
    the step's first stamp to its last, to the nanosecond."""
    seen = []  # each stamp's own time, as it recorded it
    orig = profiling.StepSpans.stamp

    def record(self, slot):
        orig(self, slot)
        seen.append(int(self.buf[-1]))

    monkeypatch.setattr(profiling.StepSpans, "stamp", record)
    trainer, ds = _build(kind)
    trainer.set_tracing(True)
    trainer.train_epoch(1, _rows(ds, steps=1))
    totals = trainer.spans.totals_ns
    assert len(seen) == 1 + len(ORDER) and all(v >= 0 for v in totals.values())
    assert totals["replay_gap"] == 0 and seen == sorted(seen)
    assert sum(totals.values()) == seen[-1] - seen[0]
    ms = trainer.spans.ms_per_step()
    assert ms["replay_gap"] is None
    assert sum(v for v in ms.values() if v is not None) == pytest.approx((seen[-1] - seen[0]) / 1e6)


def test_eval_and_grad_steps_stamp_nothing(stamps):
    """With tracing on, the validation epoch (its MCMI rebuild included)
    and the pre-optimizer gradient step stamp nothing."""
    trainer, ds = _build("full5", val_frames=400)
    trainer.set_tracing(True)
    trainer.test_epoch(5)
    grad_fn = trainer.make_grad_fn()
    grad_fn(trainer.state, torch.as_tensor(_rows(ds, steps=1)[0]), trainer.loss_scale_for_epoch(1))
    assert stamps == []
    trainer.train_epoch(1, _rows(ds, steps=1))
    assert stamps == ["replay_gap"] + list(ORDER)


@pytest.mark.parametrize("kind", CONFIGS)
def test_one_host_sync_a_train_epoch(kind):
    trainer, ds = _build(kind)
    for tracing in (False, True, False):
        trainer.set_tracing(tracing)
        before = trainer.host_syncs
        trainer.train_epoch(1, _rows(ds))
        assert trainer.host_syncs - before == 1


class CallGraph(graph_mod.StepGraph):
    """A stand-in for a captured step on the CPU: the capture keeps where
    the step's tensors lie, each replay calls the step."""

    def __init__(self, fn, reads, generators=()):
        self.fn, self.generators = fn, list(generators)
        self._ptrs = graph_mod.storage(reads)

    def replay(self):
        self.out = self.fn()


@pytest.mark.parametrize("kind", CONFIGS)
def test_captures_and_replays(kind, monkeypatch):
    """Graph epochs through ``CallGraph``: the first capture, none while
    what the step reads stays where it was, one after a restore moves it,
    one for another batch width (a config without MCMI, whose estimator
    holds the batch's rows) and one back, one at each switch of the
    tracing, one after the graphs are released; a replay a step after each
    capture's eager first step."""
    monkeypatch.setattr(trainer_mod, "StepGraph", CallGraph)
    monkeypatch.setattr(trainer_mod, "warm_up", lambda fn: fn())
    monkeypatch.setattr(trainer_mod, "no_host_sync", contextlib.nullcontext)
    trainer, ds = _build(kind)
    trainer.use_graphs = True
    captures = replays = 0

    def epoch(capture=False, width=16):
        nonlocal captures, replays
        trainer.train_epoch(1, _rows(ds, width=width))
        captures += capture
        replays += STEPS - capture
        assert (trainer.graph_captures, trainer.replays) == (captures, replays)

    epoch(capture=True)  # the first
    epoch()
    trainer._train_sums = {k: v.clone() for k, v in trainer._train_sums.items()}  # as a restore would
    epoch(capture=True)  # moved
    if not trainer.use_mcmi:
        epoch(capture=True, width=8)
        epoch(capture=True)  # and back
    trainer.set_tracing(True)
    epoch(capture=True)
    epoch()
    assert trainer.spans.counts["data"] == STEPS
    trainer.set_tracing(False)
    epoch(capture=True)
    trainer.set_tracing(False)  # no switch
    epoch()
    trainer.release_graphs()
    epoch(capture=True)


def test_count_syncs_off_the_card():
    """Off the card nothing is counted and warnings pass as they would."""
    with pytest.warns(UserWarning, match="kept"):
        with profiling.count_syncs("cpu") as syncs:
            warnings.warn("kept")
    assert syncs.n is None


def test_count_syncs_counts_the_sync_warnings(monkeypatch):
    """On a CUDA device: sync debug mode ``warn`` while the block runs and
    the previous mode after; each of torch's sync warnings counted, and
    every other warning passed on."""
    modes = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    with pytest.warns(UserWarning) as passed:
        with profiling.count_syncs(torch.device("cuda")) as syncs:
            for _ in range(3):
                warnings.warn(f"{profiling.SYNC_WARNING} (Triggered internally)")
            warnings.warn("kept")
    assert syncs.n == 3 and modes == ["warn", 2]
    assert [str(w.message) for w in passed] == ["kept"]


def test_host_spans_in_a_cpu_profile():
    """A train epoch's host phases in a ``torch.profiler`` session, each
    holding the operators run inside it; with no profiler running a span is
    nothing."""
    from torch.profiler import ProfilerActivity, profile

    assert isinstance(profiling.host_span("train.readback"), contextlib.nullcontext)
    trainer, ds = _build("flagship")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_epoch(1, _rows(ds))
    events = prof.events()

    def span(name):
        got = [e for e in events if e.name == name]
        assert len(got) == 1, name
        return got[0].time_range

    def inside(name, op):
        tr = span(name)
        return any(e.name == op and tr.start <= e.time_range.start and e.time_range.end <= tr.end for e in events)

    assert inside("train.loss_weights", "aten::copy_")
    assert inside("train.index_upload", "aten::lift_fresh") or inside("train.index_upload", "aten::to")
    assert inside("train.steps", "aten::convolution")
    assert inside("train.readback", "aten::cat")


def test_ms_per_step_from_the_readback():
    """Totals and counts as the readback gives them: each layer's total
    over the steps, the gap's over the gaps."""
    spans = profiling.StepSpans("cpu")
    n = len(profiling.SLOTS)
    totals = [2e6 * (i + 1) for i in range(n)]
    counts = [2.0] * n
    counts[profiling.SLOTS.index("scrub_forward")] = 4.0
    counts[profiling.SLOTS.index("replay_gap")] = 1.0
    spans.take(totals + counts)
    ms = spans.ms_per_step()
    assert ms["data"] == 1.0 and ms["scrub_forward"] == 4.0 and ms["replay_gap"] == 2.0 * n
    spans.take([0.0] * (2 * n))
    assert all(v is None for v in spans.ms_per_step().values())
