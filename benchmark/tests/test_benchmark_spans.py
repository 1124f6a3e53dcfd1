"""The readers of the program's spans and counters (``benchmark.spans``,
``metrics/<quantity>.py``): on the CPU a small traced run and stand-in
trainers; on the card (``card``) the metrics in a traced run's line, the
slots against the traced epoch's host seconds, the stamps against the
profiler's timeline, and tracing on and off training alike, bit for bit."""

import itertools
import json
import math
import os
import pathlib
import subprocess
import sys
import types
import warnings

import pytest
import torch

from benchmark import manifest, run, spans
from scrubvae_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[2]
SLOTS = ("data", "encoder", "decoder", "scrub_forward", "losses", "backward", "optimizer", "scrub_update",
         "replay_gap")
QUANTITIES = tuple(f"{s}_ms" for s in SLOTS) + ("host_syncs_per_epoch", "replays_pct")
CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]
SEED = 2**31 + 11
# kernels_per_step of each cell as PERF_LEDGER.jsonl has it since the SPD
# solves went to one Cholesky factor: the untraced graph holds no stamp
KERNELS = {"flagship.b512": 2581.8, "full5.b512": 4036.1}


def span_metrics(cell: str) -> list:
    return [m["name"] for m in manifest.reported(cell, True) if m["name"].split(".")[0] in QUANTITIES]


def test_every_cell_reports_every_quantity():
    for cell in CELLS:
        assert sorted(n.split(".")[0] for n in span_metrics(cell)) == sorted(QUANTITIES)
        assert all(manifest.metric_reader(n)(types.SimpleNamespace(trainer=object())) is None
                   for n in span_metrics(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_readers_on_a_small_traced_run(cell):
    """Every per-layer reader of the cell on the program after a small
    set-up on the CPU: a number or None. The replays read (no graph to
    replay there); the device ms and the host syncs are left out."""
    su = run.set_up(cell, SEED, "cpu", small=True)
    view = run.RunView(su.sections, su.batch, 1, 1.0, 1.0, su.flops, None, None, None, su.trainer, su.leaf_numels)
    got = {m["name"]: manifest.metric_reader(m["name"])(view) for m in manifest.reported(cell, True)}
    assert all(v is None or (isinstance(v, (int, float)) and math.isfinite(v)) for v in got.values())
    got = {n: v for n, v in got.items() if v is not None}
    assert sorted(got) == [n for n in span_metrics(cell) if n.split(".")[0] == "replays_pct"]
    assert list(got.values()) == [0.0]
    assert not su.trainer.tracing


class _Spans:
    counts = {"data": 4}

    def ms_per_step(self):
        return {s: float(i) for i, s in enumerate(SLOTS)}


class _Trainer:
    """What ``spans.measure`` reads of a trainer, counting its epochs."""

    device = torch.device("cuda")
    steps_per_epoch = 4

    def __init__(self):
        self.replays = 0
        self.epochs, self.tracing, self.spans = [], False, _Spans()

    def set_tracing(self, on):
        self.tracing = on

    def train_epoch(self, epoch):
        self.epochs.append(self.tracing)
        warnings.warn(profiling.SYNC_WARNING)  # as torch's sync debug mode warns of the readback
        self.replays += 4


def test_readers_measure_once_a_run(monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    trainer = _Trainer()
    view = types.SimpleNamespace(trainer=trainer)
    got = {q: manifest.metric_reader(q)(view) for q in QUANTITIES}
    assert trainer.epochs == [False, True, True] and not trainer.tracing and modes == ["warn", 0]
    assert got == {**{f"{s}_ms": float(i) for i, s in enumerate(SLOTS)}, "host_syncs_per_epoch": 1,
                   "replays_pct": 100.0}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_traced_line_reports_the_spans(cell):
    _card()
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", str(SEED),
                          "--seconds", "3", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    print(cell, json.dumps({n: metrics.get(n) for n in span_metrics(cell) + [n for n in metrics if "kernels" in n]}))
    assert result["correct"] and set(span_metrics(cell)) <= set(metrics)
    sfx = next(n for n in span_metrics(cell) if n.split(".")[0] == "replays_pct")[len("replays_pct"):]
    assert metrics["host_syncs_per_epoch" + sfx] == 1 and metrics["replays_pct" + sfx] == 100.0
    if cell in KERNELS:
        assert abs(metrics["kernels_per_step" + sfx] - KERNELS[cell]) <= 1.0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_spans_on_the_card(cell):
    """After the cell's set-up: the nine slots' ms a step times the steps
    within 3% of the traced epoch's host seconds; a stamp kernel a stamp of
    a traced step and none in an untraced one; and in one traced replay
    under the profiler, every stamp whose own time the buffer gives (all
    but the two around the losses' slot, since the two scrub_forward
    charges share one total) one constant from its kernel's start in the
    device trace, within 2 us."""
    _card()
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace
    from scrubvae_torch.utils.profiling import launch_stamp

    su = run.set_up(cell, SEED, "cuda")
    trainer = su.trainer
    before = launch_stamp.launches
    got = spans.measure(trainer)
    print(cell, json.dumps(got))
    total_s = sum(got["ms"].values()) * got["steps"] / 1e3
    assert abs(total_s / got["traced_epoch_s"] - 1.0) < 0.03
    assert got["host_syncs_per_epoch"] == 1 and got["replays_pct"] == 100.0
    # two traced epochs: the capture's eager first step and the replays, ten stamps each
    assert launch_stamp.launches - before == 10 * 2 * trainer.steps_per_epoch
    before = launch_stamp.launches
    trainer.train_epoch(2)
    assert launch_stamp.launches == before

    B = trainer.batch_size
    rows = np.arange(3 * B).reshape(3, B)
    trainer.set_tracing(True)
    trainer.train_epoch(2, rows[:2])  # the eager first step and the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_epoch(2, rows[2:])  # one replay
        torch.cuda.synchronize()
    buf = trainer.spans.buf.cpu().tolist()
    run.free_program(su)
    n = len(SLOTS)
    tot = dict(zip(SLOTS, buf[:n]))
    last = buf[2 * n]
    first = last - sum(tot.values())
    # the stamps in order: the gap's, data, encoder, decoder, scrub_forward,
    # losses, scrub_forward, backward, optimizer, scrub_update
    head = list(itertools.accumulate([first, tot["data"], tot["encoder"], tot["decoder"]]))
    tail = list(itertools.accumulate([last, -tot["scrub_update"], -tot["optimizer"], -tot["backward"]]))[::-1]
    known = dict(zip([0, 1, 2, 3, 6, 7, 8, 9], head + tail))
    kernels = sorted((e for e in trace.from_profiler(prof) if e["device"] and "span_stamp" in e["name"]),
                     key=lambda e: e["start"])
    assert len(kernels) == 10
    offsets = [known[i] / 1e3 - kernels[i]["start"] for i in known]
    print(cell, "stamp offsets from the trace (us):", [round(o - offsets[0], 3) for o in offsets])
    span_us = (known[9] - known[0]) / 1e3
    print(cell, "the trace's clock against the stamps' over", round(span_us, 1), "us (ppm):",
          round(((kernels[9]["start"] - kernels[0]["start"]) / span_us - 1) * 1e6, 1))
    assert max(offsets) - min(offsets) <= 2.0


THREE_STEPS = """
import hashlib, json, sys, torch
torch.use_deterministic_algorithms(True)
from benchmark import program, run
from scrubvae_torch.train.state import tree_map
cell, seed, tracing = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
build = program.build
def traced(*a, **k):
    trainer, ds = build(*a, **k)
    trainer.set_tracing(tracing)
    return trainer, ds
program.build = traced
su = run.set_up(cell, seed, "cuda")
h = hashlib.sha256()
def visit(o):
    if isinstance(o, torch.nn.Module):
        for t in list(o.parameters()) + list(o.buffers()):
            h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    elif isinstance(o, torch.Tensor):
        h.update(o.detach().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    elif isinstance(o, torch.Generator):
        h.update(o.get_state().numpy().tobytes())
    elif isinstance(o, int) and not isinstance(o, bool):
        h.update(str(o).encode())
    return o
tree_map(visit, [su.trainer.model, su.trainer.state])
print(json.dumps({"loss": su.readings["loss"], "state": h.hexdigest(), "tracing": su.trainer.tracing}))
"""


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_tracing_on_and_off_train_alike_on_the_card(cell):
    """The cell's first three steps (one eager, the capture's eager first,
    a replay) traced and not, under deterministic algorithms: the same
    losses and the same model and train state, bit for bit."""
    _card()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    got = {}
    for tracing in ("0", "1"):
        out = subprocess.run([sys.executable, "-c", THREE_STEPS, cell, str(SEED), tracing], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        got[tracing] = json.loads(out.stdout.strip().splitlines()[-1])
    print(cell, json.dumps(got))
    assert got["1"]["tracing"] and not got["0"]["tracing"]
    assert got["0"]["loss"] == got["1"]["loss"] and got["0"]["state"] == got["1"]["state"]
