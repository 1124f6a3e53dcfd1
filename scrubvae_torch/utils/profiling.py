"""Tracing and a NaN tripwire (counterpart of
``scrubvae_tpu/utils/profiling.py``): a ``torch.profiler`` Chrome trace of a
block, the train step's spans and the epoch's host spans, an opt-in scoped
check that raises on the first NaN an operation produces (forward and
backward), and per-device memory statistics.

Step spans. A traced train step (``Trainer.set_tracing``) stamps where it
passes from one layer to the next; each stamp charges the time since the
previous one to its slot (``SLOTS``), so the stamps split the step:

- ``data``: the batch's assembly (``batch_fn``);
- ``encoder``: to the decoder's entry (pose input, encoder, Cholesky head,
  the sample);
- ``decoder``: to the end of the VAE's forward;
- ``scrub_forward``: the scrubber heads of the model's forward, and the
  losses from ``mcmi`` to ``total`` (MCMI, every scrubber's term, total
  correlation);
- ``losses``: rotation, prior, jpe and root;
- ``backward``: the gradients;
- ``optimizer``: the update, the clip included;
- ``scrub_update``: the streaming scrubbers' updates, the discriminators'
  inner fit, the MCMI rebuild, and landing the state and the sums;
- ``replay_gap``: from a step's last stamp to the next step's first, in
  one epoch.

Nested spans (``NESTED``) time a kind of block inside those slots: a
``nested_span`` opens and closes one interval and charges it to its own
total, and leaves the slots' last time alone, so the slots still split
the step and a slot's time holds the nested intervals within it. The
transformer's ``attention`` runs from an attention block's in-projection
to its out-projection, the weights' dropout included; its
``feedforward`` from ``linear1`` through the activation to ``linear2``.

On the card a stamp is a one-thread kernel (``csrc/step_spans.cu``) that
reads the GPU's ``%globaltimer``; captured in a CUDA graph it is a node of
the graph, so replays stamp with no host work. On the CPU it adds
``time.perf_counter_ns()`` deltas into a CPU buffer. A nested span's two
ends are a kernel of their own (``nested_span_kernel``, counted by
``launch_nested.launches``) or the same CPU arithmetic. Stamps and nested
spans fire only inside ``stamping``; elsewhere they do nothing.

Host spans. ``host_span`` names a phase of the host's epoch
(``torch.profiler.record_function``) while a profiler runs, and is nothing
otherwise.

Host syncs. ``count_syncs`` counts the operations of a block that make the
host wait for a CUDA device (torch's sync debug mode: a readback, a copy
from pageable memory that waits, a ``.item()``), whatever code runs them.

Solve counts. ``SolveCounts`` keeps, on the device, the number of SPD
factorizations (``ops.smallsolve.spd_factor``) made while ``counting_solves``
made it active, and the number of them whose ``info`` was non-zero: a
matrix that was not numerically positive definite at its precision. Each
factorization adds to both with device operations, so a captured step
keeps counting at every replay and the host reads them with the epoch's
other sums; elsewhere ``count_factorizations`` does nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
import warnings
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from scrubvae_torch.utils.cuda_build import CudaLibrary, counted

__all__ = [
    "NESTED", "SLOTS", "STAMP_LIBRARY", "SolveCounts", "StepSpans", "SyncCount", "count_factorizations",
    "count_syncs", "counting_solves", "debug_nans", "device_memory_stats", "host_span", "launch_nested",
    "launch_stamp", "nested_span", "stamp", "stamping", "trace",
]

SLOTS = ("data", "encoder", "decoder", "scrub_forward", "losses", "backward", "optimizer", "scrub_update",
         "replay_gap")
NESTED = ("attention", "feedforward")
STAMP_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "step_spans.cu"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.span_stamp_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # buf n_slots slot stream
    fn.restype = ctypes.c_int
    fn = lib.nested_span_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # buf n span close stream
    fn.restype = ctypes.c_int


STAMP_LIBRARY = CudaLibrary(STAMP_SOURCE, _bind)


@contextlib.contextmanager
def trace(log_dir: str = "./build/trace"):
    """Profile the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity when a GPU is present) and write it as a Chrome trace,
    ``{log_dir}/trace.json``. Yields the trace file's path."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir) / "trace.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield str(out)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out))


@counted
def launch_stamp(buf: torch.Tensor, slot: int) -> None:
    """One stamp kernel into ``buf`` (``StepSpans.buf``) for slot index
    ``slot``, on the current stream. ``launches`` counts the launches; one
    recorded while a CUDA graph is captured counts once for each replay
    (``train.graph.StepGraph``), not at the capture."""
    if buf.device.type != "cuda" or buf.dtype != torch.int64 or buf.shape != (2 * len(SLOTS) + 1,):
        raise ValueError(f"launch_stamp: buf must be {2 * len(SLOTS) + 1} int64 words on a CUDA device")
    if not 0 <= slot < len(SLOTS):
        raise ValueError(f"launch_stamp: no slot {slot}")
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    STAMP_LIBRARY.launch("span_stamp_launch", buf.data_ptr(), len(SLOTS), slot, stream)
    launch_stamp.launches += 1


@counted
def launch_nested(buf: torch.Tensor, span: int, close: bool) -> None:
    """One nested-span kernel into ``buf`` (``StepSpans.nested_buf``),
    opening or closing span index ``span``, on the current stream.
    ``launches`` counts the launches as ``launch_stamp.launches`` does."""
    if buf.device.type != "cuda" or buf.dtype != torch.int64 or buf.shape != (3 * len(NESTED),):
        raise ValueError(f"launch_nested: buf must be {3 * len(NESTED)} int64 words on a CUDA device")
    if not 0 <= span < len(NESTED):
        raise ValueError(f"launch_nested: no span {span}")
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    STAMP_LIBRARY.launch("nested_span_launch", buf.data_ptr(), len(NESTED), span, int(close), stream)
    launch_nested.launches += 1


class StepSpans:
    """The train step's spans on ``device``: ``buf`` holds each slot's
    total in nanoseconds, each slot's count of charges, and the time of the
    last stamp (int64, ``2 * len(SLOTS) + 1``); ``nested_buf`` each nested
    span's total, its count and the time it was last opened (int64,
    ``3 * len(NESTED)``); ``totals_ns``, ``counts``, ``nested_totals_ns``
    and ``nested_counts`` are the last readback's."""

    def __init__(self, device):
        self.buf = torch.zeros(2 * len(SLOTS) + 1, dtype=torch.int64, device=device)
        self.nested_buf = torch.zeros(3 * len(NESTED), dtype=torch.int64, device=device)
        self.totals_ns: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}
        self.nested_totals_ns: Dict[str, int] = {}
        self.nested_counts: Dict[str, int] = {}

    def start_epoch(self) -> None:
        """Zero the totals, the counts and the last time (a fill on the
        current stream: the host waits for nothing), so the epoch's first
        stamp charges nothing."""
        self.buf.zero_()
        self.nested_buf.zero_()

    def stamp(self, slot: str) -> None:
        """Charge the time since the previous stamp to ``slot``."""
        i = SLOTS.index(slot)
        if self.buf.is_cuda:
            launch_stamp(self.buf, i)
            return
        now, n = time.perf_counter_ns(), len(SLOTS)
        prev = int(self.buf[2 * n])
        if prev:
            self.buf[i] += now - prev
            self.buf[n + i] += 1
        self.buf[2 * n] = now

    def nest(self, span: str, close: bool) -> None:
        """Open nested ``span``, or close it and charge it the time since."""
        i = NESTED.index(span)
        if self.nested_buf.is_cuda:
            launch_nested(self.nested_buf, i, close)
            return
        now, m = time.perf_counter_ns(), len(NESTED)
        if close:
            self.nested_buf[i] += now - int(self.nested_buf[2 * m + i])
            self.nested_buf[m + i] += 1
        else:
            self.nested_buf[2 * m + i] = now

    @property
    def sums(self) -> torch.Tensor:
        """The slots' totals and counts, then the nested spans': what the
        epoch's readback carries."""
        return torch.cat([self.buf[: 2 * len(SLOTS)], self.nested_buf[: 2 * len(NESTED)]])

    def take(self, values: Sequence[float]) -> None:
        """Keep the readback's values of ``sums`` (the nested spans' taken
        as 0 where ``values`` holds the slots' alone)."""
        n, m = len(SLOTS), len(NESTED)
        self.totals_ns = {s: int(values[i]) for i, s in enumerate(SLOTS)}
        self.counts = {s: int(values[n + i]) for i, s in enumerate(SLOTS)}
        nested = list(values[2 * n: 2 * n + 2 * m]) or [0] * (2 * m)
        self.nested_totals_ns = {s: int(nested[i]) for i, s in enumerate(NESTED)}
        self.nested_counts = {s: int(nested[m + i]) for i, s in enumerate(NESTED)}

    def ms_per_step(self) -> Dict[str, Optional[float]]:
        """Each slot's milliseconds a step over the last read epoch: its
        total over the steps (the charges of ``data``, one a step), and
        ``replay_gap``'s over the gaps; None where nothing was charged."""
        steps = self.counts.get("data", 0)
        out = {}
        for s in SLOTS:
            count = self.counts.get(s, 0) if s == "replay_gap" else steps
            out[s] = self.totals_ns.get(s, 0) / count / 1e6 if count else None
        return out

    def nested_ms_per_step(self) -> Dict[str, Optional[float]]:
        """Each nested span's milliseconds a step over the last read epoch,
        over the steps as ``ms_per_step`` counts them; None where it was
        never closed."""
        steps = self.counts.get("data", 0)
        return {s: self.nested_totals_ns.get(s, 0) / steps / 1e6 if steps and self.nested_counts.get(s) else None
                for s in NESTED}


_active: Optional[StepSpans] = None


def stamp(slot: str) -> None:
    """Charge the time since the previous stamp to ``slot`` of the spans
    that ``stamping`` made active; nothing outside it."""
    if _active is not None:
        _active.stamp(slot)


@contextlib.contextmanager
def nested_span(name: str):
    """Time the block as nested span ``name`` of the spans that
    ``stamping`` made active; nothing outside it."""
    spans = _active
    if spans is None:
        yield
        return
    spans.nest(name, close=False)
    yield
    spans.nest(name, close=True)


@contextlib.contextmanager
def stamping(spans: StepSpans):
    """Make ``spans`` the one that ``stamp`` charges while the block runs."""
    global _active
    prev, _active = _active, spans
    try:
        yield
    finally:
        _active = prev


class SolveCounts:
    """The SPD factorizations counted on ``device`` (the module docstring):
    ``buf`` holds their number and the number not positive definite
    (int64, running totals, never reset); ``spd_factorizations`` and
    ``spd_not_pd`` are the last readback's."""

    def __init__(self, device):
        self.buf = torch.zeros(2, dtype=torch.int64, device=device)
        self.spd_factorizations = 0
        self.spd_not_pd = 0

    def count(self, info: torch.Tensor) -> None:
        """Add the factorizations of one call, whose ``info`` (one entry a
        matrix) is non-zero where the matrix was not positive definite."""
        self.buf[0].add_(info.numel())
        self.buf[1].add_(torch.count_nonzero(info))

    def take(self, values: Sequence[float]) -> int:
        """Keep the readback's values of ``buf``; returns the factorizations
        not positive definite since the previous readback."""
        new = int(values[1]) - self.spd_not_pd
        self.spd_factorizations, self.spd_not_pd = int(values[0]), int(values[1])
        return new


_counting: Optional[SolveCounts] = None


def count_factorizations(info: torch.Tensor) -> None:
    """Count one factorization call (``SolveCounts.count``) into the counts
    that ``counting_solves`` made active; nothing outside it."""
    if _counting is not None:
        _counting.count(info)


@contextlib.contextmanager
def counting_solves(counts: SolveCounts):
    """Make ``counts`` the one that ``count_factorizations`` adds to while
    the block runs."""
    global _counting
    prev, _counting = _counting, counts
    try:
        yield
    finally:
        _counting = prev


def host_span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler runs; a
    context that does nothing otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


# the warning torch's sync debug mode gives for each synchronizing CUDA operation
SYNC_WARNING = "called a synchronizing CUDA operation"


class SyncCount:
    """What ``count_syncs`` counted: ``n`` host syncs, None off the card."""

    n: Optional[int] = None


@contextlib.contextmanager
def count_syncs(device):
    """Count the block's host syncs on a CUDA ``device`` (the module
    docstring) into the yielded ``SyncCount``; off the card nothing is
    counted. Other warnings of the block are passed on after it."""
    out = SyncCount()
    if torch.device(device).type != "cuda":
        yield out
        return
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    out.n = sum(SYNC_WARNING in str(w.message) for w in seen)
    for w in seen:
        if SYNC_WARNING not in str(w.message):
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)


class _NanCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` after the first operation whose
    floating-point output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()) and bool(t.isnan().any()):
                raise FloatingPointError(f"debug_nans: {func} produced a NaN")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Opt-in NaN tripwire, the counterpart of ``jax_debug_nans``: inside
    the block every operation's output is checked, those of the backward
    pass included, and the first NaN raises ``FloatingPointError`` naming
    the operation; autograd's anomaly mode adds the forward call whose
    backward made it. Scoped and off by default: each check costs a device
    sync. The previous anomaly-mode state is restored on exit."""
    if not enable:
        yield
        return
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        with _NanCheck():
            yield
    finally:
        torch.autograd.set_detect_anomaly(*prev)


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of every CUDA device, keyed by the
    device's name and index (empty without a GPU)."""
    if not torch.cuda.is_available():
        return {}
    return {
        f"cuda:{i} {torch.cuda.get_device_name(i)}": torch.cuda.memory_stats(i)
        for i in range(torch.cuda.device_count())
    }
