"""CUDA graphs of the train and eval steps: the port's counterpart of the
JAX package's scanned epochs (``make_train_epoch`` and ``make_eval_epoch``
under ``train.scan_epoch``), which run an epoch as one program.

A ``StepGraph`` captures one call of a step function in a
``torch.cuda.CUDAGraph`` (in a memory pool of its own) and replays it,
one launch of the whole step from the host. A graph reads and writes the
addresses it captured, so the step must carry its state in place
(``train.step.make_inplace_step``), read its inputs from static buffers and
allocate nothing it keeps; ``valid`` says whether every tensor the step
reads still lies where it was captured (a state that was replaced, by a
checkpoint's restore or an MCMI refresh, needs a new capture). A
generator the step draws from is registered with the graph, so each replay
draws what the next eager step would draw and advances it as that step
would. A capture runs no kernel: the launch counts of the kernel
wrappers declared with ``utils.cuda_build.counted`` take the launches it
recorded at each replay instead, and ``advance_counts`` moves a train
state's host step counts on by the replays.

Capture needs a step free of host synchronisation: ``StepGraph`` raises
on any operation that cannot be captured, and nothing falls back to
eager steps.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Callable, Dict, Iterable, List, Sequence

import torch
from torch import nn

from scrubvae_torch.train.state import tree_map
from scrubvae_torch.utils.cuda_build import launch_counts

__all__ = ["StepGraph", "advance_counts", "capturable_linalg", "no_host_sync", "side_stream", "storage", "warm_up"]


def storage(objs: Iterable) -> List[int]:
    """The data pointer of every tensor in ``objs``, in a fixed order:
    through dataclasses, dicts, lists and tuples (``tree_map``), modules
    (parameters and buffers) and the tensors themselves."""
    out: List[int] = []

    def visit(o):
        if isinstance(o, torch.Tensor):
            out.append(o.data_ptr())
        elif isinstance(o, nn.Module):
            out.extend(t.data_ptr() for t in itertools.chain(o.parameters(), o.buffers()))
        return o

    tree_map(visit, list(objs))
    return out


def advance_counts(now, before, after, times: int):
    """``now`` with every int field moved on by ``times`` times the step
    from ``before`` to ``after`` (three states of one layout): the host
    step counts of ``times`` replays of a captured step."""

    def advance(n, b, a):
        return n + (a - b) * times if isinstance(n, int) and not isinstance(n, bool) else n

    return tree_map(advance, now, before, after)


@contextlib.contextmanager
def capturable_linalg():
    """Route torch's CUDA linear algebra to cuSOLVER and cuBLAS while the
    block runs (``torch.backends.cuda.preferred_linalg_library``, restored
    after): by default torch sends some small batched solves to MAGMA,
    whose routines wait on the host and cannot be captured. Under it the
    scrubbers' Cholesky factors (``ops.smallsolve``: ``cholesky_ex``,
    forward and backward) run on cuSOLVER and their triangular solves on
    cuBLAS, and so does the pivoted LU of ``linalg.solve`` where a step
    still calls it (RLS). The trainer's eager epochs take the same route,
    so that a graph and an eager epoch compute the same bits."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


@contextlib.contextmanager
def no_host_sync():
    """Make any operation that waits for the device (a copy to the host,
    ``.item()``, a synchronising copy from it) raise while the block runs
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


_SIDE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def side_stream() -> torch.cuda.Stream:
    """The current device's one side stream, on which every warm-up runs and
    every graph is captured. cuBLAS keeps a workspace for each stream it
    has run on until the process ends: a new stream a warm-up would leave
    one behind each time, and a stream first met inside a capture would
    take its workspace from the graph's pool and keep the pool alive after
    the graph is released."""
    dev = torch.cuda.current_device()
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[dev]


def warm_up(fn: Callable):
    """``fn()`` on ``side_stream()``, which the current stream then waits
    for: the eager call that precedes a capture (it sets up the libraries'
    per-stream handles and workspaces, and fills the index caches)."""
    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    return out


class StepGraph:
    """``fn()`` captured in a CUDA graph: ``out`` is what the capture
    returned (tensors in the graph's pool, rewritten by each replay).
    ``reads`` is what the step reads and writes (tensors, modules,
    states); ``generators`` are the generators it draws from (the default
    CUDA generator is registered by torch itself).

    ``launches`` maps each counted kernel wrapper (``cuda_build.counted``)
    to the launches the capture recorded; it covers the wrappers declared
    when the capture begins. A wrapper is declared when its module is
    imported, which the models and the optimizer do at their top."""

    def __init__(self, fn: Callable, reads: Sequence, generators: Sequence[torch.Generator] = ()):
        self.generators = list(generators)
        self.graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            self.graph.register_generator_state(g)
        before = launch_counts()
        with torch.cuda.graph(self.graph, stream=side_stream()):
            self.out = fn()
        # a capture records the kernels and launches none
        self.launches = {c: c.launches - b for c, b in before.items()}
        for c, b in before.items():
            c.launches = b
        self._ptrs = storage(reads)

    def valid(self, reads: Sequence, generators: Sequence[torch.Generator]) -> bool:
        """Whether every tensor of ``reads`` (the layout the capture was
        given) lies where it was captured and ``generators`` are the ones
        registered."""
        if [id(g) for g in generators] != [id(g) for g in self.generators]:
            return False
        return storage(reads) == self._ptrs

    def replay(self) -> None:
        """One launch of the captured step; the kernel wrappers' launch
        counts take the launches it recorded."""
        self.graph.replay()
        for c, n in self.launches.items():
            c.launches += n
