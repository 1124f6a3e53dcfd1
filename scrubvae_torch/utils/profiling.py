"""Tracing, timing and a NaN tripwire (counterpart of
``scrubvae_tpu/utils/profiling.py``): a ``torch.profiler`` Chrome trace of a
block, a wall-clock step timer, an opt-in scoped check that raises on the
first NaN an operation produces (forward and backward), and per-device
memory statistics.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["trace", "StepTimer", "debug_nans", "device_memory_stats"]


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


class StepTimer:
    """Wall-clock step/epoch timing with steady-state rate reporting."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.steps = 0

    def start(self):
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n: int = 1):
        self.steps += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - (self.t0 or time.perf_counter())

    def rate(self, per: int = 1) -> float:
        e = self.elapsed
        return (self.steps * per) / e if e > 0 else 0.0


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
