"""Bounded retry of transient failures of the build and the backend
(counterpart of ``scrubvae_tpu/utils/retry.py``, with its policy and names).

What fails and then recovers on this stack:

- ``nvcc`` killed by a signal (a negative return code: the machine's memory
  or a time limit), or a build file busy while another process writes or
  runs it (``ops/fused_adamw.py`` ``build``);
- a process-group rendezvous that times out or finds its store not yet
  listening (``torch.distributed.init_process_group``).

What is never retried: running out of device memory; an illegal memory
access or a device-side assert, which are sticky and poison the context;
``nvcc`` rejecting the source; shape and dtype errors; a failed CUDA
initialisation, which torch keeps for the life of the process (so unlike
``jax.clear_backends`` there is nothing to reset in place: the reset below
drops the kernel's library handle and empties the caching allocator, no
more).

A retry repeats the same call on the same device: it never falls back to
the CPU or to a kernel's plain version. Every retry prints one line to
stderr naming the error and the attempt, and after the last attempt the
original exception propagates, so the process exits non-zero.
"""

from __future__ import annotations

import re
import sys
import time
from typing import Callable, TypeVar

__all__ = ["is_transient_backend_error", "with_backend_retry", "retry_build"]

T = TypeVar("T")

_TRANSIENT = re.compile(
    r"nvcc killed by signal"
    r"|Text file busy"
    r"|Device or resource busy"
    r"|DistStoreError"
    r"|Timed out after \d+ seconds waiting for clients"
    r"|[Ss]ocket [Tt]imeout"
    r"|[Cc]onnection (?:reset|refused)"
    r"|[Rr]endezvous.*timed out",
)
# sticky or programming errors, never retried whatever else their text says
_FATAL = re.compile(
    r"out of memory"
    r"|illegal memory access"
    r"|device-side assert"
    r"|CUDA \w+ initialization failed"
    r"|CUDA error: initialization error"
    r"|[Nn]o CUDA GPUs are available"
    r"|cudaErrorInitializationError"
    r"|nvcc failed",
)


def is_transient_backend_error(exc: BaseException) -> bool:
    """True when the exception's text matches a known-transient failure of
    this stack (retry-worthy), False for everything else (a real bug, or a
    failure that poisons the process)."""
    text = f"{type(exc).__name__}: {exc}"
    return not _FATAL.search(text) and bool(_TRANSIENT.search(text))


def _reset_backend() -> None:
    """Drop the kernels' library handles (the next call loads each build
    again) and return the caching allocator's free blocks."""
    import torch

    from scrubvae_torch.utils import cuda_build

    cuda_build.drop_all()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def with_backend_retry(
    fn: Callable[[], T],
    retries: int = 3,
    base_delay: float = 10.0,
    reset_backend: bool = True,
    sleep: Callable[[float], None] = time.sleep,
) -> T:
    """Call ``fn()`` with up to ``retries`` retries on transient errors,
    exponential backoff (``base_delay * 2**attempt``) and, with
    ``reset_backend``, ``_reset_backend`` between attempts. Non-transient
    errors and the last transient failure propagate unchanged."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — filtered by pattern below
            if attempt >= retries or not is_transient_backend_error(e):
                raise
            delay = base_delay * (2**attempt)
            print(
                f"transient error (attempt {attempt + 1}/{retries + 1}), retrying in {delay:.0f}s: "
                f"{type(e).__name__}: {str(e)[:200]}",
                file=sys.stderr, flush=True,
            )
            sleep(delay)
            if reset_backend:
                _reset_backend()
    raise AssertionError("unreachable")


def retry_build(build: Callable[[], T], retries: int = 2, base_delay: float = 15.0, **kw) -> T:
    """``build()`` (a kernel's ``nvcc`` build) under the transient-failure
    policy, without a reset: nothing is loaded yet."""
    kw.setdefault("reset_backend", False)
    return with_backend_retry(build, retries=retries, base_delay=base_delay, **kw)
