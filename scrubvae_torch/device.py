"""Device selection for the port's entry points, and constants kept on a
device."""

from __future__ import annotations

import functools
import os
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "trace_safe_cache", "device_constant", "cached_constant"]


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; ``None`` means ``"cuda"``,
    and a CUDA device without an index is this rank's card, ``cuda:LOCAL_RANK``
    under a launcher that sets ``LOCAL_RANK`` (``torchrun``), else the
    current one (``cuda:0``), as a tensor placed there reports it. Ranks
    that share a card name it (``cuda:0``).

    Nothing falls back to the CPU on its own: asking for CUDA without a GPU
    raises, and CPU runs must pass ``device="cpu"`` explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "scrubvae_torch: CUDA was requested but no GPU is available; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None else torch.cuda.current_device())
    return dev


def trace_safe_cache(fn):
    """``functools.lru_cache`` for a function that builds tensors, bypassed
    while ``torch.export`` or ``torch.compile`` traces: a trace runs on fake
    tensors, and a fake tensor left in the cache would stand in for the real
    one in every later eager call. Eager calls keep the cached tensors, so a
    train step copies no index to the device."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def wrapper(*args):
        return fn(*args) if torch.compiler.is_compiling() else cached(*args)

    wrapper.cache_clear = cached.cache_clear
    return wrapper


def device_constant(x, device) -> torch.Tensor:
    """``x`` (an array or a sequence of numbers) as a tensor on ``device``;
    to a card through pinned memory, a copy that does not wait for the
    device: the caches fill inside a step's first call, which must not
    synchronise with the host (a captured step's warm-up)."""
    device = torch.device(device)
    if device.type != "cuda" or torch.compiler.is_compiling():
        return torch.as_tensor(x, device=device)
    return torch.as_tensor(x).pin_memory().to(device, non_blocking=True)


def cached_constant(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The array ``a`` on ``device`` (cast to ``dtype`` on the host first,
    where given), copied there once and kept: a step indexes and scales
    with it without a copy from the host, which a CUDA graph could not
    capture."""
    a = np.ascontiguousarray(a)
    return _constant(a.tobytes(), a.dtype.str, a.shape, torch.device(device), dtype)


@trace_safe_cache
def _constant(raw: bytes, dt: str, shape: tuple, device: torch.device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.frombuffer(raw, dtype=dt).reshape(shape).copy())
    return device_constant(t if dtype is None else t.to(dtype), device)
