"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; ``None`` means ``"cuda"``,
    and a CUDA device without an index is the current one (``cuda:0``), as
    a tensor placed there reports it.

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
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
