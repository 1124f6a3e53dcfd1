"""Training state carried from step to step (counterpart of
``scrubvae_tpu/train/state.py``). Parameters and BatchNorm statistics live
in the model; this holds the rest."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from scrubvae_torch.train.optim import AdamWState

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    step: int
    opt_state: AdamWState
    scrub_state: Dict[str, Dict[str, Any]]
    generator: torch.Generator  # draws the reparameterisation noise

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)
