"""Training state carried from step to step (counterpart of
``scrubvae_tpu/train/state.py``). The model's parameters and BatchNorm
statistics live in the model, each discriminator's in its ``AdvNet``; this
holds the rest."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from scrubvae_torch.models.scrubbers import AdvState, MIState
from scrubvae_torch.train.optim import AdamWState

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    step: int
    opt_state: AdamWState
    scrub_state: Dict[str, Dict[str, Any]]
    generator: torch.Generator  # draws the sample noise and the adversarial shuffles
    adv_states: Dict[str, AdvState] = dataclasses.field(default_factory=dict)
    mi_state: Optional[MIState] = None

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)
