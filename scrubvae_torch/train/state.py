"""Training state carried from step to step (counterpart of
``scrubvae_tpu/train/state.py``). The model's parameters and BatchNorm
statistics live in the model, each discriminator's in its ``AdvNet``; this
holds the rest. ``tree_map`` walks such a state's layout."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from scrubvae_torch.models.scrubbers import AdvState, MIState
from scrubvae_torch.train.optim import AdamWState

__all__ = ["TrainState", "tree_map"]


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


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the leaves at the same places
    of ``rest`` (trees of ``tree``'s layout), through dicts, lists, tuples
    and dataclasses (their init fields); anything else is a leaf (tensors,
    numbers, generators, modules). Returns ``tree``'s layout with ``fn``'s
    results; a container whose leaves all come back as they were is
    returned itself, not rebuilt."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
        return tree if all(out[k] is v for k, v in tree.items()) else out
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *vs) for vs in zip(tree, *rest)]
        return tree if all(a is b for a, b in zip(out, tree)) else type(tree)(out)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree) if f.init]
        out = {n: tree_map(fn, getattr(tree, n), *(getattr(r, n) for r in rest)) for n in names}
        return tree if all(out[n] is getattr(tree, n) for n in names) else dataclasses.replace(tree, **out)
    return fn(tree, *rest)
