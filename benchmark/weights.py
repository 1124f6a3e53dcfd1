"""The start weights of a run, made by the benchmark on the device from the
seed and handed to the measured program and to the reference alike.

The kernels take flax's lecun-normal init (a normal truncated at two
standard deviations, of variance 1 / fan-in), drawn in one call for all
of a model's kernels and scaled in one more; biases and BatchNorm shifts
are 0, BatchNorm scales 1, PReLU slopes 0.25. A leaf that the
configuration stores in bf16 reaches the reference rounded as the program
stores it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.model import init_kinds, lecun_std

# the configurations' bf16 storage applies to leaves of at least this many elements
LOWP_MIN_ELEMS = 1 << 16


def derived_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for ``stream`` (weights, discriminators, rows)."""
    return int(np.random.SeedSequence([int(seed), stream]).generate_state(1, np.uint64)[0]) >> 1


@torch.no_grad()
def make(model: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 start values of ``model``'s parameters by name (the model may
    live on the meta device: only names, shapes and kinds are read)."""
    kinds = init_kinds(model)
    kernels = [(n, p.shape, fan) for n, p, kind, fan in kinds if kind == "kernel"]
    numels = [int(np.prod(s)) for _, s, _ in kernels]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(numels), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, std=1.0, a=-2.0, b=2.0, generator=gen)
    stds = torch.tensor([lecun_std(f) for _, _, f in kernels], dtype=torch.float32, device=device)
    flat.mul_(torch.repeat_interleave(stds, torch.tensor(numels, device=device)))
    out = {n: w.view(s) for (n, s, _), w in zip(kernels, torch.split(flat, numels))}
    fills = {"zero": 0.0, "one": 1.0, "prelu": 0.25}
    for n, p, kind, _ in kinds:
        if kind in fills:
            out[n] = torch.full(p.shape, fills[kind], dtype=torch.float32, device=device)
    return out


def as_stored(weights: Dict[str, torch.Tensor], lowp: bool) -> Dict[str, torch.Tensor]:
    """``weights`` as the configuration stores them, back in f32: rounded to
    bf16 (to nearest) where ``lowp`` and the leaf is large enough."""
    return {n: w.to(torch.bfloat16).float() if lowp and w.numel() >= LOWP_MIN_ELEMS else w for n, w in weights.items()}


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters by name, in place (the
    storage the program's optimizer recorded stays where it is)."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise KeyError(f"leaves differ by name: {sorted(set(params) ^ set(weights))[:6]}")
    for n, p in params.items():
        if tuple(p.shape) != tuple(weights[n].shape):
            raise ValueError(f"leaf {n}: {tuple(p.shape)} against {tuple(weights[n].shape)}")
        p.copy_(weights[n])
