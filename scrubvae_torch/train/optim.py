"""AdamW through the fused kernel, the lr schedule and beta annealing
(counterpart of ``FusedAdamW``, ``make_lr_schedule``, ``cyclical_beta`` and
the adam/adamw branch of ``make_optimizer`` in
``scrubvae_tpu/train/optim.py``).

All leaves go through ``ops.fused_adamw.fused_adamw_multi``: one kernel
launch per dtype variant a step, over a ``LeafTable`` built once by
``init``; the JAX package's routing of small leaves elsewhere does not exist
here. Leaves of at least ``MIN_LOWP_ELEMS`` elements keep bf16 moments
(stochastically rounded); smaller ones keep f32 moments, so optimizer state
has the JAX package's dtypes. The step count, the lr, the bias corrections
and the optional clip factor stay on the device: a step never syncs the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Union

import torch

from scrubvae_torch.ops.fused_adamw import LeafTable, fused_adamw_multi

__all__ = ["AdamWState", "FusedAdamW", "cyclical_beta", "make_lr_schedule", "make_optimizer"]


@dataclasses.dataclass
class AdamWState:
    count: torch.Tensor  # int32 device scalar: updates applied so far
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    table: LeafTable  # the parameters and moments as the kernel sees them
    step: int = 0  # host mirror of count; the Philox counter of the rounding bits


class FusedAdamW:
    """torch-AdamW semantics (decoupled decay, bias-corrected moments) with
    the whole update of a leaf in one in-place kernel pass."""

    MIN_LOWP_ELEMS = 1 << 16

    def __init__(
        self,
        lr: Union[float, Callable[[torch.Tensor], torch.Tensor]],
        *,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        moment_dtype: torch.dtype = torch.bfloat16,
        clip_norm: Optional[float] = None,
        seed: int = 17,
    ):
        self.lr = lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.wd = weight_decay
        self.m_dtype = moment_dtype
        self.clip_norm = clip_norm
        self.seed = seed

    def _leaf_m_dtype(self, p: torch.Tensor) -> torch.dtype:
        lowp = self.m_dtype == torch.bfloat16 and p.numel() >= self.MIN_LOWP_ELEMS
        return torch.bfloat16 if lowp else torch.float32

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        mu = [torch.zeros_like(p, dtype=self._leaf_m_dtype(p)) for p in params]
        nu = [torch.zeros_like(p, dtype=self._leaf_m_dtype(p)) for p in params]
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=params[0].device),
            mu=mu,
            nu=nu,
            table=LeafTable([p.detach() for p in params], mu, nu),
        )

    def _scalars(self, count: torch.Tensor, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """[lr, 1 - b1^t, 1 - b2^t, clip factor] as one f32 device buffer."""
        t = count.float()
        b1c = 1.0 - torch.pow(self.b1, t)
        b2c = 1.0 - torch.pow(self.b2, t)
        lr = self.lr(count - 1) if callable(self.lr) else torch.full_like(t, self.lr)
        if self.clip_norm and self.clip_norm > 0:
            gn = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32))
            )
            gscale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-30), max=1.0)
        else:
            gscale = torch.ones_like(t)
        return torch.stack([lr.float(), b1c, b2c, gscale.float()])

    @torch.no_grad()
    def update_and_apply(
        self,
        grads: Sequence[Optional[torch.Tensor]],
        state: AdamWState,
        params: Sequence[torch.Tensor],
    ) -> AdamWState:
        """Update ``params`` and the moments in place; returns the new state.
        Raises if a parameter or moment no longer lies where ``init`` found
        it."""
        state.table.check_storage(params, state.mu, state.nu)
        grads = [torch.zeros_like(p) if g is None else g.contiguous() for g, p in zip(grads, params)]
        count = state.count + 1
        scal = self._scalars(count, grads)
        step = state.step + 1
        fused_adamw_multi(
            state.table, grads, scal,
            b1=self.b1, b2=self.b2, eps=self.eps, wd=self.wd, seed=self.seed, step=step,
        )
        return dataclasses.replace(state, count=count, step=step)


def cyclical_beta(epoch: int, beta_max: float = 1.0, len_cycle: int = 100, R: float = 0.5) -> float:
    """Cyclical beta annealing of the KL weight."""
    len_increasing = int(len_cycle * R)
    remainder = (epoch - 1) % len_cycle
    if remainder >= len_increasing:
        return float(beta_max)
    return float(beta_max) * remainder / len_increasing


def make_lr_schedule(lr: float, schedule: Optional[str], steps_per_epoch: int, T_0: int = 50):
    """LR as a function of the global step (a device tensor). 'cawr' =
    cosine annealing with warm restarts every ``T_0`` epochs, at fractional
    epochs."""
    if schedule is None:
        return lr
    if schedule == "cawr":

        def sched(step: torch.Tensor) -> torch.Tensor:
            e = step / steps_per_epoch
            t_cur = torch.remainder(e, T_0)
            return lr * 0.5 * (1.0 + torch.cos(math.pi * t_cur / T_0))

        return sched
    raise ValueError(f"unknown lr_schedule {schedule!r}")


def make_optimizer(train_config: dict, steps_per_epoch: int, clip_norm: float = 1e6) -> FusedAdamW:
    """The fused AdamW for optimizer adam/adamw (train.moment_dtype bf16 by
    default; train.clip_norm 0 disables the global-norm clip)."""
    lr = make_lr_schedule(
        float(train_config.get("lr") or 1e-4), train_config.get("lr_schedule"), steps_per_epoch
    )
    name = train_config.get("optimizer") or "adam"
    if name not in ("adam", "adamw") or train_config.get("fused_optimizer") is False:
        raise NotImplementedError("scrubvae_torch trains with the fused adam/adamw only")
    lowp = (train_config.get("moment_dtype") or "bf16") == "bf16"
    cn = train_config.get("clip_norm")
    if cn is None:
        cn = clip_norm
    return FusedAdamW(
        lr,
        weight_decay=0.01 if name == "adamw" else 0.0,
        moment_dtype=torch.bfloat16 if lowp else torch.float32,
        clip_norm=float(cn) if cn and float(cn) > 0 else None,
    )
