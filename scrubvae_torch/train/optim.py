"""The optimizers, the lr schedule and beta annealing (counterpart of
``FusedAdamW``, ``scale_by_adam_lowp``, ``make_lr_schedule``,
``cyclical_beta`` and ``make_optimizer`` in ``scrubvae_tpu/train/optim.py``).

``make_optimizer`` returns, by ``train.optimizer`` and
``train.fused_optimizer``:

- adam/adamw (the default): ``FusedAdamW``, the hand-written kernel;
- adam/adamw with ``fused_optimizer: false``: ``AdamLowp``, the JAX
  package's optax chain ``scale_by_adam_lowp`` (then
  ``add_decayed_weights(0.01)`` for adamw) and ``scale_by_learning_rate``,
  as plain torch ops, under optax's global-norm clip;
- sgd: ``SGD``, optax's ``sgd(lr, momentum=0.2, nesterov=True)`` under the
  same clip.

The two optax counterparts are separate optimizers that a config picks;
they never stand in for the kernel. All three share the interface
``init(params, shards=None, group=None) -> state`` and
``update_and_apply(grads, state, params) -> state``, updating the
parameters in place.

On a model-parallel mesh (``parallel.mesh``) some parameters are a rank's
rows of a split leaf: ``shards[i]`` is ``(first element, whole leaf's
numel)`` for those (``mesh.leaf_shards``), and ``group`` the ranks that
hold the other slices. Such a slice keeps the whole leaf's moment dtype
and rounding bits (the kernel draws them from the slice's offset), and the
global-norm clip adds the slices' squared norms over ``group`` once.

All leaves go through ``ops.fused_adamw.fused_adamw_multi``: one kernel
launch per dtype variant a step, over a ``LeafTable`` built once by
``init``; the JAX package's routing of small leaves elsewhere does not exist
here. Leaves of at least ``MIN_LOWP_ELEMS`` elements keep bf16 moments
(stochastically rounded); smaller ones keep f32 moments, so optimizer state
has the JAX package's dtypes. The step count, the lr, the bias corrections
and the optional clip factor stay on the device: a step never syncs the host.

Every optimizer updates its state in place: the parameters, the moments
(or the momentum trace), the device count (``count.add_(1)``) and the
unfused Adam's rounding generator. So a step reads and writes the same
storage each time, as a step captured in a CUDA graph must
(``train.graph``); the fused kernel takes its Philox step from the count
on the device. ``update_and_apply`` returns the state object with its host
fields advanced (``AdamWState.step``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Union

import torch

from scrubvae_torch.ops.fused_adamw import LeafTable, fused_adamw_multi
from scrubvae_torch.parallel.mesh import all_reduce_

__all__ = [
    "AdamWState",
    "FusedAdamW",
    "AdamLowpState",
    "AdamLowp",
    "SGDState",
    "SGD",
    "stochastic_round_bf16",
    "cyclical_beta",
    "make_lr_schedule",
    "make_optimizer",
]


@dataclasses.dataclass
class AdamWState:
    count: torch.Tensor  # int32 device scalar: updates applied so far
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    table: LeafTable  # the parameters and moments as the kernel sees them
    step: int = 0  # host mirror of count (the kernel reads its Philox step from count)
    split: tuple = ()  # per leaf, a slice of a split leaf (the clip's norm)
    group: Optional[object] = None  # the ranks holding the other slices


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

    def _leaf_m_dtype(self, numel: int) -> torch.dtype:
        lowp = self.m_dtype == torch.bfloat16 and numel >= self.MIN_LOWP_ELEMS
        return torch.bfloat16 if lowp else torch.float32

    def init(self, params: Sequence[torch.Tensor], shards=None, group=None) -> AdamWState:
        shards = _shards(params, shards)
        dts = [self._leaf_m_dtype(s[1] if s else p.numel()) for p, s in zip(params, shards)]
        mu = [torch.zeros_like(p, dtype=dt) for p, dt in zip(params, dts)]
        nu = [torch.zeros_like(p, dtype=dt) for p, dt in zip(params, dts)]
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=params[0].device),
            mu=mu,
            nu=nu,
            table=LeafTable([p.detach() for p in params], mu, nu, starts=[s[0] if s else 0 for s in shards]),
            split=tuple(s is not None for s in shards),
            group=group,
        )

    def _scalars(self, count: torch.Tensor, grads: Sequence[torch.Tensor], split=(), group=None) -> torch.Tensor:
        """[lr, 1 - b1^t, 1 - b2^t, clip factor] as one f32 device buffer."""
        t = count.float()
        b1c = 1.0 - torch.pow(self.b1, t)
        b2c = 1.0 - torch.pow(self.b2, t)
        lr = _lr_at(self.lr, count)
        if self.clip_norm and self.clip_norm > 0:
            gn = _global_norm(grads, split, group)
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
        """Update ``params``, the moments and the count in place; returns the
        state with its host mirror of the count advanced. Raises if a
        parameter or moment no longer lies where ``init`` found it."""
        state.table.check_storage(params, state.mu, state.nu)
        grads = [torch.zeros_like(p) if g is None else g.contiguous() for g, p in zip(grads, params)]
        state.count.add_(1)
        scal = self._scalars(state.count, grads, state.split, state.group)
        fused_adamw_multi(
            state.table, grads, scal,
            b1=self.b1, b2=self.b2, eps=self.eps, wd=self.wd, seed=self.seed, step=state.count,
        )
        return dataclasses.replace(state, step=state.step + 1)


def _lr_at(lr, count: torch.Tensor) -> torch.Tensor:
    """The lr of the update numbered ``count`` (from 1), as optax's
    schedules see it: evaluated at ``count - 1``."""
    return lr(count - 1) if callable(lr) else torch.full_like(count, lr, dtype=torch.float32)


def _shards(params, shards) -> list:
    return list(shards) if shards is not None else [None] * len(params)


def _global_norm(grads: Sequence[torch.Tensor], split=(), group=None) -> torch.Tensor:
    """The f32 global norm of ``grads``; with ``group``, the leaves flagged
    in ``split`` are slices whose squared norms are summed over ``group``
    (every rank of it holds the same other leaves)."""
    norms = torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32))
    if group is None or not any(split):
        return torch.linalg.vector_norm(norms)
    mask = torch.tensor(split, device=norms.device)
    sq = norms * norms
    split_sq = all_reduce_(torch.sum(torch.where(mask, sq, 0.0)), group)
    return torch.sqrt(torch.sum(torch.where(mask, 0.0, sq)) + split_sq)


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: Optional[float], split=(), group=None) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: the gradients as they are when
    their global norm is below ``max_norm``, else ``g / norm * max_norm``."""
    if not max_norm:
        return grads
    gn = _global_norm(grads, split, group)
    keep = gn < max_norm
    return [torch.where(keep, g, (g / gn.to(g.dtype)) * max_norm) for g in grads]


def stochastic_round_bf16(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding, the JAX package's
    ``_stochastic_round_bf16``: ``(bits + noise) & 0xFFFF0000`` over the
    uint32 bits of ``x`` for integer ``noise`` in [0, 65536). The sum is
    formed in int64 from the sign-extended bits and masked with
    ``~0xFFFF``, so its low 32 bits are the uint32 sum's."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    rounded = (bits + noise.to(torch.int64)) & ~0xFFFF
    return rounded.to(torch.int32).view(torch.float32).to(torch.bfloat16)


@dataclasses.dataclass
class AdamLowpState:
    count: torch.Tensor  # int32 device scalar: updates applied so far
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    generator: torch.Generator  # the stochastic rounding's bits
    shards: tuple = ()  # per leaf, (first element, whole leaf's numel) of a slice, else None
    group: Optional[object] = None  # the ranks holding the other slices


class AdamLowp:
    """Adam (AdamW with ``weight_decay``) as the JAX package's unfused optax
    chain: the moments accumulated in f32 and stored in ``moment_dtype``
    (bf16 stores stochastically rounded, on leaves of at least
    ``lowp_min_elems`` elements; f32 below), the update
    ``(m / b1c) / (sqrt(max(n, 0) / b2c) + eps)``, plus
    ``weight_decay * w``, times -lr, added to the weights; under optax's
    global-norm clip when ``clip_norm``. The rounding bits come from the
    state's generator, on the parameters' device, seeded with ``seed``."""

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
        lowp_min_elems: int = 0,
    ):
        self.lr = lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.wd = weight_decay
        self.m_dtype = moment_dtype
        self.clip_norm = clip_norm
        self.seed = seed
        self.lowp_min_elems = lowp_min_elems

    def _leaf_m_dtype(self, numel: int) -> torch.dtype:
        if self.m_dtype == torch.bfloat16 and numel < self.lowp_min_elems:
            return torch.float32
        return self.m_dtype

    def init(self, params: Sequence[torch.Tensor], shards=None, group=None) -> AdamLowpState:
        dev = params[0].device
        shards = _shards(params, shards)
        dts = [self._leaf_m_dtype(s[1] if s else p.numel()) for p, s in zip(params, shards)]
        return AdamLowpState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=[torch.zeros_like(p, dtype=dt) for p, dt in zip(params, dts)],
            nu=[torch.zeros_like(p, dtype=dt) for p, dt in zip(params, dts)],
            generator=torch.Generator(device=dev).manual_seed(self.seed),
            shards=tuple(shards),
            group=group,
        )

    def _store(self, x: torch.Tensor, like: torch.Tensor, gen: torch.Generator, noise, shard=None) -> torch.Tensor:
        if like.dtype != torch.bfloat16:
            return x.to(like.dtype)
        if noise is None and shard is not None:
            # the whole leaf's bits, drawn as the unsplit leaf draws them
            start, full = shard
            noise = torch.randint(0, 1 << 16, (full,), generator=gen, device=x.device, dtype=torch.int32)
            noise = noise[start:start + x.numel()].view(x.shape)
        elif noise is None:
            noise = torch.randint(0, 1 << 16, x.shape, generator=gen, device=x.device, dtype=torch.int32)
        return stochastic_round_bf16(x, noise)

    @torch.no_grad()
    def update_and_apply(
        self,
        grads: Sequence[Optional[torch.Tensor]],
        state: AdamLowpState,
        params: Sequence[torch.Tensor],
        noise: Optional[Sequence] = None,
    ) -> AdamLowpState:
        """Update ``params``, the moments, the count and the generator in
        place; returns ``state``. ``noise[i]``, when given, is leaf i's (mu,
        nu) rounding bits in place of the generator's (None for an f32
        leaf)."""
        grads = [torch.zeros_like(p) if g is None else g.float() for g, p in zip(grads, params)]
        shards = state.shards or (None,) * len(params)
        grads = _clip_by_global_norm(grads, self.clip_norm, tuple(s is not None for s in shards), state.group)
        count = state.count.add_(1)
        t = count.float()
        b1c = 1.0 - torch.pow(self.b1, t)
        b2c = 1.0 - torch.pow(self.b2, t)
        step_size = -_lr_at(self.lr, count)
        for i, (p, g, m, v) in enumerate(zip(params, grads, state.mu, state.nu)):
            nm, nv = (None, None) if noise is None or noise[i] is None else noise[i]
            m_new = self._store(self.b1 * m.float() + (1.0 - self.b1) * g, m, state.generator, nm, shards[i])
            v_new = self._store(self.b2 * v.float() + (1.0 - self.b2) * (g * g), v, state.generator, nv, shards[i])
            u = (m_new.float() / b1c) / (torch.sqrt(torch.clamp(v_new.float(), min=0.0) / b2c) + self.eps)
            if self.wd:
                u = u + self.wd * p
            p.copy_((p + step_size * u).to(p.dtype))
            m.copy_(m_new)
            v.copy_(v_new)
        return state


@dataclasses.dataclass
class SGDState:
    count: torch.Tensor  # int32 device scalar: updates applied so far
    trace: List[torch.Tensor]
    split: tuple = ()  # per leaf, a slice of a split leaf (the clip's norm)
    group: Optional[object] = None  # the ranks holding the other slices


class SGD:
    """optax's ``sgd(lr, momentum, nesterov=True)``: the trace
    ``t = g + momentum * t`` in the parameters' dtype, the update
    ``-lr * (g + momentum * t)`` added to the weights; under optax's
    global-norm clip when ``clip_norm``."""

    def __init__(
        self,
        lr: Union[float, Callable[[torch.Tensor], torch.Tensor]],
        *,
        momentum: float = 0.2,
        clip_norm: Optional[float] = None,
    ):
        self.lr = lr
        self.momentum = momentum
        self.clip_norm = clip_norm

    def init(self, params: Sequence[torch.Tensor], shards=None, group=None) -> SGDState:
        return SGDState(
            count=torch.zeros((), dtype=torch.int32, device=params[0].device),
            trace=[torch.zeros_like(p) for p in params],
            split=tuple(s is not None for s in _shards(params, shards)),
            group=group,
        )

    @torch.no_grad()
    def update_and_apply(
        self, grads: Sequence[Optional[torch.Tensor]], state: SGDState, params: Sequence[torch.Tensor]
    ) -> SGDState:
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        grads = _clip_by_global_norm(grads, self.clip_norm, state.split, state.group)
        step_size = -_lr_at(self.lr, state.count.add_(1))
        for p, g, t in zip(params, grads, state.trace):
            t_new = g + self.momentum * t
            u = g + self.momentum * t_new
            t.copy_(t_new)
            p.copy_((p + step_size.to(u.dtype) * u).to(p.dtype))
        return state


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


def make_optimizer(train_config: dict, steps_per_epoch: int, clip_norm: float = 1e6):
    """The optimizer of ``train_config`` (see the module docstring);
    train.moment_dtype bf16 by default; train.clip_norm 0 disables the
    global-norm clip, unset keeps it at ``clip_norm``."""
    lr = make_lr_schedule(
        float(train_config.get("lr") or 1e-4), train_config.get("lr_schedule"), steps_per_epoch
    )
    name = train_config.get("optimizer") or "adam"
    lowp = (train_config.get("moment_dtype") or "bf16") == "bf16"
    m_dtype = torch.bfloat16 if lowp else torch.float32
    cn = train_config.get("clip_norm")
    if cn is None:
        cn = clip_norm
    cn = float(cn) if cn and float(cn) > 0 else None
    fused = train_config.get("fused_optimizer")
    if name in ("adam", "adamw") and (fused is None or bool(fused)):
        return FusedAdamW(lr, weight_decay=0.01 if name == "adamw" else 0.0, moment_dtype=m_dtype, clip_norm=cn)
    if name in ("adam", "adamw"):
        return AdamLowp(
            lr, weight_decay=0.01 if name == "adamw" else 0.0, moment_dtype=m_dtype, clip_norm=cn,
            lowp_min_elems=FusedAdamW.MIN_LOWP_ELEMS,
        )
    if name == "sgd":
        return SGD(lr, momentum=0.2, clip_norm=cn)
    raise ValueError(f"unknown optimizer {name!r}")
