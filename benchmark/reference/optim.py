"""AdamW, the cosine-with-warm-restarts lr and beta annealing, plain f32.

torch-AdamW semantics as the measured program states them: decoupled
weight decay, bias-corrected moments, the update ``(m / b1c) /
(sqrt(n / b2c) + eps) + wd * w`` times the lr, under an optional
global-norm clip of the gradients; the lr of update ``t`` (from 1) is
the schedule at ``t - 1``.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch


def cawr(lr: float, steps_per_epoch: int, T_0: int = 50):
    def sched(step: int) -> float:
        t_cur = math.fmod(step / steps_per_epoch, T_0)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t_cur / T_0))

    return sched


def cyclical_beta(epoch: int, beta_max: float = 1.0, len_cycle: int = 100, R: float = 0.5) -> float:
    len_increasing = int(len_cycle * R)
    remainder = (epoch - 1) % len_cycle
    return float(beta_max) if remainder >= len_increasing else float(beta_max) * remainder / len_increasing


class AdamW:
    def __init__(self, lr, *, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, clip_norm: Optional[float] = None):
        self.lr = lr if callable(lr) else (lambda step, v=float(lr): v)
        self.b1, self.b2, self.eps, self.wd, self.clip = b1, b2, eps, weight_decay, clip_norm
        self.count = 0
        self.m: List[torch.Tensor] = []
        self.n: List[torch.Tensor] = []
        self.last_grads: List[torch.Tensor] = []  # the gradients of the last update, as the update took them

    @torch.no_grad()
    def step(self, params, grads) -> None:
        grads = [torch.zeros_like(p) if g is None else g.float() for p, g in zip(params, grads)]
        if self.clip:
            gn = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.clamp(self.clip / torch.clamp(gn, min=1e-30), max=1.0)
            grads = [g * scale for g in grads]
        if not self.m:
            self.m = [torch.zeros_like(p) for p in params]
            self.n = [torch.zeros_like(p) for p in params]
        self.count += 1
        t = self.count
        b1c, b2c = 1.0 - self.b1**t, 1.0 - self.b2**t
        lr = self.lr(t - 1)
        for p, g, m, n in zip(params, grads, self.m, self.n):
            m.mul_(self.b1).add_((1.0 - self.b1) * g)
            n.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            upd = (m / b1c) / (torch.sqrt(torch.clamp(n, min=0.0) / b2c) + self.eps)
            p.sub_(lr * (upd + self.wd * p))
        self.last_grads = grads
