"""Layers of the residual conv VAE in PyTorch, NCW layout (counterpart of
``scrubvae_tpu/models/layers.py``).

Module and parameter names follow the reference torch model
(``conv_in``, ``res_layers.{i}.residual.{0..3}``, ``skip``, ``add.{0,1}``),
so a state dict carried over from the JAX package loads by name.

``compute_dtype`` (bf16 under ``precision: bf16``) is the dtype convs and
dense layers compute in, as flax's ``dtype``: inputs and parameters are cast
per call, parameters keep their storage dtype. BatchNorm keeps flax's
semantics: statistics in f32, biased batch variance in the running update,
running = 0.9 * running + 0.1 * batch, eps 1e-4.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from scrubvae_torch.device import device_constant, trace_safe_cache
from scrubvae_torch.parallel.mesh import all_reduce

__all__ = [
    "conv_out_len",
    "conv_transpose_out_len",
    "encoder_lengths",
    "decoder_lengths",
    "PReLU",
    "Conv1d",
    "ConvTranspose1d",
    "Linear",
    "BatchNorm1d",
    "upsample_linear_1d",
    "packed_softplus_diag",
    "packed_diag",
    "packed_matvec",
    "packed_sumsq",
    "packed_to_L",
    "CholeskyL",
    "ResidualBlock",
    "ResidualBlockTranspose",
    "lecun_normal_",
    "f32_or_wider",
    "trace_safe_cache",
]


def f32_or_wider(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or as it is when it is f64: the f32 outputs of the heads
    and the decoder (flax's ``.astype(float32)``), which a model cast to f64
    keeps in f64."""
    return x if x.dtype == torch.float64 else x.float()


def conv_out_len(l: int, kernel: int, stride: int, pad: int, dilation: int = 1) -> int:
    return (l + 2 * pad - dilation * (kernel - 1) - 1) // stride + 1


def conv_transpose_out_len(l: int, kernel: int, stride: int, pad: int, dilation: int = 1) -> int:
    return (l - 1) * stride - 2 * pad + dilation * (kernel - 1) + 1


def encoder_lengths(window: int, kernel: int, n_blocks: int, dilations: Sequence[int]) -> list:
    """Sequence lengths through conv_in + the residual blocks."""
    lens = [conv_out_len(window, 7, 1, 3)]
    for i in range(n_blocks):
        d = int(dilations[i])
        stride = 1 if d > 1 else 2
        lens.append(conv_out_len(lens[-1], kernel, stride, kernel // 2, d))
    return lens


def decoder_lengths(latent_len: int, kernel: int, n_blocks: int) -> list:
    """Lengths through the transpose blocks (undilated path)."""
    lens = [latent_len]
    for _ in range(n_blocks):
        l = conv_transpose_out_len(lens[-1], kernel, 1, kernel // 2)
        lens.append(conv_transpose_out_len(l, kernel, 2, kernel // 2))
    return lens


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: truncated normal (±2 sd), variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def _cast(x: torch.Tensor, w: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, w.dtype)


class PReLU(nn.Module):
    """Single-parameter PReLU, init 0.25: max(x, 0) + a * min(x, 0)."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, min=0.0) + self.weight.to(x.dtype) * torch.clamp(x, max=0.0)


def make_activation(name: str) -> nn.Module:
    return nn.Tanh() if name == "tanh" else PReLU()


class Conv1d(nn.Conv1d):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _cast(x, self.weight, self.compute_dtype)
        b = self.bias.to(dt) if self.bias is not None else None
        return F.conv1d(
            x.to(dt), self.weight.to(dt), b, self.stride, self.padding, self.dilation
        )


class ConvTranspose1d(nn.ConvTranspose1d):
    """torch ConvTranspose1d: out = (L-1)*s - 2p + d(k-1) + 1. The JAX
    package computes it as an input-dilated correlation; the carried kernel
    is flipped along k (utils/weights.py)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _cast(x, self.weight, self.compute_dtype)
        b = self.bias.to(dt) if self.bias is not None else None
        return F.conv_transpose1d(
            x.to(dt), self.weight.to(dt), b, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation,
        )


class Linear(nn.Linear):
    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _cast(x, self.weight, self.compute_dtype)
        b = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), b)


class BatchNorm1d(nn.Module):
    """BatchNorm over (N, W) of an NCW tensor with flax semantics (see the
    module docstring). Output in ``compute_dtype`` (or the input's dtype).
    With ``group`` (the data group of ``parallel.mesh``, set by
    ``place_state``) the training statistics are the global batch's: the
    per-rank sums of x and x^2 are all-reduced, forward and backward, so
    the running statistics agree on every rank."""

    group = None

    def __init__(
        self,
        num_features: int,
        eps: float = 1e-4,
        momentum: float = 0.9,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.eps, self.momentum, self.compute_dtype = eps, momentum, compute_dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = f32_or_wider(x)
        if self.training:
            if self.group is None:
                mean = xf.mean(dim=(0, 2))
                sq = (xf * xf).mean(dim=(0, 2))
            else:
                # the global batch's sums, differentiably: every rank's rows
                # feed every rank's normalisation
                n = xf.shape[0] * xf.shape[2] * dist.get_world_size(self.group)
                sums = all_reduce(torch.stack([xf.sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2))]), self.group)
                mean, sq = sums[0] / n, sums[1] / n
            var = torch.clamp(sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * f32_or_wider(self.weight)
        y = (xf - mean[:, None]) * mul[:, None] + f32_or_wider(self.bias)[:, None]
        return y.to(self.compute_dtype or x.dtype)


def upsample_linear_1d(x: torch.Tensor) -> torch.Tensor:
    """2x linear upsampling along W of an NCW tensor with half-pixel
    centers, as ``F.interpolate(scale_factor=2, mode="linear",
    align_corners=False)``, written as the JAX package's blend: out[2i] and
    out[2i+1] are 0.75 x[i] + 0.25 x[i-1] and 0.75 x[i] + 0.25 x[i+1], edges
    clamped. Its backward is elementwise too, where the backward of
    ``F.interpolate`` scatters with atomic adds, which in bf16 took 2.5 s
    of a 2.6 s flagship step on an H100."""
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    nxt = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    even, odd = 0.75 * x + 0.25 * prev, 0.75 * x + 0.25 * nxt
    return torch.stack([even, odd], dim=-1).flatten(-2)


class UpsampleLinear(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_linear_1d(x)


# ---------------------------------------------------------------------------
# Packed lower-triangular Cholesky factor: row-major packed tril, entry k at
# (row_k, col_k), the order the dense CholeskyL scatters. Everything the
# train losses need from L (L @ eps, diag(L), trace(LL^T)) works on the
# packed vector; the (B, D, D) matrix is built (``packed_to_L``) only for
# the dense head, which total correlation needs.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _tril_info(D: int, diag_only: bool):
    if diag_only:
        rows = cols = np.arange(D, dtype=np.int64)
    else:
        rows = np.repeat(np.arange(D), np.arange(1, D + 1)).astype(np.int64)
        cols = np.concatenate([np.arange(i + 1) for i in range(D)]).astype(np.int64)
    diag_pos = np.nonzero(rows == cols)[0].astype(np.int64)
    return rows, cols, diag_pos


@trace_safe_cache
def _tril_tensors(D: int, diag_only: bool, device: torch.device):
    rows, cols, diag_pos = _tril_info(D, diag_only)
    return tuple(device_constant(a, device) for a in (rows, cols, diag_pos))


def _diag_only(xp: torch.Tensor, D: int, diag_only: Optional[bool]) -> bool:
    return xp.shape[-1] == D if diag_only is None else diag_only


def packed_softplus_diag(xp: torch.Tensor, D: int, diag_only: Optional[bool] = None) -> torch.Tensor:
    """softplus(+1e-6 floor) on the diagonal entries of a packed tril (B, K)."""
    if _diag_only(xp, D, diag_only):
        return F.softplus(xp) + 1e-6
    rows, cols, _ = _tril_tensors(D, False, xp.device)
    return torch.where(rows == cols, F.softplus(xp) + 1e-6, xp)


def packed_diag(xp: torch.Tensor, D: int, diag_only: Optional[bool] = None) -> torch.Tensor:
    """diag(L) from the packed vector."""
    if _diag_only(xp, D, diag_only):
        return xp
    _, _, diag_pos = _tril_tensors(D, False, xp.device)
    return xp[:, diag_pos]


def packed_sumsq(xp: torch.Tensor) -> torch.Tensor:
    """sum_b trace(L_b L_b^T) = sum of squares of all packed entries."""
    return torch.sum(xp * xp)


def packed_matvec(xp: torch.Tensor, v: torch.Tensor, D: int, diag_only: Optional[bool] = None) -> torch.Tensor:
    """L @ v without building L: (L v)_i = sum_{k in row i} xp_k v_{col_k},
    a column gather and a row ``index_add``."""
    if _diag_only(xp, D, diag_only):
        return xp * v
    rows, cols, _ = _tril_tensors(D, False, xp.device)
    prod = f32_or_wider(xp * v[:, cols])
    return prod.new_zeros(xp.shape[0], D).index_add(1, rows, prod)


def packed_to_L(xp: torch.Tensor, D: int, diag_only: Optional[bool] = None) -> torch.Tensor:
    """The (B, D, D) factor from a packed vector (already softplus'd): entry
    k to (row_k, col_k), zeros above the diagonal."""
    B = xp.shape[0]
    if _diag_only(xp, D, diag_only):
        return torch.diag_embed(xp)
    rows, cols, _ = _tril_tensors(D, False, xp.device)
    return xp.new_zeros(B, D * D).index_copy(1, rows * D + cols, xp).view(B, D, D)


class CholeskyL(nn.Module):
    """A flat head output onto a lower-triangular Cholesky factor (B, D, D):
    the tril filled row-major, the diagonal softplus'd with a 1e-6 floor
    (softplus underflows to 0 below -103, and the KL and total-correlation
    losses take log(diag)); with ``is_diag`` the output is the diagonal
    alone. No parameters: ``fc_sigma`` before it is the same layer, in the
    same packed order, as in the packed head."""

    def __init__(self, z_dim: int, is_diag: bool):
        super().__init__()
        self.z_dim, self.is_diag = z_dim, is_diag

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return packed_to_L(packed_softplus_diag(x, self.z_dim, self.is_diag), self.z_dim, self.is_diag)


class ResidualBlock(nn.Module):
    """Strided (or dilated) residual downsampling block."""

    def __init__(
        self,
        in_ch: int,
        features: int,
        kernel: int = 3,
        activation: str = "prelu",
        dilation: int = 1,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        stride = 1 if dilation > 1 else 2
        k, p, dt = kernel, kernel // 2, compute_dtype
        self.residual = nn.Sequential(
            Conv1d(in_ch, features // 2, k, stride, p, dilation, compute_dtype=dt),
            BatchNorm1d(features // 2, compute_dtype=dt),
            make_activation(activation),
            Conv1d(features // 2, features, k, 1, p, 1, compute_dtype=dt),
        )
        self.skip = Conv1d(in_ch, features, k, stride, p, dilation, compute_dtype=dt)
        self.add = nn.Sequential(BatchNorm1d(features, compute_dtype=dt), make_activation(activation))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.add(self.residual(x) + self.skip(x))


class ResidualBlockTranspose(nn.Module):
    """Transposed residual upsampling block with a linear-upsample skip."""

    def __init__(
        self,
        in_ch: int,
        features: int,
        kernel: int = 3,
        activation: str = "prelu",
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        k, p, dt = kernel, kernel // 2, compute_dtype
        self.residual = nn.Sequential(
            ConvTranspose1d(in_ch, in_ch // 2, k, 1, p, compute_dtype=dt),
            BatchNorm1d(in_ch // 2, compute_dtype=dt),
            make_activation(activation),
            ConvTranspose1d(in_ch // 2, features, k, 2, p, compute_dtype=dt),
        )
        self.skip = nn.Sequential(
            UpsampleLinear(), Conv1d(in_ch, features, k + 1, 1, p, compute_dtype=dt)
        )
        self.add = nn.Sequential(BatchNorm1d(features, compute_dtype=dt), make_activation(activation))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.add(self.residual(x) + self.skip(x))
