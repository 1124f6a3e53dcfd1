"""Transformer VAE (counterpart of ``scrubvae_tpu/models/transformer.py``) on
the data interface the rcnn model has (``models/base.py``).

The encoder embeds each frame (``pose_embedding``), adds sinusoidal
positions and runs post-norm self-attention layers; the flattened (W, z)
sequence gives ``fc_mu`` and the dense Cholesky head over ``fc_sigma``.
The decoder runs the positions as queries through post-norm layers that
attend to themselves and to z as one memory token (after ``cond_proj`` of
z and the conditionals), then ``fc_out`` and a tanh. Module and parameter
names are the reference torch model's (``encoder.transformer_encoder.
layers.{i}.self_attn.in_proj_weight``, ``linear1``, ``norm1``, ...,
``decoder.transformer_decoder.layers.{i}.multihead_attn``, ``norm3``,
``decoder.fc_out``), the layout ``scrubvae_tpu/utils/torch_export.py``
writes.

Numerics follow flax's: the query is divided by sqrt(head_dim) before the
product, the softmax runs in f32, gelu is the exact erf form, LayerNorm
takes its variance as E[x^2] - E[x]^2 with eps 1e-5. In training mode
dropout acts as flax's ``nn.Dropout`` on the encoder's input after the
positional add, on the decoder's positional queries and on both residual
branches of every layer, and on the attention weights after the softmax
with one (q_len, kv_len) mask for the whole batch and every head; its masks
are drawn from the ``generator`` passed down from ``forward``. The rate is
each sub-module's ``dropout`` (0.1, as in the JAX model, which sets no
other). The model computes in f32; bf16-stored kernels are promoted.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scrubvae_torch.models.base import PoseVAE
from scrubvae_torch.models.layers import CholeskyL, Linear, lecun_normal_

__all__ = [
    "sinusoidal_positions",
    "dropout",
    "attention_dropout",
    "LayerNorm",
    "MultiheadAttention",
    "EncoderLayer",
    "DecoderLayer",
    "TransformerEncoder",
    "TransformerDecoder",
    "TransformerVAE",
]

LN_EPS = 1e-5  # torch's LayerNorm default (flax's is 1e-6)


def sinusoidal_positions(length: int, d_model: int) -> np.ndarray:
    """(length, d_model) f32: sin on the even columns, cos on the odd."""
    pos = np.arange(length)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, d_model, 2).astype(np.float32) * (-np.log(1e4) / d_model))
    pe = np.zeros((length, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _keep(shape, rate: float, generator: Optional[torch.Generator], device) -> torch.Tensor:
    if generator is None:
        raise ValueError("dropout in training mode draws its masks from a generator; none was given")
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout`` in training mode: each entry kept with
    probability 1 - rate and then divided by it, else 0."""
    keep = _keep(x.shape, rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def attention_dropout(weights: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's dropout of the attention weights (B, H, q, kv): one (q, kv)
    mask for every batch entry and head, as a multiplier of 0 or
    1 / (1 - rate)."""
    keep = _keep(weights.shape[-2:], rate, generator, weights.device)
    return weights * (keep.to(weights.dtype) / (1.0 - rate))


def _act(name: str):
    return F.gelu if name == "gelu" else F.relu


class _Dropping(nn.Module):
    """A module with a dropout rate that acts in training mode."""

    dropout: float

    def drop(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.training and self.dropout > 0.0:
            return dropout(x, self.dropout, generator)
        return x


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with flax's arithmetic:
    (x - E[x]) * (rsqrt(E[x^2] - E[x]^2 + eps) * weight) + bias."""

    def __init__(self, d: int, eps: float = LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class MultiheadAttention(_Dropping):
    """flax's ``MultiHeadDotProductAttention`` with torch's parameter
    layout: q, k and v projections stacked in ``in_proj_weight`` (3d, d)
    and ``in_proj_bias``, heads split along the projected features."""

    def __init__(self, d: int, n_heads: int, dropout: float = 0.1):
        super().__init__()
        self.n_heads, self.dropout = n_heads, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        # flax's q, k and v kernels: lecun-normal over the input width
        lecun_normal_(self.in_proj_weight, d, None)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = Linear(d, d)

    def forward(self, x: torch.Tensor, memory: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, Lq, d = x.shape
        H = self.n_heads
        dt = torch.promote_types(x.dtype, self.in_proj_weight.dtype)
        w, b = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        if memory is x:
            q, k, v = F.linear(x.to(dt), w, b).chunk(3, dim=-1)
        else:
            q = F.linear(x.to(dt), w[:d], b[:d])
            k, v = F.linear(memory.to(dt), w[d:], b[d:]).chunk(2, dim=-1)
        q = q.reshape(B, Lq, H, d // H) / math.sqrt(d // H)
        k = k.reshape(B, -1, H, d // H)
        v = v.reshape(B, -1, H, d // H)
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        if self.training and self.dropout > 0.0:
            weights = attention_dropout(weights, self.dropout, generator)
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, Lq, d))


class EncoderLayer(_Dropping):
    def __init__(self, d: int, n_heads: int = 4, ff_size: int = 512, dropout: float = 0.1, activation: str = "gelu"):
        super().__init__()
        self.dropout, self.activation = dropout, activation
        self.self_attn = MultiheadAttention(d, n_heads, dropout)
        self.linear1 = Linear(d, ff_size)
        self.linear2 = Linear(ff_size, d)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm1(x + self.drop(self.self_attn(x, x, generator), generator))
        h = self.linear2(_act(self.activation)(self.linear1(x)))
        return self.norm2(x + self.drop(h, generator))


class DecoderLayer(_Dropping):
    def __init__(self, d: int, n_heads: int = 4, ff_size: int = 512, dropout: float = 0.1, activation: str = "gelu"):
        super().__init__()
        self.dropout, self.activation = dropout, activation
        self.self_attn = MultiheadAttention(d, n_heads, dropout)
        self.multihead_attn = MultiheadAttention(d, n_heads, dropout)
        self.linear1 = Linear(d, ff_size)
        self.linear2 = Linear(ff_size, d)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.norm3 = LayerNorm(d)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tgt = self.norm1(tgt + self.drop(self.self_attn(tgt, tgt, generator), generator))
        tgt = self.norm2(tgt + self.drop(self.multihead_attn(tgt, memory, generator), generator))
        h = self.linear2(_act(self.activation)(self.linear1(tgt)))
        return self.norm3(tgt + self.drop(h, generator))


class _Stack(nn.Module):
    """Holds the layers under ``layers.{i}``, as torch's transformer
    containers do."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class TransformerEncoder(_Dropping):
    def __init__(
        self,
        in_channels: int,
        z_dim: int = 128,
        window: int = 51,
        activation: str = "gelu",
        n_heads: int = 4,
        ff_size: int = 512,
        n_layers: int = 4,
        is_diag: bool = False,
        dropout: float = 0.1,
    ):
        super().__init__()
        self.dropout = dropout
        self.pose_embedding = Linear(in_channels, z_dim)
        self.register_buffer("pe", torch.from_numpy(sinusoidal_positions(window, z_dim)), persistent=False)
        self.transformer_encoder = _Stack(
            [EncoderLayer(z_dim, n_heads, ff_size, dropout, activation) for _ in range(n_layers)]
        )
        self.fc_mu = Linear(window * z_dim, z_dim)
        self.fc_sigma = nn.Sequential(Linear(window * z_dim, z_dim if is_diag else z_dim * (z_dim + 1) // 2))
        self.cholesky = CholeskyL(z_dim, is_diag)

    def forward(self, x: torch.Tensor, mu_only: bool = False, generator: Optional[torch.Generator] = None):
        """x: (B, W, C) -> (mu (B, z), L (B, z, z) or None)."""
        h = self.pose_embedding(x) + self.pe[: x.shape[1]].to(x.dtype)
        h = self.drop(h, generator)
        for layer in self.transformer_encoder.layers:
            h = layer(h, generator)
        flat = h.reshape(h.shape[0], -1)
        mu = self.fc_mu(flat)
        if mu_only:
            return mu, None
        return mu, self.cholesky(self.fc_sigma(flat))


class TransformerDecoder(_Dropping):
    def __init__(
        self,
        out_channels: int,
        z_dim: int = 128,
        window: int = 51,
        activation: str = "gelu",
        n_heads: int = 4,
        ff_size: int = 512,
        n_layers: int = 4,
        dropout: float = 0.1,
    ):
        super().__init__()
        self.dropout = dropout
        self.register_buffer("pe", torch.from_numpy(sinusoidal_positions(window, z_dim)), persistent=False)
        self.transformer_decoder = _Stack(
            [DecoderLayer(z_dim, n_heads, ff_size, dropout, activation) for _ in range(n_layers)]
        )
        self.fc_out = Linear(z_dim, out_channels)

    def forward(self, z: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z: (B, z) -> (B, W, C) in (-1, 1)."""
        tgt = self.drop(self.pe.to(z.dtype).expand(z.shape[0], -1, -1), generator)
        memory = z[:, None, :]
        for layer in self.transformer_decoder.layers:
            tgt = layer(tgt, memory, generator)
        return torch.tanh(self.fc_out(tgt))


class TransformerVAE(PoseVAE):
    def __init__(
        self,
        in_channels: int,
        z_dim: int = 128,
        window: int = 51,
        activation: str = "gelu",
        n_heads: int = 4,
        ff_size: int = 512,
        n_layers: int = 4,
        is_diag: bool = False,
        conditional_dim: int = 0,
        prior: str = "gaussian",
        arena_size=None,
        conditional_keys: Sequence[str] = (),
        discrete_classes: Optional[Dict[str, int]] = None,
    ):
        super().__init__(z_dim, window, is_diag, conditional_dim, arena_size, conditional_keys, discrete_classes)
        self.encoder = TransformerEncoder(in_channels, z_dim, window, activation, n_heads, ff_size, n_layers, is_diag)
        self.decoder = TransformerDecoder(in_channels, z_dim, window, activation, n_heads, ff_size, n_layers)
        if conditional_dim > 0:
            # [z, conditionals] back to the width of the decoder's memory
            self.cond_proj = Linear(z_dim + conditional_dim, z_dim)

    def encode(
        self, data: Dict[str, torch.Tensor], mu_only: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """mu (and the dense Cholesky factor ``L``) of the batch."""
        mu, L = self.encoder(self.pose_input(data["x6d"], data["root"]), mu_only=mu_only, generator=generator)
        return {"mu": mu} if L is None else {"mu": mu, "L": L}

    def decode(
        self, z: torch.Tensor, data: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        var = self.build_conditionals(data)
        if var is not None:
            out["var"] = var
            z = self.cond_proj(torch.cat([z, var], dim=-1))
        out.update(self.pose_output(self.decoder(z, generator)))
        return out
