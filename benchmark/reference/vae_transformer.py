"""The transformer VAE (``model.type: transformer``), plain PyTorch in f32.

The architecture is the reference repository's second backbone,
tdunnlab/scrubvae ``src/scrubvae/model/transformer.py:120``
(``TransformerVAE``; encoder ``:29-76``, decoder ``:79-117``):

- encoder: each frame's pose and arena-normalised root embedded to d = z
  (``pose_embedding``), sinusoidal positions added, then post-norm layers
  of self-attention and a feed-forward block (``linear1``, gelu in its
  exact erf form, ``linear2``); the flattened (W, d) sequence goes to
  ``fc_mu`` and to the dense Cholesky head ``fc_sigma`` (the tril filled
  row-major, the diagonal softplus'd with a 1e-6 floor);
- decoder: the positions as queries through post-norm layers of
  self-attention, cross-attention to z as one memory token (z and the
  conditionals first through ``cond_proj``) and the feed-forward block,
  then ``fc_out`` and a tanh;
- dropout at 0.1 in training mode on the embedded input, on the decoder's
  positional queries, on every residual branch and on the attention
  weights.

It departs from the published torch model where the measured program
follows the JAX package (flax's arithmetic), and says so:

- the attention weights' dropout draws one (q, kv) mask for the whole
  batch and every head (flax's ``broadcast_dropout``), not torch's mask
  per element;
- LayerNorm takes its variance as E[x^2] - E[x]^2 (flax), not
  E[(x - E[x])^2]; eps 1e-5 as torch's;
- the query is divided by sqrt(head width) before the product with the
  keys (flax), not the product after.

Where f32 leaves a choice, it takes the program's: a self-attention's q,
k and v come from one product with the stacked ``in_proj_weight``, the
heads' products are the program's einsums, and the positional table is
computed in float64 and rounded. On the CPU the two sides then round
alike, and the first gradients agree to about 1e-8 (rounding apart from
that is amplified about a hundredfold by the step's first gradients).

Each mask is ``rand(shape) < 1 - rate`` from the generator the step hands
the forward, in the program's order: the encoder's input; in each encoder
layer the attention weights, then the two residual branches; the
decoder's queries; in each decoder layer the self-attention's weights,
its residual, the cross-attention's weights, its residual, the
feed-forward residual. A kept entry is divided by 1 - rate. On the meta
device (the FLOP count) the masks are drawn with no generator. The
parameter names are the program's (``scrubvae_torch/models/transformer.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import geometry as geo
from benchmark.reference import model as rm

# the model keys of the CPU tests' size: two encoder and two decoder layers
SMALL = {"z_dim": 16, "n_heads": 2, "ff_size": 32, "n_layers": 2}
RATE = 0.1
LN_EPS = 1e-5


def compute_precision(model_cfg: dict, train_cfg: dict) -> str:
    return "f32"  # the port's transformer computes in f32 and reads no precision setting


def build_vae(model_cfg, in_ch, cond_dim, conditional_keys, discrete_classes, arena, loss_keys, quant):
    if quant is not None:
        raise ValueError("the reference transformer computes in f32; its control is TF32")
    if model_cfg.get("diag"):
        raise ValueError("the reference transformer holds the dense Cholesky head only")
    if (model_cfg.get("activation") or "gelu") != "gelu":
        raise ValueError("the reference transformer holds gelu only")
    return TransformerVAE(in_ch, model_cfg.get("window") or 51, model_cfg.get("z_dim") or 128,
                          model_cfg.get("n_heads") or 4, model_cfg.get("ff_size") or 512,
                          model_cfg.get("n_layers") or 4, cond_dim, arena, conditional_keys, discrete_classes)


def positions(length: int, d: int) -> torch.Tensor:
    """(length, d): sin on the even columns, cos on the odd, of position
    times 10000^(-2i/d), computed in float64 and rounded to f32."""
    angle = np.arange(length, dtype=np.float64)[:, None] * np.exp(np.arange(0, d, 2) * (-math.log(1e4) / d))
    pe = np.zeros((length, d), dtype=np.float64)
    pe[:, 0::2] = np.sin(angle)
    pe[:, 1::2] = np.cos(angle)
    return torch.from_numpy(pe.astype(np.float32))


def keep_mask(shape, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) < 1.0 - RATE


def drop(x: torch.Tensor, training: bool, generator) -> torch.Tensor:
    """Dropout of every entry of ``x``."""
    if not training:
        return x
    return torch.where(keep_mask(x.shape, generator, x.device), x / (1.0 - RATE), torch.zeros_like(x))


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def init_kind(self, pname):
        return ("one" if pname == "weight" else "zero"), None

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias


class Attention(nn.Module):
    """Multi-head attention with the q, k and v projections stacked in
    ``in_proj_weight`` (3d, d), heads split along the projected width."""

    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.d, self.n_heads = d, n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = rm.Linear(d, d)

    def init_kind(self, pname):
        return ("kernel", self.d) if pname == "in_proj_weight" else ("zero", None)

    def forward(self, x, memory, generator):
        B, Lq, d = x.shape
        H, hd = self.n_heads, d // self.n_heads
        w, b = self.in_proj_weight, self.in_proj_bias
        if memory is x:
            q, k, v = F.linear(x, w, b).chunk(3, dim=-1)
        else:
            q = F.linear(x, w[:d], b[:d])
            k, v = F.linear(memory, w[d:], b[d:]).chunk(2, dim=-1)
        q = q.reshape(B, Lq, H, hd) / math.sqrt(hd)
        k, v = k.reshape(B, -1, H, hd), v.reshape(B, -1, H, hd)
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        if self.training:
            keep = keep_mask(weights.shape[-2:], generator, weights.device)
            weights = weights * (keep.float() / (1.0 - RATE))
        return self.out_proj(torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, Lq, d))


class EncoderLayer(nn.Module):
    def __init__(self, d, n_heads, ff):
        super().__init__()
        self.self_attn = Attention(d, n_heads)
        self.linear1, self.linear2 = rm.Linear(d, ff), rm.Linear(ff, d)
        self.norm1, self.norm2 = LayerNorm(d), LayerNorm(d)

    def forward(self, x, generator):
        x = self.norm1(x + drop(self.self_attn(x, x, generator), self.training, generator))
        h = self.linear2(F.gelu(self.linear1(x)))
        return self.norm2(x + drop(h, self.training, generator))


class DecoderLayer(nn.Module):
    def __init__(self, d, n_heads, ff):
        super().__init__()
        self.self_attn, self.multihead_attn = Attention(d, n_heads), Attention(d, n_heads)
        self.linear1, self.linear2 = rm.Linear(d, ff), rm.Linear(ff, d)
        self.norm1, self.norm2, self.norm3 = LayerNorm(d), LayerNorm(d), LayerNorm(d)

    def forward(self, tgt, memory, generator):
        tgt = self.norm1(tgt + drop(self.self_attn(tgt, tgt, generator), self.training, generator))
        tgt = self.norm2(tgt + drop(self.multihead_attn(tgt, memory, generator), self.training, generator))
        h = self.linear2(F.gelu(self.linear1(tgt)))
        return self.norm3(tgt + drop(h, self.training, generator))


class Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Encoder(nn.Module):
    def __init__(self, in_ch, window, z_dim, n_heads, ff, n_layers):
        super().__init__()
        self.z_dim = z_dim
        self.pose_embedding = rm.Linear(in_ch, z_dim)
        self.register_buffer("pe", positions(window, z_dim), persistent=False)
        self.transformer_encoder = Layers([EncoderLayer(z_dim, n_heads, ff) for _ in range(n_layers)])
        self.fc_mu = rm.Linear(window * z_dim, z_dim)
        self.fc_sigma = nn.Sequential(rm.Linear(window * z_dim, z_dim * (z_dim + 1) // 2))

    def forward(self, x, mu_only, generator):
        h = drop(self.pose_embedding(x) + self.pe, self.training, generator)
        for layer in self.transformer_encoder.layers:
            h = layer(h, generator)
        flat = h.flatten(1)
        mu = self.fc_mu(flat)
        if mu_only:
            return mu, None
        return mu, rm.packed_to_L(rm.packed_softplus_diag(self.fc_sigma(flat), self.z_dim), self.z_dim)


class Decoder(nn.Module):
    def __init__(self, out_ch, window, z_dim, n_heads, ff, n_layers):
        super().__init__()
        self.register_buffer("pe", positions(window, z_dim), persistent=False)
        self.transformer_decoder = Layers([DecoderLayer(z_dim, n_heads, ff) for _ in range(n_layers)])
        self.fc_out = rm.Linear(z_dim, out_ch)

    def forward(self, z, generator):
        tgt = drop(self.pe.expand(z.shape[0], -1, -1), self.training, generator)
        memory = z[:, None, :]
        for layer in self.transformer_decoder.layers:
            tgt = layer(tgt, memory, generator)
        return torch.tanh(self.fc_out(tgt))


class TransformerVAE(nn.Module):
    def __init__(self, in_ch, window, z_dim, n_heads, ff, n_layers, cond_dim, arena, conditional_keys,
                 discrete_classes):
        super().__init__()
        self.z_dim, self.cond_dim, self.window = z_dim, cond_dim, window
        self.conditional_keys, self.discrete_classes = tuple(conditional_keys), dict(discrete_classes)
        self.register_buffer("arena", torch.as_tensor(np.asarray(arena, np.float32)), persistent=False)
        self.encoder = Encoder(in_ch, window, z_dim, n_heads, ff, n_layers)
        self.decoder = Decoder(in_ch, window, z_dim, n_heads, ff, n_layers)
        if cond_dim > 0:
            self.cond_proj = rm.Linear(z_dim + cond_dim, z_dim)

    def encode(self, data, mu_only=False, generator=None):
        B, W = data["x6d"].shape[:2]
        x_in = torch.cat([data["x6d"].reshape(B, W, -1), geo.normalize_root(data["root"], self.arena)], dim=-1)
        mu, L = self.encoder(x_in, mu_only, generator)
        return {"mu": mu} if L is None else {"mu": mu, "L": L}

    def forward(self, data, eps=None, generator=None):
        out = self.encode(data, generator=generator)
        if self.training and eps is not None:
            out["z"] = out["mu"] + torch.einsum("bij,bj->bi", out["L"], eps)
        else:
            out["z"] = out["mu"]
        z = out["z"]
        if self.cond_dim > 0:
            parts = [F.one_hot(data[k].reshape(-1).long(), self.discrete_classes[k]).float()
                     if k in self.discrete_classes else data[k] for k in self.conditional_keys]
            out["var"] = torch.cat(parts, dim=-1)
            z = self.cond_proj(torch.cat([z, out["var"]], dim=-1))
        x_hat = self.decoder(z, generator)
        out["root"] = geo.inv_normalize_root(x_hat[..., -3:], self.arena)
        out["x6d"] = x_hat[..., :-3].reshape(x_hat.shape[0], self.window, -1, 6)
        return out
