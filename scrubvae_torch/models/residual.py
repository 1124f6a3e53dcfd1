"""Residual convolutional VAE, the flagship model (counterpart of
``scrubvae_tpu/models/residual.py``, ``rcnn``): with the gaussian prior,
either Cholesky head, packed, ``Lp`` (B, D(D+1)/2), or dense, ``L``
(B, D, D), which total correlation needs, over a dense ``fc_sigma`` or,
with ``sigma_head_rank``, its low-rank factorization ``fc_sigma_u`` then
``fc_sigma_v``; with the beta prior, the ``alpha`` and ``beta`` heads and
a reparameterised sample of Beta(alpha, beta) scaled to (-1, 1).

Public methods take and return the JAX package's layout: batches are dicts
of (B, W, J, 6) ``x6d`` and (B, W, 3) ``root``. Inside, the stack is NCW and
the encoder flattens channel-major, like the reference torch model. Heads
and the decoder emit f32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scrubvae_torch.models.base import PoseVAE
from scrubvae_torch.models.layers import (
    CholeskyL,
    Conv1d,
    ConvTranspose1d,
    Linear,
    ResidualBlock,
    ResidualBlockTranspose,
    decoder_lengths,
    encoder_lengths,
    f32_or_wider,
    make_activation,
    packed_softplus_diag,
)

__all__ = ["ResidualEncoder", "ResidualDecoder", "ResVAE", "gamma_rsample"]

DEFAULT_CH = (64, 128, 256, 512, 1024)


class ResidualEncoder(nn.Module):
    def __init__(
        self,
        in_channels: int,
        ch: Sequence[int] = DEFAULT_CH,
        kernel: int = 5,
        z_dim: int = 128,
        window: int = 51,
        activation: str = "prelu",
        is_diag: bool = False,
        init_dilation: Optional[int] = None,
        compute_dtype: Optional[torch.dtype] = None,
        packed_sigma: bool = True,
        prior: str = "gaussian",
        sigma_head_rank: Optional[int] = None,
    ):
        super().__init__()
        n = len(ch) - 1
        dil = [1] * n if init_dilation is None else [init_dilation * 2**i for i in range(n)]
        self.z_dim, self.is_diag, self.compute_dtype = z_dim, is_diag, compute_dtype
        dt = compute_dtype
        self.conv_in = Conv1d(in_channels, ch[0], 7, 1, 3, compute_dtype=dt)
        self.activation = make_activation(activation)
        self.res_layers = nn.Sequential(
            *[
                ResidualBlock(ch[i], ch[i + 1], kernel, activation, dil[i], compute_dtype=dt)
                for i in range(n)
            ]
        )
        flat = ch[-1] * encoder_lengths(window, kernel, n, dil)[-1]
        self.prior = prior
        if prior == "beta":
            self.fc_alpha = Linear(flat, z_dim, compute_dtype=dt)
            self.fc_beta = Linear(flat, z_dim, compute_dtype=dt)
            return
        if prior != "gaussian":
            raise ValueError(f"unknown prior {prior!r}")
        sig_dim = z_dim if is_diag else z_dim * (z_dim + 1) // 2
        self.fc_mu = Linear(flat, z_dim, compute_dtype=dt)
        # the JAX package's rule: low rank only for the full head, and only
        # where the rank is below both widths of the dense map
        self.low_rank = bool(sigma_head_rank and not is_diag and sigma_head_rank < min(sig_dim, flat))
        if self.low_rank:
            self.fc_sigma_u = Linear(flat, sigma_head_rank, compute_dtype=dt)
            self.fc_sigma_v = Linear(sigma_head_rank, sig_dim, compute_dtype=dt)
        else:
            self.fc_sigma = nn.Sequential(Linear(flat, sig_dim, compute_dtype=dt))
        self.packed_sigma = packed_sigma
        self.cholesky = None if packed_sigma else CholeskyL(z_dim, is_diag)

    def forward(self, x: torch.Tensor, mu_only: bool = False):
        """x: (B, W, C) -> (mu (B, z), L or None), both f32: L packed (B, K)
        or dense (B, z, z); with the beta prior (alpha, beta) (B, z), f32,
        whatever ``mu_only``."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        h = self.activation(self.conv_in(x.transpose(1, 2)))
        h = self.res_layers(h).flatten(1)  # channel-major (C, L)
        if self.prior == "beta":
            alpha = F.softplus(f32_or_wider(self.fc_alpha(h))) + 1.0
            return alpha, F.softplus(f32_or_wider(self.fc_beta(h))) + 1.0
        mu = f32_or_wider(self.fc_mu(h))
        if mu_only:
            return mu, None
        sig = self.fc_sigma_v(self.fc_sigma_u(h)) if self.low_rank else self.fc_sigma(h)
        sig = f32_or_wider(sig)
        if self.cholesky is not None:
            return mu, self.cholesky(sig)
        return mu, packed_softplus_diag(sig, self.z_dim, self.is_diag)


class ResidualDecoder(nn.Module):
    def __init__(
        self,
        out_channels: int,
        ch: Sequence[int] = DEFAULT_CH,
        kernel: int = 5,
        z_dim: int = 128,
        window: int = 51,
        activation: str = "prelu",
        conditional_dim: int = 0,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        n = len(ch) - 1
        self.latent_len = encoder_lengths(window, kernel, n, [1] * n)[-1]
        self.compute_dtype = compute_dtype
        dt = compute_dtype
        self.fc_in = Linear(z_dim + conditional_dim, self.latent_len * ch[-1], compute_dtype=dt)
        self.res_layers = nn.Sequential(
            *[
                ResidualBlockTranspose(ch[-i], ch[-i - 1], kernel, activation, compute_dtype=dt)
                for i in range(1, len(ch))
            ]
        )
        l_out = decoder_lengths(self.latent_len, kernel, n)[-1]
        self.conv_out = ConvTranspose1d(
            ch[0], out_channels, window - l_out + 7, 1, 3, compute_dtype=dt
        )
        self.ch_last = ch[-1]

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, z + cond) -> (B, W, C) f32 in (-1, 1)."""
        if self.compute_dtype is not None:
            z = z.to(self.compute_dtype)
        h = self.fc_in(z).reshape(z.shape[0], self.ch_last, self.latent_len)
        h = self.conv_out(self.res_layers(h))
        return f32_or_wider(torch.tanh(h)).transpose(1, 2)


class _GammaDraw(torch.autograd.Function):
    """A Gamma(alpha, 1) draw as a function of alpha, differentiated
    implicitly (d draw / d alpha at a fixed CDF), as ``jax.random.gamma``
    is."""

    @staticmethod
    def forward(ctx, alpha, draw):
        ctx.save_for_backward(alpha, draw)
        return draw.clone()

    @staticmethod
    def backward(ctx, grad):
        alpha, draw = ctx.saved_tensors
        return grad * torch._standard_gamma_grad(alpha, draw), None


def gamma_rsample(
    alpha: torch.Tensor, generator: Optional[torch.Generator] = None, draw: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Reparameterised Gamma(alpha, 1) draws: from ``generator``, or the
    given ``draw`` (another sampler's draws at this alpha), with the
    implicit gradient with respect to alpha either way."""
    if draw is None:
        draw = torch._standard_gamma(alpha.detach(), generator=generator)
    return _GammaDraw.apply(alpha, draw.detach().to(alpha.dtype))


class ResVAE(PoseVAE):
    """Encoder/decoder with arena root normalisation and conditional
    decoding; the packed Cholesky head with ``packed_sigma``, else the
    dense one; or, with ``prior="beta"``, the beta heads (never packed)."""

    def __init__(
        self,
        in_channels: int,
        ch: Sequence[int] = DEFAULT_CH,
        kernel: int = 5,
        z_dim: int = 128,
        window: int = 51,
        activation: str = "prelu",
        is_diag: bool = False,
        conditional_dim: int = 0,
        init_dilation: Optional[int] = None,
        prior: str = "gaussian",
        arena_size=None,
        conditional_keys: Sequence[str] = (),
        discrete_classes: Optional[Dict[str, int]] = None,
        precision: str = "fp32",
        sigma_head_rank: Optional[int] = None,
        packed_sigma: bool = True,
    ):
        super().__init__(z_dim, window, is_diag, conditional_dim, arena_size, conditional_keys, discrete_classes)
        self.prior = prior
        self.packed_sigma = packed_sigma and prior == "gaussian"
        dt = torch.bfloat16 if precision == "bf16" else None
        self.encoder = ResidualEncoder(
            in_channels, ch, kernel, z_dim, window, activation, is_diag, init_dilation, dt,
            self.packed_sigma, prior, sigma_head_rank,
        )
        self.decoder = ResidualDecoder(
            in_channels, ch, kernel, z_dim, window, activation, conditional_dim, dt
        )

    def encode(
        self, data: Dict[str, torch.Tensor], mu_only: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """mu (and the Cholesky factor) of the batch; the encoder reads the
        heading-free view ``x6d_enc``/``root_enc`` when the batch carries it
        (``data.encoder_direction_process``), else ``x6d``/``root``. Under
        the beta prior: ``alpha``, ``beta`` and their mode scaled to
        (-1, 1) as ``mu``, whatever ``mu_only``."""
        x_in = self.pose_input(data.get("x6d_enc", data["x6d"]), data.get("root_enc", data["root"]))
        if self.prior == "beta":
            a, b = self.encoder(x_in)
            return {"alpha": a, "beta": b, "mu": (a - 1.0 + 1e-8) / (a + b - 2.0 + 2e-8) * 2.0 - 1.0}
        mu, L = self.encoder(x_in, mu_only=mu_only)
        if L is None:
            return {"mu": mu}
        return {"mu": mu, self.sigma_key: L}

    def decode(
        self, z: torch.Tensor, data: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        var = self.build_conditionals(data)
        if var is not None:
            out["var"] = var
            z = torch.cat([z, var], dim=-1)
        out.update(self.pose_output(self.decoder(z)))
        return out

    def forward(
        self,
        data: Dict[str, torch.Tensor],
        eps=None,
        mu_only: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The gaussian prior as ``PoseVAE.forward``. The beta prior in
        training mode: z = ga / (ga + gb) * 2 - 1 for reparameterised
        Gamma(alpha) and Gamma(beta) draws ``ga``, ``gb``, from
        ``generator`` in that order, or ``eps`` = (ga, gb) when given;
        z = mu in eval mode."""
        if self.prior != "beta":
            return super().forward(data, eps=eps, mu_only=mu_only, generator=generator)
        out = self.encode(data)
        if self.training:
            ga_draw, gb_draw = (None, None) if eps is None else eps
            ga = gamma_rsample(out["alpha"], generator, ga_draw)
            gb = gamma_rsample(out["beta"], generator, gb_draw)
            out["z"] = ga / (ga + gb) * 2.0 - 1.0
        else:
            out["z"] = out["mu"]
        out.update(self.decode(out["z"], data))
        return out
