"""Residual convolutional VAE, the flagship model (counterpart of
``scrubvae_tpu/models/residual.py``, ``rcnn`` with the gaussian prior and
either Cholesky head: packed, ``Lp`` (B, D(D+1)/2), or dense, ``L``
(B, D, D), which total correlation needs).

Public methods take and return the JAX package's layout: batches are dicts
of (B, W, J, 6) ``x6d`` and (B, W, 3) ``root``. Inside, the stack is NCW and
the encoder flattens channel-major, like the reference torch model. Heads
and the decoder emit f32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
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

__all__ = ["ResidualEncoder", "ResidualDecoder", "ResVAE"]

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
        sig_dim = z_dim if is_diag else z_dim * (z_dim + 1) // 2
        self.fc_mu = Linear(flat, z_dim, compute_dtype=dt)
        self.fc_sigma = nn.Sequential(Linear(flat, sig_dim, compute_dtype=dt))
        self.packed_sigma = packed_sigma
        self.cholesky = None if packed_sigma else CholeskyL(z_dim, is_diag)

    def forward(self, x: torch.Tensor, mu_only: bool = False):
        """x: (B, W, C) -> (mu (B, z), L or None), both f32: L packed (B, K)
        or dense (B, z, z)."""
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        h = self.activation(self.conv_in(x.transpose(1, 2)))
        h = self.res_layers(h).flatten(1)  # channel-major (C, L)
        mu = f32_or_wider(self.fc_mu(h))
        if mu_only:
            return mu, None
        sig = f32_or_wider(self.fc_sigma(h))
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


class ResVAE(PoseVAE):
    """Encoder/decoder with arena root normalisation and conditional
    decoding; the packed Cholesky head with ``packed_sigma``, else the
    dense one."""

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
        if prior != "gaussian" or sigma_head_rank:
            raise NotImplementedError(
                "scrubvae_torch ResVAE supports the gaussian prior with a full-rank "
                "Cholesky head only (ROADMAP.md A.5)"
            )
        self.packed_sigma = packed_sigma
        dt = torch.bfloat16 if precision == "bf16" else None
        self.encoder = ResidualEncoder(
            in_channels, ch, kernel, z_dim, window, activation, is_diag, init_dilation, dt,
            packed_sigma,
        )
        self.decoder = ResidualDecoder(
            in_channels, ch, kernel, z_dim, window, activation, conditional_dim, dt
        )

    def encode(
        self, data: Dict[str, torch.Tensor], mu_only: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """mu (and the Cholesky factor) of the batch; the encoder reads the
        heading-free view ``x6d_enc``/``root_enc`` when the batch carries it
        (``data.encoder_direction_process``), else ``x6d``/``root``."""
        x_in = self.pose_input(data.get("x6d_enc", data["x6d"]), data.get("root_enc", data["root"]))
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
