"""Top-level model: core VAE + trainable scrubber heads (counterpart of
``scrubvae_tpu/models/scrubvae.py``). The linear null-space projection of a
feature, when present, supplies ``z_null`` as the latent of that feature's
other scrubbers."""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from scrubvae_torch.models.scrubbers import GRScrubber, LinearProjection
from scrubvae_torch.utils.profiling import stamp

__all__ = ["ScrubVAE"]


class ScrubVAE(nn.Module):
    def __init__(
        self,
        vae: nn.Module,
        linear_dims: Optional[Mapping[str, int]] = None,
        gr_dims: Optional[Mapping[str, int]] = None,
        gr_alpha: float = 1.0,
    ):
        super().__init__()
        self.vae = vae
        self.linear_dims = dict(linear_dims or {})
        self.gr_dims = dict(gr_dims or {})
        z = vae.z_dim
        self.linear = nn.ModuleDict({k: LinearProjection(z, d) for k, d in self.linear_dims.items()})
        self.grad_reversal = nn.ModuleDict(
            {k: GRScrubber(z, d, alpha=gr_alpha) for k, d in self.gr_dims.items()}
        )

    def encode(self, data: Dict[str, torch.Tensor], mu_only: bool = False) -> Dict[str, torch.Tensor]:
        return self.vae.encode(data, mu_only=mu_only)

    def decode(self, z: torch.Tensor, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.vae.decode(z, data)

    def forward(
        self,
        data: Dict[str, torch.Tensor],
        eps: Optional[torch.Tensor] = None,
        mu_only: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict:
        """The VAE's output (``models/base.py``; ``generator`` draws its
        dropout masks in training mode) and, under ``disentangle``, each
        scrubber head's. A traced train step stamps the end of the VAE's
        forward and of the heads (``utils.profiling``)."""
        out = self.vae(data, eps=eps, mu_only=mu_only, generator=generator)
        stamp("decoder")
        dis: Dict[str, Dict] = {}
        if len(self.linear):
            dis["linear"] = {k: m(out["mu"]) for k, m in self.linear.items()}
        if len(self.grad_reversal):
            dis["grad_reversal"] = {
                k: m(dis["linear"][k]["z_null"] if k in self.linear else out["mu"])
                for k, m in self.grad_reversal.items()
            }
        out["disentangle"] = dis
        stamp("scrub_forward")
        return out
