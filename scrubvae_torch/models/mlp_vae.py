"""MLP encoder/decoder VAE (counterpart of ``scrubvae_tpu/models/mlp_vae.py``),
the model of ``configs/ladder/1_vanilla_mlp.yaml``, on the data interface
the rcnn model has (``models/base.py``), so the train and eval stack serves
it unchanged.

The encoder flattens the window (the pose and the arena-normalised root of
every frame) through ReLU dense layers to ``fc_mu`` and a dense Cholesky
head over ``fc_sigma``; the decoder takes z and the conditionals through
the layers in reverse order to ``dec_out`` and a tanh. Parameter names are
the JAX package's (``enc_{i}``, ``fc_mu``, ``fc_sigma``, ``dec_{i}``,
``dec_out``). It computes in f32 (bf16-stored kernels are promoted), as the
JAX model, which takes no precision setting; it has no dropout.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from scrubvae_torch.models.base import PoseVAE
from scrubvae_torch.models.layers import CholeskyL, Linear
from scrubvae_torch.utils.profiling import stamp

__all__ = ["MLPVAE"]


class MLPVAE(PoseVAE):
    def __init__(
        self,
        in_channels: int,
        window: int = 51,
        z_dim: int = 32,
        hidden: Sequence[int] = (512, 256),
        is_diag: bool = True,
        conditional_dim: int = 0,
        prior: str = "gaussian",
        arena_size=None,
        conditional_keys: Sequence[str] = (),
        discrete_classes: Optional[Dict[str, int]] = None,
    ):
        super().__init__(z_dim, window, is_diag, conditional_dim, arena_size, conditional_keys, discrete_classes)
        self.in_channels = in_channels
        self.hidden = tuple(hidden)
        width = window * in_channels
        for i, w in enumerate(self.hidden):
            setattr(self, f"enc_{i}", Linear(width, w))
            width = w
        self.fc_mu = Linear(width, z_dim)
        self.fc_sigma = Linear(width, z_dim if is_diag else z_dim * (z_dim + 1) // 2)
        self.cholesky = CholeskyL(z_dim, is_diag)
        width = z_dim + conditional_dim
        for i, w in enumerate(reversed(self.hidden)):
            setattr(self, f"dec_{i}", Linear(width, w))
            width = w
        self.dec_out = Linear(width, window * in_channels)

    def encode(
        self, data: Dict[str, torch.Tensor], mu_only: bool = False, generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        """mu (and the dense Cholesky factor ``L``) of the batch."""
        x_in = self.pose_input(data["x6d"], data["root"])
        h = x_in.reshape(x_in.shape[0], -1)
        for i in range(len(self.hidden)):
            h = F.relu(getattr(self, f"enc_{i}")(h))
        mu = self.fc_mu(h)
        if mu_only:
            return {"mu": mu}
        return {"mu": mu, "L": self.cholesky(self.fc_sigma(h))}

    def decode(
        self, z: torch.Tensor, data: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Dict[str, torch.Tensor]:
        stamp("encoder")  # a traced train step's encoder ends here (utils.profiling)
        out: Dict[str, torch.Tensor] = {}
        var = self.build_conditionals(data)
        if var is not None:
            out["var"] = var
            z = torch.cat([z, var], dim=-1)
        h = z
        for i in range(len(self.hidden)):
            h = F.relu(getattr(self, f"dec_{i}")(h))
        x_hat = torch.tanh(self.dec_out(h)).reshape(z.shape[0], self.window, self.in_channels)
        out.update(self.pose_output(x_hat))
        return out
