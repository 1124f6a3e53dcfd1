"""Training orchestration for the flagship path (counterpart of the
construction, ``loss_scale_for_epoch``, ``_maybe_lowp_params`` and
``train_epoch`` of ``scrubvae_tpu/train/trainer.py``; no mesh, host
streaming, checkpoints, evaluation or logging sinks yet). The JAX scanned
epoch becomes a Python loop of steps over an index matrix."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from scrubvae_torch import factory
from scrubvae_torch.data.dataset import epoch_index_matrix
from scrubvae_torch.device import resolve_device
from scrubvae_torch.train import optim
from scrubvae_torch.train.state import TrainState
from scrubvae_torch.train.step import make_train_step

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, config: dict, datasets: dict, model, info: dict, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.train_ds = datasets["train"]
        if self.train_ds.device != self.device:
            raise ValueError(
                f"train dataset lives on {self.train_ds.device}, trainer on {self.device}"
            )
        data_cfg = config["data"]
        self.batch_size = int(data_cfg.get("batch_size") or 256)
        self.batch_size = max(1, min(self.batch_size, len(self.train_ds)))
        if config["train"].get("mesh"):
            raise NotImplementedError("scrubvae_torch trains on one device")
        self.loss_cfg = dict(config.get("loss") or {})
        self.dis_cfg = config["disentangle"]
        self.train_cfg = config["train"]
        self.seed = int(self.train_cfg.get("seed") or 0)
        self.steps_per_epoch = max(len(self.train_ds) // self.batch_size, 1)
        self.tx = optim.make_optimizer(self.train_cfg, self.steps_per_epoch)

        factory.init_weights(self.model, self.seed)
        self._maybe_lowp_params()
        self.state = TrainState(
            step=0,
            opt_state=self.tx.init(list(self.model.parameters())),
            scrub_state=factory.init_scrub_state(
                self.dis_cfg, self.loss_cfg, info["z_dim"], info["feat_dims"], self.device
            ),
            generator=torch.Generator(device=self.device).manual_seed(self.seed),
        )
        self.train_step = make_train_step(
            self.model, self.tx, self.train_ds.kinematic_tree,
            disentangle_config=self.dis_cfg, batch_fn=self.train_ds.batch,
        )
        self.np_rng = np.random.default_rng(self.seed)

    def loss_scale_for_epoch(self, epoch: int) -> Dict[str, float]:
        scale = {k: float(v) for k, v in self.loss_cfg.items()}
        if "prior" in scale and self.train_cfg.get("beta_anneal"):
            scale["prior"] = optim.cyclical_beta(epoch, beta_max=float(self.loss_cfg["prior"]))
        return scale

    @torch.no_grad()
    def _maybe_lowp_params(self) -> None:
        """train.param_dtype bf16: store the large kernels (at least
        ``FusedAdamW.MIN_LOWP_ELEMS`` elements) in bf16; the fused optimizer
        keeps them integrating with stochastically rounded stores. Small
        leaves stay f32."""
        if (self.train_cfg.get("param_dtype") or "f32") != "bf16":
            return
        for p in self.model.parameters():
            if p.dtype == torch.float32 and p.numel() >= optim.FusedAdamW.MIN_LOWP_ELEMS:
                p.data = p.data.to(torch.bfloat16)

    def train_epoch(self, epoch: int, idx_matrix: Optional[np.ndarray] = None) -> Dict[str, float]:
        """One pass over ``idx_matrix`` (steps, batch) of window indices, a
        shuffled epoch by default; returns the mean of each loss term."""
        loss_scale = self.loss_scale_for_epoch(epoch)
        if idx_matrix is None:
            idx_matrix = epoch_index_matrix(len(self.train_ds), self.batch_size, self.np_rng)
        idx_dev = torch.as_tensor(idx_matrix, device=self.device)
        sums: Dict[str, torch.Tensor] = {}
        for idx in idx_dev:
            self.state, metrics = self.train_step(self.state, idx, loss_scale)
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        n = max(len(idx_dev), 1)
        return {k: float(v) / n for k, v in sums.items()}
