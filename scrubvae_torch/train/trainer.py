"""Training orchestration (counterpart of ``Trainer`` and ``train`` of
``scrubvae_tpu/train/trainer.py``): beta annealing, per-epoch re-init of
the gradient-reversal ensembles, MALS lambda logging, weights every 5
epochs and the full state every 20, validation losses and generative
restrictiveness every 5 epochs from ``train.eval_start_epoch``, resume from
``model.load_model`` + ``model.start_epoch``, and ``metrics.csv``.

The JAX scanned epoch becomes a Python loop of steps over an index matrix.
Two of the JAX package's accelerator options are accepted and have no
effect: ``train.scan_epoch`` (the port always steps from the host: an
eager step has no program to scan) and ``train.donate`` (steps update
parameters, moments and statistics in place, so nothing is left to
donate). ``train.mesh`` must be unset: the port trains on one device.

The cross-validated decodability metrics are not ported yet (ROADMAP.md
A8): unless ``train.minimal_test`` is true, which skips them as it does in
the JAX package, constructing a ``Trainer`` raises.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from scrubvae_torch import factory
from scrubvae_torch.data.dataset import epoch_batches, epoch_index_matrix
from scrubvae_torch.device import resolve_device
from scrubvae_torch.evals.restrictiveness import generative_restrictiveness_batch
from scrubvae_torch.train import optim
from scrubvae_torch.train.state import TrainState
from scrubvae_torch.train.step import make_eval_step, make_train_step
from scrubvae_torch.utils import checkpoint as ckpt
from scrubvae_torch.utils.logging import MetricLogger

__all__ = ["Trainer", "train"]

GEN_RESTRICT_KEYS = ("heading", "avg_speed_3d")


class Trainer:
    def __init__(self, config: dict, datasets: dict, model, info: dict, run=None, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.info = info
        self.model = model.to(self.device)
        self.train_ds = datasets["train"]
        self.val_ds = datasets.get("val")
        for ds in (self.train_ds, self.val_ds):
            if ds is not None and ds.device != self.device:
                raise ValueError(f"a dataset lives on {ds.device}, the trainer on {self.device}")
        self.train_cfg = config["train"]
        if not self.train_cfg.get("minimal_test"):
            raise NotImplementedError(
                "scrubvae_torch has no decodability metrics yet (ROADMAP.md A8, "
                "evals/metrics.py); set train.minimal_test: true"
            )
        if self.train_cfg.get("mesh"):
            raise NotImplementedError("scrubvae_torch trains on one device")
        data_cfg = config["data"]
        self.batch_size = int(data_cfg.get("batch_size") or 256)
        # a batch above len(train) would give no batch an epoch
        self.batch_size = max(1, min(self.batch_size, len(self.train_ds)))
        self.loss_cfg = dict(config.get("loss") or {})
        self.dis_cfg = config["disentangle"]
        self.out_path = config.get("out_path") or "./"
        self.seed = int(self.train_cfg.get("seed") or 0)
        ese = self.train_cfg.get("eval_start_epoch")
        self.eval_start_epoch = 50 if ese is None else int(ese)
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
        model_cfg = config.get("model") or {}
        self.start_epoch = int(model_cfg.get("start_epoch") or 0)
        load_model = model_cfg.get("load_model")
        if load_model and self.start_epoch:
            ckpt.load_weights(load_model, self.start_epoch, self.model)
            full = ckpt.load_train_state(load_model, self.start_epoch, self.model, self.state)
            if full is not None:
                self.state = full

        tree = self.train_ds.kinematic_tree
        self.train_step = make_train_step(
            self.model, self.tx, tree, disentangle_config=self.dis_cfg, batch_fn=self.train_ds.batch,
        )
        self.eval_step = (
            make_eval_step(
                self.model, tree, disentangle_config=self.dis_cfg,
                loss_keys=tuple(self.loss_cfg), batch_fn=self.val_ds.batch,
            )
            if self.val_ds is not None
            else None
        )
        self.logger = MetricLogger(
            self.out_path,
            use_wandb=run is not None,
            wandb_run=run,
            resume=bool(load_model) and self.start_epoch > 0,
            start_epoch=self.start_epoch,
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
        # sorted, as the JAX package's jitted steps return their dicts
        return {k: float(sums[k]) / n for k in sorted(sums)}

    def _gen_restrict_keys(self) -> tuple:
        return tuple(k for k in self.info["disentangle_keys"] if k in GEN_RESTRICT_KEYS)

    def test_epoch(self, epoch: int, draws: Optional[Dict[str, list]] = None):
        """Validation epoch over the whole val split: full batches, then the
        ``len(val) % batch_size`` tail, each batch's mean losses weighted by
        its size; the generative-restrictiveness R^2 of each conditioned
        factor over all samples. ``draws[key][b]`` is the random draw of
        batch ``b`` for ``key`` (see ``generative_restrictiveness_batch``);
        by default they come from a generator seeded with ``1000 + epoch``,
        one draw a batch per key in key order. Returns (metrics, mu of every
        val sample as a numpy array)."""
        loss_scale = self.loss_scale_for_epoch(epoch)
        gen = torch.Generator(device=self.device).manual_seed(1000 + epoch)
        tree = self.val_ds.kinematic_tree
        keys = self._gen_restrict_keys()
        losses, zs = [], []
        gen_res = {k: ([], []) for k in keys}
        for b, idx in enumerate(epoch_batches(len(self.val_ds), self.batch_size, None, drop_last=False)):
            idx = torch.as_tensor(idx, device=self.device)
            data = self.val_ds.batch(idx)
            bl, mu = self.eval_step(self.state, idx, loss_scale, data=data)
            losses.append((bl, len(idx)))
            zs.append(mu)
            for key in keys:
                pred, target = generative_restrictiveness_batch(
                    self.model, mu, data, key, tree, norm_params=self.val_ds.norm_params,
                    draw=None if draws is None else draws[key][b], generator=gen,
                )
                gen_res[key][0].append(pred)
                gen_res[key][1].append(target)

        sums: Dict[str, float] = {}
        for bl, nb in losses:
            for k, v in bl.items():
                sums[k] = sums.get(k, 0.0) + float(v) * nb
        count = sum(nb for _, nb in losses)
        metrics = {k: sums[k] / max(count, 1) for k in sorted(sums)}
        for key, (preds, targets) in gen_res.items():
            # summed in f32 on the host, as the JAX package does
            pred = torch.cat(preds).cpu().numpy()
            target = torch.cat(targets).cpu().numpy()
            ss_res = ((target - pred) ** 2).sum()
            ss_tot = ((target - target.mean(axis=0)) ** 2).sum()
            metrics[f"r2_gen_restrict_{key}"] = float(1.0 - ss_res / ss_tot)
        return metrics, torch.cat(zs).cpu().numpy() if zs else np.zeros((0,))

    @torch.no_grad()
    def reset_gr(self, epoch: int) -> None:
        """Per-epoch re-init of the gradient-reversal ensembles (reference
        trainer.py:368-370), in place so the optimizer's leaf table stays
        valid; their moments are left as they are."""
        if len(self.model.grad_reversal):
            factory.init_weights(self.model.grad_reversal, self.seed * 100003 + epoch)

    def lambda_metrics(self) -> Dict[str, float]:
        return {
            f"lambda_mals_{k}": float(st.lam1)
            for k, st in self.state.scrub_state.get("moving_avg_lsq", {}).items()
        }

    def _check_finite(self, train_metrics: Dict[str, float], epoch: int) -> None:
        """Divergence tripwire: a non-finite epoch loss halts the run with a
        diagnostic checkpoint. Opt out with ``train.halt_on_nonfinite:
        false`` (unset means on)."""
        if self.train_cfg.get("halt_on_nonfinite") is False or np.isfinite(train_metrics.get("total", 0.0)):
            return
        bad = {k: v for k, v in train_metrics.items() if not np.isfinite(v)}
        path = ckpt.save_train_state(self.out_path, epoch, self.model, self.state)
        raise FloatingPointError(
            f"non-finite training loss at epoch {epoch}: {bad}; diagnostic train state saved "
            f"to {path} (set train.halt_on_nonfinite: false to train through)"
        )

    def fit(self, num_epochs: Optional[int] = None) -> TrainState:
        num_epochs = num_epochs or int(self.train_cfg.get("num_epochs") or 1)
        for epoch in range(self.start_epoch + 1, num_epochs + 1):
            t0 = time.time()
            train_metrics = self.train_epoch(epoch)
            self._check_finite(train_metrics, epoch)
            metrics = {f"{k}_train": v for k, v in train_metrics.items()}
            self.reset_gr(epoch)
            metrics.update(self.lambda_metrics())
            metrics["time"] = time.time() - t0

            if epoch % 5 == 0:
                ckpt.save_weights(self.out_path, epoch, self.model)
                if epoch % 20 == 0:
                    ckpt.save_train_state(self.out_path, epoch, self.model, self.state)
                if epoch >= self.eval_start_epoch and self.eval_step is not None:
                    test_metrics, _ = self.test_epoch(epoch)
                    metrics.update({f"{k}_test": v for k, v in test_metrics.items()})

            self.logger.log(metrics, epoch)
        return self.state


def train(config: dict, datasets=None, model=None, info=None, run=None, device=None) -> Trainer:
    """Build the datasets and the model from ``config`` unless given, then
    train for ``train.num_epochs``; returns the trainer."""
    if datasets is None or model is None:
        datasets, model, info = factory.data_and_model(
            config,
            train_val_test=("train", "val"),
            data_keys=tuple(
                ["x6d", "root", "offsets", "target_pose"]
                + list(config["disentangle"].get("features") or [])
            ),
            device=device,
        )
    trainer = Trainer(config, datasets, model, info, run=run, device=device)
    trainer.fit()
    return trainer
