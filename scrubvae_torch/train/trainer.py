"""Training orchestration (counterpart of ``Trainer`` and ``train`` of
``scrubvae_tpu/train/trainer.py``): beta annealing, per-epoch re-init of
the gradient-reversal ensembles, MALS and QDA lambda logging, the
streaming scrubber states (MALS, moving-average class means, QDA), the
adversarial discriminators and the MCMI estimator carried in the train
state, weights every 5 epochs and the full state every 20, validation
losses (after the MCMI estimator is rebuilt from the validation split) and
generative restrictiveness and the cross-validated decodability of the
validation mu every 5 epochs from ``train.eval_start_epoch``, resume from
``model.load_model`` + ``model.start_epoch``, and ``metrics.csv``.

A train split in host memory (``HostStreamDataset``, ``data.host_stream``)
feeds each step a slab copied to the device ahead of it
(``prefetch_to_device``, two deep), which the step assembles; the epoch's
batch order is the device-resident one, from the same numpy generator.

The JAX scanned epoch becomes a Python loop of steps over an index matrix.
Two of the JAX package's accelerator options are accepted and have no
effect: ``train.scan_epoch`` (the port always steps from the host: an
eager step has no program to scan) and ``train.donate`` (steps update
parameters, moments and statistics in place, so nothing is left to
donate). ``train.mesh`` is accepted where one device is visible, where
the JAX package ignores it too; the port shards over no more than one
(a mesh over several devices raises).

Decodability (``decodability_metrics``) runs its estimators on the
trainer's device and draws from no training stream (not the sample-noise
generator, not the batch-order ``np_rng``), so a run trains bit for bit as
the same run with ``train.minimal_test: true``, which skips it as it does
in the JAX package.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from scrubvae_torch import factory
from scrubvae_torch.data.dataset import epoch_batches, epoch_index_matrix
from scrubvae_torch.data.hoststream import HostStreamDataset, prefetch_to_device
from scrubvae_torch.device import resolve_device
from scrubvae_torch.evals import metrics as em
from scrubvae_torch.evals.restrictiveness import generative_restrictiveness_batch
from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.train import optim
from scrubvae_torch.train.state import TrainState
from scrubvae_torch.train.step import encode_mi_state, feature_slices, make_eval_step, make_train_step
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
        if isinstance(self.val_ds, HostStreamDataset):
            raise ValueError(
                "host-streaming val splits are unsupported: the validation epoch reads the "
                "split again and again (data.host_stream applies to the train split only)"
            )
        self.host_stream = isinstance(self.train_ds, HostStreamDataset)
        self.stream_stats: Dict[str, float] = {}  # the host stream's waits (prefetch_to_device)
        self.train_cfg = config["train"]
        visible = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if self.train_cfg.get("mesh") and visible > 1:
            raise NotImplementedError(f"scrubvae_torch trains on one device; train.mesh over {visible} is not ported")
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
        if (self.train_cfg.get("param_dtype") or "f32") == "bf16" and not isinstance(self.tx, optim.FusedAdamW):
            raise ValueError(
                "train.param_dtype: bf16 requires the fused optimizer (stochastically rounded "
                "weight stores); remove fused_optimizer: false, optimizer: sgd or param_dtype"
            )

        factory.init_weights(self.model, self.seed)
        self._maybe_lowp_params()
        self.adv_bundle = factory.init_adv_bundle(
            self.dis_cfg, info["z_dim"], info["feat_dims"], self.seed, self.device
        )
        self.mcmi_bandwidth = float(self.dis_cfg.get("bandwidth") or 1.0)
        self.mcmi_var_mode = self.dis_cfg.get("var_mode") or "sphere"
        self.use_mcmi = "mcmi" in self.loss_cfg
        mi_state = None
        if self.use_mcmi:
            # zeros, not yet valid: the mcmi loss is 0 until the first refresh
            f32 = dict(dtype=torch.float32, device=self.device)
            mi_state = scr.mi_init(
                torch.zeros((self.batch_size, info["z_dim"]), **f32),
                torch.zeros((self.batch_size, max(info["conditional_dim"], 1)), **f32),
                self.mcmi_bandwidth, self.mcmi_var_mode,
                model_diag=torch.zeros((self.batch_size, info["z_dim"]), **f32), valid=0.0,
            )
        self.state = TrainState(
            step=0,
            opt_state=self.tx.init(list(self.model.parameters())),
            scrub_state=factory.init_scrub_state(
                self.dis_cfg, self.loss_cfg, info["z_dim"], info["feat_dims"], self.device,
                discrete_classes=self.train_ds.discrete_classes,
            ),
            generator=torch.Generator(device=self.device).manual_seed(self.seed),
            adv_states=dict(self.adv_bundle["states"]) if self.adv_bundle else {},
            mi_state=mi_state,
        )
        self.np_rng = np.random.default_rng(self.seed)  # the batch order
        model_cfg = config.get("model") or {}
        self.start_epoch = int(model_cfg.get("start_epoch") or 0)
        load_model = model_cfg.get("load_model")
        if load_model and self.start_epoch:
            ckpt.load_weights(load_model, self.start_epoch, self.model)
            full = ckpt.load_train_state(load_model, self.start_epoch, self.model, self.state, self.np_rng)
            if full is not None:
                self.state = full

        tree = self.train_ds.kinematic_tree
        self.feat_slices = feature_slices(info["conditional_keys"], info["feat_dims"])
        adv_fit = self.dis_cfg.get("adv_fit")
        self.train_step = make_train_step(
            self.model, self.tx, tree, disentangle_config=self.dis_cfg,
            batch_fn=self.train_ds.make_batch_fn() if self.host_stream else self.train_ds.batch,
            loss_keys=tuple(self.loss_cfg), feat_slices=self.feat_slices,
            adv_tx=self.adv_bundle["tx"] if self.adv_bundle else None,
            adv_fit=adv_fit is None or bool(adv_fit), adv_n_iter=int(self.dis_cfg.get("n_iter") or 5),
            mcmi_bandwidth=self.mcmi_bandwidth, mcmi_var_mode=self.mcmi_var_mode,
            static_loss_scale=self.loss_cfg,
        )
        self.eval_step = (
            make_eval_step(
                self.model, tree, disentangle_config=self.dis_cfg,
                loss_keys=tuple(self.loss_cfg), batch_fn=self.val_ds.batch, feat_slices=self.feat_slices,
                static_loss_scale=self.loss_cfg,
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
        shuffled epoch by default (for a host-streamed split, the slabs of
        those rows); returns the mean of each loss term."""
        loss_scale = self.loss_scale_for_epoch(epoch)
        if idx_matrix is None:
            idx_matrix = epoch_index_matrix(len(self.train_ds), self.batch_size, self.np_rng)
        if self.host_stream:
            feed = prefetch_to_device(
                self.train_ds.epoch_slabs(np.asarray(idx_matrix)), size=2, device=self.device,
                stats=self.stream_stats,
            )
        else:
            feed = torch.as_tensor(idx_matrix, device=self.device)
        sums: Dict[str, torch.Tensor] = {}
        for batch in feed:
            self.state, metrics = self.train_step(self.state, batch, loss_scale)
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        n = max(len(idx_matrix), 1)
        # sorted, as the JAX package's jitted steps return their dicts
        return {k: float(sums[k]) / n for k in sorted(sums)}

    def _gen_restrict_keys(self) -> tuple:
        return tuple(k for k in self.info["disentangle_keys"] if k in GEN_RESTRICT_KEYS)

    def _refresh_eval_mi(self) -> None:
        """Rebuild the MCMI estimator from ``batch_size`` strided validation
        windows, ``(arange(B) * max(n // B, 1)) % n``, encoded under the
        current parameters, and write it into the train state: the next
        train epoch starts from it."""
        n = len(self.val_ds)
        idx = (np.arange(self.batch_size) * max(n // self.batch_size, 1)) % n
        data = self.val_ds.batch(torch.as_tensor(idx, device=self.device))
        var = self.model.vae.build_conditionals(data)
        mi = encode_mi_state(self.model, data, var, self.mcmi_bandwidth, self.mcmi_var_mode)
        self.state = self.state.replace(mi_state=mi)

    def test_epoch(self, epoch: int, draws: Optional[Dict[str, list]] = None):
        """Validation epoch over the whole val split: full batches, then the
        ``len(val) % batch_size`` tail, each batch's mean losses weighted by
        its size; the generative-restrictiveness R^2 of each conditioned
        factor over all samples. With MCMI on, the estimator is rebuilt from
        the validation split first (``_refresh_eval_mi``). ``draws[key][b]``
        is the random draw of batch ``b`` for ``key`` (see
        ``generative_restrictiveness_batch``); by default they come from a
        generator seeded with ``1000 + epoch``, which also draws each
        batch's adversarial shuffle first: a batch's shuffle, then one draw
        per key in key order. Returns (metrics, mu of every val sample as a
        numpy array)."""
        if self.use_mcmi:
            self._refresh_eval_mi()
        loss_scale = self.loss_scale_for_epoch(epoch)
        gen = torch.Generator(device=self.device).manual_seed(1000 + epoch)
        tree = self.val_ds.kinematic_tree
        keys = self._gen_restrict_keys()
        losses, zs = [], []
        gen_res = {k: ([], []) for k in keys}
        for b, idx in enumerate(epoch_batches(len(self.val_ds), self.batch_size, None, drop_last=False)):
            idx = torch.as_tensor(idx, device=self.device)
            data = self.val_ds.batch(idx)
            bl, mu = self.eval_step(self.state, idx, loss_scale, data=data, generator=gen)
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

    @staticmethod
    def _fold_summary(out: Dict[str, float], name: str, folds) -> None:
        """Mean and std over the valid folds; failed (nan) folds are counted
        in ``{name}_nanfolds``, present only when a fold failed."""
        folds = np.asarray(folds, dtype=float)
        n_nan = int(np.isnan(folds).sum())
        valid = folds[~np.isnan(folds)]
        out[f"{name}_mean"] = float(valid.mean()) if valid.size else float("nan")
        out[f"{name}_std"] = float(valid.std()) if valid.size else float("nan")
        if n_nan:
            out[f"{name}_nanfolds"] = float(n_nan)

    def decodability_metrics(self, z_val) -> Dict[str, float]:
        """5-fold decodability of the validation factors from ``z_val`` (mu
        of every val sample), on the trainer's device: the linear and MLP
        R^2 of avg_speed_3d and heading (folds of every ``window``-th
        sample) and the logistic and QDA accuracy of the ids (every
        ``decodability_class_window``-th), or of ids and pd_label on the
        parkinsons data; nothing with ``train.minimal_test``."""
        out: Dict[str, float] = {}
        window = self.info["window"]
        dataset_name = self.config["data"].get("dataset")
        class_window = em.decodability_class_window(dataset_name, window)
        if self.train_cfg.get("minimal_test"):
            return out
        dev = self.device
        full = self.val_ds.batch(torch.arange(len(self.val_ds), device=dev))
        if dataset_name == "parkinsons":
            for key in ("ids", "pd_label"):
                y = full[key].long()
                self._fold_summary(out, f"acc_{key}_log", em.log_class_rand_cv(z_val, y, class_window, 5, device=dev))
                self._fold_summary(out, f"acc_{key}_qda", em.qda_rand_cv(z_val, y, class_window, 5, device=dev))
        else:
            for key in ("avg_speed_3d", "heading"):
                if key not in full:
                    continue
                y = full[key]
                self._fold_summary(out, f"r2_{key}_lin", em.linear_rand_cv(z_val, y, window, 5, device=dev))
                self._fold_summary(out, f"r2_{key}_mlp", em.mlp_rand_cv(z_val, y, window, 5, device=dev))
            y = full["ids"].long()
            self._fold_summary(out, "acc_ids_log", em.log_class_rand_cv(z_val, y, class_window, 5, device=dev))
            self._fold_summary(out, "acc_ids_qda", em.qda_rand_cv(z_val, y, class_window, 5, device=dev))
        return out

    @torch.no_grad()
    def reset_gr(self, epoch: int) -> None:
        """Per-epoch re-init of the gradient-reversal ensembles (reference
        trainer.py:368-370), in place so the optimizer's leaf table stays
        valid; their moments are left as they are."""
        if len(self.model.grad_reversal):
            factory.init_weights(self.model.grad_reversal, self.seed * 100003 + epoch)

    def lambda_metrics(self) -> Dict[str, float]:
        out = {
            f"lambda_mals_{k}": float(st.lam1)
            for k, st in self.state.scrub_state.get("moving_avg_lsq", {}).items()
        }
        for k, st in self.state.scrub_state.get("qda", {}).items():
            out[f"lambda_qda_{k}"] = float(st.lama.mean())
        return out

    def _check_finite(self, train_metrics: Dict[str, float], epoch: int) -> None:
        """Divergence tripwire: a non-finite epoch loss halts the run with a
        diagnostic checkpoint. Opt out with ``train.halt_on_nonfinite:
        false`` (unset means on)."""
        if self.train_cfg.get("halt_on_nonfinite") is False or np.isfinite(train_metrics.get("total", 0.0)):
            return
        bad = {k: v for k, v in train_metrics.items() if not np.isfinite(v)}
        path = ckpt.save_train_state(self.out_path, epoch, self.model, self.state, self.np_rng)
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
                if epoch >= self.eval_start_epoch and self.eval_step is not None:
                    test_metrics, z_val = self.test_epoch(epoch)
                    metrics.update({f"{k}_test": v for k, v in test_metrics.items()})
                    metrics.update(self.decodability_metrics(z_val))
                # after the validation epoch, whose MCMI refresh the next
                # epoch starts from (the JAX package saves before it), so a
                # resume trains on as the run would have
                if epoch % 20 == 0:
                    ckpt.save_train_state(self.out_path, epoch, self.model, self.state, self.np_rng)

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
