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

Every epoch runs its steps in the form that carries the state in place
(``make_inplace_step``), which computes what the functional train step
computes bit for bit. ``train.scan_epoch`` (unset means on, as in the JAX
package, where it scans the epoch as one program) decides whether the
epochs replay CUDA graphs of that step. On CUDA, the train epoch uploads its (steps, batch) index matrix once, takes its first step
eagerly on a side stream (with host synchronisation an error), captures
one step in a CUDA graph (``train.graph``) and replays it for every other
row, reading each row from a static buffer and the loss weights from a
device buffer; the metrics are summed on the device and read once, at the
epoch's end. The validation epoch likewise captures one full batch
(forward, losses, mu and the generative-restrictiveness decodes with
their draws) and replays it; the ragged tail runs eagerly. Each graph is
captured once per trainer and again only when a tensor it reads no
longer lies where it was captured (an MCMI refresh, a restored state).
On CUDA the train and validation epochs route torch's linear algebra to
cuSOLVER while they run (``graph.capturable_linalg``), graph or not, and
put the process's setting back after.
A failed capture raises: nothing falls back to eager steps. On the CPU,
and with ``scan_epoch: false``, the in-place step runs eagerly, one call
from the host a step; a graph epoch equals the eager one bit for bit (on
the card, with deterministic algorithms). As in the JAX package a
host-streamed train split (``data.host_stream``) always steps from the
host, and a mesh of more than one rank steps eagerly: gloo stages CUDA tensors through the host, which a capture
cannot hold, and NCCL capture is not done yet. ``train.donate`` is
accepted and has no effect (steps update parameters, moments and
statistics in place, so nothing is left to donate).

Tracing. ``set_tracing(True)`` makes the train steps stamp their layers
(``utils.profiling``: on the card a kernel a stamp, which a captured graph
keeps as a node); the epoch's totals come back in its one readback, and
``spans.ms_per_step()`` gives each slot's time a step and
``spans.nested_ms_per_step()`` each nested span's (the transformer's
attention and feed-forward blocks). Switching it captures the train step
again, so the untraced graph holds no stamp. The
host phases of a train epoch are profiler ranges (``host_span``) while a
profiler runs. Always kept: ``graph_captures`` (switching the tracing
counts as one), ``replays`` and ``host_syncs`` (every readback of the
train and validation epochs), and the train steps' SPD factorizations,
``spd_factorizations`` and ``spd_not_pd`` (``profiling.SolveCounts``:
running totals on the device, read with the train epoch's sums); a
readback that finds new factorizations not positive definite warns once
with their count. The host does not wait for the uploads of
an epoch's loss weights and indices, so a train epoch's one host sync is
its readback.

``train.mesh`` (``{data: D, model: M}``, an int, ``true`` or -1: see
``parallel.mesh.make_mesh``) trains over the ranks of the default process
group, one process a rank (``torchrun --nproc_per_node N -m
scrubvae_torch.train_model ...``): the batch, rounded down to a multiple
of D, is cut into D row blocks, and with M > 1 the Cholesky head is split
by output column. The run computes what the single-device run computes
at the same global batch (``parallel.mesh``). Every rank holds the whole
dataset and the same batch order; a validation batch that does not
divide D (the split's tail) runs whole on every rank. Rank 0 alone writes
``metrics.csv``, weights and the full state (all ranks take part in
gathering the split leaves); decodability runs on rank 0 and its results
are broadcast. Without a process group the mesh is one rank and the run
is the single-device run; with several cards visible that raises, since
it would train on one card. Every rank computes the replicated part of a
step on its own: the ranks stay bit for bit alike under
``torch.use_deterministic_algorithms(True)``, which the trainer does not
turn on by itself.

Decodability (``decodability_metrics``) runs its estimators on the
trainer's device and draws from no training stream (not the sample-noise
generator, not the batch-order ``np_rng``), so a run trains bit for bit as
the same run with ``train.minimal_test: true``, which skips it as it does
in the JAX package.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from scrubvae_torch import factory
from scrubvae_torch.data.dataset import epoch_index_matrix
from scrubvae_torch.data.hoststream import HostStreamDataset, prefetch_to_device
from scrubvae_torch.device import resolve_device
from scrubvae_torch.evals import metrics as em
from scrubvae_torch.evals.restrictiveness import generative_restrictiveness_batch
from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.parallel import mesh as pmesh
from scrubvae_torch.train import optim
from scrubvae_torch.train.graph import StepGraph, advance_counts, capturable_linalg, no_host_sync, warm_up
from scrubvae_torch.train.state import TrainState
from scrubvae_torch.train.step import (
    encode_mi_state, feature_slices, make_eval_step, make_grad_step, make_inplace_step, make_train_step,
)
from scrubvae_torch.utils import checkpoint as ckpt
from scrubvae_torch.utils.logging import MetricLogger
from scrubvae_torch.utils.profiling import SolveCounts, StepSpans, counting_solves, host_span, stamping

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
        self.mesh = self._make_mesh(self.train_cfg.get("mesh"))
        data_cfg = config["data"]
        self.batch_size = int(data_cfg.get("batch_size") or 256)
        # a batch above len(train) would give no batch an epoch
        self.batch_size = max(1, min(self.batch_size, len(self.train_ds)))
        per = pmesh.data_axis_size(self.mesh)
        if self.batch_size % per:
            # the data axis cuts the batch into equal row blocks
            self.batch_size = max(per, (self.batch_size // per) * per)
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
        # every rank starts from rank 0's weights, whatever its own draws
        pmesh.replicate(list(self.model.parameters()) + list(self.model.buffers()), self.mesh)
        self._maybe_lowp_params()
        pmesh.place_state(self.model, self.mesh)
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
            opt_state=self.tx.init(
                list(self.model.parameters()), shards=pmesh.leaf_shards(self.model),
                group=self.mesh.model_group if self.mesh is not None else None,
            ),
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
        self._dp = pmesh.data_parallel(self.mesh)
        if self.host_stream:
            batch_fn = self.train_ds.make_batch_fn(mesh=self._dp)
        else:
            batch_fn = self.train_ds.batch
        self._step_kwargs = dict(
            disentangle_config=self.dis_cfg, batch_fn=batch_fn, feat_slices=self.feat_slices,
            adv_n_iter=int(self.dis_cfg.get("n_iter") or 5), static_loss_scale=self.loss_cfg, mesh=self.mesh,
        )
        self.train_step = make_train_step(
            self.model, self.tx, tree, loss_keys=tuple(self.loss_cfg),
            adv_tx=self.adv_bundle["tx"] if self.adv_bundle else None,
            adv_fit=adv_fit is None or bool(adv_fit),
            mcmi_bandwidth=self.mcmi_bandwidth, mcmi_var_mode=self.mcmi_var_mode, **self._step_kwargs,
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
        scan = self.train_cfg.get("scan_epoch")
        self.use_scan_epoch = scan is None or bool(scan)
        self.scan_train = self.use_scan_epoch and not self.host_stream
        ranks = 1 if self.mesh is None else self.mesh.data * self.mesh.model
        # the epochs as CUDA graphs (the module docstring)
        self.use_graphs = self.use_scan_epoch and self.device.type == "cuda" and ranks == 1
        self.inplace_step = make_inplace_step(self.train_step)
        self._loss_vec = None  # this epoch's loss weights, on the device
        self._train_sums: Dict[str, torch.Tensor] = {}
        self._eval_sums: Dict[str, torch.Tensor] = {}
        self._idx_buf = self._eval_idx_buf = None
        self._draw_bufs: Dict[str, torch.Tensor] = {}
        self._train_graph = self._eval_graph = None
        self._train_graph_before = None  # the state the captured train step was given
        self._eval_graph_given = False  # whether the captured eval batch reads given draws
        self.graph_captures = 0  # captures of the train and eval steps so far
        self.replays = 0
        self.host_syncs = 0
        self.tracing = False
        self.spans = StepSpans(self.device)
        self.solve_counts = SolveCounts(self.device)
        self._eval_gen = torch.Generator(device=self.device)
        self.is_main = self.mesh is None or self.mesh.is_main
        self.logger = (
            MetricLogger(
                self.out_path,
                use_wandb=run is not None,
                wandb_run=run,
                resume=bool(load_model) and self.start_epoch > 0,
                start_epoch=self.start_epoch,
            )
            if self.is_main
            else None
        )

    def _make_mesh(self, spec) -> Optional[pmesh.Mesh]:
        """The mesh of ``train.mesh`` over the default process group; None
        without ``train.mesh``, and a mesh of one rank without a process
        group (which with several cards visible raises: the run would
        train on one card)."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        if not spec:
            if world > 1:
                raise ValueError(f"a world of {world} ranks trains under train.mesh; set it (e.g. {{data: {world}}})")
            return None
        visible = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if not dist.is_initialized() and visible > 1:
            raise RuntimeError(
                f"train.mesh with {visible} cards visible and no process group: launch one process a "
                "card, e.g. torchrun --nproc_per_node N -m scrubvae_torch.train_model ..."
            )
        return pmesh.make_mesh(spec)

    def set_tracing(self, on: bool) -> None:
        """Trace the train steps (the module docstring) or stop; a captured
        train step of the other kind is dropped, to be captured again."""
        on = bool(on)
        if on != self.tracing and self._train_graph is not None:
            self._train_graph = None
        self.tracing = on

    @property
    def spd_factorizations(self) -> int:
        """The train steps' SPD factorizations, as of the last readback."""
        return self.solve_counts.spd_factorizations

    @property
    def spd_not_pd(self) -> int:
        """Those of them not positive definite, as of the last readback."""
        return self.solve_counts.spd_not_pd

    def _step(self, state, idx, weights, sums):
        """The in-place train step, counting its factorizations and, while
        tracing, stamping its layers."""
        with counting_solves(self.solve_counts):
            if not self.tracing:
                return self.inplace_step(state, idx, weights, sums)
            with stamping(self.spans):
                return self.inplace_step(state, idx, weights, sums)

    def _to_host(self, sums: Dict[str, torch.Tensor], spans: Optional[StepSpans] = None,
                 counts: Optional[SolveCounts] = None) -> Dict[str, float]:
        """The device scalars of ``sums`` as floats, sorted by key, the
        totals of ``spans`` (``StepSpans.take``) and the solve counts
        ``counts`` (``SolveCounts.take``, a warning for new factorizations
        not positive definite), read in one copy: one host sync, none where
        there is nothing to read."""
        keys = sorted(sums)
        parts = ([torch.stack([sums[k].double() for k in keys])] if keys else []) + (
            [spans.sums.double()] if spans is not None else []
        ) + ([counts.buf.double()] if counts is not None else [])
        if not parts:
            return {}
        values = torch.cat(parts).tolist()
        self.host_syncs += 1
        if counts is not None:
            new = counts.take(values[-2:])
            if new:
                warnings.warn(f"{new} SPD factorization(s) of the scrubbers' solves were not numerically "
                              f"positive definite (spd_not_pd {counts.spd_not_pd} of {counts.spd_factorizations})")
            values = values[:-2]
        if spans is not None:
            spans.take(values[len(keys):])
        return dict(zip(keys, values[: len(keys)]))

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """``t`` read to the host as a numpy array (one host sync)."""
        self.host_syncs += 1
        return t.cpu().numpy()

    def make_grad_fn(self):
        """The pre-optimizer view of the train step (``make_grad_step``):
        ``fn(state, idx, loss_scale, eps=None, perms=None) -> (grads,
        losses, mu)`` through this trainer's loss path, changing nothing."""
        return make_grad_step(self.model, self.train_ds.kinematic_tree, **self._step_kwargs)

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

    def _epoch_linalg(self):
        """The linear-algebra route of an epoch on this trainer's device
        (``capturable_linalg`` on CUDA)."""
        return capturable_linalg() if self.device.type == "cuda" else contextlib.nullcontext()

    def train_epoch(self, epoch: int, idx_matrix: Optional[np.ndarray] = None) -> Dict[str, float]:
        """One pass over ``idx_matrix`` (steps, batch) of window indices, a
        shuffled epoch by default (for a host-streamed split, the slabs of
        those rows) through the in-place step, on CUDA under
        ``train.scan_epoch`` as replays of a captured step (the module
        docstring); returns the mean of each loss term, read from the
        device once."""
        with host_span("train.loss_weights"):
            weights = self._loss_weights(self.loss_scale_for_epoch(epoch))
        if idx_matrix is None:
            idx_matrix = epoch_index_matrix(len(self.train_ds), self.batch_size, self.np_rng)
        idx_matrix = np.asarray(idx_matrix)
        if self.host_stream:
            feed = prefetch_to_device(
                self.train_ds.epoch_slabs(idx_matrix), size=2, device=self.device, stats=self.stream_stats,
            )
        else:
            with host_span("train.index_upload"):
                rows = torch.as_tensor(pmesh.shard_batch(self._dp, idx_matrix, axis=1))
                feed = rows.to(self.device, non_blocking=True)  # staged from pageable memory: no wait
        sums = self._train_sums
        for v in sums.values():
            v.zero_()
        if self.tracing:
            self.spans.start_epoch()
        with self._epoch_linalg():
            if self.scan_train and self.use_graphs:
                self._graph_train_rows(feed, weights, sums)
            else:
                with host_span("train.steps"):
                    for batch in feed:
                        self.state = self._step(self.state, batch, weights, sums)
        n = max(len(idx_matrix), 1)
        with host_span("train.readback"):
            # sorted, as the JAX package's jitted steps return their dicts
            host = self._to_host(sums, self.spans if self.tracing else None, self.solve_counts)
            return {k: v / n for k, v in host.items()}

    def _loss_weights(self, loss_scale: Dict[str, float]) -> Dict[str, torch.Tensor]:
        """``loss_scale`` written into the float64 device buffer that the
        in-place steps read, one 0-dim view a key."""
        keys = sorted(loss_scale)
        if self._loss_vec is None or self._loss_vec.numel() != len(keys):
            self._loss_vec = torch.zeros(len(keys), dtype=torch.float64, device=self.device)
        # staged from pageable memory before the call returns: the host waits for nothing
        scales = torch.tensor([float(loss_scale[k]) for k in keys], dtype=torch.float64)
        self._loss_vec.copy_(scales, non_blocking=True)
        return {k: self._loss_vec[i] for i, k in enumerate(keys)}

    def _generators(self) -> list:
        """The generators a train step draws from: the train state's and
        the unfused Adam's rounding generator."""
        opt_gen = getattr(self.state.opt_state, "generator", None)
        return [self.state.generator] + ([opt_gen] if opt_gen is not None else [])

    def _graph_train_rows(self, rows: torch.Tensor, weights: Dict[str, torch.Tensor], sums: Dict[str, torch.Tensor]):
        """The rows through the in-place step: the first eagerly and the
        others as replays of the captured step (captured again when what it
        reads has moved)."""

        def reads():
            return (self.model, self.state, self.train_ds, self._idx_buf, self._loss_vec, sums, self.solve_counts.buf)

        graph = self._train_graph
        if graph is not None:
            with host_span("train.graph_valid"):
                if not graph.valid(reads(), self._generators()):
                    graph = self._train_graph = None
        if self._idx_buf is None or self._idx_buf.shape != rows.shape[1:]:
            graph = self._train_graph = None
            self._idx_buf = torch.empty(rows.shape[1:], dtype=rows.dtype, device=self.device)
        first = 0
        if graph is None:
            with host_span("train.capture"):
                self._idx_buf.copy_(rows[0])
                with no_host_sync():
                    self.state = warm_up(lambda: self._step(self.state, self._idx_buf, weights, sums))
                first = 1
                if len(rows) > 1:
                    before = self.state
                    graph = self._train_graph = StepGraph(
                        lambda: self._step(before, self._idx_buf, weights, sums), reads(), self._generators()
                    )
                    self._train_graph_before = before
                    self.graph_captures += 1
        with host_span("train.replays"):
            for r in rows[first:]:
                self._idx_buf.copy_(r)
                graph.replay()
        self.replays += len(rows) - first
        if len(rows) > first:
            self.state = advance_counts(self.state, self._train_graph_before, graph.out, len(rows) - first)

    def release_graphs(self) -> None:
        """Drop the captured train and eval steps and their memory pools
        (the next epoch captures again)."""
        self._train_graph = self._eval_graph = None

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
        per key in key order. The full batches' losses are summed on the
        device (read once, at the end; the tail's are added on the host, as
        the JAX package's scanned epoch does); on CUDA under
        ``train.scan_epoch`` the first full batch runs eagerly and the others
        replay it captured (the module docstring). Returns (metrics, mu of
        every val sample as a numpy array)."""
        with self._epoch_linalg():
            return self._test_epoch(epoch, draws)

    def _test_epoch(self, epoch: int, draws: Optional[Dict[str, list]]):
        if self.use_mcmi:
            self._refresh_eval_mi()
        weights = self._loss_weights(self.loss_scale_for_epoch(epoch))
        gen = self._eval_gen.manual_seed(1000 + epoch)
        n, B = len(self.val_ds), self.batch_size
        full = n // B
        keys = self._gen_restrict_keys()
        zs, gen_res = [], {k: ([], []) for k in keys}

        def keep(mu, res):
            zs.append(mu.clone())
            for key, (pred, target) in res.items():
                gen_res[key][0].append(pred.clone())
                gen_res[key][1].append(target.clone())

        def batch_draws(b):
            return None if draws is None else {k: torch.as_tensor(draws[k][b]) for k in keys}

        sums = self._eval_sums
        for v in sums.values():
            v.zero_()
        rows = torch.arange(full * B, device=self.device).reshape(full, B)
        if self.use_graphs and full:
            self._graph_eval_rows(rows, weights, gen, sums, batch_draws, keep)
        else:
            for b, idx in enumerate(rows):
                keep(*self._eval_batch(idx, weights, gen, sums, batch_draws(b)))
        tail = {}
        if full * B < n:
            keep(*self._eval_batch(
                torch.arange(full * B, n, device=self.device), weights, gen, tail, batch_draws(full)
            ))
        # summed in float64 on the host: the full batches' device sums, then the tail
        full_sums, tail_sums = self._to_host(sums) if full else {}, self._to_host(tail)
        metrics = {k: full_sums.get(k, 0.0) * B for k in sorted(set(full_sums) | set(tail_sums))}
        for k, v in tail_sums.items():
            metrics[k] += v * (n - full * B)
        metrics = {k: v / max(n, 1) for k, v in metrics.items()}
        for key, (preds, targets) in gen_res.items():
            # summed in f32 on the host, as the JAX package does
            pred = self._fetch(torch.cat(preds))
            target = self._fetch(torch.cat(targets))
            ss_res = ((target - pred) ** 2).sum()
            ss_tot = ((target - target.mean(axis=0)) ** 2).sum()
            metrics[f"r2_gen_restrict_{key}"] = float(1.0 - ss_res / ss_tot)
        return metrics, self._fetch(torch.cat(zs)) if zs else np.zeros((0,))

    def _eval_batch(self, idx, weights, gen, sums, draw=None):
        """One validation batch: its losses added into ``sums`` (each
        created by its first batch), its mu and the generative-restrictiveness
        (pred, target) of each conditioned factor. A batch that the data axis
        divides is cut into this rank's rows; a ragged one runs whole on
        every rank."""
        data = self.val_ds.batch(idx)
        if self._dp is not None and len(idx) % self._dp.data == 0:
            bl, mu = self.eval_step(
                self.state, pmesh.shard_batch(self._dp, idx), weights, data=pmesh.shard_batch(self._dp, data),
                generator=gen, mesh=self._dp,
            )
        else:
            bl, mu = self.eval_step(self.state, idx, weights, data=data, generator=gen)
        for k, v in bl.items():
            if k in sums:
                sums[k].add_(v)
            else:
                sums[k] = v.clone()
        res = {
            key: generative_restrictiveness_batch(
                self.model, mu, data, key, self.val_ds.kinematic_tree, norm_params=self.val_ds.norm_params,
                draw=None if draw is None else draw[key], generator=gen,
            )
            for key in self._gen_restrict_keys()
        }
        return mu, res

    def _graph_eval_rows(self, rows, weights, gen, sums, batch_draws, keep) -> None:
        """The full validation batches ``rows``: the first eagerly, the
        others as replays of the captured batch (captured again when what
        it reads has moved or the draws switch between given and drawn)."""
        given = batch_draws(0) is not None

        def reads():
            return (self.model, self.state, self.val_ds, self._eval_idx_buf, self._loss_vec, sums, self._draw_bufs)

        def load(b):
            self._eval_idx_buf.copy_(rows[b])
            for k, d in (batch_draws(b) or {}).items():
                self._draw_bufs[k].copy_(d)

        def run():
            return self._eval_batch(self._eval_idx_buf, weights, gen, sums, self._draw_bufs if given else None)

        graph = self._eval_graph
        if graph is not None and (self._eval_graph_given != given or not graph.valid(reads(), [gen])):
            graph = self._eval_graph = None
        if self._eval_idx_buf is None:
            self._eval_idx_buf = torch.empty(rows.shape[1:], dtype=rows.dtype, device=self.device)
        if given and set(self._draw_bufs) != set(batch_draws(0)):
            graph = self._eval_graph = None
            self._draw_bufs = {k: torch.empty_like(d, device=self.device) for k, d in batch_draws(0).items()}
        first = 0
        if graph is None:
            load(0)
            with no_host_sync():
                keep(*warm_up(run))
            first = 1
            if len(rows) > 1:
                graph = self._eval_graph = StepGraph(run, reads(), [gen])
                self._eval_graph_given = given
                self.graph_captures += 1
        for b in range(first, len(rows)):
            load(b)
            graph.replay()
            keep(*graph.out)
        self.replays += len(rows) - first

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

    def _decodability_on_main(self, z_val) -> Dict[str, float]:
        """``decodability_metrics``; over several ranks rank 0 computes them
        and every rank returns its results."""
        if self.mesh is None or self.mesh.data * self.mesh.model == 1:
            return self.decodability_metrics(z_val)
        out = [self.decodability_metrics(z_val) if self.is_main else None]
        dist.broadcast_object_list(out, src=0)
        return out[0]

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
        path = ckpt.save_train_state(self.out_path, epoch, self.model, self.state, self.np_rng, mesh=self.mesh)
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
                ckpt.save_weights(self.out_path, epoch, self.model, mesh=self.mesh)
                if epoch >= self.eval_start_epoch and self.eval_step is not None:
                    test_metrics, z_val = self.test_epoch(epoch)
                    metrics.update({f"{k}_test": v for k, v in test_metrics.items()})
                    metrics.update(self._decodability_on_main(z_val))
                # after the validation epoch, whose MCMI refresh the next
                # epoch starts from (the JAX package saves before it), so a
                # resume trains on as the run would have
                if epoch % 20 == 0:
                    ckpt.save_train_state(self.out_path, epoch, self.model, self.state, self.np_rng, mesh=self.mesh)

            if self.logger is not None:
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
