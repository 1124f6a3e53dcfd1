"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the root of the repository:

    python3 chip_smoke.py

Phases (each one fails the run on error; nothing is caught and swallowed):

1. card: print the GPU's name and power limit (nvidia-smi); TF32 off.
2. build: compile every hand-written kernel from ``scrubvae_torch/csrc``.
3. kernel: the fused AdamW kernel against its plain PyTorch version, bitwise
   in all four dtype variants at two shapes, both with injected noise and
   on the Philox path; stochastic rounding unbiased; its time beside the
   plain version's, ``torch._fused_adamw_``'s and the bandwidth bound, and
   the bf16 variant's Philox time beside its injected-noise time. Then the
   flagship's whole leaf set (130 leaves, 53,308,812 elements, at their
   shapes and dtypes) in one multi-tensor call, bitwise against the plain
   version on the Philox path, and that pass's time beside its bound and
   ``torch._fused_adamw_`` over f32 copies of every leaf.
4. parity: one small train step on the GPU against the same step on the CPU
   (same weights, same sample noise), held to the step-1 bounds of
   ``scrubvae_torch.train.parity``; the GPU runs it twice with deterministic
   algorithms, and the two runs must be bitwise equal.
5. path: the flagship train step at full width (channels 64-1024, window 51,
   z 128, batch 512, bf16) for 3 warm-up and 20 timed steps through
   ``factory.build_model`` and ``Trainer``; losses finite, and the
   optimizer's leaf table covering all 130 leaves with one kernel launch
   per dtype variant (2) a step; then the optimizer pass alone beside the
   bytes it must move.
6. profile, only when asked for (``--phases kernel,parity,path,profile``):
   device time by kernel over 5 flagship steps, and the device's idle share
   (torch.profiler; the table goes to ``build/profile_path.txt``).
7. fit: the training entry point at full flagship width. A YAML config
   (the path phase's flagship with 20 epochs, validation from epoch 0,
   without ``minimal_test``, so decodability runs) is read by
   ``scrubvae_torch.params.read.config`` and trained by
   ``scrubvae_torch.train.trainer.train`` on synthetic splits built in
   memory (train: 4 ids, at least 3 steps an epoch at batch 512; val: 4 ids
   x 2600 frames, 5100 windows, so 100 rows for the regression folds and
   1020 for the classification folds, and a partial tail batch).
   ``metrics.csv`` must hold 20 rows with a finite ``total_train``, the
   validation losses and finite generative-restrictiveness R^2 at epochs 5,
   10, 15 and 20, and there every decodability column (linear and MLP R^2 of
   avg_speed_3d and heading, logistic and QDA accuracy of the ids) finite,
   with no ``*_nanfolds`` column: a failed fold prints its exception, saves
   that mu to ``chiprun_out/`` and fails the phase. Weights at those epochs
   and the full state at 20; 2 optimizer launches a step over a table of
   all 130 leaves, epoch after epoch of GR re-init. Then the epoch-20
   validation mu and labels go through the decodability estimators on the
   card and on the CPU: the same folds, linear R^2 within 1e-9 (float64),
   QDA and LDA predictions identical, logistic predictions within one
   sample a fold, MLP R^2 within 1e-3 from the same CPU-drawn init. Then a
   resume from epoch 20 (``model.load_model``, ``start_epoch``) must
   restore parameters, moments, step counts, MALS state and generator
   state bit for bit as the first run held them, and epoch 21 must train
   with finite losses. Prints the epoch, step, validation, decodability (by
   probe), save and restore times and the peak memory beside the card's
   name and power limit. The card's machine has no ``h5py`` and no
   ``sklearn``, so this phase builds its splits in memory; the route through
   pose files on disk and the ``python -m scrubvae_torch.train_model`` CLI,
   and the estimators against the JAX package's sklearn ones, are covered
   by the tests on the CPU (``tests/test_torch_port_checkpoint.py``,
   ``tests/test_torch_port_fit.py``, ``tests/test_torch_port_decodability.py``).
8. full: the full scrubber stack of ``configs/ladder/5_full.yaml`` (QDA on
   ids; linear, MALS, gradient-reversal and adversarial scrubbers on
   avg_speed_3d; mcmi and total correlation, so the dense Cholesky head).
   First steps 1 and 2 on the card against the CPU from the seed's weights
   and states with the same rows, noise and shuffles, at narrow channels, z
   128, batch 16, f32, without clip: step 1 held to
   ``scrubvae_torch.train.parity`` (losses, gradients, weights to four ulps,
   MALS, QDA, MCMI; the discriminator after its inner fit to 1e-3 on each
   leaf and 1e-4 on the median leaf, see ``ADV_TOL``), step 2's losses at
   rtol 1e-2; the same step 1 with one inner discriminator step left out
   must fail the discriminator's bounds. Then a copy of the config file
   (20 epochs, validation at epoch 20 only) through ``params.read.config`` and ``train(config,
   datasets, model, info)`` at full width on the fit phase's splits: every
   loss column and ``lambda_qda_ids`` finite at every epoch, the validation
   losses finite at 20, 2 outer and 5 inner optimizer launches a step; the
   ``_an``, ``_qda``, ``mcmi`` and ``total_correlation`` columns and
   ``lambda_qda_ids`` printed at epochs 1, 5, 10 and 20. The discriminator's
   22-leaf set in one kernel call, bitwise against the plain version, its
   device time (profiler) and call time beside the bound, the plain
   version's and ``torch._fused_adamw_``'s. Then, with deterministic
   algorithms, the run's own epoch 21 against a resume from epoch 20: the
   restored state and the epoch-21 state bit for bit (model, moments,
   MALS, QDA, discriminator and MCMI states, generator, batch order).
   Prints the step time inside ``fit``, the train-epoch, validation-epoch,
   MCMI-refresh and decodability times and the peak memory.

9. bench: ``scrubvae_torch.bench.run`` at its defaults, as ``python -m
   scrubvae_torch.bench`` runs it (the flagship of the path phase, batch
   512, bf16 storage, 5 warm-up and 100 timed steps of
   ``Trainer.train_epoch``, one more step under the FLOP counter); its
   JSON line is printed. Requires a finite total, 2 optimizer launches a
   step and 0 < mfu <= 1.
10. x360: the x360 windows and the heading-free encoder view, then two
   shipped configs of that process. First ``materialize`` of every key
   (``raw_pose``, ``x6d_enc``, ``root_enc`` included) over the structured
   val split on the card against the CPU, within the CPU tests'
   tolerance, and the window assembly of a batch of 64 with and without
   the view timed. Then steps 1 and 2 of ``configs/sane/4_full.yaml`` (every
   scrubber, heading among the scrubbed features, negative MALS weights)
   on the card against the CPU at narrow channels, z 32, batch 16, f32,
   without clip, held as the full phase holds 5_full (the discriminator's
   leaves to 2e-2, its median leaf to 1e-4). Then
   ``configs/sweep/8_structural.yaml`` (x360 target, midfwd encoder view)
   and ``configs/sane/4_full.yaml``, each read from a copy of the file by
   ``params.read.config`` and run through ``factory.data_and_model`` and
   ``train(config, datasets, model, info)`` at the files' own widths
   (channels 16-32-32-64-64, z 32, batch 64, bf16 compute) on the
   structured stream at the size ``tools/run_ladder.py`` gives them (train
   24000 frames, val 8000, 4 ids, seeds 0 and 1; the pose arrays are
   served from memory in place of the pose files): 2 epochs, numbered 4
   and 5 (``model.start_epoch: 3`` with nothing loaded, as validation runs
   at epochs divisible by 5), validating with decodability at 5. Every
   loss, validation and decodability column finite, the optimizer's
   launches a step equal to its dtype variants (plus 5 inner launches for
   4_full), and each run's leaf tables (the outer one and 4_full's
   discriminator's, at their shapes and dtypes) in one kernel call each,
   bitwise against the plain version. Prints the step time inside
   ``fit``, the epoch, validation and decodability times and the peak
   memory beside the card's name.

11. models: the mlp and transformer model families and the scrubber
   branches no shipped config uses. First ``configs/ladder/1_vanilla_mlp.yaml``
   at its own widths (z 16, hidden 256-128, batch 64) on the x360 runs'
   structured splits, as those runs go (epochs 4 and 5, validation with
   decodability at 5). Then steps 1 and 2 on the card against the CPU of the
   flagship's method map on the transformer, and of the branches' method
   map on the rcnn, at z 16, window 51, f32, without clip, dropout off
   (batch 16, and 32 for the branches, whose least-squares system needs
   more rows than its 17 columns), held to ``scrubvae_torch.train.parity``.
   Then the flagship's config with ``model: {type: transformer, z_dim: 128,
   window: 51, diag: false}`` (4 heads, ``ff_size`` 512, 4 layers, gelu;
   batch 512, bf16 storage; linear, MALS and gradient-reversal scrubbers on
   avg_speed_3d, decoding conditional on avg_speed_3d and heading) and the
   flagship rcnn with every branch (MALS at polynomial 2 on avg_speed_3d,
   direct least squares on heading with a negative weight, gradient
   reversal on the ids under ``gr_legacy_norm``, the moving-average class
   means of the ids), each through ``params.read.config`` and
   ``train(config, datasets, model, info)`` on the fit phase's splits for
   epochs 16 to 20 (validation, decodability and the full state at 20).
   Every loss column finite at every epoch, the validation losses and
   decodability finite at 20, 2 optimizer launches a step, each run's leaf
   table bitwise against the plain version. For the transformer, its dropout
   at the 0.1 rate on one flagship batch (the kept share of each residual
   and positional mask within 0.005 of 0.9, kept entries scaled by 1/0.9,
   one attention mask for the whole batch and every head, no mask drawn in
   eval mode or by the eval step), then its epoch 21 against a resume from
   epoch 20, bit for bit (the dropout masks' generator included). Prints
   each run's step time inside ``fit``, the epoch, validation and
   decodability times and the peak memory beside the card's name.

Prints one JSON line describing the kernels, the card's name and power limit
again, then, as its last line, the device record. Needs one CUDA GPU and
``nvcc``; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
ADAMW_FLOPS_PER_ELEM = 20
ROOT = pathlib.Path(__file__).resolve().parent
PHASES = ("kernel", "parity", "path", "fit", "full", "bench", "x360", "models")
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality (tells -0.0 from 0.0 and compares NaN payloads)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(a.view(as_int), b.view(as_int))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn`` on the card, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50) -> float:
    """Device time of one call of ``fn``: every kernel it launches, summed
    over ``iters`` calls by torch.profiler, over ``iters``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    if busy <= 0:
        raise AssertionError("device_ms: the profiler saw no device time")
    return busy / 1e3 / iters


# ---------------------------------------------------------------------------
# phase 3: the fused AdamW kernel
# ---------------------------------------------------------------------------

KERNEL_SHAPES = (
    ("encoder.fc_sigma.0.weight", (4096, 8256)),
    ("encoder.conv_in.weight", (64, 111, 7)),
)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _leaf_inputs(shape, w_dt, m_dt, gen):
    dev = torch.device("cuda")

    def randn(scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    w = randn(0.05).to(w_dt)
    g = randn(1e-2).to(w_dt)
    mu = randn(1e-3).to(m_dt)
    nu = (randn(1e-4) ** 2).to(m_dt)
    return w, g, mu, nu


def _bound(bytes_moved: int, n: int) -> tuple:
    """The least time (ms) the card could take, and what sets it."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S
    by_ops = ADAMW_FLOPS_PER_ELEM * n / F32_FLOP_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops else "operations")


def _assert_bits(name: str, got, want) -> float:
    """Raise unless ``got`` and ``want`` (w, m, n) are bitwise equal;
    returns the max |difference| (0)."""
    err = 0.0
    for label, a, b in zip("wmn", got, want):
        if not bits_equal(a, b):
            diff = (a.float() - b.float()).abs().max().item()
            raise AssertionError(f"kernel != plain version for {name} on {label}: max |diff| {diff}")
        err = max(err, (a.float() - b.float()).abs().max().item())
    return err


def kernel_phase(flagship) -> dict:
    """Each dtype variant at two shapes: bitwise against the plain version
    with injected noise and on the Philox path, stochastic rounding
    unbiased, and (at fc_sigma) the kernel's time beside the plain
    version's, the library call's and the bound; then the whole flagship
    leaf set in one multi-tensor call."""
    from scrubvae_torch.ops import fused_adamw as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    scal, hyper, t = _outer_hyper()
    lr, b1c, b2c, gscale = scal.unbind(0)
    timings = {}
    max_err = 0.0
    for name, shape in KERNEL_SHAPES:
        n = math.prod(shape)
        for wk, mk in (("f32", "f32"), ("f32", "bf16"), ("bf16", "f32"), ("bf16", "bf16")):
            case = f"{name} w={wk} m={mk}"
            w_dt, m_dt = DTYPES[wk], DTYPES[mk]
            w, g, mu, nu = _leaf_inputs(shape, w_dt, m_dt, gen)
            noise = torch.randint(
                0, 1 << 16, (3, n), generator=gen, device="cuda", dtype=torch.int32
            )
            # bitwise against the plain version on the same injected noise
            ref = fa.fused_adamw_leaf_reference(
                w, g, mu, nu, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, noise=noise, **hyper
            )
            kw, km, kn = w.clone(), mu.clone(), nu.clone()
            fa.fused_adamw_leaf(kw, g, km, kn, scal, noise=noise, **hyper)
            torch.cuda.synchronize()
            max_err = max(max_err, _assert_bits(case + " (injected noise)", (kw, km, kn), ref))
            # Philox path: bitwise against the plain version on philox_noise
            pw, pm, pn = w.clone(), mu.clone(), nu.clone()
            fa.fused_adamw_leaf(pw, g, pm, pn, scal, seed=1234, leaf=7, step=t, **hyper)
            ref = fa.fused_adamw_leaf_reference(
                w, g, mu, nu, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale,
                noise=fa.philox_noise(n, 1234, 7, t, device="cuda"), **hyper,
            )
            torch.cuda.synchronize()
            max_err = max(max_err, _assert_bits(case + " (Philox)", (pw, pm, pn), ref))
            # and unbiased (mean rounding error within 4 sigma)
            exact = fa.fused_adamw_leaf_reference(
                w.float(), g.float(), mu.float(), nu.float(),
                lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, **hyper,
            )
            sr = []
            for label, got, want in zip("wmn", (pw, pm, pn), exact):
                if got.dtype != torch.bfloat16:
                    if not bits_equal(got, want):
                        raise AssertionError(f"f32 store differs from exact for {case} on {label}")
                    continue
                err = (got.double() - want.double()).flatten()
                mean, sd = err.mean().item(), err.std().item()
                z = mean / (sd / math.sqrt(err.numel())) if sd > 0 else 0.0
                if abs(z) > 4.0:
                    raise AssertionError(
                        f"stochastic rounding biased for {case} on {label}: "
                        f"mean {mean:.3e}, {z:.2f} sigma"
                    )
                sr.append(f"{label}:{z:+.2f}sigma")
            rec = {"bitwise_injected": True, "bitwise_philox": True,
                   "sr_mean_err": " ".join(sr) or "no bf16 store"}
            if name == KERNEL_SHAPES[0][0]:
                rec["bytes"] = fa.leaf_bytes([shape], w.element_size(), mu.element_size())
                rec["bound_ms"], rec["bound_by"] = _bound(rec["bytes"], n)
                # tables built once, as the optimizer builds them
                table = fa.LeafTable([kw], [km], [kn], leaf_ids=[0])
                rec["kernel_ms"] = cuda_ms(
                    lambda: fa.fused_adamw_multi(table, [g], scal, seed=1, step=t, **hyper)
                )
                if wk == "bf16" and mk == "bf16":
                    # reads 12 B an element more than the Philox path
                    inj = fa.LeafTable([kw], [km], [kn], noise=[noise])
                    rec["inject_ms"] = cuda_ms(
                        lambda: fa.fused_adamw_multi(inj, [g], scal, **hyper)
                    )
                    rec["inject_bound_ms"] = (rec["bytes"] + 12 * n) / HBM_BYTES_PER_S * 1e3
                rec["plain_ms"] = cuda_ms(
                    lambda: fa.fused_adamw_leaf_reference(
                        kw, g, km, kn, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, noise=noise, **hyper
                    )
                )
                if wk == "f32" and mk == "f32":
                    steps = [torch.tensor(float(t), device="cuda")]
                    rec["library_ms"] = cuda_ms(
                        lambda: torch._fused_adamw_(
                            [kw], [g], [km], [kn], [], steps,
                            lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.01,
                            eps=1e-8, amsgrad=False, maximize=False,
                        )
                    )
                timings[f"w {wk}, m {mk}"] = rec
            log(f"kernel fused_adamw {name} {tuple(shape)} w={wk} m={mk}: " + json.dumps(rec))
            del w, g, mu, nu, noise, ref, kw, km, kn, exact, pw, pm, pn
            torch.cuda.empty_cache()
    leaf_set = leaf_set_check(flagship, scal, hyper, t)
    max_err = max(max_err, leaf_set.pop("max_abs_err"))
    return {"timings": timings, "max_abs_err": max_err, "leaf_set": leaf_set}


def _outer_hyper():
    """(scalars, hyperparameters, step) of the kernel checks' AdamW step."""
    t = 3
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    scal = torch.tensor(
        [1e-3, 1.0 - 0.9**t, 1.0 - 0.999**t, 0.7], dtype=torch.float32, device="cuda"
    )
    return scal, hyper, t


# what a training run reports of its leaf set's check
LEAF_SET_KEYS = (
    "leaves", "elements", "launches_per_call", "pass_ms", "pass_device_ms", "pass_plain_ms", "pass_bound_ms",
    "pass_library_ms",
)


def leaf_set_check(trainer, scal, hyper, t, label: str = "flagship") -> dict:
    """A trainer's whole leaf set (its parameters' shapes and dtypes, its
    moments' dtypes, random values) in one multi-tensor call on the Philox
    path, bitwise against the plain version leaf by leaf; then the pass's
    time (CUDA events around 20 calls) and device time (profiler) beside
    its bound, the plain version's time and ``torch._fused_adamw_`` over
    f32 copies of every leaf."""
    from scrubvae_torch.ops import fused_adamw as fa

    params = list(trainer.model.parameters())
    moments = trainer.state.opt_state.mu
    gen = torch.Generator(device="cuda").manual_seed(1)

    def randn(like, scale, dtype):
        return (torch.randn(like.shape, generator=gen, device="cuda") * scale).to(dtype)

    ws = [randn(p, 0.05, p.dtype) for p in params]
    gs = [randn(p, 1e-2, p.dtype) for p in params]
    mus = [randn(m, 1e-3, m.dtype) for m in moments]
    nus = [(randn(m, 1e-2, torch.float32) ** 2).to(m.dtype) for m in moments]
    table = fa.LeafTable([w.clone() for w in ws], [m.clone() for m in mus], [v.clone() for v in nus])
    seed = 17
    fa.fused_adamw_multi(table, gs, scal, seed=seed, step=t, **hyper)
    lr, b1c, b2c, gscale = scal.unbind(0)
    refs = fa.fused_adamw_multi_reference(
        ws, gs, mus, nus, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, seed=seed, step=t, **hyper
    )
    torch.cuda.synchronize()
    err = 0.0
    for i, ref in enumerate(refs):
        got = (table.w[i], table.mu[i], table.nu[i])
        err = max(err, _assert_bits(f"leaf {i} {tuple(ws[i].shape)} of the {label} set", got, ref))
    del refs
    n = sum(table.numel)
    bytes_moved = sum(
        fa.leaf_bytes([w.shape], w.element_size(), m.element_size()) for w, m in zip(ws, mus)
    )
    rec = {
        "leaves": len(ws), "elements": n, "launches_per_call": len(table.batches),
        "bitwise_philox": True, "max_abs_err": err, "bytes": bytes_moved,
        "pass_ms": cuda_ms(lambda: fa.fused_adamw_multi(table, gs, scal, seed=seed, step=t, **hyper)),
        "pass_device_ms": device_ms(lambda: fa.fused_adamw_multi(table, gs, scal, seed=seed, step=t, **hyper)),
        "pass_plain_ms": cuda_ms(
            lambda: fa.fused_adamw_multi_reference(
                ws, gs, mus, nus, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, seed=seed, step=t, **hyper
            )
        ),
    }
    rec["pass_bound_ms"], rec["bound_by"] = _bound(bytes_moved, n)
    f32 = [[x.float() for x in xs] for xs in (ws, gs, mus, nus)]
    steps = [torch.tensor(float(t), device="cuda") for _ in ws]
    rec["pass_library_ms"] = cuda_ms(
        lambda: torch._fused_adamw_(
            *f32, [], steps, lr=1e-3, beta1=0.9, beta2=0.999, weight_decay=0.01,
            eps=1e-8, amsgrad=False, maximize=False,
        )
    )
    log(f"kernel fused_adamw {label} leaf set: " + json.dumps(rec))
    del f32, table, ws, gs, mus, nus
    torch.cuda.empty_cache()
    return {**rec, "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 4: one small step on the card against the same step on the CPU
# ---------------------------------------------------------------------------


def _one_step(trainer, device: str, rows: np.ndarray, eps: np.ndarray) -> dict:
    from scrubvae_torch.train.parity import MALS_KEYS

    names = [n for n, _ in trainer.model.named_parameters()]
    trainer.state, metrics = trainer.train_step(
        trainer.state, torch.as_tensor(rows, device=device), trainer.loss_scale_for_epoch(1),
        eps=torch.from_numpy(eps).to(device),
    )
    mals = trainer.state.scrub_state["moving_avg_lsq"]["avg_speed_3d"]
    b1 = trainer.tx.b1
    return {
        "losses": {k: float(v) for k, v in metrics.items()},
        # step 1: m = (1 - b1) g
        "grads": {n: m.cpu() / (1.0 - b1) for n, m in zip(names, trainer.state.opt_state.mu)},
        "w1": {n: p.detach().cpu() for n, p in trainer.model.named_parameters()},
        "mals": {k: getattr(mals, k).cpu() for k in MALS_KEYS},
    }


def _same_bits(a: dict, b: dict) -> bool:
    return a["losses"] == b["losses"] and all(
        bits_equal(a[part][k], b[part][k]) for part in ("grads", "w1", "mals") for k in a[part]
    )


def parity_phase() -> dict:
    """One ``--small`` step on the card against the same step on the CPU
    (same weights, noise and window rows), held to the step-1 bounds of
    ``scrubvae_torch.train.parity``. The card takes the step twice with
    deterministic algorithms (cuDNN, cuBLAS, index_add), and the two must be
    bitwise equal, so the verdict does not change from one run to the next."""
    from scrubvae_torch.train import parity

    from scrubvae_torch import bench

    cpu_trainer, ds = bench.build(16, 51, 16, bench.SMALL_CH, "cpu", precision="fp32", bf16_params=False)
    rows = np.random.default_rng(0).integers(0, len(ds), 16)
    eps = np.random.default_rng(1).standard_normal((16, 16)).astype(np.float32)
    cpu = _one_step(cpu_trainer, "cpu", rows, eps)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        gpu, again = [
            _one_step(
                bench.build(16, 51, 16, bench.SMALL_CH, DEVICE, precision="fp32", bf16_params=False)[0],
                DEVICE, rows, eps,
            )
            for _ in range(2)
        ]
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    if not _same_bits(gpu, again):
        raise AssertionError("parity: two deterministic steps on the card differ")
    rec = {
        "max_loss_rel": parity.check_losses(cpu["losses"], gpu["losses"], 1e-4),
        **parity.check_grads(cpu["grads"], gpu["grads"]),
        **parity.check_weights(cpu["w1"], gpu["w1"], cpu["grads"]),
        "max_mals_rel": parity.check_mals(cpu["mals"], gpu["mals"], 1e-4),
        "repeat_bitwise_equal": True,
    }
    log("parity small step, card vs CPU: " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phase 5: the flagship train step at full width
# ---------------------------------------------------------------------------


FLAGSHIP_LEAVES = 130
FLAGSHIP_PARAMS = 53_308_812


def path_phase(trainer, ds, warmup: int = 3, steps: int = 20):
    """The flagship step through ``Trainer.train_step``: losses finite, one
    kernel launch per dtype variant a step over a table of every leaf; then
    the optimizer pass alone beside the bytes it must move."""
    from scrubvae_torch.ops import fused_adamw as fa

    batch = trainer.batch_size
    params = list(trainer.model.parameters())
    opt = trainer.state.opt_state
    table = opt.table
    variants = {}
    for p, m in zip(params, opt.mu):
        key = f"w {'bf16' if p.dtype == torch.bfloat16 else 'f32'}, m {'bf16' if m.dtype == torch.bfloat16 else 'f32'}"
        variants[key] = variants.get(key, 0) + 1
    n_params = sum(p.numel() for p in params)
    if (len(params), n_params) != (FLAGSHIP_LEAVES, FLAGSHIP_PARAMS) or (
        len(table.w), sum(table.numel)
    ) != (len(params), n_params):
        raise AssertionError(
            f"path: {len(params)} leaves of {n_params} elements, table {len(table.w)} of "
            f"{sum(table.numel)}; expected {FLAGSHIP_LEAVES} of {FLAGSHIP_PARAMS}"
        )
    rows = torch.as_tensor(
        np.random.default_rng(0).integers(0, len(ds), (warmup + steps, batch)), device=DEVICE
    )
    loss_scale = trainer.loss_scale_for_epoch(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    fa.fused_adamw_multi.launches = 0
    fa.fused_adamw_leaf.launches = 0
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        trainer.state, m = trainer.train_step(trainer.state, rows[i], loss_scale)
        metrics.append(m)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    launches = fa.fused_adamw_multi.launches + fa.fused_adamw_leaf.launches

    losses = {k: torch.stack([m[k] for m in metrics]).float().cpu() for k in metrics[0]}
    bad = [k for k, v in losses.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"path: non-finite losses {bad}")
    if len(table.batches) != len(variants) or launches != len(variants) * (warmup + steps):
        raise AssertionError(
            f"path: {launches} kernel launches in {warmup + steps} steps; expected one per "
            f"dtype variant ({len(variants)}) a step"
        )

    # the optimizer pass alone: one update_and_apply over every leaf, on
    # gradients of the leaves' shapes and dtypes (its cost does not depend
    # on their values), beside the bytes it must move
    grads = [torch.randn_like(p) * 1e-3 for p in params]
    opt_ms = cuda_ms(lambda: trainer.tx.update_and_apply(grads, trainer.state.opt_state, params), iters=10)
    opt_bytes = sum(
        fa.leaf_bytes([p.shape], p.element_size(), m.element_size()) for p, m in zip(params, opt.mu)
    )
    rec = {
        "batch": batch, "channels": trainer.config["model"]["channel"], "window": 51, "z_dim": 128,
        "precision": "bf16", "param_dtype": "bf16", "warmup_steps": warmup, "timed_steps": steps,
        "step_ms": step_s * 1e3, "samples_per_s": batch / step_s,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "leaves": len(params), "params": n_params,
        "leaf_variants": variants, "kernel_launches": launches,
        "launches_per_step": launches / (warmup + steps),
        "first_total": float(losses["total"][0]), "last_total": float(losses["total"][-1]),
        "optimizer_pass_ms": opt_ms, "optimizer_pass_bytes": opt_bytes,
        "optimizer_pass_bound_ms": opt_bytes / HBM_BYTES_PER_S * 1e3,
    }
    log("path flagship train step: " + json.dumps(rec))
    return rec, rows, loss_scale


def profile_phase(trainer, rows, loss_scale, steps: int = 5) -> None:
    """Device time by kernel over a few flagship steps (torch.profiler);
    the full table is written to build/profile_path.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            trainer.state, _ = trainer.train_step(trainer.state, rows[i], loss_scale)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: the aten ops above them carry the same device time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: -e.self_device_time_total)
    out = ROOT / "build" / "profile_path.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)
    )
    top = [
        {"name": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / steps,
         "calls_per_step": e.count / steps}
        for e in events[:15]
    ]
    log("profile: " + json.dumps({
        "steps": steps, "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": sum(e.count for e in events) / steps,
        "top_kernels": top,
    }))


# ---------------------------------------------------------------------------
# phase 7: the training entry point at full width
# ---------------------------------------------------------------------------

FIT_EPOCHS = 20
MALS_FIELDS = ("Sxx0", "Sxy0", "Sxx1", "Sxy1", "lam0", "lam1")
DECOD_COLUMNS = tuple(
    f"{m}_{s}"
    for m in (
        "r2_avg_speed_3d_lin", "r2_avg_speed_3d_mlp", "r2_heading_lin", "r2_heading_mlp",
        "acc_ids_log", "acc_ids_qda",
    )
    for s in ("mean", "std")
)
# card against CPU on the same mu: the bands of the CPU tests
# (tests/test_torch_port_decodability.py)
LIN_R2_CARD_CPU = 1e-9
MLP_R2_CARD_CPU = 1e-3


def _fit_splits():
    """Synthetic train (4 ids x 1200 frames) and val (4 ids x 2600 frames)
    splits, on the card."""
    from scrubvae_torch import bench
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream

    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    out = {}
    for label, seed, per_id, n_ids in (("train", 0, 1200, 4), ("val", 1, 2600, 4)):
        pose, ids = synthetic_pose_stream(skel, n_frames=per_id * n_ids, n_ids=n_ids, seed=seed)
        store = build_frame_store(pose, ids, skel, window=51, stride=2, device=DEVICE)
        mid = store.ids[store.starts + 51 // 2].cpu().numpy()
        out[label] = StreamDataset(
            store, skel, bench.KEYS, "midfwd", arena_size=bench.ARENA, discrete_classes={"ids": np.unique(mid)},
            device=DEVICE, label=label,
        )
    return out


def _fit_config(run: pathlib.Path, model: dict = None, **train: dict) -> dict:
    """Write the flagship's config for ``train``, without ``minimal_test``
    and with ``model`` and ``train`` entries overridden, to
    ``run/model_config.yaml`` and read it back through the port's config
    reader."""
    import yaml

    from scrubvae_torch.params import read

    from scrubvae_torch import bench

    cfg = bench.bench_config(512, 51, 128, bench.FULL_CH, True)
    del cfg["train"]["minimal_test"]
    cfg["train"].update({"num_epochs": FIT_EPOCHS, "eval_start_epoch": 0, **train})
    cfg["model"].update(model or {})
    run.mkdir(parents=True)
    (run / "model_config.yaml").write_text(yaml.safe_dump(cfg))
    return read.config(run / "model_config.yaml")


def _trainer_state(trainer) -> dict:
    st = trainer.state
    mals = st.scrub_state["moving_avg_lsq"]["avg_speed_3d"]
    return {
        "params": [p.detach().clone() for p in trainer.model.parameters()],
        "buffers": [b.clone() for b in trainer.model.buffers()],
        "mu": [m.clone() for m in st.opt_state.mu],
        "nu": [n.clone() for n in st.opt_state.nu],
        "count": st.opt_state.count.clone(),
        "steps": (st.opt_state.step, st.step),
        "mals": [getattr(mals, f).clone() for f in MALS_FIELDS],
        "generator": st.generator.get_state().clone(),
        "np_rng": repr(trainer.np_rng.bit_generator.state),
    }


def _same_state(a: dict, b: dict) -> list:
    """Names of the parts of two ``_trainer_state`` records that differ."""
    bad = [
        part for part in ("params", "buffers", "mu", "nu", "mals")
        if len(a[part]) != len(b[part])
        or not all(
            bits_equal(x, y) if x.is_floating_point() else torch.equal(x, y) for x, y in zip(a[part], b[part])
        )
    ]
    if not torch.equal(a["count"], b["count"]):
        bad.append("count")
    if a["steps"] != b["steps"]:
        bad.append("steps")
    if not torch.equal(a["generator"], b["generator"]):
        bad.append("generator")
    if a["np_rng"] != b["np_rng"]:
        bad.append("np_rng")
    return bad


class _Timer:
    """Wraps functions of a module or class so each call is timed on the
    host clock between two synchronizes, and its arguments kept in
    ``last``; ``undo`` puts them back."""

    def __init__(self):
        self.times: dict = {}
        self.last: dict = {}
        self._saved = []

    def wrap(self, owner, name: str, label: str) -> None:
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))

        def timed(*a, **k):
            self.last[label] = a
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.times.setdefault(label, []).append(time.perf_counter() - t0)
            return out

        setattr(owner, name, timed)

    def undo(self) -> None:
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []

    def mean_ms(self, label: str) -> float:
        return float(np.mean(self.times[label])) * 1e3

    def total_ms(self, label: str) -> float:
        return float(np.sum(self.times[label])) * 1e3


def decodability_card_vs_cpu(z: np.ndarray, val_ds, window: int) -> dict:
    """The estimators of ``Trainer.decodability_metrics`` on the card and on
    the CPU, on the same validation mu and labels and the same host-drawn
    folds: each rand_cv's 5 folds (linear R^2 within ``LIN_R2_CARD_CPU``,
    MLP R^2 within ``MLP_R2_CARD_CPU``, the MLP starting from the same
    CPU-drawn init), and per classification fold the QDA and LDA
    predictions (identical) and the logistic ones (at most one sample
    apart)."""
    from scrubvae_torch.evals import metrics as em
    from scrubvae_torch.evals import probes

    full = val_ds.batch(torch.arange(len(val_ds), device=DEVICE))
    labels = {k: full[k].cpu() for k in ("avg_speed_3d", "heading", "ids")}
    devices = (DEVICE, "cpu")
    rec = {"lin_r2_max_diff": 0.0, "mlp_r2_max_diff": 0.0}
    for key in ("avg_speed_3d", "heading"):
        for name, fn, band in (
            ("lin", em.linear_rand_cv, LIN_R2_CARD_CPU), ("mlp", em.mlp_rand_cv, MLP_R2_CARD_CPU),
        ):
            card, cpu = (np.asarray(fn(z, labels[key], window, 5, device=d)) for d in devices)
            if card.shape != cpu.shape or len(card) != 5:
                raise AssertionError(f"fit: {name} folds of {key}: card {card}, CPU {cpu}")
            diff = float(np.abs(card - cpu).max())
            rec[f"{name}_r2_max_diff"] = max(rec[f"{name}_r2_max_diff"], diff)
            if not diff <= band:
                raise AssertionError(f"fit: {name} R^2 of {key}, card {card} against CPU {cpu}")
    cw = em.decodability_class_window("synthetic", window)
    cz, cy = z[::cw], labels["ids"][::cw].numpy()
    differ = {"qda": [], "lda": [], "logistic": []}
    retried = 0
    for tr, te in em.kfold_indices(len(cz), 5):
        preds = {}
        try:
            probes.qda_fit(torch.as_tensor(cz[tr]).to(DEVICE), torch.as_tensor(cy[tr]).to(DEVICE))
        except ValueError as e:
            if "full rank" not in str(e):
                raise
            retried += 1
        for d in devices:
            ztr, ytr, zte = (torch.as_tensor(a).to(d) for a in (cz[tr], cy[tr], cz[te]))
            preds[d] = {
                "qda": probes.qda_predict(em.qda_fit_retry(ztr, ytr), zte),
                "lda": probes.lda_predict(probes.lda_fit(ztr, ytr), zte),
                "logistic": probes.logistic_predict(ztr, ytr, zte),
            }
        for name in differ:
            differ[name].append(int((preds[DEVICE][name].cpu() != preds["cpu"][name]).sum()))
    rec.update({f"{name}_differing_per_fold": v for name, v in differ.items()})
    if any(differ["qda"]) or any(differ["lda"]) or max(differ["logistic"]) > 1:
        raise AssertionError(f"fit: card and CPU predictions differ: {differ}")
    rec["qda_retry_folds"] = retried

    # what shaped the estimators, read on this mu: the folds where QDA took
    # its retry (above), how far from isotropic a classification fold is and
    # the Newton iterations its logistic fit takes; how far apart the card
    # and the CPU land with the MLP probe trained in float32, not float64
    tr = em.kfold_indices(len(cz), 5)[0][0]
    xc = torch.as_tensor(cz[tr], device=DEVICE).double()
    sv = torch.linalg.svdvals(xc - xc.mean(0))
    rec["class_fold_singular_value_ratio"] = float(sv[0] / sv[-1])
    onehot = torch.nn.functional.one_hot(torch.unique(torch.as_tensor(cy[tr]), return_inverse=True)[1])
    rec["class_fold_logistic_iterations"] = probes.logistic_fit(xc, onehot.to(DEVICE).double())[2]
    dz, dy = z[::window], labels["avg_speed_3d"][::window]
    tr, te = em.kfold_indices(len(dz), 5)[0]
    r2 = {}
    for d in devices:
        model = probes.MLPProbe(probes.probe_init(z.shape[1], dy.shape[1]), device=d).float()
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
        x, y = torch.as_tensor(dz[tr]).to(d), dy[tr].to(d).float()
        for _ in range(200):
            opt.zero_grad()
            ((model(x) - y) ** 2).sum().backward()
            opt.step()
        with torch.no_grad():
            r2[d] = probes.r2_score(dy[te], model(torch.as_tensor(dz[te]).to(d)).cpu())
    rec["mlp_float32_r2_card_cpu_diff"] = abs(r2[DEVICE] - r2["cpu"])
    return rec


def fit_phase(card: str) -> dict:
    """``train(config, datasets, model, info)`` for 20 epochs at full
    flagship width, then a resume from epoch 20 for epoch 21 (see the
    module docstring)."""
    import csv

    from scrubvae_torch import bench, factory
    from scrubvae_torch.evals import metrics as em
    from scrubvae_torch.ops import fused_adamw as fa
    from scrubvae_torch.train import trainer as trainer_mod
    from scrubvae_torch.utils import checkpoint as ckpt

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    timer = _Timer()
    try:
        datasets = _fit_splits()
        n_train, n_val = len(datasets["train"]), len(datasets["val"])
        if n_train // 512 < 3 or n_val < 5000 or n_val % 512 == 0:
            raise AssertionError(f"fit: {n_train} train and {n_val} val windows")
        run = tmp / "run"
        config = _fit_config(run)

        def build():
            return factory.build_model(
                config["model"], config["disentangle"], n_keypts=18, direction_process="midfwd",
                arena_size=bench.ARENA, discrete_classes=datasets["train"].discrete_classes,
                loss_keys=config["loss"].keys(), device=DEVICE,
            )

        model, info = build()
        for owner, name, label in (
            (trainer_mod.Trainer, "train_epoch", "train_epoch"),
            (trainer_mod.Trainer, "test_epoch", "val_epoch"),
            (ckpt, "save_weights", "save_weights"),
            (ckpt, "save_train_state", "save_train_state"),
            (ckpt, "load_weights", "load_weights"),
            (ckpt, "load_train_state", "load_train_state"),
            (trainer_mod.Trainer, "decodability_metrics", "decodability"),
            (em, "linear_rand_cv", "linear"),
            (em, "mlp_rand_cv", "mlp"),
            (em, "log_class_rand_cv", "logistic"),
            (em, "qda_rand_cv", "qda"),
        ):
            timer.wrap(owner, name, label)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.fused_adamw_multi.launches = 0
        fa.fused_adamw_leaf.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trainer = trainer_mod.train(config, datasets, model, info, device=DEVICE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        for w in caught:
            log(f"fit: warning during train: {w.category.__name__}: {w.message}")
        # read before the card-against-CPU comparison calls the estimators again
        n_eval = len(timer.times["decodability"])
        decod_ms = {k: timer.total_ms(k) / n_eval for k in ("linear", "mlp", "logistic", "qda")}
        launches = fa.fused_adamw_multi.launches + fa.fused_adamw_leaf.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        ended = _trainer_state(trainer)

        steps = trainer.steps_per_epoch * FIT_EPOCHS
        params = list(trainer.model.parameters())
        table = trainer.state.opt_state.table
        table.check_storage(params, trainer.state.opt_state.mu, trainer.state.opt_state.nu)
        if (len(params), len(table.w), len(table.batches)) != (FLAGSHIP_LEAVES, FLAGSHIP_LEAVES, 2):
            raise AssertionError(
                f"fit: {len(params)} leaves, a table of {len(table.w)} in {len(table.batches)} launches"
            )
        if launches != 2 * steps or trainer.state.opt_state.step != steps:
            raise AssertionError(f"fit: {launches} optimizer launches in {steps} steps; expected 2 a step")
        with open(run / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        if [int(r["epoch"]) for r in rows] != list(range(1, FIT_EPOCHS + 1)):
            raise AssertionError(f"fit: metrics.csv epochs {[r['epoch'] for r in rows]}")
        test_keys = ("total_test", "r2_gen_restrict_avg_speed_3d_test", "r2_gen_restrict_heading_test")
        for r in rows:
            if not math.isfinite(float(r["total_train"])):
                raise AssertionError(f"fit: total_train {r['total_train']} at epoch {r['epoch']}")
            if int(r["epoch"]) % 5 == 0 and not all(r[k] and math.isfinite(float(r[k])) for k in test_keys):
                raise AssertionError(f"fit: validation metrics at epoch {r['epoch']}: {[r[k] for k in test_keys]}")
        z20 = timer.last["decodability"][1]
        nanfolds = [k for k in rows[0] if k.endswith("_nanfolds")]
        missing = [k for k in DECOD_COLUMNS if k not in rows[0]]
        bad = [
            (r["epoch"], k, r[k]) for r in rows if int(r["epoch"]) % 5 == 0
            for k in DECOD_COLUMNS if k in r and not (r[k] and math.isfinite(float(r[k])))
        ]
        if nanfolds or missing or bad:
            out = ROOT / "chiprun_out"
            out.mkdir(exist_ok=True)
            full = datasets["val"].batch(torch.arange(n_val, device=DEVICE))
            np.savez(out / "fit_decodability_z.npz", z=z20, **{k: full[k].cpu().numpy() for k in ("avg_speed_3d", "heading", "ids")})
            raise AssertionError(
                f"fit: decodability columns: nan folds in {nanfolds}, missing {missing}, not finite {bad}; "
                f"the epoch-20 mu and labels are in {out / 'fit_decodability_z.npz'}"
            )
        card_cpu = decodability_card_vs_cpu(z20, datasets["val"], info["window"])
        log("fit decodability, card against CPU: " + json.dumps(card_cpu))
        if list(factory.all_saved_epochs(run)) != [5, 10, 15, 20] or sorted(
            p.name for p in (run / "checkpoints").iterdir()
        ) != ["epoch_20.pt"]:
            raise AssertionError("fit: weights at 5, 10, 15, 20 and the full state at 20 expected")

        # resume from epoch 20
        config = _fit_config(
            tmp / "resume", num_epochs=FIT_EPOCHS + 1, model={"load_model": str(run), "start_epoch": FIT_EPOCHS}
        )
        model, info = build()
        resumed = trainer_mod.Trainer(config, datasets, model, info, device=DEVICE)
        bad = _same_state(_trainer_state(resumed), ended)
        if bad:
            raise AssertionError(f"fit: resume from epoch {FIT_EPOCHS} differs in {bad}")
        resumed.fit()
        with open(tmp / "resume" / "metrics.csv", newline="") as f:
            rows21 = list(csv.DictReader(f))
        if [r["epoch"] for r in rows21] != [str(FIT_EPOCHS + 1)] or not all(
            math.isfinite(float(v)) for k, v in rows21[0].items() if k.endswith("_train")
        ):
            raise AssertionError(f"fit: epoch {FIT_EPOCHS + 1} after the resume: {rows21}")

        epoch_ms = timer.mean_ms("train_epoch")
        rec = {
            "card": card, "epochs": FIT_EPOCHS, "train_windows": n_train, "val_windows": n_val,
            "steps_per_epoch": trainer.steps_per_epoch, "fit_s": fit_s,
            "train_epoch_ms": epoch_ms, "step_ms": epoch_ms / trainer.steps_per_epoch,
            "val_epoch_ms": timer.mean_ms("val_epoch"), "val_epochs": len(timer.times["val_epoch"]),
            "decodability_ms_per_val_epoch": timer.mean_ms("decodability"),
            "decodability_ms_per_val_epoch_by_probe": decod_ms,
            "decodability_epoch20": {k: float(rows[FIT_EPOCHS - 1][k]) for k in DECOD_COLUMNS},
            "decodability_card_vs_cpu": card_cpu,
            "save_weights_ms": timer.mean_ms("save_weights"),
            "weights_bytes": (run / "weights" / "epoch_20.pt").stat().st_size,
            "save_train_state_ms": timer.mean_ms("save_train_state"),
            "train_state_bytes": (run / "checkpoints" / "epoch_20.pt").stat().st_size,
            "restore_ms": timer.mean_ms("load_weights") + timer.mean_ms("load_train_state"),
            "peak_mem_gib": peak_gib, "optimizer_launches": launches, "launches_per_step": launches / steps,
            "leaves": len(params), "resume_bitwise_equal": True,
            "first_total_train": float(rows[0]["total_train"]), "last_total_train": float(rows[-1]["total_train"]),
            "epoch21_total_train": float(rows21[0]["total_train"]),
            "r2_gen_restrict_epoch20": {k: float(rows[-1][k]) for k in test_keys[1:]},
        }
        log("fit flagship train entry point: " + json.dumps(rec))
        return rec
    finally:
        timer.undo()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8: the full scrubber stack (configs/ladder/5_full.yaml)
# ---------------------------------------------------------------------------

FULL_EPOCHS = 20
FULL_PRINT_EPOCHS = (1, 5, 10, 20)
FULL_COLUMNS = ("avg_speed_3d_an", "ids_qda", "mcmi", "total_correlation")
ADV_FEAT = "avg_speed_3d"
# card against CPU: narrow channels, the flagship's z (QDA's 128-dim
# systems), f32, no clip (as the CPU tests: a clip factor below 1 makes the
# step-1 update of a small gradient depend on its value, not only its sign,
# which the weights' two-ulp bound assumes), and the parity phase's batch
# of 16: at batch 128 the
# rotation loss's f32 rounding (see scrubvae_torch/train/parity.py) put the
# median step-1 gradient difference at 1.008e-2, past its 1e-2 bound
FULL_PARITY = {"channel": [8, 8, 16, 16, 32], "z_dim": 128, "batch": 16}
# the discriminator after its 5 inner AdamW steps at lr 0.1, card against
# CPU, per leaf by relative norm and on the median leaf. Each inner step
# moves a weight by about lr times the sign of its gradient, so an element
# whose gradient is near 0 flips under any rounding, the more so in
# sane/4_full: sound runs read up to 2.1e-4 (5_full) and 2.27e-3
# (sane/4_full; its CPU reference moves by up to 3.55e-3 under a 1e-6
# perturbation of the discriminator's input), medians up to 4.2e-6; one
# inner step left out, or an inner lr of 0.09, reads 0.11 or more on the
# largest leaf and 0.10 or more on the median
# (tests/test_torch_port_adv_bounds.py reads both on the CPU)
ADV_TOL = {"ladder/5_full": 1e-3, "sane/4_full": 2e-2}
ADV_MEDIAN_TOL = 1e-4


def _shipped_config(run: pathlib.Path, name: str, model: dict = None, data: dict = None, **train) -> dict:
    """``configs/{name}.yaml`` with ``model``, ``data`` and ``train``
    entries overridden, written to ``run/model_config.yaml`` and read back
    through the port's config reader."""
    import yaml

    from scrubvae_torch.params import read

    with open(ROOT / "configs" / f"{name}.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["train"].update(train)
    cfg["model"].update(model or {})
    cfg["data"].update(data or {})
    run.mkdir(parents=True)
    (run / "model_config.yaml").write_text(yaml.safe_dump(cfg))
    return read.config(run / "model_config.yaml")


def _full_config(run: pathlib.Path, num_epochs: int = FULL_EPOCHS, model: dict = None, **train) -> dict:
    """configs/ladder/5_full.yaml with ``num_epochs`` and validation at
    epoch 20 only (see ``_shipped_config``)."""
    return _shipped_config(run, "ladder/5_full", model, num_epochs=num_epochs, eval_start_epoch=FULL_EPOCHS, **train)


def _full_parity_run(device: str, rows: np.ndarray, draws: list, name: str, z_dim: int) -> dict:
    """Two steps of the full stack of ``configs/{name}.yaml`` at
    ``FULL_PARITY``'s channels and batch and ``z_dim``, from the seed's
    weights and states, with the given rows, noise and shuffles (one inner
    discriminator step per shuffle); the step-1 gradients, weights and
    states, and both steps' losses, on the CPU."""
    from scrubvae_torch import bench, factory
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream
    from scrubvae_torch.train import parity
    from scrubvae_torch.train.trainer import Trainer

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_full_parity_"))
    try:
        config = _shipped_config(
            tmp / "run", name, model={"channel": FULL_PARITY["channel"], "z_dim": z_dim, "precision": "fp32"},
            precision="fp32", moment_dtype="f32", minimal_test=True, clip_norm=0,
        )
        config["data"]["batch_size"] = FULL_PARITY["batch"]
        dp = config["data"]["direction_process"]
        skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
        pose, ids = synthetic_pose_stream(skel, n_frames=4096, n_ids=4, seed=0)
        ds = StreamDataset(
            build_frame_store(pose, ids, skel, window=51, stride=2, device=device), skel, bench.KEYS, dp,
            arena_size=bench.ARENA, discrete_classes={"ids": np.unique(ids)}, device=device,
        )
        model, info = factory.build_model(
            config["model"], config["disentangle"], 18, dp, arena_size=bench.ARENA,
            discrete_classes=ds.discrete_classes, loss_keys=config["loss"].keys(), device=device,
        )
        trainer = Trainer(config, {"train": ds}, model, info, device=device)
        names = [n for n, _ in trainer.model.named_parameters()]
        loss_scale = trainer.loss_scale_for_epoch(26)  # the prior at half its weight
        out = {"losses": []}
        for s, (eps, perms) in enumerate(draws):
            perms = {"loss": perms["loss"].to(device), "fit": {k: [p.to(device) for p in v] for k, v in perms["fit"].items()}}
            trainer.state, metrics = trainer.train_step(
                trainer.state, torch.as_tensor(rows[s] % len(ds), device=device), loss_scale,
                eps=torch.from_numpy(eps).to(device), perms=perms,
            )
            out["losses"].append({k: float(v) for k, v in metrics.items()})
            if s == 0:
                # copies: step 2 updates the parameters and moments in place
                st = trainer.state

                def cpu(t):
                    return t.detach().to("cpu", copy=True)

                out["grads"] = {n: cpu(m) / (1.0 - trainer.tx.b1) for n, m in zip(names, st.opt_state.mu)}
                out["w1"] = {n: cpu(p) for n, p in trainer.model.named_parameters()}
                out["mals"] = {
                    feat: {k: cpu(getattr(m, k)) for k in parity.MALS_KEYS}
                    for feat, m in st.scrub_state["moving_avg_lsq"].items()
                }
                out["qda"] = {k: cpu(getattr(st.scrub_state["qda"]["ids"], k)) for k in parity.QDA_KEYS}
                out["adv"] = {k: cpu(v) for k, v in st.adv_states[ADV_FEAT].net.state_dict().items()}
                out["mi"] = {k: cpu(getattr(st.mi_state, k)) for k in parity.MI_KEYS}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def full_parity_draws(z_dim: int):
    """The window rows of two steps (modulo the dataset's length) and each
    step's noise and permutations: the loss's shuffle and the
    discriminator's 5 inner shuffles."""
    B = FULL_PARITY["batch"]
    rng = np.random.default_rng(5)
    gen = torch.Generator().manual_seed(5)
    rows = rng.integers(0, 1 << 20, (2, B))
    draws = [
        (
            rng.standard_normal((B, z_dim)).astype(np.float32),
            {"loss": torch.randperm(B, generator=gen), "fit": {ADV_FEAT: [torch.randperm(B, generator=gen) for _ in range(5)]}},
        )
        for _ in range(2)
    ]
    return rows, draws


def skip_inner_step(draws: list) -> list:
    """Step 1 of ``draws`` with the discriminator's last inner step left
    out: a planted fault."""
    eps, perms = draws[0]
    return [(eps, {**perms, "fit": {ADV_FEAT: perms["fit"][ADV_FEAT][:4]}})]


def full_parity(name: str = "ladder/5_full", z_dim: int = FULL_PARITY["z_dim"]) -> dict:
    """The full stack's steps 1 and 2 of ``configs/{name}.yaml`` on the card
    against the CPU: step 1 held to ``scrubvae_torch.train.parity`` (losses
    1e-4, gradients, weights to four ulps, MALS of every feature and QDA
    1e-4, the discriminator by ``ADV_TOL``, MCMI 1e-2), step 2's losses,
    where QDA's and MCMI's are no longer 0, at rtol 1e-2. The card runs with
    deterministic algorithms. Then the same step 1 on the card with one of
    the discriminator's 5 inner steps left out, a planted fault that the
    discriminator's bounds must catch."""
    from scrubvae_torch.train import parity

    B, Z = FULL_PARITY["batch"], z_dim
    rows, draws = full_parity_draws(Z)
    adv_tol = ADV_TOL[name]
    cpu = _full_parity_run("cpu", rows, draws, name, Z)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        card = _full_parity_run(DEVICE, rows, draws, name, Z)
        fault = _full_parity_run(DEVICE, rows, skip_inner_step(draws), name, Z)["adv"]
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    fault_rec = parity.check_adv(cpu["adv"], fault, math.inf)
    if fault_rec["max_adv_rel"] <= adv_tol and fault_rec["median_adv_rel"] <= ADV_MEDIAN_TOL:
        raise AssertionError(f"{name}: an inner discriminator step left out passes the bounds: {fault_rec}")
    want0 = {k: v for k, v in cpu["losses"][0].items() if k != "mcmi"}
    got0 = {k: v for k, v in card["losses"][0].items() if k != "mcmi"}
    if cpu["losses"][0]["mcmi"] != 0.0 or card["losses"][0]["mcmi"] != 0.0:
        raise AssertionError("full: the mcmi loss is not 0 before the estimator's first refresh")
    checks = {
        "max_loss_rel_step1": lambda: parity.check_losses(want0, got0, 1e-4),
        "grads": lambda: parity.check_grads(cpu["grads"], card["grads"]),
        "weights": lambda: parity.check_weights(cpu["w1"], card["w1"], cpu["grads"], ulps=4),
        "max_mals_rel": lambda: max(parity.check_mals(cpu["mals"][f], card["mals"][f], 1e-4) for f in cpu["mals"]),
        "max_qda_rel": lambda: parity.check_qda(cpu["qda"], card["qda"], 1e-4),
        "adv": lambda: parity.check_adv(cpu["adv"], card["adv"], adv_tol, median_tol=ADV_MEDIAN_TOL),
        "max_mi_rel": lambda: parity.check_mi(cpu["mi"], card["mi"], 1e-2),
        "max_loss_rel_step2": lambda: parity.check_losses(cpu["losses"][1], card["losses"][1], 1e-2),
    }
    rec = {
        "config": name, "batch": B, "z_dim": Z, "channels": FULL_PARITY["channel"],
        "adv_tol": adv_tol, "adv_median_tol": ADV_MEDIAN_TOL,
        "adv_fault_max_rel": fault_rec["max_adv_rel"], "adv_fault_median_rel": fault_rec["median_adv_rel"],
    }
    failed = {}
    for label, check in checks.items():
        # every check runs, so one call shows all that differs; any failure
        # fails the phase below
        try:
            got = check()
        except AssertionError as e:
            failed[label] = str(e)
            continue
        rec.update(got if isinstance(got, dict) else {label: got})
    rec["step2_losses_card"] = {k: card["losses"][1][k] for k in ("ids_qda", "mcmi", "avg_speed_3d_an", "total_correlation")}
    if failed:
        raise AssertionError(f"{name}: card against CPU: {json.dumps(failed)}; readings {json.dumps(rec)}")
    log(f"{name} card against CPU, steps 1 and 2: " + json.dumps(rec))
    return rec


def inner_adamw_check(adv_state, label: str = "discriminator") -> dict:
    """The discriminator's leaf set (its shapes, random values, f32 with f32
    moments) in one call of the kernel, bitwise against the plain version;
    the call's time beside its bound, the plain version's and
    ``torch._fused_adamw_``'s over the same leaves."""
    from scrubvae_torch.ops import fused_adamw as fa

    params = list(adv_state.net.parameters())
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(p, scale):
        return torch.randn(p.shape, generator=gen, device="cuda") * scale

    ws = [randn(p, 0.1) for p in params]
    gs = [randn(p, 1e-2) for p in params]
    mus = [randn(p, 1e-3) for p in params]
    nus = [randn(p, 1e-2) ** 2 for p in params]
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-4)
    t = 3
    scal = torch.tensor([0.1, 1.0 - 0.9**t, 1.0 - 0.999**t, 1.0], dtype=torch.float32, device="cuda")
    lr, b1c, b2c, gscale = scal.unbind(0)
    table = fa.LeafTable([w.clone() for w in ws], [m.clone() for m in mus], [v.clone() for v in nus])
    fa.fused_adamw_multi(table, gs, scal, step=t, **hyper)
    refs = fa.fused_adamw_multi_reference(ws, gs, mus, nus, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, step=t, **hyper)
    torch.cuda.synchronize()
    err = 0.0
    for i, ref in enumerate(refs):
        err = max(err, _assert_bits(f"{label} leaf {i} {tuple(ws[i].shape)}", (table.w[i], table.mu[i], table.nu[i]), ref))
    n = sum(table.numel)
    bytes_moved = fa.leaf_bytes([w.shape for w in ws], 4, 4)
    lib = [[x.clone() for x in xs] for xs in (ws, gs, mus, nus)]
    steps = [torch.tensor(float(t), device="cuda") for _ in ws]
    calls = {
        "kernel": lambda: fa.fused_adamw_multi(table, gs, scal, step=t, **hyper),
        "plain": lambda: fa.fused_adamw_multi_reference(
            ws, gs, mus, nus, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, step=t, **hyper
        ),
        "library": lambda: torch._fused_adamw_(
            *lib, [], steps, lr=0.1, beta1=0.9, beta2=0.999, weight_decay=1e-4,
            eps=1e-8, amsgrad=False, maximize=False,
        ),
    }
    rec = {
        "leaves": len(ws), "elements": n, "launches_per_call": len(table.batches), "bitwise": True,
        "max_abs_err": err, "bytes": bytes_moved,
    }
    # a call this small is set by the host: its device time (profiler) is
    # what the kernel costs, its time between events what a caller waits
    for name, fn in calls.items():
        rec[f"{name}_ms"] = device_ms(fn)
        rec[f"{name}_call_ms"] = cuda_ms(fn, iters=50)
    rec["bound_ms"], rec["bound_by"] = _bound(bytes_moved, n)
    log(f"kernel fused_adamw {label} leaf set: " + json.dumps(rec))
    return rec


def _full_state(trainer) -> dict:
    """``_trainer_state`` plus the QDA state, the discriminator's parameters,
    moments and counts, the MCMI state and the batch-order generator."""
    from scrubvae_torch.train import parity

    st = trainer.state
    adv = st.adv_states[ADV_FEAT]
    out = _trainer_state(trainer)
    out.update(
        qda=[getattr(st.scrub_state["qda"]["ids"], f).clone() for f in parity.QDA_KEYS],
        adv=[p.detach().clone() for p in adv.net.parameters()] + [m.clone() for m in adv.opt_state.mu + adv.opt_state.nu],
        mi=[getattr(st.mi_state, f).clone() for f in parity.MI_KEYS],
        adv_counts=(adv.opt_state.count.clone(), adv.opt_state.step),
    )
    return out


def _same_full_state(a: dict, b: dict) -> list:
    bad = _same_state(a, b)
    bad += [
        part for part in ("qda", "adv", "mi")
        if len(a[part]) != len(b[part]) or not all(bits_equal(x, y) for x, y in zip(a[part], b[part]))
    ]
    if not torch.equal(a["adv_counts"][0], b["adv_counts"][0]) or a["adv_counts"][1] != b["adv_counts"][1]:
        bad.append("adv_counts")
    return bad


def full_phase(card: str) -> dict:
    """``configs/ladder/5_full.yaml`` at its full width through
    ``train(config, datasets, model, info)`` for 20 epochs on the fit
    phase's splits, one validation epoch at 20 (MCMI refresh, decodability);
    then a resume from epoch 20 against the run's own epoch 21 (see the
    module docstring)."""
    import csv

    from scrubvae_torch import bench, factory
    from scrubvae_torch.ops import fused_adamw as fa
    from scrubvae_torch.train import trainer as trainer_mod

    parity_rec = full_parity()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_full_"))
    timer = _Timer()
    try:
        datasets = _fit_splits()
        run = tmp / "run"
        config = _full_config(run)

        def build():
            return factory.build_model(
                config["model"], config["disentangle"], n_keypts=18, direction_process="midfwd",
                arena_size=bench.ARENA, discrete_classes=datasets["train"].discrete_classes,
                loss_keys=config["loss"].keys(), device=DEVICE,
            )

        model, info = build()
        if model.vae.packed_sigma:
            raise AssertionError("full: total_correlation needs the dense Cholesky head")
        for owner, name, label in (
            (trainer_mod.Trainer, "train_epoch", "train_epoch"),
            (trainer_mod.Trainer, "test_epoch", "val_epoch"),
            (trainer_mod.Trainer, "_refresh_eval_mi", "mi_refresh"),
            (trainer_mod.Trainer, "decodability_metrics", "decodability"),
        ):
            timer.wrap(owner, name, label)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.fused_adamw_multi.launches = 0
        fa.fused_adamw_leaf.launches = 0
        t0 = time.perf_counter()
        trainer = trainer_mod.train(config, datasets, model, info, device=DEVICE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = fa.fused_adamw_multi.launches + fa.fused_adamw_leaf.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        at20 = _full_state(trainer)

        steps = trainer.steps_per_epoch * FULL_EPOCHS
        outer = trainer.state.opt_state.table
        adv = trainer.state.adv_states[ADV_FEAT]
        n_iter = int(config["disentangle"]["n_iter"])
        per_step = len(outer.batches) + n_iter * len(adv.opt_state.table.batches)
        n_params = len(list(trainer.model.parameters()))
        if (len(outer.w), len(adv.opt_state.table.w), len(adv.opt_state.table.batches)) != (n_params, 22, 1):
            raise AssertionError(
                f"full: outer table of {len(outer.w)} leaves for {n_params} parameters, discriminator "
                f"table of {len(adv.opt_state.table.w)} leaves in {len(adv.opt_state.table.batches)} launches"
            )
        if launches != per_step * steps or adv.opt_state.step != n_iter * steps:
            raise AssertionError(f"full: {launches} kernel launches in {steps} steps; expected {per_step} a step")

        with open(run / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        if [int(r["epoch"]) for r in rows] != list(range(1, FULL_EPOCHS + 1)):
            raise AssertionError(f"full: metrics.csv epochs {[r['epoch'] for r in rows]}")
        loss_cols = [k for k in rows[0] if k.endswith("_train")]
        missing = [f"{c}_{s}" for c in FULL_COLUMNS for s in ("train", "test") if f"{c}_{s}" not in rows[0]]
        bad = [
            (r["epoch"], k, r[k]) for r in rows for k in loss_cols + ["lambda_qda_ids"]
            if not math.isfinite(float(r[k]))
        ]
        bad += [(20, k, rows[-1][k]) for k in rows[-1] if k.endswith("_test") and not math.isfinite(float(rows[-1][k]))]
        if missing or bad:
            raise AssertionError(f"full: metrics.csv columns missing {missing}, not finite {bad}")
        lam = [float(r["lambda_qda_ids"]) for r in rows]
        printed = {
            r["epoch"]: {k: float(r[k]) for k in ["lambda_qda_ids", "total_train"] + [f"{c}_train" for c in FULL_COLUMNS]}
            for r in rows if int(r["epoch"]) in FULL_PRINT_EPOCHS
        }
        printed["20"].update({f"{c}_test": float(rows[-1][f"{c}_test"]) for c in FULL_COLUMNS})
        log("full metrics.csv at epochs 1, 5, 10, 20: " + json.dumps(printed))
        epoch_ms = timer.mean_ms("train_epoch")
        rec = {
            "card": card, "epochs": FULL_EPOCHS, "batch": int(config["data"]["batch_size"]),
            "z_dim": int(config["model"]["z_dim"]), "channels": config["model"]["channel"],
            "steps_per_epoch": trainer.steps_per_epoch, "fit_s": fit_s,
            "train_epoch_ms": epoch_ms, "step_ms": epoch_ms / trainer.steps_per_epoch,
            "val_epoch_ms": timer.mean_ms("val_epoch"), "val_epochs": len(timer.times["val_epoch"]),
            "mi_refresh_ms": timer.mean_ms("mi_refresh"),
            "decodability_ms": timer.mean_ms("decodability"),
            "peak_mem_gib": peak_gib, "kernel_launches": launches, "launches_per_step": launches / steps,
            "inner_launches_per_step": n_iter * len(adv.opt_state.table.batches),
            "lambda_qda_ids_first_last": [lam[0], lam[-1]],
            "first_total_train": float(rows[0]["total_train"]), "last_total_train": float(rows[-1]["total_train"]),
        }
        timer.undo()
        inner = inner_adamw_check(adv)

        # epoch 21 of the run itself, then a resume from epoch 20, both with
        # deterministic algorithms
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
        try:
            trainer.start_epoch = FULL_EPOCHS
            trainer.fit(FULL_EPOCHS + 1)
            at21 = _full_state(trainer)
            del trainer
            resume_cfg = _full_config(
                tmp / "resume", num_epochs=FULL_EPOCHS + 1,
                model={"load_model": str(run), "start_epoch": FULL_EPOCHS},
            )
            model, info = build()
            resumed = trainer_mod.Trainer(resume_cfg, datasets, model, info, device=DEVICE)
            bad = _same_full_state(_full_state(resumed), at20)
            if bad:
                raise AssertionError(f"full: the state restored at epoch {FULL_EPOCHS} differs in {bad}")
            resumed.fit()
            bad = _same_full_state(_full_state(resumed), at21)
            if bad:
                raise AssertionError(f"full: epoch {FULL_EPOCHS + 1} after the resume differs in {bad}")
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False

        rec.update(resume_bitwise_equal=True, card_vs_cpu=parity_rec, inner_adamw=inner)
        log("full scrubber stack train entry point: " + json.dumps(rec))
        return rec
    finally:
        timer.undo()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: the port's bench entry
# ---------------------------------------------------------------------------


def bench_phase() -> dict:
    """``scrubvae_torch.bench.run`` at its defaults (the flagship, batch 512,
    bf16 storage, 5 warm-up and 100 timed steps, one more step under the
    FLOP counter); its JSON line, printed as ``python -m
    scrubvae_torch.bench`` prints it. Requires a finite total, 2 optimizer
    launches a step and 0 < mfu <= 1."""
    from scrubvae_torch import bench
    from scrubvae_torch.ops import fused_adamw as fa

    args = bench.parse_args([])
    fa.fused_adamw_multi.launches = 0
    fa.fused_adamw_leaf.launches = 0
    out = bench.run(args)
    launches = fa.fused_adamw_multi.launches + fa.fused_adamw_leaf.launches
    log(json.dumps(out))
    steps = args.warmup + args.steps + 1
    if launches != 2 * steps:
        raise AssertionError(f"bench: {launches} optimizer launches in {steps} steps; expected 2 a step")
    if not 0.0 < out.get("mfu", 0.0) <= 1.0:
        raise AssertionError(f"bench: mfu {out.get('mfu')} outside (0, 1]")
    return {**out, "optimizer_launches": launches, "launches_per_step": launches / steps}


# ---------------------------------------------------------------------------
# phase 10: x360 windows, the encoder view, configs/sane and configs/sweep
# ---------------------------------------------------------------------------

# the structured stream at the size tools/run_ladder.py gives these configs:
# (seed, frames) per split, 4 ids
X360_SPLITS = {"train": (0, 24000), "val": (1, 8000)}
X360_RUNS = ("sweep/8_structural", "sane/4_full")
# 2 epochs: validation runs at epochs divisible by 5, so the runs start at
# epoch 3 (model.start_epoch, nothing loaded) and validate at 5
X360_START, X360_EPOCHS = 3, 5
ENC_KEYS = ("x6d_enc", "root_enc")
ARENA_KEYS = ("root", "root_enc", "raw_pose")


def _structured(split: str):
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import structured_pose_stream

    seed, frames = X360_SPLITS[split]
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    return (skel, *structured_pose_stream(skel, n_frames=frames, n_ids=4, seed=seed))


def x360_windows_card_vs_cpu() -> dict:
    """``materialize`` of every key the port assembles (``raw_pose``,
    ``x6d_enc``, ``root_enc`` included) over the x360 windows of the
    structured val split, on the card against the CPU: atol 1e-5 (plus
    2e-6 of the vector's length for the keys in arena units), and for the
    keys built from IK (x6d, target_pose, x6d_enc) 1e-5 plus twice the
    CPU's own distance from float64, as the CPU tests hold the port to
    JAX. Then the window
    assembly of one batch of 64 with and without the view (the IK it runs
    again), timed on the card."""
    import dataclasses

    from scrubvae_torch import bench
    from scrubvae_torch.data.pipeline import SUPPORTED_KEYS, assemble_windows, build_frame_store, materialize
    from scrubvae_torch.ops import kinematics as kin
    from scrubvae_torch.ops import quaternion as qtn

    skel, pose, ids = _structured("val")
    stores = {d: build_frame_store(pose, ids, skel, window=51, stride=2, device=d) for d in (DEVICE, "cpu")}
    got = {d: materialize(st, skel.tree, SUPPORTED_KEYS, "x360") for d, st in stores.items()}
    cpu = stores["cpu"]
    p64 = cpu.pose.double()
    x6d64 = qtn.quaternion_to_cont6d(kin.inv_kin(p64, skel.tree, forward_indices=[1, 0]))
    tpose64 = kin.fwd_kin_cont6d(x6d64, skel.tree, cpu.offsets.double(), p64.new_zeros(len(p64), 3), eps=1e-8)
    s64 = dataclasses.replace(cpu, pose=p64, yaw=kin.frame_yaw(p64, 0, 1))
    enc64 = assemble_windows(s64, skel.tree, cpu.starts, ("x6d_enc",), "x360")["x6d_enc"]
    noise = {
        "x6d": float((cpu.x6d.double() - x6d64).abs().max()),
        "target_pose": float((cpu.tpose.double() - tpose64).abs().max()),
        "x6d_enc": float(np.abs(got["cpu"]["x6d_enc"] - enc64.numpy()).max()),
    }
    rec = {"windows": cpu.n_windows, "cpu_f64_distance": noise, "max_abs_diff": {}}
    bad = []
    for k in SUPPORTED_KEYS:
        a, b = got[DEVICE][k], got["cpu"][k]
        diff = np.abs(a.astype(np.float64) - b)
        rec["max_abs_diff"][k] = float(diff.max())
        # a rotation's rounding moves a vector's every entry by its length
        length = np.linalg.norm(b, axis=-1, keepdims=True) if k in ARENA_KEYS else 0.0
        tol = 1e-5 + 2 * noise.get(k, 0.0) + 2e-6 * length
        if a.shape != b.shape or a.dtype != b.dtype or not (diff <= tol).all():
            bad.append(k)
    if bad:
        raise AssertionError(f"x360: card and CPU windows differ in {bad}: {json.dumps(rec)}")
    rows = torch.randperm(cpu.n_windows, generator=torch.Generator().manual_seed(0))[:64]
    idx = stores[DEVICE].starts[rows.to(DEVICE)]
    for label, keys in (("assemble_ms_batch64_with_view", bench.KEYS + ENC_KEYS), ("assemble_ms_batch64_without_view", bench.KEYS)):
        rec[label] = cuda_ms(lambda: assemble_windows(stores[DEVICE], skel.tree, idx, keys, "x360"))
    log("x360 windows, card against CPU: " + json.dumps(rec))
    return rec


def _shipped_run(name: str, arrays: dict, card: str) -> dict:
    """``configs/{name}.yaml`` (its widths, batch and precision) through
    ``params.read.config``, ``factory.data_and_model`` and ``train(config,
    datasets, model, info)`` for 2 epochs on ``arrays``, validating with
    decodability at the second (see ``X360_START``). The card's machine
    has no ``h5py``: the split's pose file is an empty placeholder and
    ``factory.read_pose_h5`` serves its arrays from memory."""
    import csv

    from scrubvae_torch import factory
    from scrubvae_torch.ops import fused_adamw as fa
    from scrubvae_torch.train import trainer as trainer_mod

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_x360_"))
    timer = _Timer()
    read_pose_h5 = factory.read_pose_h5
    try:
        data = tmp / "data"
        for split in arrays:
            (data / "synthetic" / split).mkdir(parents=True)
            (data / "synthetic" / split / "pose.h5").touch()
        shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
        run = tmp / "run"
        config = _shipped_config(
            run, name, model={"start_epoch": X360_START}, data={"data_path": str(data) + "/"},
            num_epochs=X360_EPOCHS, eval_start_epoch=X360_EPOCHS,
        )
        factory.read_pose_h5 = lambda path: arrays[pathlib.Path(path).parent.name]
        datasets, model, info = factory.data_and_model(
            config,
            data_keys=tuple(["x6d", "root", "offsets", "target_pose"] + list(config["disentangle"]["features"] or [])),
            device=DEVICE,
        )
        factory.read_pose_h5 = read_pose_h5
        for owner, fn, label in (
            (trainer_mod.Trainer, "train_epoch", "train_epoch"),
            (trainer_mod.Trainer, "test_epoch", "val_epoch"),
            (trainer_mod.Trainer, "decodability_metrics", "decodability"),
        ):
            timer.wrap(owner, fn, label)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.fused_adamw_multi.launches = 0
        fa.fused_adamw_leaf.launches = 0
        t0 = time.perf_counter()
        trainer = trainer_mod.train(config, datasets, model, info, device=DEVICE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = fa.fused_adamw_multi.launches + fa.fused_adamw_leaf.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        epochs = X360_EPOCHS - X360_START
        steps = trainer.steps_per_epoch * epochs
        n_iter = int(config["disentangle"].get("n_iter") or 5)
        inner = sum(n_iter * len(a.opt_state.table.batches) for a in trainer.state.adv_states.values())
        per_step = len(trainer.state.opt_state.table.batches) + inner
        if launches != per_step * steps:
            raise AssertionError(f"{name}: {launches} optimizer launches in {steps} steps; expected {per_step} a step")
        # the kernel over this run's own leaf tables (the outer one and each
        # discriminator's), bitwise against its plain version
        checks = [leaf_set_check(trainer, *_outer_hyper(), label=name)] + [
            inner_adamw_check(a, label=f"{name} discriminator {k}") for k, a in trainer.state.adv_states.items()
        ]
        view = all(set(ENC_KEYS) <= set(ds.data_keys) for ds in datasets.values())
        with open(run / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        if [int(r["epoch"]) for r in rows] != list(range(X360_START + 1, X360_EPOCHS + 1)):
            raise AssertionError(f"{name}: metrics.csv epochs {[r['epoch'] for r in rows]}")
        last = rows[-1]
        tests = [k for k in last if k.endswith("_test")]
        bad = [
            (r["epoch"], k, r[k]) for r in rows for k in r
            if k.endswith("_train") and not math.isfinite(float(r[k]))
        ]
        bad += [(k, last.get(k)) for k in tests + list(DECOD_COLUMNS) if not (last.get(k) and math.isfinite(float(last[k])))]
        bad += [k for k in last if k.endswith("_nanfolds")]
        if bad or not tests:
            raise AssertionError(f"{name}: metrics.csv columns not finite or missing: {bad}")
        epoch_ms = timer.mean_ms("train_epoch")
        rec = {
            "config": name, "card": card, "epochs": epochs, "train_windows": len(datasets["train"]),
            "val_windows": len(datasets["val"]), "batch": trainer.batch_size,
            "channels": config["model"]["channel"], "z_dim": int(config["model"]["z_dim"]),
            "precision": config["train"]["precision"], "encoder_view": view,
            "direction_process": datasets["train"].direction_process, "model": config["model"]["type"],
            "steps_per_epoch": trainer.steps_per_epoch, "fit_s": fit_s,
            "train_epoch_ms": epoch_ms, "step_ms": epoch_ms / trainer.steps_per_epoch,
            "val_epoch_ms": timer.mean_ms("val_epoch"), "decodability_ms": timer.mean_ms("decodability"),
            "peak_mem_gib": peak_gib, "optimizer_launches": launches, "launches_per_step": launches / steps,
            "inner_launches_per_step": inner,
            "leaf_sets": [{k: c[k] for k in LEAF_SET_KEYS if k in c} for c in checks],
            "kernel_max_abs_err": max(c["max_abs_err"] for c in checks),
            "total_train": [float(r["total_train"]) for r in rows],
            "validation": {k: float(last[k]) for k in tests},
            "decodability": {k: float(last[k]) for k in DECOD_COLUMNS},
        }
        log(f"{name} train entry point: " + json.dumps(rec))
        return rec
    finally:
        factory.read_pose_h5 = read_pose_h5
        timer.undo()
        shutil.rmtree(tmp, ignore_errors=True)


def x360_phase(card: str) -> dict:
    """The x360 windows and the encoder view card against CPU, steps 1 and
    2 of configs/sane/4_full.yaml card against CPU, then 8_structural and
    4_full through the training entry point (see the module docstring)."""
    windows = x360_windows_card_vs_cpu()
    step = full_parity("sane/4_full", z_dim=32)
    arrays = {split: _structured(split)[1:] for split in X360_SPLITS}
    runs = {}
    for name in X360_RUNS:
        runs[name] = rec = _shipped_run(name, arrays, card)
        if rec["encoder_view"] != (name == "sweep/8_structural") or rec["direction_process"] != "x360":
            raise AssertionError(f"{name}: direction process {rec['direction_process']}, view {rec['encoder_view']}")
        torch.cuda.empty_cache()
    return {"windows": windows, "card_vs_cpu": step, "runs": runs}


# ---------------------------------------------------------------------------
# phase 11: the mlp and transformer model families and the scrubber branches
# ---------------------------------------------------------------------------

MLP_CONFIG = "ladder/1_vanilla_mlp"
TRANSFORMER = {"type": "transformer", "z_dim": 128, "window": 51, "diag": False}
# the transformer and branches runs train epochs 16 to 20 (model.start_epoch
# 15, nothing loaded): validation, decodability and the full state at 20
MODELS_START, MODELS_EPOCHS = 15, 20
# every branch this phase adds: MALS at polynomial 2, direct least squares
# with its bias column (a negative weight), gradient reversal on the ids
# under gr_legacy_norm and the moving-average class means of the ids
BRANCHES_METHODS = {
    "conditional": ["avg_speed_3d", "heading"],
    "moving_avg_lsq": ["avg_speed_3d"],
    "direct_lsq": ["heading"],
    "grad_reversal": ["ids"],
    "moving_avg": ["ids"],
}
BRANCHES_LOSS = {
    "rotation": 1.0, "prior": 0.001, "root": 0.01, "jpe": 1.0,
    "avg_speed_3d_mals": 0.1, "heading_lsq": -0.1, "ids_gr": 1.0, "ids_ma": 0.1,
}
# card against CPU: z 16, window 51, f32, no clip; batch 16, and 32 for the
# branches, whose least-squares system of 16 latents and the bias column
# needs more rows than columns
MODELS_PARITY_Z = 16
# the residual and positional dropout masks keep 0.9 of the entries within
# this over the flagship batch
KEPT_SHARE_TOL = 5e-3


def _models_config(out: pathlib.Path, batch: int, z_dim: int, ch, bf16_params: bool, model: dict = None,
                   branches: bool = False, precision: str = "bf16", **train) -> dict:
    """The flagship's config (``bench.bench_config``) with ``model`` and
    ``train`` entries overridden, and with the branches' method map and
    losses when ``branches``; writes to ``out``."""
    from scrubvae_torch import bench

    cfg = bench.bench_config(batch, 51, z_dim, ch, bf16_params, precision=precision)
    cfg["model"].update(model or {})
    cfg["train"].update(train)
    if branches:
        cfg["disentangle"].update(method=BRANCHES_METHODS, polynomial=2, gr_legacy_norm=True)
        cfg["loss"] = dict(BRANCHES_LOSS)
    cfg["out_path"] = str(out)
    return cfg


def _no_dropout(model) -> None:
    from scrubvae_torch.models import transformer as tr

    for m in model.modules():
        if isinstance(m, tr._Dropping):
            m.dropout = 0.0


def _models_parity_run(device: str, config: dict, rows: np.ndarray, eps: list) -> dict:
    """Two steps of ``config`` on ``device`` from the seed's weights (drawn
    on the CPU) with the given rows and noise, dropout off; the initial
    weights, step 1's gradients, weights and streaming states and both
    steps' losses, on the CPU; on the CPU also step 1's gradients in
    float64 (``parity.grads_float64``)."""
    from scrubvae_torch import bench, factory
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream
    from scrubvae_torch.train import parity
    from scrubvae_torch.train.trainer import Trainer

    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=4096, n_ids=4, seed=0)
    ds = StreamDataset(
        build_frame_store(pose, ids, skel, window=51, stride=2, device=device), skel, bench.KEYS, "midfwd",
        arena_size=bench.ARENA, discrete_classes={"ids": np.unique(ids)}, device=device,
    )
    model, info = factory.build_model(
        config["model"], config["disentangle"], 18, "midfwd", arena_size=bench.ARENA,
        discrete_classes=ds.discrete_classes, loss_keys=config["loss"].keys(), device=device,
    )
    _no_dropout(model)
    trainer = Trainer(config, {"train": ds}, model, info, device=device)
    names = [n for n, _ in trainer.model.named_parameters()]
    keys = {"moving_avg_lsq": parity.MALS_KEYS, "moving_avg": parity.MA_KEYS}

    def cpu(t):
        return t.detach().to("cpu", copy=True)

    out = {"losses": [], "w0": {n: cpu(p) for n, p in trainer.model.named_parameters()}}
    if device == "cpu":
        out["grads64"] = parity.grads_float64(trainer, torch.as_tensor(rows[0] % len(ds)), torch.from_numpy(eps[0]))
    for s in range(2):
        trainer.state, metrics = trainer.train_step(
            trainer.state, torch.as_tensor(rows[s] % len(ds), device=device), trainer.loss_scale_for_epoch(1),
            eps=torch.from_numpy(eps[s]).to(device),
        )
        out["losses"].append({k: float(v) for k, v in metrics.items()})
        if s == 0:
            st = trainer.state
            out["grads"] = {n: cpu(m) / (1.0 - trainer.tx.b1) for n, m in zip(names, st.opt_state.mu)}
            out["w1"] = {n: cpu(p) for n, p in trainer.model.named_parameters()}
            out["states"] = {
                (method, feat): {k: cpu(getattr(state, k)) for k in keys[method]}
                for method in keys for feat, state in st.scrub_state.get(method, {}).items()
            }
    return out


def models_parity(label: str, model: dict, batch: int, branches: bool = False) -> dict:
    """Steps 1 and 2 on the card against the CPU at z 16, window 51, f32,
    without clip, with injected noise and dropout off on both sides: step 1
    held to ``scrubvae_torch.train.parity`` (losses 1e-4, gradients, weights
    to four ulps as the full stack's step, given both runs' gradients for
    the elements near Adam's eps and the CPU's float64 gradient as the
    witness of where the CPU's own f32 gradient has an unsure sign, the MALS and
    moving-average states 1e-4), step 2's losses at rtol 1e-2. The card
    runs with deterministic algorithms."""
    from scrubvae_torch import bench
    from scrubvae_torch.train import parity

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_models_parity_"))
    try:
        config = _models_config(
            tmp, batch, MODELS_PARITY_Z, bench.SMALL_CH, False, model=model, branches=branches, precision="fp32",
            moment_dtype="f32",
        )
        rng = np.random.default_rng(7)
        rows = rng.integers(0, 1 << 20, (2, batch))
        eps = [rng.standard_normal((batch, MODELS_PARITY_Z)).astype(np.float32) for _ in range(2)]
        cpu = _models_parity_run("cpu", config, rows, eps)
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True)
        try:
            card = _models_parity_run(DEVICE, config, rows, eps)
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def states(tol):
        worst = 0.0
        for (method, feat), want in cpu["states"].items():
            check = parity.check_mals if method == "moving_avg_lsq" else parity.check_ma
            worst = max(worst, check(want, card["states"][(method, feat)], tol))
        return worst

    checks = {
        "max_loss_rel_step1": lambda: parity.check_losses(cpu["losses"][0], card["losses"][0], 1e-4),
        "grads": lambda: parity.check_grads(cpu["grads"], card["grads"]),
        "weights": lambda: parity.check_weights(
            cpu["w1"], card["w1"], cpu["grads"], ulps=4, got_grads=card["grads"], unsure=unsure,
        ),
        "max_state_rel": lambda: states(1e-4),
        "max_loss_rel_step2": lambda: parity.check_losses(cpu["losses"][1], card["losses"][1], 1e-2),
    }
    unsure = parity.sign_unsure(cpu["grads"], cpu["grads64"])
    rec = {
        "run": label, "batch": batch, "z_dim": MODELS_PARITY_Z, "states": sorted(f"{m}/{f}" for m, f in cpu["states"]),
        "sign_unsure_elements": int(sum(int(m.sum()) for m in unsure.values())),
    }
    failed = {}
    for name, check in checks.items():
        # every check runs, so one call shows all that differs
        try:
            got = check()
        except AssertionError as e:
            failed[name] = str(e)
            continue
        rec.update(got if isinstance(got, dict) else {name: got})
    if failed:
        raise AssertionError(f"models {label}: card against CPU: {json.dumps(failed)}; readings {json.dumps(rec)}")
    rec["planted_sign_error_caught"] = planted_sign_error(cpu, card, unsure)
    log(f"models {label} card against CPU, steps 1 and 2: " + json.dumps(rec))
    return rec


def planted_sign_error(cpu: dict, card: dict, unsure: dict) -> str:
    """The card's step-1 update of its largest leaf with the sign reversed
    in the noise band of the CPU's gradient, where each element alone is
    excused: the weights' check of ``models_parity`` must raise on the
    flips' count. Returns the leaf."""
    from scrubvae_torch.train import parity

    n = max(cpu["w1"], key=lambda k: cpu["w1"][k].numel())
    g = cpu["grads"][n]
    band = g.abs() < 5e-2 * torch.sqrt(torch.mean(g * g))
    faulty = dict(card["w1"])
    faulty[n] = torch.where(band, 2 * card["w0"][n] - card["w1"][n], card["w1"][n])
    try:
        parity.check_weights(cpu["w1"], faulty, cpu["grads"], ulps=4, got_grads=card["grads"], unsure=unsure)
    except AssertionError as e:
        if "weights differ after step 1" in str(e):
            return n
        raise
    raise AssertionError(f"a sign error in the noise band of {n} ({int(band.sum())} elements) passed the weights' check")


def dropout_statistics(trainer, batch: dict) -> dict:
    """The transformer's dropout at its 0.1 rate on one flagship batch, in
    training mode with a generator of its own: every residual and
    positional mask keeps 0.9 of the nonzero entries within
    ``KEPT_SHARE_TOL`` and scales the kept ones by 1/0.9 (bitwise as the
    division on the card computes it); every attention mask is one (q, kv)
    mask for the whole batch and every head, scaling by 1/0.9 within one
    f32 ulp. Then neither an eval-mode forward (twice, bitwise equal) nor
    the eval step draws a mask."""
    from scrubvae_torch.models import transformer as tr

    calls = {"dropout": [], "attention": []}
    saved = (tr.dropout, tr.attention_dropout)

    def residual(x, rate, generator):
        out = saved[0](x, rate, generator)
        nonzero, kept = x != 0, out != 0
        calls["dropout"].append({
            "shape": list(x.shape), "rate": rate, "kept_share": float(kept[nonzero].float().mean()),
            "scaled": bool(torch.equal(out[kept], (x / (1.0 - rate))[kept])),
        })
        return out

    def attention(w, rate, generator):
        out = saved[1](w, rate, generator)
        kept = out != 0
        scale = (out[kept] - w[kept] / (1.0 - rate)).abs() / (w[kept] / (1.0 - rate)).abs()
        calls["attention"].append({
            "shape": list(w.shape), "rate": rate, "kept_share": float(kept[:1, :1].float().mean()),
            "shared": bool(torch.equal(kept, kept[:1, :1].expand_as(kept))),
            "max_scale_rel": float(scale.max()),
        })
        return out

    model = trainer.model
    B = batch["x6d"].shape[0]
    try:
        tr.dropout, tr.attention_dropout = residual, attention
        model.train()
        with torch.no_grad():
            model(batch, eps=torch.zeros(B, model.vae.z_dim, device=DEVICE),
                  generator=torch.Generator(device=DEVICE).manual_seed(0))
        train_calls = {k: list(v) for k, v in calls.items()}
        calls["dropout"].clear()
        calls["attention"].clear()
        model.eval()
        with torch.no_grad():
            e1, e2 = (model(batch)["x6d"] for _ in range(2))
        idx = torch.arange(B, device=DEVICE)
        trainer.eval_step(trainer.state, idx, trainer.loss_scale_for_epoch(MODELS_EPOCHS), data=batch,
                          generator=torch.Generator(device=DEVICE).manual_seed(1))
    finally:
        tr.dropout, tr.attention_dropout = saved
    n_layers = len(model.vae.encoder.transformer_encoder.layers)
    want = (2 + 2 * n_layers + 3 * n_layers, 3 * n_layers)
    shares = [c["kept_share"] for c in train_calls["dropout"]]
    rec = {
        "residual_positional_masks": len(train_calls["dropout"]), "attention_masks": len(train_calls["attention"]),
        "kept_share_min": min(shares), "kept_share_max": max(shares),
        "attention_kept_share": [c["kept_share"] for c in train_calls["attention"]],
        "attention_max_scale_rel": max(c["max_scale_rel"] for c in train_calls["attention"]),
        "eval_masks": len(calls["dropout"]) + len(calls["attention"]), "eval_bitwise_repeat": bool(torch.equal(e1, e2)),
    }
    bad = []
    if (rec["residual_positional_masks"], rec["attention_masks"]) != want:
        bad.append(f"{want} masks expected")
    bad += [c for c in train_calls["dropout"] if c["rate"] != 0.1 or not c["scaled"] or abs(c["kept_share"] - 0.9) > KEPT_SHARE_TOL]
    bad += [c for c in train_calls["attention"] if c["rate"] != 0.1 or not c["shared"] or c["max_scale_rel"] > 1.2e-7]
    if rec["eval_masks"] or not rec["eval_bitwise_repeat"]:
        bad.append("dropout in eval mode")
    if bad:
        raise AssertionError(f"models transformer dropout: {bad}; readings {json.dumps(rec)}")
    log("models transformer dropout at 0.1: " + json.dumps(rec))
    return rec


def _models_run(label: str, config: dict, datasets: dict, card: str, transformer: bool = False) -> dict:
    """``config`` through ``params.read.config`` and ``train(config,
    datasets, model, info)`` on the fit phase's splits for epochs 16 to 20
    (validation, decodability and the full state at 20): every loss column
    finite at every epoch, the validation losses and decodability finite at
    20, the optimizer's launches a step equal to its table's dtype
    variants (2), and its leaf table bitwise against the plain version
    (``leaf_set_check``). For the ``transformer``, the dropout statistics on
    one flagship batch (``dropout_statistics``), then the run's own epoch 21
    against a resume from epoch 20 with deterministic algorithms: the
    restored state and the epoch-21 state bit for bit, the dropout
    generator's included."""
    import csv

    import yaml

    from scrubvae_torch import bench, factory
    from scrubvae_torch.ops import fused_adamw as fa
    from scrubvae_torch.params import read
    from scrubvae_torch.train import trainer as trainer_mod

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_models_"))
    timer = _Timer()
    try:
        def read_config(run, **model):
            cfg = dict(config, out_path="current")
            cfg["model"] = dict(config["model"], **model)
            run.mkdir(parents=True)
            (run / "model_config.yaml").write_text(yaml.safe_dump(cfg))
            return read.config(run / "model_config.yaml")

        run = tmp / "run"
        cfg = read_config(run, start_epoch=MODELS_START)

        def build():
            return factory.build_model(
                cfg["model"], cfg["disentangle"], n_keypts=18, direction_process="midfwd",
                arena_size=bench.ARENA, discrete_classes=datasets["train"].discrete_classes,
                loss_keys=cfg["loss"].keys(), device=DEVICE,
            )

        model, info = build()
        for owner, name, tag in (
            (trainer_mod.Trainer, "train_epoch", "train_epoch"),
            (trainer_mod.Trainer, "test_epoch", "val_epoch"),
            (trainer_mod.Trainer, "decodability_metrics", "decodability"),
        ):
            timer.wrap(owner, name, tag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.fused_adamw_multi.launches = 0
        fa.fused_adamw_leaf.launches = 0
        t0 = time.perf_counter()
        trainer = trainer_mod.train(cfg, datasets, model, info, device=DEVICE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = fa.fused_adamw_multi.launches + fa.fused_adamw_leaf.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        timer.undo()
        at20 = _trainer_state(trainer) if transformer else None

        epochs = MODELS_EPOCHS - MODELS_START
        steps = trainer.steps_per_epoch * epochs
        per_step = len(trainer.state.opt_state.table.batches)
        if per_step != 2 or launches != per_step * steps:
            raise AssertionError(f"models {label}: {launches} optimizer launches in {steps} steps; expected 2 a step")
        check = leaf_set_check(trainer, *_outer_hyper(), label=f"models {label}")
        with open(run / "metrics.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        if [int(r["epoch"]) for r in rows] != list(range(MODELS_START + 1, MODELS_EPOCHS + 1)):
            raise AssertionError(f"models {label}: metrics.csv epochs {[r['epoch'] for r in rows]}")
        last = rows[-1]
        loss_cols = [f"{k}_train" for k in cfg["loss"]] + ["total_train"]
        tests = [k for k in last if k.endswith("_test")]
        bad = [(r["epoch"], k, r.get(k)) for r in rows for k in loss_cols if not (r.get(k) and math.isfinite(float(r[k])))]
        bad += [(k, last.get(k)) for k in tests + list(DECOD_COLUMNS) if not (last.get(k) and math.isfinite(float(last[k])))]
        bad += [k for k in last if k.endswith("_nanfolds")]
        if bad or not tests:
            raise AssertionError(f"models {label}: metrics.csv columns not finite or missing: {bad}")
        if sorted(p.name for p in (run / "checkpoints").iterdir()) != ["epoch_20.pt"]:
            raise AssertionError(f"models {label}: the full state at epoch 20 expected")
        epoch_ms = timer.mean_ms("train_epoch")
        rec = {
            "run": label, "card": card, "model": cfg["model"]["type"], "epochs": epochs,
            "train_windows": len(datasets["train"]), "val_windows": len(datasets["val"]), "batch": trainer.batch_size,
            "z_dim": int(cfg["model"]["z_dim"]), "param_dtype": cfg["train"]["param_dtype"],
            "methods": sorted(cfg["disentangle"]["method"]), "steps_per_epoch": trainer.steps_per_epoch,
            "fit_s": fit_s, "train_epoch_ms": epoch_ms, "step_ms": epoch_ms / trainer.steps_per_epoch,
            "val_epoch_ms": timer.mean_ms("val_epoch"), "decodability_ms": timer.mean_ms("decodability"),
            "peak_mem_gib": peak_gib, "optimizer_launches": launches, "launches_per_step": launches / steps,
            "leaf_set": {k: check[k] for k in LEAF_SET_KEYS},
            "kernel_max_abs_err": check["max_abs_err"],
            "loss_train": {k: [float(r[k]) for r in rows] for k in loss_cols},
            "validation": {k: float(last[k]) for k in tests},
            "decodability": {k: float(last[k]) for k in DECOD_COLUMNS},
        }
        if transformer:
            rec["dropout"] = dropout_statistics(trainer, datasets["train"].batch(torch.arange(512, device=DEVICE)))
            torch.backends.cudnn.deterministic = True
            torch.use_deterministic_algorithms(True)
            try:
                trainer.start_epoch = MODELS_EPOCHS
                trainer.fit(MODELS_EPOCHS + 1)
                at21 = _trainer_state(trainer)
                del trainer
                resume_cfg = read_config(tmp / "resume", load_model=str(run), start_epoch=MODELS_EPOCHS)
                resume_cfg["train"]["num_epochs"] = MODELS_EPOCHS + 1
                model, info = build()
                resumed = trainer_mod.Trainer(resume_cfg, datasets, model, info, device=DEVICE)
                bad = _same_state(_trainer_state(resumed), at20)
                if bad:
                    raise AssertionError(f"models {label}: the state restored at epoch {MODELS_EPOCHS} differs in {bad}")
                resumed.fit()
                bad = _same_state(_trainer_state(resumed), at21)
                if bad:
                    raise AssertionError(f"models {label}: epoch {MODELS_EPOCHS + 1} after the resume differs in {bad}")
            finally:
                torch.use_deterministic_algorithms(False)
                torch.backends.cudnn.deterministic = False
            rec["resume_bitwise_equal"] = True
        log(f"models {label} train entry point: " + json.dumps(rec))
        return rec
    finally:
        timer.undo()
        shutil.rmtree(tmp, ignore_errors=True)


def models_phase(card: str) -> dict:
    """The mlp and transformer model families and the scrubber branches
    (see the module docstring)."""
    from scrubvae_torch import bench

    arrays = {split: _structured(split)[1:] for split in X360_SPLITS}
    runs = {"mlp": _shipped_run(MLP_CONFIG, arrays, card)}
    if runs["mlp"]["model"] != "mlp" or runs["mlp"]["launches_per_step"] != 2:
        raise AssertionError(f"models mlp: {runs['mlp']['model']} model, {runs['mlp']['launches_per_step']} launches a step")
    torch.cuda.empty_cache()
    parity_recs = {
        "transformer": models_parity("transformer", {"type": "transformer"}, 16),
        "branches": models_parity("branches", {}, 32, branches=True),
    }
    datasets = _fit_splits()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_models_cfg_"))
    try:
        configs = {
            "transformer": _models_config(
                tmp, 512, 128, bench.FULL_CH, True, model=dict(TRANSFORMER), num_epochs=MODELS_EPOCHS,
                eval_start_epoch=0, minimal_test=None,
            ),
            "branches": _models_config(
                tmp, 512, 128, bench.FULL_CH, True, branches=True, num_epochs=MODELS_EPOCHS,
                eval_start_epoch=0, minimal_test=None,
            ),
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    runs["transformer"] = _models_run("transformer", configs["transformer"], datasets, card, transformer=True)
    torch.cuda.empty_cache()
    runs["branches"] = _models_run("branches", configs["branches"], datasets, card)
    torch.cuda.empty_cache()
    return {"runs": runs, "card_vs_cpu": parity_recs}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def kernels_line(kernel: dict, path: dict, fit: dict, full: dict, bench: dict, x360: dict, models: dict) -> dict:
    """One record per kernel of the main path: its launches on the path run
    and, at the fc_sigma shape, its time beside the plain version's, the
    bound and the library call's, for the f32 variant (where
    ``torch._fused_adamw_`` computes the same function) and for every
    variant; the Philox against the injected-noise time of the bf16
    variant; and the whole flagship pass (every leaf, one launch per
    variant) beside its bound and ``torch._fused_adamw_`` over f32 copies;
    and the full phase's launches, with the discriminator's inner pass (the
    f32 variant over its 22 leaves) beside its bound, the plain version's
    and ``torch._fused_adamw_``'s time; and the launches of the bench's run
    and of each x360 and models training run with its leaf tables'
    agreement with the plain version. ``max_abs_err`` is the largest of
    every check's."""
    errs = [kernel["max_abs_err"]]
    errs += [] if full is None else [full["inner_adamw"]["max_abs_err"]]
    errs += [] if x360 is None else [r["kernel_max_abs_err"] for r in x360["runs"].values()]
    errs += [] if models is None else [r["kernel_max_abs_err"] for r in models["runs"].values()]
    f32 = kernel["timings"]["w f32, m f32"]
    bf16 = kernel["timings"]["w bf16, m bf16"]
    leaf_set = kernel["leaf_set"]
    return {"kernels": [{
        "name": "fused_adamw",
        "route": "cuda",
        "source": "scrubvae_torch/csrc/fused_adamw.cu",
        "replaces": "scrubvae_tpu/ops/fused_adamw.py:77",
        "launches": path["kernel_launches"],
        "max_abs_err": max(errs),
        "ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
        "shape": list(KERNEL_SHAPES[0][1]),
        "variant": "w f32, m f32",
        "variants": {
            v: {k: t[k] for k in ("kernel_ms", "plain_ms", "bound_ms", "bytes")}
            for v, t in kernel["timings"].items()
        },
        "main_path_fc_sigma_variant": "w bf16, m bf16",
        "philox_ms": bf16["kernel_ms"],
        "inject_ms": bf16["inject_ms"],
        "inject_bound_ms": bf16["inject_bound_ms"],
        "pass_ms": leaf_set["pass_ms"],
        "pass_bound_ms": leaf_set["pass_bound_ms"],
        "pass_library_ms": leaf_set["pass_library_ms"],
        "pass_plain_ms": leaf_set["pass_plain_ms"],
        "pass_device_ms": leaf_set["pass_device_ms"],
        "launches_per_step": path["launches_per_step"],
        "fit_launches": None if fit is None else fit["optimizer_launches"],
        "fit_launches_per_step": None if fit is None else fit["launches_per_step"],
        "full_launches": None if full is None else full["kernel_launches"],
        "full_launches_per_step": None if full is None else full["launches_per_step"],
        "full_inner_launches_per_step": None if full is None else full["inner_launches_per_step"],
        "bench_launches": None if bench is None else bench["optimizer_launches"],
        "bench_launches_per_step": None if bench is None else bench["launches_per_step"],
        "x360_launches": None if x360 is None else {k: r["optimizer_launches"] for k, r in x360["runs"].items()},
        "x360_launches_per_step": None if x360 is None else {k: r["launches_per_step"] for k, r in x360["runs"].items()},
        "x360_max_abs_err": None if x360 is None else {k: r["kernel_max_abs_err"] for k, r in x360["runs"].items()},
        "models_launches": None if models is None else {k: r["optimizer_launches"] for k, r in models["runs"].items()},
        "models_launches_per_step": None if models is None else {k: r["launches_per_step"] for k, r in models["runs"].items()},
        "models_max_abs_err": None if models is None else {k: r["kernel_max_abs_err"] for k, r in models["runs"].items()},
        "inner_pass": None if full is None else {
            k: full["inner_adamw"][k]
            for k in (
                "leaves", "elements", "kernel_ms", "kernel_call_ms", "plain_ms", "plain_call_ms", "bound_ms",
                "bound_by", "library_ms", "library_call_ms", "max_abs_err",
            )
        },
    }]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--phases", default=",".join(PHASES),
        help="comma-separated phases out of %s (default: %s)"
        % (",".join(PHASES + ("profile",)), ",".join(PHASES)),
    )
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # cuBLAS is deterministic with this workspace setting; the parity phase
    # asks for deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from scrubvae_torch.ops import fused_adamw as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    log(smi[0] if smi else "nvidia-smi: no output")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = fa.build(force=True)
    log(f"build fused_adamw: {time.perf_counter() - t0:.2f} s -> {lib.relative_to(ROOT)}")
    log(lib.with_suffix(".ptxas.txt").read_text().strip())

    flagship = None
    if {"kernel", "path", "profile"} & set(phases):
        from scrubvae_torch import bench

        flagship = bench.build(512, 51, 128, bench.FULL_CH, DEVICE)
    kernel = kernel_phase(flagship[0]) if "kernel" in phases else None
    if "parity" in phases:
        parity_phase()
    path = None
    if "path" in phases or "profile" in phases:
        path, rows, loss_scale = path_phase(*flagship)
        if "profile" in phases:
            profile_phase(flagship[0], rows, loss_scale)
    flagship = None  # frees the path phase's trainer before the fit phase
    torch.cuda.empty_cache()
    fit = fit_phase(smi[0] if smi else "nvidia-smi: no output") if "fit" in phases else None
    torch.cuda.empty_cache()
    full = full_phase(smi[0] if smi else "nvidia-smi: no output") if "full" in phases else None
    torch.cuda.empty_cache()
    bench = bench_phase() if "bench" in phases else None
    torch.cuda.empty_cache()
    x360 = x360_phase(smi[0] if smi else "nvidia-smi: no output") if "x360" in phases else None
    torch.cuda.empty_cache()
    models = models_phase(smi[0] if smi else "nvidia-smi: no output") if "models" in phases else None
    if kernel is not None and path is not None:
        log(json.dumps(kernels_line(kernel, path, fit, full, bench, x360, models)))
    log(smi[0] if smi else "nvidia-smi: no output")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
