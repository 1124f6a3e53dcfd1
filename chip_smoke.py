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
   ``minimal_test``) is read by ``scrubvae_torch.params.read.config`` and
   trained by ``scrubvae_torch.train.trainer.train`` on synthetic splits
   built in memory (train: 4 ids, at least 3 steps an epoch at batch 512;
   val: one partial batch, so the eval tail runs). ``metrics.csv`` must
   hold 20 rows with a finite ``total_train``, the validation losses and
   finite generative-restrictiveness R^2 at epochs 5, 10, 15 and 20;
   weights at those epochs and the full state at 20; 2 optimizer launches
   a step over a table of all 130 leaves, epoch after epoch of GR re-init.
   Then a resume from epoch 20 (``model.load_model``, ``start_epoch``) must
   restore parameters, moments, step counts, MALS state and generator
   state bit for bit as the first run held them, and epoch 21 must train
   with finite losses. Prints the epoch, step, validation, save and
   restore times and the peak memory beside the card's name and power
   limit. The card's machine has no ``h5py``, so this phase builds its
   splits in memory; the route through pose files on disk and the
   ``python -m scrubvae_torch.train_model`` CLI is covered by the tests on
   the CPU (``tests/test_torch_port_checkpoint.py``,
   ``tests/test_torch_port_fit.py``).

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

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
ADAMW_FLOPS_PER_ELEM = 20
ROOT = pathlib.Path(__file__).resolve().parent
PHASES = ("kernel", "parity", "path", "fit")
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
    t = 3
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    scal = torch.tensor(
        [1e-3, 1.0 - 0.9**t, 1.0 - 0.999**t, 0.7], dtype=torch.float32, device="cuda"
    )
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


def leaf_set_check(trainer, scal, hyper, t) -> dict:
    """The flagship's whole leaf set (its parameters' shapes and dtypes,
    random values) in one multi-tensor call on the Philox path, bitwise
    against the plain version leaf by leaf; then the pass's device time
    beside its bound and ``torch._fused_adamw_`` over f32 copies of every
    leaf."""
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
        err = max(err, _assert_bits(f"leaf {i} {tuple(ws[i].shape)} of the flagship set", got, ref))
    del refs
    n = sum(table.numel)
    bytes_moved = sum(
        fa.leaf_bytes([w.shape], w.element_size(), m.element_size()) for w, m in zip(ws, mus)
    )
    rec = {
        "leaves": len(ws), "elements": n, "launches_per_call": len(table.batches),
        "bitwise_philox": True, "max_abs_err": err, "bytes": bytes_moved,
        "pass_ms": cuda_ms(lambda: fa.fused_adamw_multi(table, gs, scal, seed=seed, step=t, **hyper)),
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
    log("kernel fused_adamw flagship leaf set: " + json.dumps(rec))
    del f32, table, ws, gs, mus, nus
    torch.cuda.empty_cache()
    return {**rec, "max_abs_err": err}


# ---------------------------------------------------------------------------
# the bench configuration (bench.py build()), through the port's entry points
# ---------------------------------------------------------------------------

SMALL_CH = (8, 8, 16, 16, 32)
FULL_CH = (64, 128, 256, 512, 1024)
KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids")
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)



def bench_config(batch: int, z_dim: int, ch, bf16: bool) -> dict:
    return {
        "data": {
            "batch_size": batch, "dataset": "synthetic", "direction_process": "midfwd",
            "arena_size": ARENA.tolist(),
        },
        "disentangle": {
            "method": {
                "conditional": ["avg_speed_3d", "heading"],
                "linear": ["avg_speed_3d"],
                "moving_avg_lsq": ["avg_speed_3d"],
                "grad_reversal": ["avg_speed_3d"],
            },
            "features": ["avg_speed_3d", "heading"], "alpha": 1.0, "balance_loss": None,
            "bandwidth": 1.0, "polynomial": 1, "var_mode": "sphere", "l2_reg": 0.0, "n_iter": 2,
        },
        "model": {
            "type": "rcnn", "z_dim": z_dim, "window": 51, "diag": False, "channel": list(ch),
            "kernel": 5, "start_epoch": 0, "load_model": None, "prior": "gaussian",
            "activation": "prelu", "init_dilation": None, "sigma_head_rank": None,
            "precision": "bf16" if bf16 else "fp32",
        },
        "train": {
            "lr": 1e-4, "optimizer": "adamw", "lr_schedule": "cawr", "num_epochs": 1, "seed": 0,
            "mesh": None, "clip_norm": 0, "fused_optimizer": True,
            "param_dtype": "bf16" if bf16 else "f32", "minimal_test": True,
        },
        "loss": {
            "rotation": 1.0, "prior": 0.001, "root": 0.01, "jpe": 1.0,
            "avg_speed_3d_mals": 0.1, "avg_speed_3d_lin": 1.0, "avg_speed_3d_gr": 1.0,
        },
    }


def build_trainer(batch: int, z_dim: int, ch, bf16: bool, device: str):
    """Synthetic stream (max(16 batch, 4096) frames, 4 ids, seed 0), the
    on-device frame store and window dataset, the model and the trainer."""
    from scrubvae_torch import factory
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream
    from scrubvae_torch.train.trainer import Trainer

    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=max(batch * 16, 4096), n_ids=4, seed=0)
    store = build_frame_store(pose, ids, skel, window=51, stride=2, device=device)
    ds = StreamDataset(
        store, skel, KEYS, "midfwd", arena_size=ARENA,
        discrete_classes={"ids": np.unique(ids)}, device=device,
    )
    cfg = bench_config(batch, z_dim, ch, bf16)
    model, info = factory.build_model(
        cfg["model"], cfg["disentangle"], n_keypts=18, direction_process="midfwd",
        arena_size=ARENA, discrete_classes=ds.discrete_classes, loss_keys=cfg["loss"].keys(),
        device=device,
    )
    return Trainer(cfg, {"train": ds}, model, info, device=device), ds


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

    cpu_trainer, ds = build_trainer(16, 16, SMALL_CH, False, "cpu")
    rows = np.random.default_rng(0).integers(0, len(ds), 16)
    eps = np.random.default_rng(1).standard_normal((16, 16)).astype(np.float32)
    cpu = _one_step(cpu_trainer, "cpu", rows, eps)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        gpu, again = [
            _one_step(build_trainer(16, 16, SMALL_CH, False, DEVICE)[0], DEVICE, rows, eps)
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
        "batch": batch, "channels": list(FULL_CH), "window": 51, "z_dim": 128,
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


def _fit_splits():
    """Synthetic train (4 ids x 1200 frames) and val (2 ids x 300 frames)
    splits, on the card."""
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream

    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    out = {}
    for label, seed, per_id, n_ids in (("train", 0, 1200, 4), ("val", 1, 300, 2)):
        pose, ids = synthetic_pose_stream(skel, n_frames=per_id * n_ids, n_ids=n_ids, seed=seed)
        store = build_frame_store(pose, ids, skel, window=51, stride=2, device=DEVICE)
        mid = store.ids[store.starts + 51 // 2].cpu().numpy()
        out[label] = StreamDataset(
            store, skel, KEYS, "midfwd", arena_size=ARENA, discrete_classes={"ids": np.unique(mid)},
            device=DEVICE, label=label,
        )
    return out


def _fit_config(run: pathlib.Path, model: dict = None, **train: dict) -> dict:
    """Write the flagship's config for ``train``, with ``model`` and
    ``train`` entries overridden, to ``run/model_config.yaml`` and read it
    back through the port's config reader."""
    import yaml

    from scrubvae_torch.params import read

    cfg = bench_config(512, 128, FULL_CH, True)
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
    return bad


class _Timer:
    """Wraps functions of a module or class so each call is timed on the
    host clock between two synchronizes; ``undo`` puts them back."""

    def __init__(self):
        self.times: dict = {}
        self._saved = []

    def wrap(self, owner, name: str, label: str) -> None:
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))

        def timed(*a, **k):
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


def fit_phase(card: str) -> dict:
    """``train(config, datasets, model, info)`` for 20 epochs at full
    flagship width, then a resume from epoch 20 for epoch 21 (see the
    module docstring)."""
    import csv

    from scrubvae_torch import factory
    from scrubvae_torch.ops import fused_adamw as fa
    from scrubvae_torch.train import trainer as trainer_mod
    from scrubvae_torch.utils import checkpoint as ckpt

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    timer = _Timer()
    try:
        datasets = _fit_splits()
        n_train, n_val = len(datasets["train"]), len(datasets["val"])
        if n_train // 512 < 3 or not 0 < n_val < 512:
            raise AssertionError(f"fit: {n_train} train and {n_val} val windows")
        run = tmp / "run"
        config = _fit_config(run)

        def build():
            return factory.build_model(
                config["model"], config["disentangle"], n_keypts=18, direction_process="midfwd",
                arena_size=ARENA, discrete_classes=datasets["train"].discrete_classes,
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
# main
# ---------------------------------------------------------------------------


def kernels_line(kernel: dict, path: dict, fit: dict) -> dict:
    """One record per kernel of the main path: its launches on the path run
    and, at the fc_sigma shape, its time beside the plain version's, the
    bound and the library call's, for the f32 variant (where
    ``torch._fused_adamw_`` computes the same function) and for every
    variant; the Philox against the injected-noise time of the bf16
    variant; and the whole flagship pass (every leaf, one launch per
    variant) beside its bound and ``torch._fused_adamw_`` over f32 copies."""
    f32 = kernel["timings"]["w f32, m f32"]
    bf16 = kernel["timings"]["w bf16, m bf16"]
    leaf_set = kernel["leaf_set"]
    return {"kernels": [{
        "name": "fused_adamw",
        "route": "cuda",
        "source": "scrubvae_torch/csrc/fused_adamw.cu",
        "replaces": "scrubvae_tpu/ops/fused_adamw.py:77",
        "launches": path["kernel_launches"],
        "max_abs_err": kernel["max_abs_err"],
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
        "launches_per_step": path["launches_per_step"],
        "fit_launches": None if fit is None else fit["optimizer_launches"],
        "fit_launches_per_step": None if fit is None else fit["launches_per_step"],
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
        flagship = build_trainer(512, 128, FULL_CH, True, DEVICE)
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
    if kernel is not None and path is not None:
        log(json.dumps(kernels_line(kernel, path, fit)))
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
