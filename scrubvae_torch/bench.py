"""Training throughput of the port: the flagship train step on one GPU.

    python -m scrubvae_torch.bench [--batch 512] [--steps 100] [--warmup 5]
                                   [--small] [--f32-params] [--no-fused]
                                   [--sigma-rank N] [--host-stream]
                                   [--device cuda]

The configuration is the flagship of the JAX package's bench: the rcnn
ResVAE at window 51, channels 64-128-256-512-1024, kernel 5, z 128, packed
Cholesky head, decoding conditional on avg_speed_3d and heading, linear,
MALS and gradient-reversal scrubbers on avg_speed_3d, AdamW (lr 1e-4, cawr,
clip off) on the fused kernel, bf16 compute and bf16 storage of the leaves
of at least 65536 elements, on a synthetic stream (max(16 batch, 4096)
frames, 4 ids, seed 0) assembled into midfwd windows on the device.
``--small`` is the CPU smoke size: channels 8-8-16-16-32, z 16, batch 16,
f32 storage and f32 compute. ``--f32-params`` keeps every leaf in f32.
``--no-fused`` trains with the unfused Adam (``train.fused_optimizer:
false``, plain torch ops) in place of the kernel; bf16 storage needs the
kernel's stochastically rounded weight stores, so it needs
``--f32-params`` (or ``--small``), as the JAX trainer refuses bf16 storage
without the fused optimizer. ``--sigma-rank N`` factors ``fc_sigma`` at
rank N (``model.sigma_head_rank``). ``--host-stream`` keeps the frame
store in host memory and streams each step's slab to the device
(``data.host_stream``).

It times the real training path, ``Trainer.train_epoch`` over a (steps,
batch) matrix of window indices, after one untimed epoch of ``warmup``
rows, between two synchronizes, and prints one JSON line:

- ``metric`` (train_samples_per_sec_per_chip), ``value`` (samples/s),
  ``unit``, ``step_ms``, ``device_kind`` (the card's name, or "cpu"),
  ``param_dtype``, ``sigma_head_rank`` (null without ``--sigma-rank``),
  ``fused_optimizer`` and, with ``--host-stream``, ``host_stream: true``;
  the model's ``leaves`` and ``parameters``;
- ``gflops_per_step`` and ``tflops_per_s``: the FLOPs of one more, untimed,
  step counted by ``torch.utils.flop_counter.FlopCounterMode``, 2*M*N*K for
  every matrix product (mm, addmm, bmm, baddbmm) and every convolution,
  forward and backward as autograd runs them (so the first convolution has
  no input gradient), the 3x3 products of the forward kinematics included;
  elementwise work, reductions, the small solves and the optimizer are not
  counted. This is the convention of the JAX bench's ``mfu_static_hlo``
  (2*M*N*K over the dot and convolution ops of the compiled step);
- ``mfu``, ``peak_tflops`` and ``peak_hbm_gb_per_s``: that rate over the
  card's dense bf16 peak, from ``PEAKS`` keyed by the card's name; a card
  not in the table, or the CPU, gets none of the three.

There is no ``vs_baseline``: the JAX bench's ``BENCH_BASELINE.json`` holds
a TPU number, which this bench neither reads nor writes.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time

import numpy as np
import torch

__all__ = ["PEAKS", "bench_config", "build", "peak_specs", "run", "main"]

SKELETON = pathlib.Path(__file__).resolve().parent.parent / "configs" / "mouse_skeleton.yaml"
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)
KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids")
FULL_CH = (64, 128, 256, 512, 1024)
SMALL_CH = (8, 8, 16, 16, 32)

# Dense bf16 tensor-core TFLOP/s and HBM GB/s by card name (NVIDIA's data
# sheets, without sparsity, at the full power limit).
PEAKS = (
    ("H100 80GB HBM3", 989.4, 3350.0),  # H100 SXM
    ("H100 PCIe", 756.0, 2000.0),
)


def peak_specs(name: str):
    """(bf16 TFLOP/s, HBM GB/s) of the card called ``name``, or (None, None)."""
    for tag, tflops, gbps in PEAKS:
        if tag in name:
            return tflops, gbps
    return None, None


def bench_config(
    batch: int, window: int, z_dim: int, ch, bf16_params: bool, precision: str = "bf16",
    fused: bool = True, sigma_rank: int = 0,
) -> dict:
    """The flagship's config sections, with ``train.minimal_test`` set."""
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
            "type": "rcnn", "z_dim": z_dim, "window": window, "diag": False, "channel": list(ch),
            "kernel": 5, "start_epoch": 0, "load_model": None, "prior": "gaussian",
            "activation": "prelu", "init_dilation": None, "sigma_head_rank": sigma_rank or None,
            "precision": precision,
        },
        "train": {
            "lr": 1e-4, "optimizer": "adamw", "lr_schedule": "cawr", "num_epochs": 1, "seed": 0,
            "mesh": None, "clip_norm": 0, "fused_optimizer": fused,
            "param_dtype": "bf16" if bf16_params else "f32", "minimal_test": True,
        },
        "loss": {
            "rotation": 1.0, "prior": 0.001, "root": 0.01, "jpe": 1.0,
            "avg_speed_3d_mals": 0.1, "avg_speed_3d_lin": 1.0, "avg_speed_3d_gr": 1.0,
        },
    }


def build(batch: int, window: int, z_dim: int, ch, device, *, precision: str = "bf16",
          bf16_params: bool = True, fused: bool = True, sigma_rank: int = 0, host_stream: bool = False):
    """The synthetic stream, the on-device frame store and midfwd window
    dataset (its store in host memory with ``host_stream``), the model and
    the trainer on ``device``, computing in ``precision`` ("bf16" or
    "fp32"). Returns (trainer, dataset)."""
    from scrubvae_torch import factory
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.hoststream import HostStreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream
    from scrubvae_torch.train.trainer import Trainer

    skel = load_skeleton(SKELETON)
    pose, ids = synthetic_pose_stream(skel, n_frames=max(batch * 16, 4096), n_ids=4, seed=0)
    store = build_frame_store(pose, ids, skel, window=window, stride=2, device=device)
    ds = StreamDataset(
        store, skel, KEYS, "midfwd", arena_size=ARENA,
        discrete_classes={"ids": np.unique(ids)}, device=device,
    )
    if host_stream:
        ds = HostStreamDataset.from_stream(ds)
    cfg = bench_config(batch, window, z_dim, ch, bf16_params, precision, fused, sigma_rank)
    model, info = factory.build_model(
        cfg["model"], cfg["disentangle"], n_keypts=skel.n_keypts, direction_process="midfwd",
        arena_size=ARENA, discrete_classes=ds.discrete_classes, loss_keys=cfg["loss"].keys(),
        device=device,
    )
    return Trainer(cfg, {"train": ds}, model, info, device=device), ds


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=None, help="512 (--small: fixed at 16)")
    ap.add_argument("--window", type=int, default=51)
    ap.add_argument("--z_dim", type=int, default=None, help="128 (--small: fixed at 16)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--small", action="store_true", help="tiny model (CPU smoke)")
    ap.add_argument("--f32-params", action="store_true", help="f32 storage of every leaf")
    ap.add_argument("--no-fused", action="store_true", help="the unfused Adam in place of the kernel")
    ap.add_argument("--sigma-rank", type=int, default=0, help="low-rank fc_sigma (0: the dense head)")
    ap.add_argument("--host-stream", action="store_true", help="frame store in host memory, slabs streamed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.no_fused and not (args.f32_params or args.small):
        ap.error("bf16 parameter storage needs the fused optimizer: add --f32-params to --no-fused")
    if args.small:
        if args.batch is not None or args.z_dim is not None:
            ap.error("--small fixes batch 16 and z 16: drop --batch/--z_dim")
        args.batch, args.z_dim = 16, 16
    else:
        args.batch = 512 if args.batch is None else args.batch
        args.z_dim = 128 if args.z_dim is None else args.z_dim
    return args


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args) -> dict:
    """Build, warm up, time ``args.steps`` steps and count one more step's
    FLOPs; returns the result record."""
    from torch.utils.flop_counter import FlopCounterMode

    from scrubvae_torch.device import resolve_device

    device = resolve_device(args.device)
    ch = SMALL_CH if args.small else FULL_CH
    batch = args.batch
    bf16_params = not args.f32_params and not args.small
    trainer, ds = build(
        batch, args.window, args.z_dim, ch, device,
        precision="fp32" if args.small else "bf16", bf16_params=bf16_params,
        fused=not args.no_fused, sigma_rank=args.sigma_rank, host_stream=args.host_stream,
    )
    rng = np.random.default_rng(0)

    def idx_matrix(steps):
        return rng.integers(0, len(ds), size=(steps, batch))

    trainer.train_epoch(1, idx_matrix(args.warmup))
    _sync(device)
    t0 = time.perf_counter()
    metrics = trainer.train_epoch(1, idx_matrix(args.steps))
    _sync(device)
    dt = time.perf_counter() - t0
    total = metrics["total"]
    if not math.isfinite(total):
        raise FloatingPointError(f"non-finite training loss in the bench run: {total}")

    counter = FlopCounterMode(display=False)
    with counter:
        trainer.train_epoch(1, idx_matrix(1))
    _sync(device)
    flops = counter.get_total_flops()

    step_s = dt / args.steps
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out = {
        "metric": "train_samples_per_sec_per_chip",
        "value": batch / step_s,
        "unit": "samples/sec/chip",
        "step_ms": step_s * 1e3,
        "device_kind": kind,
        "param_dtype": "bf16" if bf16_params else "f32",
        "sigma_head_rank": args.sigma_rank or None,
        "fused_optimizer": not args.no_fused,
        "leaves": len(list(trainer.model.parameters())),
        "parameters": sum(p.numel() for p in trainer.model.parameters()),
        "batch": batch,
        "steps": args.steps,
        "total": total,
        "gflops_per_step": flops / 1e9,
        "tflops_per_s": flops / step_s / 1e12,
    }
    if args.host_stream:
        out["host_stream"] = True
    peak_tflops, peak_gbps = peak_specs(kind) if device.type == "cuda" else (None, None)
    if peak_tflops:
        out["mfu"] = out["tflops_per_s"] / peak_tflops
        out["peak_tflops"] = peak_tflops
        out["peak_hbm_gb_per_s"] = peak_gbps
    return out


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
