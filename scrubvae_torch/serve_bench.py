"""Serving latency and throughput of the exported artifacts (counterpart of
``tools/serve_bench.py``):

    python -m scrubvae_torch.serve_bench --run RUNS/PROJ/NAME   # its export/
    python -m scrubvae_torch.serve_bench --flagship [--batches 1 8 64 512]
                                         [--iters 20] [--device cuda]

It times what a deployment calls: the ``.pt2`` artifacts of
``python -m scrubvae_torch.export_model``, loaded with
``utils.export.load_exported`` (no model code) onto ``--device`` (default
``cuda``, which raises without a GPU), at serving batch sizes: the encoder
(pose window -> mu and the Cholesky factor), the mu-only encoder and the
decoder (z and the conditionals -> pose). ``--flagship`` builds the port's
flagship (rcnn, window 51, channels 64-128-256-512-1024, z 128, the packed
head, decoding conditional on avg_speed_3d and heading, f32, weights from
``factory.init_weights`` at seed 0), exports it in memory and times that;
no run folder is needed.

One JSON line a (artifact, batch): ``latency_ms`` pipelined, the median
over windows of ``--iters`` calls each followed by one synchronize (the
device's time a call when the host keeps ahead), the windows repeated until
``SECONDS`` have passed and at least ``MIN_WINDOWS`` ran, with
``latency_ms_min`` and ``latency_ms_max`` the fastest and slowest window and
``windows`` their count; ``latency_ms_sync_min`` and ``latency_ms_sync_p50``
(each call waited for, as a synchronous client sees it, for half as many
seconds and at least ``--iters`` calls); ``samples_per_sec`` from the
median pipelined latency; and ``device_kind`` (the card's name, or "cpu").
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["flagship", "poses", "normals", "time_call", "bench", "main"]

WARMUP = 3
# a point's least time: host-timed windows of a few ms each spread by tens
# of percent on a shared host, so one window alone is no reading
SECONDS = 1.0
MIN_WINDOWS = 3


def flagship(device) -> tuple:
    """The port's flagship model in f32 on ``device`` (weights from
    ``init_weights(model, 0)``, eval mode) and an example batch of 2
    (x6d, root, avg_speed_3d, heading). Returns (model, batch, info)."""
    from scrubvae_torch import bench, factory
    from scrubvae_torch.device import resolve_device

    device = resolve_device(device)
    cfg = bench.bench_config(2, 51, 128, bench.FULL_CH, bf16_params=False, precision="fp32")
    model, info = factory.build_model(
        cfg["model"], cfg["disentangle"], n_keypts=18, direction_process="midfwd",
        arena_size=bench.ARENA, loss_keys=cfg["loss"].keys(), device=device,
    )
    factory.init_weights(model, 0)
    model.eval()
    rng = np.random.default_rng(0)
    batch = poses(rng, 2, {"x6d": (51, 18, 6), "root": (51, 3)}, device)
    batch.update(normals(rng, 2, {k: (info["feat_dims"][k],) for k in info["conditional_keys"]}, device))
    return model, batch, info


def poses(rng, n: int, shapes: dict, device) -> dict:
    """Random encoder inputs of the trailing ``shapes``: x6d in (-1, 1),
    roots within the arena."""
    return {
        k: torch.as_tensor(
            np.tanh(rng.normal(size=(n, *s))) if k.startswith("x6d") else rng.uniform(-200, 200, size=(n, *s)),
            dtype=torch.float32, device=device,
        )
        for k, s in shapes.items()
    }


def normals(rng, n: int, shapes: dict, device) -> dict:
    return {k: torch.as_tensor(rng.normal(size=(n, *s)), dtype=torch.float32, device=device) for k, s in shapes.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_call(fn, args: tuple, device: torch.device, iters: int) -> dict:
    """Seconds a call: pipelined (windows of ``iters`` calls, each window
    ending in one synchronize, until ``SECONDS`` have passed and at least
    ``MIN_WINDOWS`` ran: the median window and the fastest and slowest) and
    the least and median of calls each waited for (until ``SECONDS / 2``
    have passed and at least ``iters`` ran)."""
    with torch.no_grad():
        for _ in range(WARMUP):
            fn(*args)
        _sync(device)
        windows = []
        start = time.perf_counter()
        while len(windows) < MIN_WINDOWS or time.perf_counter() - start < SECONDS:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            _sync(device)
            windows.append((time.perf_counter() - t0) / iters)
        times = []
        start = time.perf_counter()
        while len(times) < iters or time.perf_counter() - start < SECONDS / 2:
            t0 = time.perf_counter()
            fn(*args)
            _sync(device)
            times.append(time.perf_counter() - t0)
    windows.sort()
    times.sort()
    return {
        "pipelined": windows[len(windows) // 2], "pipelined_min": windows[0], "pipelined_max": windows[-1],
        "windows": len(windows), "sync_min": times[0], "sync_p50": times[len(times) // 2],
    }


def bench(fns: dict, shapes: dict, cond_shapes: dict, z_dim: int, batches, iters: int, device) -> list:
    """Time the artifacts ``fns`` ("encoder", "encoder_mu", "decoder") at
    each batch size on random inputs of the given trailing shapes; prints
    and returns one record a (artifact, batch)."""
    rng = np.random.default_rng(0)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    lines = []
    for n in batches:
        data = poses(rng, n, shapes, device)
        z = normals(rng, n, {"z": (z_dim,)}, device)["z"]
        cond = normals(rng, n, cond_shapes, device)
        for artifact, args in (("encoder", (data,)), ("encoder_mu", (data,)), ("decoder", (z, cond))):
            st = time_call(fns[artifact], args, device, iters)
            line = {
                "artifact": artifact, "batch": n,
                "latency_ms": st["pipelined"] * 1e3,
                "latency_ms_min": st["pipelined_min"] * 1e3,
                "latency_ms_max": st["pipelined_max"] * 1e3,
                "windows": st["windows"],
                "latency_ms_sync_min": st["sync_min"] * 1e3,
                "latency_ms_sync_p50": st["sync_p50"] * 1e3,
                "samples_per_sec": n / st["pipelined"],
                "device_kind": kind,
            }
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="scrubvae_torch.serve_bench", description=__doc__.split("\n")[0])
    ap.add_argument("--run", default=None, help="run folder holding export/")
    ap.add_argument("--flagship", action="store_true", help="bench a freshly exported flagship model")
    ap.add_argument("--batches", type=int, nargs="+", default=(1, 8, 64, 512))
    ap.add_argument("--iters", type=int, default=20, help="calls a pipelined window")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from scrubvae_torch.device import resolve_device
    from scrubvae_torch.utils.export import export_decoder, export_encoder, load_exported

    device = resolve_device(args.device)
    if args.run:
        out_dir = Path(args.run) / "export"
        meta = json.loads((out_dir / "meta.json").read_text())
        fns = {a: load_exported(out_dir / f"{a}.pt2", device) for a in ("encoder", "encoder_mu", "decoder")}
        shapes, cond_shapes, z_dim = meta["input_shapes"], meta["conditional_shapes"], meta["z_dim"]
    elif args.flagship:
        model, batch, info = flagship(device)
        cond_keys, z_dim = info["conditional_keys"], info["z_dim"]
        fns = {
            "encoder": load_exported(export_encoder(model, batch)),
            "encoder_mu": load_exported(export_encoder(model, batch, mu_only=True)),
            "decoder": load_exported(export_decoder(model, batch, z_dim, cond_keys)),
        }
        shapes = {k: tuple(batch[k].shape[1:]) for k in ("x6d", "root")}
        cond_shapes = {k: tuple(batch[k].shape[1:]) for k in cond_keys}
    else:
        ap.error("need --run or --flagship")
    return bench(fns, shapes, cond_shapes, z_dim, args.batches, args.iters, device)


if __name__ == "__main__":
    main()
