"""Profile the port's train step on the card (counterpart of the JAX
package's ``tools/profile_step.py`` and ``tools/parse_trace.py``).

    python -m scrubvae_torch.profile_step [--batch 512] [--steps 20]
                                          [--f32-params] [--no-fused]
                                          [--per-step] [--config YAML]
                                          [--small] [--device cuda]

By default it profiles the bench's flagship (``scrubvae_torch.bench``:
rcnn, window 51, channels 64-1024, z 128, batch 512, bf16) as
``Trainer.train_epoch`` runs it under ``train.scan_epoch``: one step
captured in a CUDA graph and replayed. ``--per-step`` profiles the eager
step from the host instead (``train.scan_epoch: false``). ``--config``
profiles a shipped config file (``configs/ladder/5_full.yaml``, say) at its
own widths, batch and precision, on a synthetic stream (the bench's: 4
ids, ``max(16 batch, 4096)`` frames, seed 0) assembled with the config's
direction process; ``--batch`` overrides its batch. ``--f32-params`` keeps
every leaf in f32 and ``--no-fused`` trains with the unfused Adam (which
needs ``--f32-params``). ``--small`` is the CPU smoke size of the bench
(channels 8-8-16-16-32, z 16, batch 16, f32).

After an untimed epoch of 3 steps (which captures the graph), one
``torch.profiler`` session covers an epoch of ``--steps`` steps, the
graph's replays included, and the script prints one JSON line: the wall
time, the device's busy time (the kernels' self time, from the CUDA
kernel events) and idle share a step, the kernel launches a step counted
from those events (not from host counters; copies and fills are counted
apart), the fused AdamW kernel's launches a step among them, the peak
memory, and the top kernels by self device time. The profiler's whole
table goes to ``build/profile_step_<label>.txt``. On the CPU there is no
device: the device figures are null and the top entries are operators by
self CPU time.

Without ``--per-step`` the line also gives ``slot_ms_per_step``, each
layer's ms a step from the program's own spans (``utils.profiling``):
two more epochs of the same rows with ``Trainer.set_tracing`` on, the
first capturing the traced step, the second read (on the card, device ms
over the graph's replays; on the CPU, the host's clock). A replay launches
its kernels under no operator, so these spans stand in for the class
table's device column there.

Then one more step, taken eagerly (a captured graph is released first: a
replay launches the eager step's kernels but passes no operator through a
counter), is counted by ``utils.step_cost.CostCounter`` (the counterpart of
the JAX package's ``tools/hlo_opclass.py`` and ``tools/hbm_bound.py``): the
line gains the step's ``bytes_per_step`` and ``bound_ms_per_step`` (its
least time on an H100 SXM), and the count by operator class (operators,
GFLOP, MB, bound ms) goes to ``build/profile_step_<label>_classes.txt``.
With ``--per-step`` on the card the table adds each class's device ms a
step, the profiler's kernels summed under the operator that launched each
(the fused AdamW kernel by its name; what no operator launched is
"unattributed"). A graph's replays launch their kernels under no operator,
so the graph's table says so, names ``slot_ms_per_step`` in its stead and
has no such column.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

__all__ = ["build_from_config", "main", "parse_args", "profile", "run", "slot_ms"]

ROOT = pathlib.Path(__file__).resolve().parent.parent
WARMUP_STEPS = 3
TOP_KERNELS = 15


def build_from_config(path, device, *, batch=None, small: bool = False, f32_params: bool = False,
                      fused: bool = True, scan_epoch: bool = True, val_frames: int = 0):
    """The trainer of the config file ``path`` (read by
    ``params.read.config``) on the bench's synthetic stream, assembled on
    ``device`` with the config's direction processes; ``small`` shrinks it
    to the bench's CPU size. With ``val_frames``, a validation split of 4
    ids and that many frames (seed 1) too. Returns (trainer, train
    dataset)."""
    from scrubvae_torch import bench, factory
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.data.synthetic import synthetic_pose_stream
    from scrubvae_torch.params import read
    from scrubvae_torch.train.trainer import Trainer

    cfg = read.config(path, make_dirs=False)
    cfg["out_path"] = str(ROOT / "build" / "profile_step_run") + "/"  # the logger's folder; nothing is logged
    data, model_cfg, train = cfg["data"], dict(cfg["model"]), cfg["train"]
    if small:
        model_cfg.update(channel=list(bench.SMALL_CH), z_dim=16, precision="fp32")
        train.update(precision="fp32", param_dtype="f32")
        batch = 16
    if f32_params:
        train["param_dtype"] = "f32"
    if not fused:
        train["fused_optimizer"] = False
    train["scan_epoch"] = scan_epoch
    train["minimal_test"] = True
    data["batch_size"] = batch or data.get("batch_size") or 256
    window = model_cfg.get("window") or data.get("window") or 51
    model_cfg["window"] = window
    if train.get("precision"):
        model_cfg.setdefault("precision", train["precision"])
    dp = data.get("direction_process")
    enc_dp = data.get("encoder_direction_process")
    keys = list(bench.KEYS) + [k for k in cfg["disentangle"].get("features") or () if k not in bench.KEYS]
    keys += ["x6d_enc", "root_enc"] if enc_dp and enc_dp != dp else []
    arena = np.asarray(data.get("arena_size") or bench.ARENA, np.float32)
    skel = load_skeleton(bench.SKELETON)

    def split(frames: int, seed: int, label: str):
        pose, ids = synthetic_pose_stream(skel, n_frames=frames, n_ids=4, seed=seed)
        store = build_frame_store(pose, ids, skel, window=window, stride=int(data.get("stride") or 2), device=device)
        return StreamDataset(store, skel, tuple(keys), dp, arena_size=arena, discrete_classes={"ids": np.unique(ids)},
                             device=device, label=label)

    splits = {"train": split(max(data["batch_size"] * 16, 4096), 0, "train")}
    if val_frames:
        splits["val"] = split(val_frames, 1, "val")
    model, info = factory.build_model(
        model_cfg, cfg["disentangle"], n_keypts=skel.n_keypts, direction_process=dp, arena_size=arena,
        discrete_classes=splits["train"].discrete_classes, loss_keys=(cfg.get("loss") or {}).keys(), device=device,
    )
    return Trainer(cfg, splits, model, info, device=device), splits["train"]


def profile(trainer, rows: np.ndarray, label: str) -> dict:
    """One profiler session over ``trainer.train_epoch`` of ``rows``; the
    record of the module docstring (the table to
    ``build/profile_step_<label>.txt``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cuda = trainer.device.type == "cuda"
    steps = len(rows)

    def sync():
        if cuda:
            torch.cuda.synchronize(trainer.device)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(1, rows)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    table = averages.table(sort_by="self_device_time_total" if cuda else "self_cpu_time_total", row_limit=80)
    out = ROOT / "build" / f"profile_step_{label}.txt"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(table)
    rec = {"wall_ms_per_step": wall_ms / steps}
    if cuda:
        events = [e for e in averages if e.device_type == DeviceType.CUDA]
        kernels = [e for e in events if not e.key.startswith(("Memcpy", "Memset"))]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3
        kernels.sort(key=lambda e: -e.self_device_time_total)
        rec.update(
            device_busy_ms_per_step=busy_ms / steps,
            device_idle_share=1.0 - busy_ms / wall_ms,
            kernel_launches_per_step=sum(e.count for e in kernels) / steps,
            copies_per_step=sum(e.count for e in events if e not in kernels) / steps,
            fused_adamw_launches_per_step=sum(e.count for e in kernels if "fused_adamw" in e.key) / steps,
            top=[
                {"name": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / steps,
                 "calls_per_step": e.count / steps}
                for e in kernels[:TOP_KERNELS]
            ],
        )
    else:
        ops = sorted(averages, key=lambda e: -e.self_cpu_time_total)
        rec.update(
            device_busy_ms_per_step=None, device_idle_share=None, kernel_launches_per_step=None,
            copies_per_step=None, fused_adamw_launches_per_step=None,
            top=[
                {"name": e.key[:90], "ms_per_step": e.self_cpu_time_total / 1e3 / steps,
                 "calls_per_step": e.count / steps}
                for e in ops[:TOP_KERNELS]
            ],
        )
    rec["table"] = str(out.relative_to(ROOT))
    if cuda and not (trainer.scan_train and trainer.use_graphs):
        rec["device_ms_by_class"] = device_ms_by_class(averages, busy_ms, steps)
    return rec


def slot_ms(trainer, rows: np.ndarray) -> dict:
    """Each span slot's ms a step over a traced epoch of ``rows``, after
    another that captures the traced step (the module docstring)."""
    trainer.set_tracing(True)
    try:
        for _ in range(2):
            trainer.train_epoch(1, rows)
    finally:
        trainer.set_tracing(False)
    return trainer.spans.ms_per_step()


def device_ms_by_class(averages, busy_ms: float, steps: int) -> dict:
    """Device ms a step by ``step_cost`` class from a profile of eager
    steps: each operator's self device time (the kernels it launched
    itself) under its class, the fused AdamW kernel's under its own, the
    rest of ``busy_ms`` as "unattributed"."""
    from torch.autograd import DeviceType

    from scrubvae_torch.utils.step_cost import op_class

    out = {}
    for e in averages:
        if e.device_type == DeviceType.CUDA and "fused_adamw" in e.key:
            cls = "fused AdamW"
        elif e.device_type == DeviceType.CPU and e.key.startswith("aten::") and e.self_device_time_total:
            packet = getattr(torch.ops.aten, e.key[len("aten::"):], None)
            cls = op_class(getattr(packet, packet.overloads()[0])) if packet is not None else "other"
        else:
            continue
        out[cls] = out.get(cls, 0.0) + e.self_device_time_total / 1e3
    out["unattributed"] = busy_ms - sum(out.values())
    return {k: v / steps for k, v in out.items()}


def count_step(trainer, row: np.ndarray, label: str, device_ms=None) -> dict:
    """One more eager step of ``row`` counted by ``step_cost.count``; its
    bytes and bound, and the table by class (``device_ms``, a step's device
    ms by class, as a column) in ``build/profile_step_<label>_classes.txt``."""
    from scrubvae_torch.utils import step_cost

    graph = trainer.scan_train and trainer.use_graphs
    trainer.release_graphs()
    _, cost = step_cost.count(trainer.train_epoch, 1, row[None])
    if graph:
        note = ("device ms: not attributed (a CUDA graph's replays launch their kernels under no operator; "
                "the line's slot_ms_per_step gives them by layer)")
    elif device_ms is None:
        note = "device ms: none (no device)"
    else:
        note = "device ms: the profiled eager steps' kernels, under the operator that launched each"
    out = ROOT / "build" / f"profile_step_{label}_classes.txt"
    out.write_text(
        f"{label}: one eager step counted by scrubvae_torch.utils.step_cost "
        "(bound: H100 SXM data sheet; cuDNN's internal layout copies not counted)\n"
        + cost.table(device_ms, note)
    )
    return {"bytes_per_step": cost.bytes, "bound_ms_per_step": cost.bound_ms, "classes_table": str(out.relative_to(ROOT))}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=None, help="512, or the config's (--small: fixed at 16)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--f32-params", action="store_true", help="f32 storage of every leaf")
    ap.add_argument("--no-fused", action="store_true", help="the unfused Adam in place of the kernel")
    ap.add_argument("--per-step", action="store_true", help="the eager step from the host (no CUDA graph)")
    ap.add_argument("--config", default=None, help="a config file to profile at its own widths")
    ap.add_argument("--small", action="store_true", help="tiny model (CPU smoke)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.no_fused and not (args.f32_params or args.small):
        ap.error("bf16 parameter storage needs the fused optimizer: add --f32-params to --no-fused")
    if args.small and args.batch is not None:
        ap.error("--small fixes batch 16: drop --batch")
    return args


def run(args) -> dict:
    """Build, warm up and profile; returns the record."""
    from scrubvae_torch import bench
    from scrubvae_torch.device import resolve_device

    device = resolve_device(args.device)
    scan = not args.per_step
    if args.config:
        trainer, ds = build_from_config(
            args.config, device, batch=args.batch, small=args.small, f32_params=args.f32_params,
            fused=not args.no_fused, scan_epoch=scan,
        )
        name = pathlib.Path(args.config).with_suffix("").name
    else:
        batch = 16 if args.small else args.batch or 512
        trainer, ds = bench.build(
            batch, 51, 16 if args.small else 128, bench.SMALL_CH if args.small else bench.FULL_CH, device,
            precision="fp32" if args.small else "bf16", bf16_params=not (args.f32_params or args.small),
            fused=not args.no_fused, scan_epoch=scan,
        )
        name = "flagship"
    path = "graph" if trainer.scan_train and trainer.use_graphs else "eager"
    label = f"{name}_{path}"
    rng = np.random.default_rng(0)
    B = trainer.batch_size
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trainer.train_epoch(1, rng.integers(0, len(ds), (WARMUP_STEPS, B)))
    rec = {"config": args.config or "flagship", "path": path, "batch": B, "steps": args.steps,
           "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    rows = rng.integers(0, len(ds), (args.steps, B))
    rec.update(profile(trainer, rows, label))
    rec["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
    if trainer.scan_train:
        rec["slot_ms_per_step"] = slot_ms(trainer, rows)
    rec.update(count_step(trainer, rows[0], label, rec.get("device_ms_by_class")))
    return rec


def main(argv=None) -> None:
    print(json.dumps(run(parse_args(argv))), flush=True)


if __name__ == "__main__":
    main()
