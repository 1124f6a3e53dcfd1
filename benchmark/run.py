"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python3 -m benchmark.run --workload flagship.b512 --seed 7 --seconds 20 --trace 0

Set-up builds the measured program (``scrubvae_torch``: the frame store,
the window dataset, the model and the trainer) from the cell's
configuration and traffic files and the seed, writes the benchmark's own
start weights into it, and drives its first three steps through
``Trainer.train_epoch`` on rows drawn from the seed: the first step alone
(its first gradient is read from the optimizer's state), then two more,
the first eager and the second a replay of the CUDA graph captured
between them, and the cell's ``warm_epochs`` whole shuffled epochs more
(``benchmark/cells``; one where the cell names none), in proportion for
another ``--seconds`` as the window. The window then runs
a fixed number of the trainer's own shuffled epochs, every step a
replay, each reading its loss back inside the window: the cell's
``window_epochs`` (``benchmark/cells``) for a run of ``run_seconds``, in
proportion for another ``--seconds``, and at least one. A faster program
trains the same steps in less time.

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` runs
the same window, then profiles a fixed slice of steps and reports the
per-layer metrics that move them; each metric is read by its reader in
``benchmark/metrics`` (``manifest.reported``, ``manifest.metric_reader``).

After the window the program is freed and the reference
(``benchmark/reference``) takes the same three steps from the same
weights, rows and draws in f32; ``benchmark.compare`` decides ``correct``
against the cell's limits (``benchmark/cells``). The numbers compared
are printed with their limits as the last lines of standard error and
under ``checks`` at the end of the result line.

A run exits non-zero and prints no result without a CUDA device (or
fewer than the cell asks for), when a forbidden module is loaded after
the window (``benchmark.guard``), or when the measured package is absent.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import time
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "bench_cache"
CACHE_VARS = {
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TRITON_CACHE_DIR": "triton",
    "TORCHINDUCTOR_CACHE_DIR": "inductor",
    "CUDA_CACHE_PATH": "cuda",
}
# the streams each seed gives: the pose stream, the weights, each
# discriminator's weights (from ADV on), the rows of the first steps and
# the rows of the profiled slice
DATA, WEIGHTS, ROWS, SLICE, ADV = 1, 2, 3, 4, 100
SLICE_STEPS = 24
# the CPU size of the tests, f32 throughout: the batch, the stream and the
# model keys of the configuration's type (``reference.model.small_shape``)
SMALL = {"batch": 16, "n_frames": 800}


def process_start() -> float:
    """The wall time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def set_caches() -> None:
    """Every build and kernel cache in fixed folders inside the checkout."""
    for var, sub in CACHE_VARS.items():
        os.environ[var] = str(CACHE / sub)


@dataclasses.dataclass
class RunView:
    """What the metric readers read."""

    sections: dict
    batch: int
    window_steps: int
    window_s: float
    setup_s: float
    flops_per_step: int
    peak: Optional[dict]
    slice: Optional[dict]
    memory_peak_bytes: Optional[int]
    trainer: object
    leaf_numels: list


def _shrink(sections: dict) -> dict:
    from benchmark.reference import model as rm

    sections["model"].update(rm.small_shape(sections["model"]), precision="fp32")
    sections["train"].update(precision="fp32", param_dtype="f32")
    sections["data"]["batch_size"] = SMALL["batch"]
    return sections


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


@dataclasses.dataclass
class SetUp:
    """What set-up made: the program's trainer after its first three steps
    and their readings, and what the reference needs to take them again
    (``control``: the control of the cell's configuration as it is stated,
    which ``--small`` keeps)."""

    name: str
    seed: int
    device: object
    sections: dict
    control: str
    chips: int
    flops: int
    pose: object
    ids: object
    skel: object
    shell: object
    leaf_numels: list
    groups: dict
    lowp: bool
    rows: object
    batch: int
    trainer: object
    ds: object
    adv_w: dict
    readings: dict


def set_up(name: str, seed: int, device, small: bool = False) -> SetUp:
    """Build the program for cell ``name`` from the seed, write the
    benchmark's weights into it and take its first three steps."""
    import numpy as np
    import torch

    from benchmark import manifest, program, roofline, synthetic
    from benchmark import weights as bw
    from benchmark.reference import data as rdata
    from benchmark.reference import model as rm

    dev = torch.device(device)
    cell = manifest.workload(name)
    traffic = manifest.traffic(cell["traffic"])
    sections = manifest.sections(cell["config"], traffic["batch_size"], seed)
    control = rm.control(sections)
    n_frames = traffic["n_frames"]
    if small:
        sections, n_frames = _shrink(sections), SMALL["n_frames"]
    skel = rdata.load_skeleton(manifest.SKELETON)
    pose, ids = synthetic.pose_stream(skel.tree, n_frames, traffic["n_ids"], bw.derived_seed(seed, DATA),
                                      traffic.get("arena_xy", 250.0))
    trainer, ds = program.build(sections, pose, ids, dev)
    B = trainer.batch_size
    with torch.device("meta"):
        shell = rm.build(dict(sections["model"]), sections["disentangle"], sections["loss"].keys(), skel.n_keypts,
                         sections["data"]["arena_size"], {"ids": len(np.unique(ids))})
        adv_shell = rm.AdvNet(shell.vae.z_dim + shell.vae.cond_dim)
    w = bw.make(shell, bw.derived_seed(seed, WEIGHTS), dev)
    bw.load_into(trainer.model, w)
    adv_w = {}
    for i, (k, net) in enumerate(program.adv_nets(trainer).items()):
        adv_w[k] = bw.make(adv_shell, bw.derived_seed(seed, ADV + i), dev)
        bw.load_into(net, adv_w[k])
    lowp = (sections["train"].get("param_dtype") or "f32") == "bf16"
    rows = np.random.default_rng(bw.derived_seed(seed, ROWS)).permutation(len(ds))[: 3 * B].reshape(3, B)
    step1 = trainer.train_epoch(1, rows[:1])
    grad1 = program.first_grads(trainer)
    steps23 = trainer.train_epoch(1, rows[1:3])
    readings = {"loss": {"step1": step1, "steps2_3": steps23}, "grad1": grad1,
                "change3": program.changes(trainer, bw.as_stored(w, lowp)),
                "state3": program.state_norms(trainer, adv_w)}
    groups = {n: roofline.dtype_group(p.numel(), sections["train"]) for n, p in shell.named_parameters()}
    flops = manifest.flops(cell["config"], traffic["batch_size"])["flops_per_step"]
    return SetUp(name, seed, dev, sections, control, int(cell["chips"]), flops, pose, ids, skel, shell,
                 [p.numel() for p in shell.parameters()], groups, lowp, rows, B, trainer, ds, adv_w, readings)


def free_program(su: SetUp) -> None:
    """Drop the program's trainer, its graphs and its cached memory."""
    import torch

    su.trainer.release_graphs()
    su.trainer = su.ds = None
    gc.collect()
    if su.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_readings(su: SetUp, control: bool = False, fault: Optional[str] = None) -> dict:
    """The reference's readings of the same three steps (``control``: the
    configuration's control in its place; ``fault``: a fault planted in
    it)."""
    from benchmark import weights as bw
    from benchmark.reference.step import Reference

    w = bw.as_stored(bw.make(su.shell, bw.derived_seed(su.seed, WEIGHTS), su.device), su.lowp)
    ref = Reference(su.sections, su.pose, su.ids, su.skel, w, su.adv_w, su.seed, su.device, batch=su.batch,
                    precision=su.control if control else "fp32", fault=fault)
    return ref.run(su.rows, epoch=1)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda", small: bool = False,
             limits: Optional[dict] = None, start: Optional[float] = None) -> tuple:
    """One run of cell ``name``: (result record, lines of the comparison)."""
    import numpy as np
    import torch

    from benchmark import compare, manifest
    from benchmark import weights as bw

    start = process_start() if start is None else start
    limits = manifest.limits(name) if limits is None else limits
    epochs = window_epochs(name, seconds)
    su = set_up(name, seed, device, small)
    trainer, ds, B, dev = su.trainer, su.ds, su.batch, su.device
    cuda = dev.type == "cuda"
    # whole epochs of the trainer's shuffle, untimed: the window's index
    # upload and loss readback, every replay of the captured step, and as
    # many more as the card's slow start takes to pass
    warm = []
    for _ in range(warm_epochs(name, seconds)):
        t = time.perf_counter()
        trainer.train_epoch(1)
        if cuda:
            torch.cuda.synchronize(dev)
        warm.append(time.perf_counter() - t)
    setup_s = time.time() - start

    # the window: whole epochs of the trainer's own shuffle
    steps_per_epoch = len(ds) // B
    attempted = failed = 0
    ends = []
    t0 = time.perf_counter()
    for epoch in range(2, epochs + 2):
        losses = trainer.train_epoch(epoch)
        attempted += steps_per_epoch
        failed += 0 if math.isfinite(losses.get("total", math.nan)) else steps_per_epoch
        ends.append(time.perf_counter() - t0)
    window_s = ends[-1]
    peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else None
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    peak = manifest.peaks(kind) if cuda else None

    result = {"correct": False, "attempted": attempted, "failed": failed}
    device_rec = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": su.chips,
                  "memory_peak_bytes": peak_bytes, "power_limit_w": power_limit() if cuda else None}
    breakdown = summary = None
    if trace:
        srows = np.random.default_rng(bw.derived_seed(seed, SLICE)).permutation(len(ds))[: SLICE_STEPS * B]
        summary = profile_slice(trainer, srows.reshape(SLICE_STEPS, B), epochs + 2)
        peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else None
        device_rec["memory_peak_bytes"] = peak_bytes
    view = RunView(su.sections, B, attempted, window_s, setup_s, su.flops, peak, summary, peak_bytes, trainer,
                   su.leaf_numels)
    metrics = {}
    for m in manifest.reported(name, trace):
        value = manifest.metric_reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if summary is not None:
        device_rec.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    del trainer, ds
    free_program(su)
    correct, table, lines = compare.judge(compare.numbers(su.readings, reference_readings(su), su.groups), limits)
    lines.insert(0, "epoch seconds " + " ".join("%.4f" % (b - a) for a, b in zip([0.0] + ends, ends)))
    lines.insert(0, "warm epoch seconds " + " ".join("%.4f" % w for w in warm))
    result.update(correct=bool(correct and failed == 0), metrics=metrics, device=device_rec)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = table
    return result, lines


def window_epochs(name: str, seconds: float) -> int:
    """The whole epochs of the cell's window for a run of ``seconds``."""
    from benchmark import manifest

    full = manifest.cell(name)["window_epochs"]
    return max(1, round(full * seconds / manifest.benchmark()["run_seconds"]))


def warm_epochs(name: str, seconds: float) -> int:
    """The whole epochs set-up trains after the capture, before the window
    of a run of ``seconds``: the cell's ``warm_epochs``, in proportion as the
    window, and at least one."""
    from benchmark import manifest

    full = manifest.cell(name).get("warm_epochs", 1)
    return max(1, round(full * seconds / manifest.benchmark()["run_seconds"]))


def profile_slice(trainer, rows, epoch: int) -> Optional[dict]:
    """``SLICE_STEPS`` replayed steps under ``torch.profiler``, reduced by
    ``benchmark.trace``; None on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace as tr

    if trainer.device.type != "cuda":
        return None
    torch.cuda.synchronize(trainer.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("benchmark.slice"):
            trainer.train_epoch(epoch, rows)
            torch.cuda.synchronize(trainer.device)
        span_s = time.perf_counter() - t0
    events = tr.from_profiler(prof)
    marks = [e for e in events if e["name"] == "benchmark.slice" and not e["device"]]
    window = (marks[0]["start"], marks[0]["end"]) if marks else (0.0, math.inf)
    return tr.summarize(events, len(rows), window, span_s)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    start = process_start()
    args = parse_args(argv)
    set_caches()
    import torch

    from benchmark import guard, manifest

    chips = int(manifest.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), start=start)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
