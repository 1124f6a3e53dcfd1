"""The readings the comparison's limits are set from, for one cell, on the
card at the cell's own size (the benchmark's runs do not run this).

    python3 -m benchmark.calibrate --workload flagship.b512 --seeds 11,12,13 --controls 3 --out FILE

For every seed: the program's first three steps against the reference's
(the sound runs, which give each number's lower reading). For the first
``--controls`` seeds also each of ``--kinds`` against the reference:
``control`` (the reference one step below the precision the program
computes the configuration's VAE in: its layers in fp8 under bf16, its
products and convolutions in TF32 under f32), ``half_batch`` (the
reference with half of each batch left out), ``unchanged`` (the reference
with each step's state put back as it was) and ``skip_lowp`` (the
program with its optimizer's launches over the leaves of a low-precision
weight or moment dtype left out). Writes one JSON record, with every
reading.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

KINDS = ("control", "half_batch", "unchanged", "skip_lowp")


@contextlib.contextmanager
def skip_lowp_launches():
    """The program's fused AdamW with its launches over bf16 weights or
    bf16 moments left out: those leaves keep their values and moments,
    the others are updated as before (also inside a captured graph)."""
    from scrubvae_torch.ops import fused_adamw

    launch = fused_adamw._launch

    def skipping(table, grads, scal, **kw):
        kept = table.batches
        table.batches = [b for b in kept if not (b.w_bf16 or b.m_bf16)]
        try:
            return launch(table, grads, scal, **kw)
        finally:
            table.batches = kept

    fused_adamw._launch = skipping
    try:
        yield
    finally:
        fused_adamw._launch = launch


def readings(su, kind: str, device: str = "cuda") -> dict:
    """The readings of ``kind`` for the seed and cell of ``su``."""
    from benchmark import run

    if kind == "control":
        return run.reference_readings(su, control=True)
    if kind == "skip_lowp":
        with skip_lowp_launches():
            broken = run.set_up(su.name, su.seed, device)
        run.free_program(broken)
        return broken.readings
    return run.reference_readings(su, fault=kind)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--kinds", default=",".join(KINDS), help="comma-separated, of " + ", ".join(KINDS))
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    from benchmark import run

    run.set_caches()
    import torch

    from benchmark import compare

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    rec = {"workload": args.workload, "card": torch.cuda.get_device_name(0), "power_limit_w": run.power_limit(),
           "seeds": {}}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        su = run.set_up(args.workload, seed, "cuda")
        prog = su.readings
        run.free_program(su)
        ref = run.reference_readings(su)
        out = {"program": compare.numbers(prog, ref, su.groups)}
        raw = {"reference": ref, "program": prog}
        if i < args.controls:
            for kind in args.kinds.split(","):
                raw[kind] = readings(su, kind)
                out[kind] = compare.numbers(raw[kind], ref, su.groups)
        out["seconds"] = time.time() - t0
        print(seed, json.dumps(out), flush=True)
        out["readings"] = raw
        rec["seeds"][str(seed)] = out
        del su
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
