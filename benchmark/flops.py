"""The pinned FLOP count of a step, and the convention it is counted by.

A step's FLOPs are 2*M*N*K over every matrix product (mm, addmm, bmm,
baddbmm, and einsum through them) and every convolution, forward and
backward as autograd runs them (the first convolution has no input
gradient), by ``torch.utils.flop_counter``'s formulas: the convention of
the measured program's own count. Elementwise work, reductions, the small
solves and the optimizer are not counted.

What is counted is the reference's train step (``reference.step``) at
the cell's shapes, run on the meta device, so only shapes are read and no
memory is taken. The count is written once into
``benchmark/flops/<config>.b<batch>.json`` and ``mfu_pct`` reads it from
there: a change to how the program computes its step leaves it where it
is.

    python -m benchmark.flops <config> <batch>   # prints the file's JSON
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from benchmark import manifest
from benchmark.reference import data as rdata
from benchmark.reference.step import Reference


def count(config: str, batch: int) -> dict:
    """The count of one step of ``config`` at ``batch``: total and by operator."""
    from torch.utils.flop_counter import FlopCounterMode

    sections = manifest.sections(config, batch)
    skel = rdata.load_skeleton(manifest.SKELETON)
    n_ids = 4
    frames = max(batch, 64) * 16
    ids = np.repeat(np.arange(n_ids), frames // n_ids)
    pose = np.zeros((frames, skel.n_keypts, 3), np.float32)
    meta = torch.device("meta")
    with torch.device(meta):
        shell = Reference(sections, pose, ids, skel, _meta_weights(sections, skel, ids), _meta_adv(sections, skel, ids),
                          0, meta, batch=batch)
    rows = torch.zeros((batch,), dtype=torch.long, device=meta)
    with FlopCounterMode(display=False) as fc:
        shell.step_terms(rows, 1)
    by_op = {str(k): int(v) for k, v in sorted(fc.get_flop_counts().get("Global", {}).items(), key=lambda kv: str(kv[0]))}
    return {"config": config, "batch": batch, "flops_per_step": int(fc.get_total_flops()), "by_operator": by_op,
            "counted_by": "python -m benchmark.flops " + f"{config} {batch}"}


def _shell_model(sections, skel, ids):
    from benchmark.reference import model as rm

    arena = np.asarray(sections["data"]["arena_size"], np.float32)
    with torch.device("meta"):
        return rm.build(dict(sections["model"]), sections["disentangle"], sections["loss"].keys(), skel.n_keypts, arena,
                        {"ids": len(np.unique(ids))})


def _meta_weights(sections, skel, ids):
    return {n: torch.empty(p.shape, device="meta") for n, p in _shell_model(sections, skel, ids).named_parameters()}


def _meta_adv(sections, skel, ids):
    from benchmark.reference import model as rm

    model = _shell_model(sections, skel, ids)
    feats = (sections["disentangle"].get("method") or {}).get("adversarial_net", [])
    with torch.device("meta"):
        net = rm.AdvNet(model.vae.z_dim + model.vae.cond_dim)
    return {k: {n: torch.empty(p.shape, device="meta") for n, p in net.named_parameters()} for k in feats}


if __name__ == "__main__":
    print(json.dumps(count(sys.argv[1], int(sys.argv[2])), indent=1))
