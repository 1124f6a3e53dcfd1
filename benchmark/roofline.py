"""The optimizer kernel's bytes, counted by the benchmark, and its time on
the card, taken alone.

Bytes: every leaf's weights, gradient and both moments read once, and
the weights and both moments written once, at the dtypes the
configuration states (``train.param_dtype`` bf16 stores the leaves of at
least 65,536 elements in bf16, the gradient taking the weights' dtype;
``train.moment_dtype``, bf16 unless set, keeps those leaves' moments in
bf16; every other leaf and moment is f32).

Time: the trainer's optimizer (``init``, ``update_and_apply``) on copies
of the trained parameters with gradients of their shapes, under the
profiler, with the 50 MB L2 flushed before each pass. A pass's time is the
device time of its fused AdamW kernels alone, from the trace: the
global-norm clip's reduction and the lr and bias-correction scalars,
which the pass launches apart, are not the kernel's and are left out.
"""

from __future__ import annotations

import statistics
from typing import Iterable, Optional, Tuple

import torch

from benchmark.weights import LOWP_MIN_ELEMS

DTYPES = {2: "bf16", 4: "f32"}
FLUSH_BYTES = 256 << 20
PASSES = 40
# the kernel's name in the trace (``csrc/fused_adamw.cu``)
KERNEL = "fused_adamw"


def leaf_dtype_bytes(numel: int, train_cfg: dict) -> Tuple[int, int]:
    """(weight bytes, moment bytes) of a leaf of ``numel`` elements."""
    big = numel >= LOWP_MIN_ELEMS
    w = 2 if big and (train_cfg.get("param_dtype") or "f32") == "bf16" else 4
    m = 2 if big and (train_cfg.get("moment_dtype") or "bf16") == "bf16" else 4
    return w, m


def dtype_group(numel: int, train_cfg: dict) -> str:
    """The leaf's weight and moment dtypes, as "weights/moments": the
    optimizer updates each such group in one kernel launch."""
    w, m = leaf_dtype_bytes(numel, train_cfg)
    return "%s/%s" % (DTYPES[w], DTYPES[m])


def adamw_bytes(numels: Iterable[int], train_cfg: dict) -> int:
    total = 0
    for n in numels:
        w, m = leaf_dtype_bytes(n, train_cfg)
        total += n * (3 * w + 4 * m)
    return total


def pass_seconds(kernels: list, passes: int) -> Optional[float]:
    """The median over ``passes`` of one pass's summed kernel time, from
    the kernel events of the passes in order; None where the events do not
    split evenly into passes."""
    if not kernels or len(kernels) % passes:
        return None
    per = len(kernels) // passes
    ordered = sorted(kernels, key=lambda e: e["start"])
    return statistics.median(sum(e["end"] - e["start"] for e in ordered[i * per:(i + 1) * per])
                             for i in range(passes)) * 1e-6


def kernel_seconds(trainer, passes: int = PASSES) -> Optional[float]:
    """Median device seconds of the fused AdamW kernels of one
    ``update_and_apply`` over copies of the trainer's parameters, with L2
    flushed before each pass; None where the trace holds no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace

    dev = trainer.device
    params = [p.detach().clone() for p in trainer.model.parameters()]
    grads = [(torch.randn(p.shape, device=dev) * 1e-3).to(p.dtype) for p in params]
    state = trainer.tx.init(params)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for _ in range(3):
        state = trainer.tx.update_and_apply(grads, state, params)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(passes):
            flush.zero_()
            state = trainer.tx.update_and_apply(grads, state, params)
        torch.cuda.synchronize(dev)
    kernels = [e for e in trace.from_profiler(prof) if e["device"] and KERNEL in e["name"]]
    return pass_seconds(kernels, passes)
