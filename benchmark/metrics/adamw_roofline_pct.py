"""Optimizer kernel: the benchmark's byte count of one update of the
configuration's leaves (``benchmark.roofline``) over 3.35 TB/s, against
the device time of the pass's fused AdamW kernels, timed alone with L2
flushed, in percent."""

from benchmark import roofline


def read(run):
    if run.peak is None or run.trainer is None:
        return None
    seconds = roofline.kernel_seconds(run.trainer)
    if seconds is None:
        return None
    nbytes = roofline.adamw_bytes(run.leaf_numels, run.sections["train"])
    return 100.0 * nbytes / (run.peak["hbm_gb_per_s"] * 1e9) / seconds
