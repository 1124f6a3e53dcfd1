"""Whole step: the pinned FLOPs of a step (``benchmark/flops``) times the
steps of the traced run's window outside its profiled slice, over that
window's host seconds and the card's dense bf16 peak, in percent."""


def read(run):
    if run.peak is None or not run.window_steps:
        return None
    return 100.0 * run.flops_per_step * run.window_steps / run.window_s / (run.peak["bf16_tflops"] * 1e12)
