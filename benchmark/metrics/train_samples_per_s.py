"""Entry: every sample trained in the window (whole epochs of the
trainer's shuffle, each with its loss readback) over the window's host
seconds."""


def read(run):
    return run.window_steps * run.batch / run.window_s
