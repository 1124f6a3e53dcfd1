"""Device memory: ``torch.cuda.max_memory_allocated()`` over the run up to
the end of the traced slice, in GiB."""


def read(run):
    return None if run.memory_peak_bytes is None else run.memory_peak_bytes / 2**30
