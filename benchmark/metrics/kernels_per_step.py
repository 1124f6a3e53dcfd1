"""Step graph: kernel events in the profiled slice over its steps (copies
and fills counted apart)."""


def read(run):
    return None if run.slice is None else run.slice["kernels_per_step"]
