"""Step graph: the trainer's count of graph replays over one untraced
shuffled epoch after the profiled slice, over its steps, in percent
(``benchmark.spans``)."""

from benchmark import spans


def read(run):
    return spans.counter(run, "replays_pct")
