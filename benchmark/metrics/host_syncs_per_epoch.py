"""Entry: the host syncs of one untraced shuffled epoch after the profiled
slice, each operation that made the host wait for the card, as torch's
sync debug mode sees them (``benchmark.spans``); None off the card."""

from benchmark import spans


def read(run):
    return spans.counter(run, "host_syncs_per_epoch")
