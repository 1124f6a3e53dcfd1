"""Step graph: device ms from one step's last stamp to the next step's
first in one epoch (the index copy and the switch between replays), the
mean over the second traced epoch's gaps (``benchmark.spans``)."""

from benchmark import spans


def read(run):
    return spans.slot_ms(run, "replay_gap")
