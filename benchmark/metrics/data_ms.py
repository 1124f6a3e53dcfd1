"""Data: the batch's assembly (``batch_fn``: the gather, the midfwd
alignment, the speed features); device ms a step from the program's
``data`` span over the second traced epoch's replays
(``benchmark.spans``)."""

from benchmark import spans


def read(run):
    return spans.slot_ms(run, "data")
