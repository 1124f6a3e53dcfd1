"""Backward: the gradients of the total; device ms a step from the
program's ``backward`` span over the second traced epoch's replays
(``benchmark.spans``)."""

from benchmark import spans


def read(run):
    return spans.slot_ms(run, "backward")
