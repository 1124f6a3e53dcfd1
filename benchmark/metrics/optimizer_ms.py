"""Optimizer pass: the parameters' update, the global-norm clip included;
device ms a step from the program's ``optimizer`` span over the second
traced epoch's replays (``benchmark.spans``)."""

from benchmark import spans


def read(run):
    return spans.slot_ms(run, "optimizer")
