"""Losses: the rotation, prior, jpe and root terms (the forward kinematics'
products); device ms a step from the program's ``losses`` span over the
second traced epoch's replays (``benchmark.spans``)."""

from benchmark import spans


def read(run):
    return spans.slot_ms(run, "losses")
