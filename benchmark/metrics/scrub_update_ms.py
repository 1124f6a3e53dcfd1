"""Scrubbers (updates): the streaming scrubbers' updates, the
discriminators' inner fit, the MCMI rebuild, and the state and sums
landed in place; device ms a step from the program's ``scrub_update``
span over the second traced epoch's replays (``benchmark.spans``)."""

from benchmark import spans


def read(run):
    return spans.slot_ms(run, "scrub_update")
