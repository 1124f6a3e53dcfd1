"""Scrubbers (forward): the scrubber heads of the model's forward, and the
loss terms from MCMI to the total (every scrubber's term, total
correlation); device ms a step from the program's ``scrub_forward`` span
over the second traced epoch's replays (``benchmark.spans``)."""

from benchmark import spans


def read(run):
    return spans.slot_ms(run, "scrub_forward")
