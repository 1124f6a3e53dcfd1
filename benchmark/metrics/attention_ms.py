"""Model (attention, forward pass): the transformer's attention blocks,
each from its in-projection to its out-projection with the weights'
dropout, in every encoder and decoder layer, forward alone (their
backward is in ``backward_ms``); device ms a step from the program's
nested ``attention`` span over the second traced epoch's replays
(``benchmark.nested``). None off the card and where the program keeps no
nested spans."""

from benchmark import nested


def read(run):
    return nested.span_ms(run, "attention")
