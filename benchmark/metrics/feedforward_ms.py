"""Model (feed-forward, forward pass): the transformer's feed-forward
blocks (``linear1``, the activation, ``linear2``) in every encoder and
decoder layer, forward alone (their backward is in ``backward_ms``);
device ms a step from the program's nested ``feedforward`` span over the
second traced epoch's replays (``benchmark.nested``). None off the card
and where the program keeps no nested spans."""

from benchmark import nested


def read(run):
    return nested.span_ms(run, "feedforward")
