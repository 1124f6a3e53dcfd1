"""Model (encoder): from the batch to the decoder's entry: the pose input,
the encoder's convolutions, the Cholesky head and the sample; device ms
a step from the program's ``encoder`` span over the second traced
epoch's replays (``benchmark.spans``)."""

from benchmark import spans


def read(run):
    return spans.slot_ms(run, "encoder")
