"""Model (decoder): to the end of the VAE's forward: the conditionals, the
decoder's convolutions and the pose output; device ms a step from the
program's ``decoder`` span over the second traced epoch's replays
(``benchmark.spans``)."""

from benchmark import spans


def read(run):
    return spans.slot_ms(run, "decoder")
