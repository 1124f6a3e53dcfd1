"""The program's nested spans (``scrubvae_torch.utils.profiling.NESTED``):
each span's device ms a step over the second traced epoch of
``benchmark.spans.measure``, taken once, right after those epochs, and
kept on ``run`` beside the slots' ``benchmark.spans.read``. The nested
spans time the forward pass alone.

A program without nested spans (one older than them) gives nothing, and
the readers then return None, as they do off the card (the CPU's spans
time the host)."""

from __future__ import annotations

from typing import Optional

from benchmark import spans


def read(run) -> Optional[dict]:
    """Each nested span's ms a step, made at the first call and kept on
    ``run``; None where the program keeps no spans or no nested ones."""
    if "_nested_spans" not in vars(run):
        got = spans.read(run)
        nested = getattr(run.trainer.spans, "nested_ms_per_step", None) if got is not None else None
        run._nested_spans = None if nested is None else nested()
    return run._nested_spans


def span_ms(run, span: str) -> Optional[float]:
    """The device ms a step of nested ``span``; None off the card or
    without nested spans."""
    got = read(run)
    if got is None or run.trainer.device.type != "cuda":
        return None
    return got[span]
