"""The program's own spans and counters, read once a run after the
profiled slice: the train step's device time by layer, from the stamps a
traced step records (``scrubvae_torch.utils.profiling``), the trainer's
count of replays, and the host syncs that torch's sync debug mode sees
(``profiling.count_syncs``).

On ``run.trainer`` (as ``roofline.kernel_seconds`` works on it):

1. one shuffled epoch untraced: the replays over it and the host syncs
   in it (on the card; None elsewhere);
2. tracing on (``Trainer.set_tracing``), one epoch, which captures the
   traced step;
3. a second traced epoch, every step a replay: each slot's device ms a
   step (``replay_gap``'s over the gaps between steps) and the epoch's host
   seconds;
4. tracing off again.

A program without ``set_tracing`` (one older than its spans) gives
nothing, and the readers then return None.
"""

from __future__ import annotations

import time
from typing import Optional

# the loss weights' epoch of the extra epochs: a window epoch's
EPOCH = 2


def measure(trainer) -> dict:
    """Steps 1 to 4 of the module docstring on ``trainer``."""
    from scrubvae_torch.utils.profiling import count_syncs

    replays = trainer.replays
    with count_syncs(trainer.device) as syncs:
        trainer.train_epoch(EPOCH)
    out = {
        "host_syncs_per_epoch": syncs.n,
        "replays_pct": 100.0 * (trainer.replays - replays) / trainer.steps_per_epoch,
    }
    trainer.set_tracing(True)
    try:
        trainer.train_epoch(EPOCH)
        t0 = time.perf_counter()
        trainer.train_epoch(EPOCH)  # ends in its readback, so the device is done
        out["traced_epoch_s"] = time.perf_counter() - t0
        out["steps"] = trainer.spans.counts["data"]
        out["ms"] = trainer.spans.ms_per_step()
    finally:
        trainer.set_tracing(False)
    return out


def read(run) -> Optional[dict]:
    """``measure`` of the run's trainer, made at the first call and kept on
    ``run``; None where the program keeps no spans."""
    if "_program_spans" not in vars(run):
        trainer = run.trainer
        run._program_spans = measure(trainer) if hasattr(trainer, "set_tracing") else None
    return run._program_spans


def slot_ms(run, slot: str) -> Optional[float]:
    """The device ms a step of ``slot``; None off the card (the CPU's
    stamps time the host) or without spans."""
    got = read(run)
    if got is None or run.trainer.device.type != "cuda":
        return None
    return got["ms"][slot]


def counter(run, name: str) -> Optional[float]:
    got = read(run)
    return None if got is None else got[name]
