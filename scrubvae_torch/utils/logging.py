"""Metric sinks (the port's own copy of ``MetricLogger`` of
``scrubvae_tpu/utils/logging.py``): CSV always; wandb when asked for and
importable.

The reference logs only to wandb (trainer.py:514); the CSV sink keeps runs
hermetic with the same flat metric names (*_train / *_test / r2_* /
lambda_* / time).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Optional

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(
        self,
        out_path: str,
        use_wandb: bool = False,
        wandb_run=None,
        resume: bool = False,
        start_epoch: Optional[int] = None,
    ):
        self.path = Path(out_path) / "metrics.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fieldnames = None
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb_run or wandb
            except ImportError:
                self._wandb = None
        self.history: Dict[str, list] = {}
        self._rows: list = []
        # A fresh run into a folder with a stale metrics.csv starts over,
        # as the weights files are overwritten epoch by epoch. Deferred to
        # the first log() so read-only constructions never delete a run's
        # history.
        self._truncate_on_first_log = not resume and self.path.exists()
        if resume and self.path.exists():
            # A resumed run adopts the existing rows, so the schema-growth
            # rewrite below keeps the history before the resume. Rows beyond
            # start_epoch are dropped: those epochs are logged again.
            with open(self.path, newline="") as f:
                reader = csv.DictReader(f)
                if reader.fieldnames:
                    self._fieldnames = list(reader.fieldnames)
                    for row in reader:
                        row = {
                            k: _int_or_scalar(v) if k == "epoch" else _scalar(v)
                            for k, v in row.items()
                        }
                        if (
                            start_epoch is not None
                            and isinstance(row.get("epoch"), int)
                            and row["epoch"] > start_epoch
                        ):
                            continue
                        self._rows.append(row)
                        for k, v in row.items():
                            self.history.setdefault(k, []).append(v)
            if start_epoch is not None:
                # rewrite now, so the dropped rows are gone even if the
                # process dies before the first log()
                with open(self.path, "w", newline="") as f:
                    writer = csv.DictWriter(f, fieldnames=self._fieldnames or [])
                    if self._fieldnames:
                        writer.writeheader()
                        writer.writerows(self._rows)

    def log(self, metrics: Dict[str, float], epoch: Optional[int] = None):
        if self._truncate_on_first_log:
            self._truncate_on_first_log = False
            if self.path.exists():
                self.path.unlink()
        row = {"epoch": epoch, **{k: _scalar(v) for k, v in metrics.items()}}
        self._rows.append(row)
        for k, v in row.items():
            self.history.setdefault(k, []).append(v)
        if self._fieldnames is None:
            self._fieldnames = list(row.keys())
        extra = [k for k in row if k not in self._fieldnames]
        if extra:
            # The schema grew (the first val epoch adds *_test columns):
            # rewrite the file with the union header instead of appending a
            # second header mid-file.
            self._fieldnames += extra
            with open(self.path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._fieldnames)
                writer.writeheader()
                writer.writerows(self._rows)
        else:
            new_file = not self.path.exists()
            with open(self.path, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._fieldnames)
                if new_file:
                    writer.writeheader()
                writer.writerow(row)
        if self._wandb is not None:
            self._wandb.log(metrics, step=epoch)


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def _int_or_scalar(v):
    try:
        return int(v)
    except (TypeError, ValueError):
        return _scalar(v)
