"""Frame-store-backed dataset whose batches assemble on the device
(counterpart of ``StreamDataset`` and ``epoch_index_matrix`` of
``scrubvae_tpu/data/dataset.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from scrubvae_torch.data.pipeline import FrameStore, assemble_windows
from scrubvae_torch.data.skeleton import Skeleton
from scrubvae_torch.device import resolve_device

__all__ = ["StreamDataset", "epoch_index_matrix"]


@dataclasses.dataclass
class StreamDataset:
    """Samples are window indices; ``batch(idx)`` gathers and aligns the
    windows on ``device`` (default CUDA), where the store must live."""

    store: FrameStore
    skeleton: Skeleton
    data_keys: Sequence[str]
    direction_process: str
    arena_size: Optional[np.ndarray]
    discrete_classes: Optional[Dict[str, np.ndarray]] = None
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.store.device != self.device:
            raise ValueError(
                f"frame store lives on {self.store.device}, dataset asked for {self.device}: "
                "build the store with the same device"
            )

    def __len__(self) -> int:
        return self.store.n_windows

    @property
    def kinematic_tree(self):
        return self.skeleton.tree

    def batch(self, idx) -> Dict[str, torch.Tensor]:
        """Assemble the windows whose dataset indices are ``idx`` (B,)."""
        idx = torch.as_tensor(idx, device=self.device).long()
        return assemble_windows(
            self.store, self.skeleton.tree, self.store.starts[idx],
            tuple(self.data_keys), self.direction_process,
        )


def epoch_index_matrix(n: int, batch_size: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(num_batches, batch_size) index matrix of one epoch."""
    order = rng.permutation(n) if rng is not None else np.arange(n)
    nb = n // batch_size
    return order[: nb * batch_size].reshape(nb, batch_size)
