"""Datasets and batch iteration (counterpart of ``WindowDataset``,
``StreamDataset``, ``epoch_batches`` and ``epoch_index_matrix`` of
``scrubvae_tpu/data/dataset.py``).

* ``WindowDataset``: materialized windows, a dict of (N, ...) tensors on
  the device (the preprocessed per-key files); a batch is an index gather.
* ``StreamDataset``: a frame store on the device; a batch assembles its
  windows from the frames, plus per-window ``extras`` gathered by index.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from scrubvae_torch.data.pipeline import FrameStore, assemble_windows
from scrubvae_torch.data.skeleton import Skeleton
from scrubvae_torch.device import resolve_device

__all__ = ["WindowDataset", "StreamDataset", "epoch_batches", "epoch_index_matrix"]


def _on_device(v, device: torch.device) -> torch.Tensor:
    """``v`` as a tensor on ``device``; float64 becomes float32, as the JAX
    package's arrays do with x64 off."""
    t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


@dataclasses.dataclass
class WindowDataset:
    """Materialized windows: ``data`` maps each key to an (N, ...) tensor on
    ``device`` (default CUDA; numpy arrays are moved there);
    ``batch(idx)`` gathers rows."""

    data: Dict[str, torch.Tensor]
    arena_size: Optional[np.ndarray]
    skeleton: Skeleton
    label: str = "train"
    discrete_classes: Optional[Dict[str, np.ndarray]] = None
    norm_params: Optional[dict] = None
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.data = {k: _on_device(v, self.device) for k, v in self.data.items()}
        if self.norm_params is not None:
            self.norm_params = {
                k: {s: _on_device(a, self.device) for s, a in stats.items()}
                for k, stats in self.norm_params.items()
            }

    def __len__(self) -> int:
        return len(next(iter(self.data.values())))

    def __getitem__(self, idx) -> Dict[str, torch.Tensor]:
        return {k: v[idx] for k, v in self.data.items()}

    @property
    def data_keys(self) -> tuple:
        return tuple(self.data)

    @property
    def n_keypts(self) -> int:
        return self.skeleton.n_keypts

    @property
    def kinematic_tree(self):
        return self.skeleton.tree

    def batch(self, idx) -> Dict[str, torch.Tensor]:
        idx = torch.as_tensor(idx, device=self.device).long()
        return {k: v[idx] for k, v in self.data.items()}


@dataclasses.dataclass
class StreamDataset:
    """Samples are window indices; ``batch(idx)`` gathers and aligns the
    windows on ``device`` (default CUDA), where the store must live.
    ``extras`` are per-window (N, ...) columns that are no frame gathers
    (the recoded ids, the parkinsons ``pd_label`` and ``fluorescence``):
    a batch takes the rows of ``idx`` of those among ``data_keys``, in
    place of anything assembled under the same key."""

    store: FrameStore
    skeleton: Skeleton
    data_keys: Sequence[str]
    direction_process: str
    arena_size: Optional[np.ndarray]
    discrete_classes: Optional[Dict[str, np.ndarray]] = None
    device: object = "cuda"
    label: str = "train"
    extras: Optional[Dict[str, torch.Tensor]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.store.device != self.device:
            raise ValueError(
                f"frame store lives on {self.store.device}, dataset asked for {self.device}: "
                "build the store with the same device"
            )
        self.extras = {k: _on_device(v, self.device) for k, v in (self.extras or {}).items()}

    def __len__(self) -> int:
        return self.store.n_windows

    @property
    def n_keypts(self) -> int:
        return self.skeleton.n_keypts

    @property
    def kinematic_tree(self):
        return self.skeleton.tree

    @property
    def norm_params(self):
        return self.store.norm_params

    def batch(self, idx) -> Dict[str, torch.Tensor]:
        """Assemble the windows whose dataset indices are ``idx`` (B,)."""
        idx = torch.as_tensor(idx, device=self.device).long()
        out = assemble_windows(
            self.store, self.skeleton.tree, self.store.starts[idx],
            tuple(k for k in self.data_keys if k not in self.extras), self.direction_process,
        )
        for k, v in self.extras.items():
            if k in self.data_keys:
                out[k] = v[idx]
        return out


def epoch_batches(
    n: int,
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    drop_last: bool = True,
) -> Iterator[np.ndarray]:
    """Per-batch dataset indices, shuffled when ``rng`` is given; with
    ``drop_last=False`` the last batch holds the ``n % batch_size`` rest."""
    order = rng.permutation(n) if rng is not None else np.arange(n)
    end = (n // batch_size) * batch_size if drop_last else n
    for lo in range(0, end, batch_size):
        yield order[lo : lo + batch_size]


def epoch_index_matrix(n: int, batch_size: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """(num_batches, batch_size) index matrix of one epoch."""
    order = rng.permutation(n) if rng is not None else np.arange(n)
    nb = n // batch_size
    return order[: nb * batch_size].reshape(nb, batch_size)
