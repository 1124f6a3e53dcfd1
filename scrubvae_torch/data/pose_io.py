"""Pose HDF5 I/O (the port's own copy of ``read_pose_h5``,
``write_pose_h5``, ``read_key_h5`` and ``write_key_h5`` of
``scrubvae_tpu/data/pose_io.py``).

File format: datasets ``pose`` (T, J, 3) float32 and ``ids`` (T,) int64.
Per-key files hold one array under its key name. ``h5py`` is imported when
a file is read or written, so the package imports without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["read_pose_h5", "write_pose_h5", "read_key_h5", "write_key_h5"]


def read_pose_h5(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as hf:
        pose = np.asarray(hf["pose"])
        ids = np.asarray(hf["ids"])
    return pose, ids


def write_pose_h5(path: str | Path, pose: np.ndarray, ids: np.ndarray) -> None:
    import h5py

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as hf:
        hf.create_dataset("pose", data=np.asarray(pose, dtype=np.float32))
        hf.create_dataset("ids", data=np.asarray(ids, dtype=np.int64))


def read_key_h5(path: str | Path, key: str) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as hf:
        return np.asarray(hf[key])


def write_key_h5(path: str | Path, key: str, value: np.ndarray) -> None:
    import h5py

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as hf:
        hf.create_dataset(key, data=value)
