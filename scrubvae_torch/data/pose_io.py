"""Pose HDF5 I/O (the port's own copy of ``read_pose_h5``,
``write_pose_h5``, ``read_key_h5``, ``write_key_h5`` and ``save_split`` of
``scrubvae_tpu/data/pose_io.py``).

File format: datasets ``pose`` (T, J, 3) float32 and ``ids`` (T,) int64.
Per-key files hold one array under its key name: ``{key}.h5`` for the
keys of ``PLAIN_KEYS``, ``{key}_{direction_process}.h5`` for the windowed
pose representations. ``h5py`` is imported when a file is read or
written, so the package imports without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

__all__ = ["PLAIN_KEYS", "key_file", "read_pose_h5", "write_pose_h5", "read_key_h5", "write_key_h5", "save_split"]

# the per-key files without a direction-process suffix; the metadata
# columns are written so but never read back (the loader derives them)
PLAIN_KEYS = ("ids", "heading", "avg_speed_3d", "offsets", "raw_pose", "pd_label", "fluorescence")


def key_file(key: str, direction_process) -> str:
    """The per-key file name of ``key``."""
    return f"{key}.h5" if key in PLAIN_KEYS else f"{key}_{direction_process}.h5"


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


def save_split(path: str | Path, data: Dict[str, np.ndarray], direction_process: str) -> None:
    """Write a preprocessed split as per-key files under ``path``; an
    (N, 1) ``fluorescence`` is stored (N,), as the reference keeps it."""
    for key, value in data.items():
        value = np.asarray(value)
        if key == "fluorescence" and value.ndim == 2 and value.shape[1] == 1:
            value = value[:, 0]
        write_key_h5(Path(path) / key_file(key, direction_process), key, value)
