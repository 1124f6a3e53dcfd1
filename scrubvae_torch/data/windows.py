"""Sliding-window start indices and the speed-outlier filter, on the host
in numpy (counterpart of ``scrubvae_tpu/data/windows.py``). Windows are
indices only; frames stay in the device-resident frame store."""

from __future__ import annotations

import numpy as np

__all__ = ["window_starts", "speed_outlier_mask"]


def window_starts(ids: np.ndarray, stride: int, window: int) -> np.ndarray:
    """Start index of every length-``window`` run of constant animal id,
    strided by ``stride``; segments shorter than the window are skipped."""
    ids = np.asarray(ids)
    boundaries = np.concatenate([[0], np.nonzero(np.diff(ids) != 0)[0] + 1, [len(ids)]])
    starts = []
    for lo, hi in zip(boundaries[:-1], boundaries[1:]):
        if hi - lo >= window:
            starts.append(np.arange(lo, hi - window + 1, stride, dtype=np.int64))
    if not starts:
        return np.zeros((0,), dtype=np.int64)
    return np.concatenate(starts)


def speed_outlier_mask(
    pose: np.ndarray, starts: np.ndarray, window: int, threshold: float = 2.25
) -> np.ndarray:
    """True for windows whose mean keypoint speed is within ``threshold``,
    from per-frame displacement prefix sums."""
    disp = np.sqrt(((np.diff(pose, axis=0) ** 2).sum(-1))).mean(-1)  # (T-1,)
    csum = np.concatenate([[0.0], np.cumsum(disp)])
    avg = (csum[starts + window - 1] - csum[starts]) / (window - 1)
    return avg <= threshold
