"""The synthetic pose stream that stands in for recordings (numpy only).

A frozen copy of the measured program's generator: per animal id, a
smooth random walk of the root through the arena with oscillating limbs
hung off the kinematic tree. The same ``seed`` gives the same stream; the
sizes depend only on ``n_frames`` and ``n_ids``.
"""

from __future__ import annotations

import numpy as np


def pose_stream(tree, n_frames: int, n_ids: int, seed: int, arena_xy: float = 250.0):
    """(pose (T, J, 3) float32, ids (T,) int64) for the kinematic ``tree``
    (``chains``, ``pos_parent``, ``offsets``)."""
    rng = np.random.default_rng(seed)
    J = len(tree.offsets)
    ids = np.repeat(np.arange(n_ids), n_frames // n_ids)[:n_frames]
    if len(ids) < n_frames:
        ids = np.concatenate([ids, np.full(n_frames - len(ids), n_ids - 1)])
    t = np.arange(n_frames)[:, None]
    heading = np.zeros(n_frames)
    speed = np.zeros(n_frames)
    for i in range(n_ids):
        m = ids == i
        n = m.sum()
        heading[m] = np.cumsum(rng.normal(0, 0.05, n)) + rng.uniform(0, 2 * np.pi)
        speed[m] = np.abs(0.5 + 0.4 * np.sin(np.arange(n) / 37.0) + rng.normal(0, 0.05, n))
    vel = np.stack([speed * np.cos(heading), speed * np.sin(heading), np.zeros(n_frames)], -1)
    root = np.cumsum(vel, axis=0)
    root[:, :2] = arena_xy * np.abs(2 * ((root[:, :2] / arena_xy / 2) % 1) - 1)
    root[:, 2] = 10.0 + 2.0 * np.sin(t[:, 0] / 11.0)
    seg_len = 8.0 + 2.0 * rng.random((n_ids, J))
    phase = rng.uniform(0, 2 * np.pi, (n_ids, J))
    pose = np.zeros((n_frames, J, 3), dtype=np.float32)
    pose[:, 0] = root
    fwd = np.stack([np.cos(heading), np.sin(heading), np.zeros(n_frames)], -1)
    up = np.asarray([0.0, 0.0, 1.0])
    left = np.cross(up, fwd)
    for chain in tree.chains:
        for j in chain[1:]:
            parent = tree.pos_parent[j]
            base = tree.offsets[j]
            wiggle = np.stack(
                [np.sin(t[:, 0] / 7.0 + phase[ids, j]), np.cos(t[:, 0] / 9.0 + phase[ids, j]),
                 0.15 * np.sin(t[:, 0] / 5.0 + phase[ids, j])], -1,
            )
            d = base[0] * fwd + base[1] * left + base[2] * up + 0.25 * wiggle
            d = d / np.linalg.norm(d, axis=-1, keepdims=True)
            pose[:, j] = pose[:, parent] + d * seg_len[ids, j][:, None]
    return pose.astype(np.float32), ids.astype(np.int64)
