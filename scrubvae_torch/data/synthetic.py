"""Synthetic mouse-like pose streams for tests and benchmarks (the port's
own copy of ``scrubvae_tpu/data/synthetic.py``; numpy only).

The reference datasets (4_mice / parkinsons h5 recordings) are not
redistributable; this generator produces kinematically consistent streams
with the same schema (pose (T, J, 3) + per-frame ids) so every pipeline
stage, model, and benchmark runs hermetically.
"""

from __future__ import annotations

import numpy as np

from scrubvae_torch.data.skeleton import Skeleton

__all__ = ["synthetic_pose_stream"]


def synthetic_pose_stream(
    skeleton: Skeleton,
    n_frames: int = 2000,
    n_ids: int = 4,
    arena_xy: float = 250.0,
    seed: int = 0,
):
    """Random smooth walk of the root through the arena with oscillating
    limbs hung off the kinematic tree. Returns (pose (T, J, 3) float32,
    ids (T,) int)."""
    rng = np.random.default_rng(seed)
    J = skeleton.n_keypts
    tree = skeleton.tree
    per_id = n_frames // n_ids
    ids = np.repeat(np.arange(n_ids), per_id)[:n_frames]
    if len(ids) < n_frames:
        ids = np.concatenate([ids, np.full(n_frames - len(ids), n_ids - 1)])

    t = np.arange(n_frames)[:, None]

    # Smooth heading + speed random walks per id
    heading = np.zeros(n_frames)
    speed = np.zeros(n_frames)
    for i in range(n_ids):
        m = ids == i
        n = m.sum()
        heading[m] = np.cumsum(rng.normal(0, 0.05, n)) + rng.uniform(0, 2 * np.pi)
        speed[m] = np.abs(
            0.5 + 0.4 * np.sin(np.arange(n) / 37.0) + rng.normal(0, 0.05, n)
        )

    vel = np.stack(
        [speed * np.cos(heading), speed * np.sin(heading), np.zeros(n_frames)], -1
    )
    root = np.cumsum(vel, axis=0)
    # Reflect into the arena
    root[:, :2] = arena_xy * np.abs(
        2 * ((root[:, :2] / arena_xy / 2) % 1) - 1
    ) * np.sign(1) - 0  # fold into [0, arena]
    root[:, 2] = 10.0 + 2.0 * np.sin(t[:, 0] / 11.0)

    # Per-id body scale and limb phase
    seg_len = 8.0 + 2.0 * rng.random((n_ids, J))
    phase = rng.uniform(0, 2 * np.pi, (n_ids, J))

    pose = np.zeros((n_frames, J, 3), dtype=np.float32)
    pose[:, 0] = root
    fwd = np.stack([np.cos(heading), np.sin(heading), np.zeros(n_frames)], -1)
    up = np.asarray([0.0, 0.0, 1.0])
    left = np.cross(up, fwd)

    for chain in tree.chains:
        for depth, j in enumerate(chain[1:], start=1):
            parent = tree.pos_parent[j]
            base_dir = skeleton.offsets[j]
            # Express the unit offset in the animal's heading frame + wiggle
            d = (
                base_dir[0] * fwd
                + base_dir[1] * left
                + base_dir[2] * up
                + 0.25
                * np.stack(
                    [
                        np.sin(t[:, 0] / 7.0 + phase[ids, j]),
                        np.cos(t[:, 0] / 9.0 + phase[ids, j]),
                        0.15 * np.sin(t[:, 0] / 5.0 + phase[ids, j]),
                    ],
                    -1,
                )
            )
            d = d / np.linalg.norm(d, axis=-1, keepdims=True)
            pose[:, j] = pose[:, parent] + d * seg_len[ids, j][:, None]

    return pose.astype(np.float32), ids.astype(np.int64)
