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

__all__ = ["synthetic_pose_stream", "structured_pose_stream"]


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


def structured_pose_stream(
    skeleton: Skeleton,
    n_frames: int = 2000,
    n_ids: int = 4,
    arena_xy: float = 250.0,
    seed: int = 0,
    speed_scale: float = 1.0,
):
    """Pose stream with *real* pose<->factor mutual information, for
    demonstrating the conditioning/scrubbing paths in a sane regime
    (reference regime: real mice, where gait couples to locomotion speed).

    Couplings baked in:
    - **speed -> gait**: limb oscillation amplitude grows with instantaneous
      speed and the gait phase advances with distance travelled (stride
      cadence proportional to speed), so a window of yaw-aligned pose
      carries strong information about ``avg_speed_3d``.
    - **heading**: smooth random walk; the root path and within-window
      turning reflect it (absolute heading is removed from aligned pose by
      the midfwd process itself).
    - **ids**: per-id body scale (segment lengths), limb phase offsets, and
      baseline cadence, so identity stays decodable from shape and style.

    Returns (pose (T, J, 3) float32, ids (T,) int64).
    """
    rng = np.random.default_rng(seed)
    J = skeleton.n_keypts
    tree = skeleton.tree
    per_id = n_frames // n_ids
    ids = np.repeat(np.arange(n_ids), per_id)[:n_frames]
    if len(ids) < n_frames:
        ids = np.concatenate([ids, np.full(n_frames - len(ids), n_ids - 1)])

    t = np.arange(n_frames, dtype=np.float64)

    # Smooth per-id heading random walk; slowly varying speed with a wide
    # dynamic range (bouts of near-rest and fast locomotion).
    heading = np.zeros(n_frames)
    speed = np.zeros(n_frames)
    for i in range(n_ids):
        m = ids == i
        n = m.sum()
        heading[m] = np.cumsum(rng.normal(0, 0.04, n)) + rng.uniform(0, 2 * np.pi)
        # log-speed random walk, mean-reverting, then smoothed
        ls = np.zeros(n)
        for k in range(1, n):
            ls[k] = 0.995 * ls[k - 1] + rng.normal(0, 0.08)
        # speed_scale calibrates the stream's avg_speed_3d distribution to
        # the reference's hardcoded normalization stats (get/data.py:58-67,
        # mean ~[.50,.71,.67], std ~[.40,.36,.42]) so the gen-restrict
        # speed-jitter clamps (eval/eval.py:41-56) operate in their
        # intended range on synthetic data.
        spd = np.exp(ls) * 0.8 * speed_scale
        kern = np.ones(9) / 9.0
        speed[m] = np.convolve(spd, kern, mode="same")

    vel = np.stack(
        [speed * np.cos(heading), speed * np.sin(heading), np.zeros(n_frames)], -1
    )
    root = np.cumsum(vel, axis=0)
    root[:, :2] = arena_xy * np.abs(2 * ((root[:, :2] / arena_xy / 2) % 1) - 1)
    root[:, 2] = 10.0 + 0.6 * speed * np.sin(t / 4.0)  # bob scales with speed

    # Identity signatures
    seg_len = 8.0 + 2.0 * rng.random((n_ids, J))
    phase = rng.uniform(0, 2 * np.pi, (n_ids, J))
    cadence = 0.8 + 0.4 * rng.random(n_ids)  # strides per unit distance

    # Gait phase advances with distance travelled: cadence ~ speed.
    dist = np.zeros(n_frames)
    for i in range(n_ids):
        m = ids == i
        dist[m] = np.cumsum(speed[m])
    gait = 2.0 * np.pi * cadence[ids] * dist

    # Limb swing amplitude modulated by speed (clipped so slow frames still
    # move a little and the unit-normalization below stays well-conditioned)
    amp = np.clip(0.08 + 0.45 * speed, 0.0, 1.2)

    pose = np.zeros((n_frames, J, 3), dtype=np.float64)
    pose[:, 0] = root
    fwd = np.stack([np.cos(heading), np.sin(heading), np.zeros(n_frames)], -1)
    up = np.asarray([0.0, 0.0, 1.0])
    left = np.cross(up, fwd)

    for chain in tree.chains:
        for depth, j in enumerate(chain[1:], start=1):
            parent = tree.pos_parent[j]
            base_dir = skeleton.offsets[j]
            # alternate limbs half a cycle apart; spine joints barely swing
            swing = amp * np.sin(gait + phase[ids, j])
            lift = 0.5 * amp * np.abs(np.cos(gait + phase[ids, j]))
            is_limb = depth >= 2
            scale = 1.0 if is_limb else 0.25
            d = (
                base_dir[0] * fwd
                + base_dir[1] * left
                + base_dir[2] * up
                + scale
                * np.stack([swing * 0.4, swing, lift * 0.3], -1)[..., [1, 0, 2]]
            )
            d = d / np.linalg.norm(d, axis=-1, keepdims=True)
            pose[:, j] = pose[:, parent] + d * seg_len[ids, j][:, None]

    return pose.astype(np.float32), ids.astype(np.int64)
