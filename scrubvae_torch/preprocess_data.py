"""Preprocess raw pose recordings into per-split, per-key h5 files (the
port's counterpart of the root ``preprocess_data.py``).

    python -m scrubvae_torch.preprocess_data --data_path DATA --dataset 4_mice \
        --splits train val test --window 51 --stride 2 --direction_process midfwd \
        [--speed_threshold 2.25] [--keys x6d root ...] [--exact-offsets] \
        [--part-centered-speed] [--device cuda]

For each split, ``{data_path}/{dataset}/{split}/pose.h5`` (or
``{dataset}/pose.h5``) goes through the port's frame store and window
assembly on the device (``build_frame_store``, ``materialize``), and the
windows are written beside it in the reference's per-key layout
(``pose_io.save_split``), which ``factory.mouse_data`` reads when a split
has no pose file. ``avg_speed_3d`` is written raw: the store gets the
identity speed normalization, because the loader applies the reference
dataset's mean and std when it reads the file.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["DEFAULT_KEYS", "identity_norm", "preprocess_split", "parse_args", "main"]

DEFAULT_KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids")


def identity_norm(device) -> dict:
    """The speed normalization that leaves avg_speed_3d raw."""
    return {"avg_speed_3d": {"mean": torch.zeros(3, device=device), "std": torch.ones(3, device=device)}}


def preprocess_split(
    pose: np.ndarray,
    ids: np.ndarray,
    skeleton,
    keys: Sequence[str] = DEFAULT_KEYS,
    window: int = 51,
    stride: int = 2,
    direction_process: str = "midfwd",
    speed_threshold: Optional[float] = 2.25,
    exact_offsets: bool = False,
    part_centered_speed: bool = False,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """The windows of one recording, one row per window, with raw
    avg_speed_3d: what ``save_split`` writes."""
    from scrubvae_torch.data.pipeline import build_frame_store, materialize
    from scrubvae_torch.device import resolve_device

    dev = resolve_device(device)
    store = build_frame_store(
        pose, ids, skeleton, window=window, stride=stride, speed_threshold=speed_threshold,
        norm_params=identity_norm(dev), exact_offsets=exact_offsets,
        part_centered_speed=part_centered_speed, device=dev,
    )
    return materialize(store, skeleton.tree, tuple(keys), direction_process)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    ap.add_argument("--window", type=int, default=51)
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--direction_process", default="midfwd")
    ap.add_argument("--speed_threshold", type=float, default=2.25)
    ap.add_argument("--keys", nargs="+", default=list(DEFAULT_KEYS))
    ap.add_argument("--exact-offsets", action="store_true", help="un-truncated scaled offsets")
    ap.add_argument("--part-centered-speed", action="store_true", help="true part-root speed centering")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    from scrubvae_torch.data.pose_io import read_pose_h5, save_split
    from scrubvae_torch.data.skeleton import load_skeleton

    args = parse_args(argv)
    root = Path(args.data_path)
    skeleton = load_skeleton(root / "mouse_skeleton.yaml")
    for split in args.splits:
        split_dir = root / args.dataset / split
        pose_file = split_dir / "pose.h5"
        if not pose_file.exists():
            pose_file = root / args.dataset / "pose.h5"
            if not pose_file.exists():
                print(f"[{split}] no pose.h5 found, skipping")
                continue
        pose, ids = read_pose_h5(pose_file)
        data = preprocess_split(
            pose, ids, skeleton, args.keys, args.window, args.stride, args.direction_process,
            args.speed_threshold, args.exact_offsets, args.part_centered_speed, args.device,
        )
        save_split(split_dir, data, args.direction_process)
        print(f"[{split}] wrote {len(next(iter(data.values())))} windows ({', '.join(data)}) to {split_dir}")


if __name__ == "__main__":
    main()
