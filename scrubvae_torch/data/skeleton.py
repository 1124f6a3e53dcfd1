"""Skeleton configuration loading (the port's own copy of the part of
``scrubvae_tpu/data/skeleton.py`` the train step needs): labels, the
compiled kinematic tree and whether the yaml offsets are integers.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List

import numpy as np
import yaml

from scrubvae_torch.ops.kinematics import KinematicTree

__all__ = ["Skeleton", "load_skeleton"]


@dataclasses.dataclass(frozen=True)
class Skeleton:
    labels: List[str]
    tree: KinematicTree
    # True when the yaml OFFSET entries are integers. The reference's
    # get_segment_len (dataset.py:279-296) tiles np.array(OFFSET) KEEPING
    # that integer dtype, so its scaled-offset assignment truncates toward
    # zero — and the shipped mouse_skeleton.yaml IS integer-valued, so the
    # reference's real offsets/target_pose are integer-truncated. The
    # pipeline replicates that when this flag is set (see
    # data.pipeline.build_frame_store; deviation gate data.exact_offsets).
    int_offsets: bool = False

    @property
    def n_keypts(self) -> int:
        return len(self.labels)

    @property
    def offsets(self) -> np.ndarray:
        return self.tree.offsets


def load_skeleton(path: str | Path) -> Skeleton:
    with open(path) as f:
        cfg = yaml.safe_load(f)
    tree = KinematicTree.build(cfg["KINEMATIC_TREE"], cfg["OFFSET"])
    # dtype the reference would see: np.array of the raw yaml lists
    # (int64 for the shipped integer-valued mouse_skeleton.yaml)
    int_offsets = np.issubdtype(np.asarray(cfg["OFFSET"]).dtype, np.integer)
    return Skeleton(labels=list(cfg["LABELS"]), tree=tree, int_offsets=bool(int_offsets))
