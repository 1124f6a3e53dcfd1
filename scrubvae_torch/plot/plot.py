"""Plot utilities (the port's own copy of ``scrubvae_tpu/plot/plot.py``):
skeleton ghost-trail traces, per-cluster tiled pose videos, ridgeline
feature distributions, colored scatter embeddings. Arrays may be numpy
arrays or tensors on any device; matplotlib is imported when a function
draws.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

import torch

from scrubvae_torch.plot.constants import PALETTE_2, PLANE

__all__ = ["trace", "sample_clusters", "feature_ridge", "scatter_cmap"]


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def trace(
    pose: np.ndarray,
    skeleton,
    frames: Sequence[int] = (0,),
    n_full_pose: int = 3,
    vis_plane: str = "xz",
    centered: bool = True,
    N_FRAMES: int = 51,
    dpi: int = 100,
    FIG_NAME: str = "trace.png",
    SAVE_ROOT: str = "./",
):
    """Ghost-trail 2D projection of pose sequences: faint full trajectories
    plus a few opaque full skeletons per clip."""
    import matplotlib.pyplot as plt

    pose = to_numpy(pose)
    segs = np.asarray(getattr(skeleton, "segments", skeleton))
    ax_i = [PLANE[c] for c in vis_plane]
    fig, ax = plt.subplots(figsize=(12, 6), dpi=dpi)
    for ci, f in enumerate(frames):
        clip = pose[f : f + N_FRAMES]
        color = PALETTE_2[ci % len(PALETTE_2)]
        keypt_trails = clip[:, :, ax_i]
        for j in range(keypt_trails.shape[1]):
            ax.plot(
                keypt_trails[:, j, 0],
                keypt_trails[:, j, 1],
                color=color,
                alpha=0.15,
                lw=0.5,
            )
        for t in np.linspace(0, len(clip) - 1, n_full_pose).astype(int):
            p = clip[t][:, ax_i]
            for a, b in segs:
                ax.plot(
                    [p[a, 0], p[b, 0]], [p[a, 1], p[b, 1]], color=color, lw=1.2
                )
    ax.set_xlabel(vis_plane[0])
    ax.set_ylabel(vis_plane[1])
    ax.set_aspect("equal")
    out = Path(SAVE_ROOT) / FIG_NAME
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    return str(out)


def sample_clusters(
    pose: np.ndarray,
    cluster_ids: np.ndarray,
    skeleton,
    n_samples: int = 9,
    window: int = 51,
    clusters: Optional[Sequence[int]] = None,
    fps: int = 15,
    SAVE_ROOT: str = "./clusters/",
    seed: int = 0,
):
    """Per-cluster tiled pose videos (reference sample_clusters): sample up
    to n_samples windows per GMM cluster and render a grid video each."""
    from scrubvae_torch.plot.pose_viz import grid3D

    rng = np.random.default_rng(seed)
    cluster_ids = to_numpy(cluster_ids)
    clusters = clusters if clusters is not None else np.unique(cluster_ids)
    out_paths = []
    for c in clusters:
        members = np.nonzero(cluster_ids == c)[0]
        if len(members) == 0:
            continue
        chosen = rng.choice(members, size=min(n_samples, len(members)), replace=False)
        grid3D(
            pose,
            skeleton,
            frames=[int(i) * window for i in chosen],
            centered=True,
            title=f"Cluster {c}",
            fps=fps,
            N_FRAMES=window,
            VID_NAME=f"cluster_{c}.mp4",
            SAVE_ROOT=SAVE_ROOT,
        )
        out_paths.append(str(Path(SAVE_ROOT) / f"cluster_{c}.mp4"))
    return out_paths


def feature_ridge(
    feature: np.ndarray,
    labels: np.ndarray,
    feature_name: str = "feature",
    FIG_NAME: str = "ridge.png",
    SAVE_ROOT: str = "./",
):
    """Ridgeline-style stacked density plot of a feature per label
    (reference feature_ridge uses seaborn FacetGrid; rendered directly with
    matplotlib so seaborn stays optional)."""
    import matplotlib.pyplot as plt

    feature = to_numpy(feature)
    feature = feature.reshape(len(feature), -1)[:, 0]
    labels = to_numpy(labels).reshape(-1)
    uniq = np.unique(labels)
    fig, axes = plt.subplots(
        len(uniq), 1, figsize=(8, 1.2 * len(uniq)), sharex=True
    )
    if len(uniq) == 1:
        axes = [axes]
    lo, hi = np.percentile(feature, [0.5, 99.5])
    grid = np.linspace(lo, hi, 200)
    for ax, u in zip(axes, uniq):
        vals = feature[labels == u]
        if len(vals) > 1:
            bw = max(vals.std() * (len(vals) ** (-1 / 5)), 1e-6)
            dens = np.exp(
                -0.5 * ((grid[:, None] - vals[None, :]) / bw) ** 2
            ).sum(1) / (len(vals) * bw * np.sqrt(2 * np.pi))
            color = PALETTE_2[int(u) % len(PALETTE_2)]
            ax.fill_between(grid, dens, alpha=0.6, color=color)
        ax.set_yticks([])
        ax.set_ylabel(str(u), rotation=0, ha="right")
    axes[-1].set_xlabel(feature_name)
    out = Path(SAVE_ROOT) / FIG_NAME
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return str(out)


def scatter_cmap(
    embedding: np.ndarray,
    values: np.ndarray,
    label: str = "value",
    FIG_NAME: str = "scatter.png",
    SAVE_ROOT: str = "./",
    s: float = 1.0,
):
    """2D embedding scatter colored by a continuous value."""
    import matplotlib.pyplot as plt

    embedding = to_numpy(embedding)
    fig, ax = plt.subplots(figsize=(8, 8))
    sc = ax.scatter(
        embedding[:, 0], embedding[:, 1], c=to_numpy(values).ravel(), s=s,
        cmap="viridis",
    )
    fig.colorbar(sc, label=label)
    out = Path(SAVE_ROOT) / FIG_NAME
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out)
    plt.close(fig)
    return str(out)
