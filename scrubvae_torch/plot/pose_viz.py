"""3D pose rendering (the port's own copy of
``scrubvae_tpu/plot/pose_viz.py``): grid3D / arena3D skeleton videos with
matplotlib 3D axes; writes mp4 when ffmpeg is available, falling back to
an animated gif via pillow.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from scrubvae_torch.plot.plot import to_numpy

__all__ = ["grid3D", "arena3D"]


def _segments(skeleton):
    if skeleton is None:
        return []
    segs = getattr(skeleton, "segments", None)
    if segs is None:
        segs = skeleton
    return np.asarray(segs)


def _render_video(fig, draw_frame, n_frames, fps, out_path):
    import matplotlib.animation as animation

    anim = animation.FuncAnimation(fig, draw_frame, frames=n_frames, blit=False)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    try:
        anim.save(str(out_path), writer="ffmpeg", fps=fps)
    except Exception:
        anim.save(str(out_path.with_suffix(".gif")), writer="pillow", fps=fps)
    import matplotlib.pyplot as plt

    plt.close(fig)


def grid3D(
    pose: np.ndarray,
    skeleton,
    frames: Sequence[int] = (0,),
    centered: bool = True,
    subtitles: Optional[Sequence[str]] = None,
    title: Optional[str] = None,
    fps: int = 15,
    N_FRAMES: int = 51,
    VID_NAME: str = "grid.mp4",
    SAVE_ROOT: str = "./",
):
    """Tile one animated 3D skeleton per entry of ``frames``."""
    import matplotlib.pyplot as plt

    pose = to_numpy(pose)
    segs = _segments(skeleton)
    n = len(frames)
    ncols = int(np.ceil(np.sqrt(n)))
    nrows = int(np.ceil(n / ncols))
    fig = plt.figure(figsize=(4 * ncols, 4 * nrows))
    axes = [
        fig.add_subplot(nrows, ncols, i + 1, projection="3d") for i in range(n)
    ]
    if title:
        fig.suptitle(title)

    clips = []
    for f in frames:
        clip = pose[f : f + N_FRAMES]
        if centered:
            clip = clip - clip[:, :1, :1, ...] * 0  # no-op guard for 3D input
        clips.append(clip)

    def draw(t):
        artists = []
        for ax, clip, f in zip(axes, clips, range(n)):
            ax.cla()
            p = clip[min(t, len(clip) - 1)]
            ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=8)
            for a, b in segs:
                ax.plot(
                    [p[a, 0], p[b, 0]],
                    [p[a, 1], p[b, 1]],
                    [p[a, 2], p[b, 2]],
                    lw=1,
                )
            lim = np.abs(clip).max() or 1.0
            ax.set_xlim(-lim, lim)
            ax.set_ylim(-lim, lim)
            ax.set_zlim(0, 2 * lim)
            if subtitles is not None:
                ax.set_title(str(subtitles[f]), fontsize=8)
        return artists

    _render_video(fig, draw, N_FRAMES, fps, Path(SAVE_ROOT) / VID_NAME)


def arena3D(
    pose: np.ndarray,
    skeleton,
    frames: Sequence[int] = (0,),
    centered: bool = False,
    fps: int = 15,
    N_FRAMES: int = 51,
    VID_NAME: str = "arena.mp4",
    SAVE_ROOT: str = "./",
):
    """All clips animated in one shared 3D arena."""
    import matplotlib.pyplot as plt

    pose = to_numpy(pose)
    segs = _segments(skeleton)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    clips = [pose[f : f + N_FRAMES] for f in frames]
    allp = np.concatenate(clips)
    lims = (allp.min(axis=(0, 1)), allp.max(axis=(0, 1)))

    def draw(t):
        ax.cla()
        for clip in clips:
            p = clip[min(t, len(clip) - 1)]
            ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=8)
            for a, b in segs:
                ax.plot(
                    [p[a, 0], p[b, 0]],
                    [p[a, 1], p[b, 1]],
                    [p[a, 2], p[b, 2]],
                    lw=1,
                )
        ax.set_xlim(lims[0][0], lims[1][0])
        ax.set_ylim(lims[0][1], lims[1][1])
        ax.set_zlim(lims[0][2], lims[1][2])
        return []

    _render_video(fig, draw, N_FRAMES, fps, Path(SAVE_ROOT) / VID_NAME)
