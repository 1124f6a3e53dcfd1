"""Latent traversal and null-space analysis (counterpart of
``scrubvae_tpu/evals/traverse.py``): shift a latent along a linear
decoder's weight direction (or around a circle for heading), decode, run
forward kinematics, and render grid/arena videos and static traces.

The sweep is built in numpy as the JAX package builds it; decoding and FK
run in torch on the dataset's device. scipy is imported by
``project_to_null`` and matplotlib only by the branches that draw.
"""

from __future__ import annotations

import numpy as np
import torch

from scrubvae_torch.ops import kinematics as kin
from scrubvae_torch.plot.plot import to_numpy

__all__ = ["project_to_null", "traverse_latent"]


def project_to_null(z, weight):
    """Project latents onto the null space of a linear decoder weight
    (reference eval/eval.py:14-19). Returns (z @ basis, basis)."""
    import scipy.linalg as spl

    u_orth = spl.null_space(to_numpy(weight))
    return to_numpy(z) @ u_orth, u_orth


def traverse_latent(
    model,
    dataset,
    z,
    weight,
    index: int,
    label: str = "",
    minmax: float = 10.0,
    n_shifts: int = 15,
    grid_vis: bool = True,
    arena_vis: bool = True,
    static_vis: bool = False,
    circle: bool = False,
    save_path: str = "./",
    sample_index: int = 1000,
) -> np.ndarray:
    """Decode a sweep of shifted latents and render videos/traces.

    ``model`` holds its weights (a ``ScrubVAE`` or a bare VAE); it decodes
    in eval mode without gradients on ``dataset.device``, and its
    train/eval mode is restored afterwards. Returns the generated poses
    (n_shifts*window, J, 3) alongside writing any requested visualizations.
    """
    vae = getattr(model, "vae", model)
    window = vae.window
    n_keypts = dataset.n_keypts
    z = to_numpy(z)
    weight = to_numpy(weight)

    if circle:
        linspace = np.linspace(-np.pi, np.pi, n_shifts)[:, None]
        circ = np.concatenate([np.sin(linspace), np.cos(linspace)], axis=-1)
        radius = np.linalg.norm(z[index : index + 1] @ weight.T)
        z_null_proj = weight.T @ np.linalg.solve(weight @ weight.T, weight @ z[index : index + 1].T)
        circle_z = circ @ weight
        circle_z = circle_z / np.linalg.norm(circle_z, axis=-1, keepdims=True) * radius
        sample_latent = z[index : index + 1] - z_null_proj.T + circle_z
    else:
        graded = np.linspace(-minmax, minmax, n_shifts)[:, None] @ weight.sum(axis=0, keepdims=True)
        sample_latent = np.repeat(z[index : index + 1], n_shifts, axis=0) + graded

    dev = dataset.device
    sample_idx = torch.full((n_shifts,), min(sample_index, len(dataset) - 1), device=dev)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            data = dataset.batch(sample_idx)
            out = vae.decode(torch.as_tensor(sample_latent, dtype=torch.float32, device=dev), data)
            offsets = dataset.batch(torch.tensor([index], device=dev))["offsets"][0]
            pose = kin.fwd_kin_cont6d(
                out["x6d"].reshape(-1, n_keypts, 6),
                dataset.kinematic_tree,
                offsets[None].expand((n_shifts,) + offsets.shape).reshape(-1, n_keypts, 3),
                root_pos=out["root"].reshape(-1, 3),
                do_root_R=True,
            )
    finally:
        model.train(was_training)
    pose = pose.cpu().numpy()

    subtitles = sample_latent @ weight.T
    if weight.shape[0] != 1:
        subtitles = [" ".join(f"{s:.2f}" for s in np.atleast_1d(row)) for row in subtitles]
    else:
        subtitles = [f"{float(s):.2f}" for s in subtitles.squeeze()]

    if static_vis:
        from scrubvae_torch.plot import trace as plot_trace
        from scrubvae_torch.plot.constants import PLANE

        for vis_plane in ["xz", "xy"]:
            pose_trans = pose.reshape(n_shifts, window, n_keypts, 3).copy()
            pose_trans[..., PLANE[vis_plane[-1]]] += (np.linspace(-20, 20, n_shifts) * n_shifts)[:, None, None]
            plot_trace(
                pose_trans.reshape(-1, n_keypts, 3),
                dataset.skeleton,
                frames=np.arange(n_shifts) * window,
                n_full_pose=3,
                vis_plane=vis_plane,
                centered=False,
                N_FRAMES=window,
                FIG_NAME=f"{dataset.label}_trace_{index}.png",
                SAVE_ROOT=save_path,
            )

    if grid_vis:
        from scrubvae_torch.plot import pose_viz

        pose_viz.grid3D(
            pose,
            dataset.skeleton,
            frames=np.arange(n_shifts) * window,
            centered=False,
            subtitles=subtitles,
            title=f"{dataset.label} Data - {label} Traversal",
            fps=15,
            N_FRAMES=window,
            VID_NAME=f"{dataset.label}_grid{index}_mod.mp4",
            SAVE_ROOT=save_path,
        )

    if arena_vis:
        from scrubvae_torch.plot import pose_viz

        pose_viz.arena3D(
            pose,
            dataset.skeleton,
            frames=np.arange(n_shifts) * window,
            centered=False,
            fps=15,
            N_FRAMES=window,
            VID_NAME=f"{dataset.label}_arena{index}_mod.mp4",
            SAVE_ROOT=save_path,
        )

    return pose
