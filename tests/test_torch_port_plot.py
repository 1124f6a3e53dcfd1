"""The port's renderers (``scrubvae_torch/plot``) against the JAX
package's (``scrubvae_tpu/plot``) on the same inputs, on the CPU: every
PNG equal pixel for pixel (``matplotlib.image.imread``), every video (a gif
where ffmpeg is missing, as here) with the same frame count, size and
frames. The port is given tensors where the JAX package is given arrays."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.image as mpimg  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from scrubvae_tpu import plot as jplot  # noqa: E402
from scrubvae_tpu.data.skeleton import load_skeleton as jax_load_skeleton  # noqa: E402
from scrubvae_torch import plot as tplot  # noqa: E402
from scrubvae_torch.data.skeleton import load_skeleton  # noqa: E402
from scrubvae_torch.data.synthetic import synthetic_pose_stream  # noqa: E402

SKEL = load_skeleton("configs/mouse_skeleton.yaml")
JSKEL = jax_load_skeleton("configs/mouse_skeleton.yaml")
POSE = synthetic_pose_stream(SKEL, n_frames=140, n_ids=1, seed=3)[0].astype(np.float32)
RNG = np.random.default_rng(0)
FEATURE = RNG.normal(size=(200, 1))
LABELS = RNG.integers(0, 3, size=200)
EMBED = RNG.normal(size=(100, 2))
VALUES = RNG.normal(size=100)
LOSSES = {
    "total": [3.0, 2.0, 1.0],
    "rotation": [2.0, 1.5, 1.0],
    "avg_speed_3d": [0.2, 0.1, 0.05],
    "mcmi": [-0.1, -0.2, -0.3],
}


def _png_equal(a, b):
    x, y = mpimg.imread(a), mpimg.imread(b)
    assert x.shape == y.shape and x.shape[0] > 50
    np.testing.assert_array_equal(x, y)


def _video(path):
    """(frame count, size, frames) of the video written at ``path``: the
    mp4 if ffmpeg wrote one, else the gif fallback."""
    if path.with_suffix(".gif").exists():
        path = path.with_suffix(".gif")
    with Image.open(path) as im:
        frames = []
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB")))
        return im.n_frames, im.size, np.stack(frames)


def _videos_equal(a, b):
    na, sa, fa = _video(a)
    nb, sb, fb = _video(b)
    assert (na, sa) == (nb, sb) and na > 1
    np.testing.assert_array_equal(fa, fb)


PNG_CASES = {
    "trace": lambda m, skel, t, root: m.trace(
        t(POSE), skel, frames=[0, 40], N_FRAMES=30, FIG_NAME="t.png", SAVE_ROOT=root),
    "trace_xy": lambda m, skel, t, root: m.trace(
        t(POSE), skel, frames=[10], n_full_pose=2, vis_plane="xy", centered=False, N_FRAMES=20,
        FIG_NAME="t.png", SAVE_ROOT=root),
    "feature_ridge": lambda m, skel, t, root: m.feature_ridge(
        t(FEATURE), t(LABELS), feature_name="speed", FIG_NAME="t.png", SAVE_ROOT=root),
    "scatter_cmap": lambda m, skel, t, root: m.scatter_cmap(
        t(EMBED), t(VALUES), label="speed", FIG_NAME="t.png", SAVE_ROOT=root),
}


def _as_tensor(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("name", sorted(PNG_CASES))
def test_png_renderers_match_jax(name, tmp_path):
    fn = PNG_CASES[name]
    want = fn(jplot, JSKEL, np.asarray, str(tmp_path / "jax"))
    got = fn(tplot, SKEL, _as_tensor, str(tmp_path / "port"))
    assert got.endswith("t.png") and want.endswith("t.png")
    _png_equal(got, want)


def test_loss_curves_match_jax(tmp_path):
    want = jplot.eval_plots.loss(LOSSES, str(tmp_path / "jax") + "/", disentangle_keys=("avg_speed_3d",))
    got = tplot.eval_plots.loss(
        {k: torch.tensor(v, dtype=torch.float64) for k, v in LOSSES.items()}, str(tmp_path / "port") + "/",
        disentangle_keys=("avg_speed_3d",),
    )
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] == ["vae.png", "disentangle.png", "mcmi.png"]
    for a, b in zip(got, want):
        _png_equal(a, b)


@pytest.mark.parametrize("name", ["grid3D", "arena3D"])
def test_video_renderers_match_jax(name, tmp_path):
    kw = dict(frames=[0, 30], N_FRAMES=3, fps=5, VID_NAME="v.mp4")
    if name == "grid3D":
        kw["subtitles"] = ["a", "b"]
        kw["title"] = "traversal"
    getattr(jplot.pose_viz, name)(POSE, JSKEL, SAVE_ROOT=str(tmp_path / "jax"), **kw)
    getattr(tplot.pose_viz, name)(torch.from_numpy(POSE), SKEL, SAVE_ROOT=str(tmp_path / "port"), **kw)
    _videos_equal(tmp_path / "port" / "v.mp4", tmp_path / "jax" / "v.mp4")


def test_sample_clusters_matches_jax(tmp_path):
    ids = np.asarray([0, 1, 0, 1, 1])
    want = jplot.sample_clusters(POSE, ids, JSKEL, n_samples=2, window=3, SAVE_ROOT=str(tmp_path / "jax") + "/")
    got = tplot.sample_clusters(
        torch.from_numpy(POSE), torch.from_numpy(ids), SKEL, n_samples=2, window=3,
        SAVE_ROOT=str(tmp_path / "port") + "/",
    )
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] == ["cluster_0.mp4", "cluster_1.mp4"]
    for a, b in zip(got, want):
        _videos_equal(tmp_path / "port" / a.split("/")[-1], tmp_path / "jax" / b.split("/")[-1])


def test_skeleton_segments_match_jax():
    np.testing.assert_array_equal(SKEL.segments, JSKEL.segments)
    assert SKEL.segments.dtype == JSKEL.segments.dtype and len(SKEL.segments) > 0
