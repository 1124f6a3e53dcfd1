"""The preprocessed per-key layout, the parkinsons recoding and the
direction processes other than midfwd and x360, the port against the JAX
package.

- Preprocessing: one raw recording (``{dataset}/pose.h5``, so each split
  directory holds only the per-key files) through the root
  ``preprocess_data.py`` (JAX) and through ``python -m
  scrubvae_torch.preprocess_data`` (the port): the same file names, keys
  and dtypes, the windows within the tolerance of
  ``tests/test_torch_port_x360.py`` with 5e-5 as JAX's float64 distance of
  the IK-built x6d and target_pose, raw ``avg_speed_3d`` (identity
  normalization at preprocessing).
- Loading, both directions: the port's ``mouse_data`` and JAX's on the
  JAX-written files and on the port-written files, batch for batch, with
  the same discrete classes and norm params; ``avg_speed_3d`` normalized
  once, by the loader's constants.
- The parkinsons recoding, in both layouts: ``pd_label`` and
  ``fluorescence`` from the raw ids (a ``metadata.csv`` whose
  ``Fluorescence`` differs for every raw id, so an off-by-36 shows), then
  the ids recoded, and ``discrete_classes["ids"]`` = ``arange``.
- ``assemble_windows`` with another direction process (no centring, no
  rotation) against JAX's ``materialize()``, every key.
"""

import runpy
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu import factory as jfactory
from scrubvae_tpu.data.pipeline import build_frame_store as jax_build_frame_store
from scrubvae_tpu.data.pipeline import materialize as jax_materialize
from scrubvae_tpu.data.pose_io import save_split as jax_save_split
from scrubvae_torch import factory
from scrubvae_torch import preprocess_data
from scrubvae_torch.data.dataset import StreamDataset, WindowDataset
from scrubvae_torch.data.pipeline import SUPPORTED_KEYS, build_frame_store, materialize
from scrubvae_torch.data.pose_io import save_split, write_pose_h5
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from test_torch_port_x360 import JSKEL, SKEL, burst_stream, f64_noise

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARENA = [[-290, -290, 0], [290, 290, 120]]
KEYS = ["x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids"]
RAW_IDS = (0, 3, 36, 39)  # recoded 0, 3, 0, 3; pd_label 0, 0, 1, 1
FLUOR = np.round(np.linspace(1.0, 40.0, 40) ** 1.5, 3)  # one value per raw id


def _close(a: np.ndarray, b: np.ndarray, key: str, noise: float = 0.0) -> None:
    """The rule of tests/test_torch_port_x360.py."""
    assert a.shape == b.shape, (key, a.shape, b.shape)
    length = np.linalg.norm(b, axis=-1, keepdims=True) if key in ("root", "root_enc", "raw_pose") else 0.0
    assert (np.abs(a - b) <= 1e-5 + 2 * noise + 2e-6 * length).all(), (key, np.abs(a - b).max())


def write_raw(root: Path, dataset: str, raw_ids=None) -> tuple:
    """One recording at ``{dataset}/pose.h5`` (4 animals, 300 frames each),
    its ids replaced by ``raw_ids``; a parkinsons ``metadata.csv``."""
    pose, ids = synthetic_pose_stream(SKEL, n_frames=1200, n_ids=4, seed=0)
    if raw_ids is not None:
        ids = np.asarray(raw_ids)[ids]
    (root / dataset).mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", root / "mouse_skeleton.yaml")
    write_pose_h5(root / dataset / "pose.h5", pose, ids)
    rows = ["Subject,Fluorescence,Sex"] + [f"{i},{FLUOR[i]},{'MF'[i % 2]}" for i in range(40)]
    (root / dataset / "metadata.csv").write_text("\n".join(rows) + "\n")
    return pose, ids


def preprocess(root: Path, dataset: str, writer: str) -> None:
    args = ["--data_path", str(root) + "/", "--dataset", dataset, "--splits", "train", "val",
            "--direction_process", "midfwd", "--keys", *KEYS]
    if writer == "port":
        preprocess_data.main(args + ["--device", "cpu"])
        return
    argv = sys.argv
    sys.argv = ["preprocess_data.py", *args]
    try:
        runpy.run_path(str(ROOT / "preprocess_data.py"), run_name="__main__")
    finally:
        sys.argv = argv


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """{writer: data root} for the synthetic and the parkinsons data, each
    preprocessed by JAX and by the port."""
    out = {}
    for dataset, raw_ids in (("synthetic", None), ("parkinsons", RAW_IDS)):
        for writer in ("jax", "port"):
            root = tmp_path_factory.mktemp(f"{dataset}_{writer}")
            write_raw(root, dataset, raw_ids)
            preprocess(root, dataset, writer)
            out[dataset, writer] = root
    return out


def data_config(root: Path, dataset: str) -> dict:
    return {"data_path": str(root) + "/", "dataset": dataset, "direction_process": "midfwd", "arena_size": ARENA}


def test_preprocessed_files_match(layouts):
    """The same files with the same keys, dtypes and windows; avg_speed_3d
    raw on both sides."""
    import h5py

    j, p = layouts["synthetic", "jax"] / "synthetic", layouts["synthetic", "port"] / "synthetic"
    for split in ("train", "val"):
        names = sorted(f.name for f in (j / split).iterdir())
        assert names == sorted(f.name for f in (p / split).iterdir())
        assert "x6d_midfwd.h5" in names and "avg_speed_3d.h5" in names
        for name in names:
            key = name[: -len("_midfwd.h5")] if name.endswith("_midfwd.h5") else name[:-3]
            with h5py.File(j / split / name) as fj, h5py.File(p / split / name) as fp:
                a, b = np.asarray(fp[key]), np.asarray(fj[key])
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
            noise = 5e-5 if key in ("x6d", "target_pose") else 0.0
            _close(a.astype(np.float64), b.astype(np.float64), key, noise)
        with h5py.File(p / split / "avg_speed_3d.h5") as f:
            raw = np.asarray(f["avg_speed_3d"])
        assert raw.min() >= 0.0, "avg_speed_3d is written raw (speeds are non-negative)"


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dataset", ["synthetic", "parkinsons"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_per_key_loaders_agree(layouts, writer, dataset, split):
    """The port's and JAX's ``mouse_data`` on the same per-key files:
    every key of every window, the discrete classes and norm params; the
    parkinsons columns from the raw ids."""
    root = layouts[dataset, writer]
    keys = KEYS + (["pd_label", "fluorescence"] if dataset == "parkinsons" else [])
    cfg = data_config(root, dataset)
    jds = jfactory.mouse_data(cfg, split, data_keys=keys)
    tds = factory.mouse_data(cfg, split, data_keys=keys, device="cpu")
    assert isinstance(tds, WindowDataset) and len(tds) == len(jds) > 0
    assert tds.discrete_classes.keys() == jds.discrete_classes.keys()
    for k, v in jds.discrete_classes.items():
        np.testing.assert_array_equal(tds.discrete_classes[k], v, err_msg=k)
    for s in ("mean", "std"):
        np.testing.assert_array_equal(
            tds.norm_params["avg_speed_3d"][s].numpy(), np.asarray(jds.norm_params["avg_speed_3d"][s])
        )
    idx = np.arange(len(jds))
    want, got = jds.batch(jnp.asarray(idx)), tds.batch(torch.as_tensor(idx))
    assert set(got) == set(want) == set(keys)
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]).astype(got[k].numpy().dtype), err_msg=k)
    if dataset == "parkinsons":
        import h5py

        with h5py.File(root / dataset / split / "ids.h5") as f:
            raw = np.asarray(f["ids"])
        assert set(np.unique(raw)) <= set(RAW_IDS) and raw.max() >= 36
        np.testing.assert_array_equal(got["ids"].numpy(), np.where(raw >= 36, raw - 36, raw))
        np.testing.assert_array_equal(got["pd_label"].numpy()[:, 0], (raw >= 36).astype(np.int64))
        np.testing.assert_array_equal(got["fluorescence"].numpy()[:, 0], FLUOR[raw].astype(np.float32))
        np.testing.assert_array_equal(tds.discrete_classes["ids"], np.arange(len(np.unique(got["ids"].numpy()))))


def test_avg_speed_is_normalized_once(layouts):
    """The loader's avg_speed_3d is the file's raw speed through the
    reference dataset's mean and std, once."""
    import h5py

    root = layouts["synthetic", "port"]
    tds = factory.mouse_data(data_config(root, "synthetic"), "train", data_keys=KEYS, device="cpu")
    with h5py.File(root / "synthetic" / "train" / "avg_speed_3d.h5") as f:
        raw = np.asarray(f["avg_speed_3d"])
    stats = tds.norm_params["avg_speed_3d"]
    np.testing.assert_array_equal(
        tds.data["avg_speed_3d"].numpy(), (raw - stats["mean"].numpy()) / stats["std"].numpy()
    )


@pytest.fixture(scope="module")
def parkinsons_raw(tmp_path_factory):
    """The parkinsons recording as raw pose files per split."""
    root = tmp_path_factory.mktemp("parkinsons_raw")
    pose, ids = write_raw(root, "parkinsons", RAW_IDS)
    for split in ("train", "val"):
        write_pose_h5(root / "parkinsons" / split / "pose.h5", pose, ids)
    return root


def test_parkinsons_raw_pose_extras_match_jax(parkinsons_raw):
    """The raw-pose branch: a StreamDataset whose recoded ids and metadata
    columns ride as per-window extras, batch for batch as JAX's."""
    keys = KEYS + ["pd_label", "fluorescence"]
    cfg = data_config(parkinsons_raw, "parkinsons")
    jds = jfactory.mouse_data(cfg, "train", data_keys=keys)
    tds = factory.mouse_data(cfg, "train", data_keys=keys, device="cpu")
    assert isinstance(tds, StreamDataset) and set(tds.extras) == {"ids", "pd_label", "fluorescence"}
    for k, v in jds.discrete_classes.items():
        np.testing.assert_array_equal(tds.discrete_classes[k], v, err_msg=k)
    idx = np.arange(0, len(jds), 7)
    want, got = jds.batch(jnp.asarray(idx)), tds.batch(torch.as_tensor(idx))
    for k in ("ids", "pd_label", "fluorescence"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]).astype(got[k].numpy().dtype), err_msg=k)
    raw = tds.store.ids[tds.store.starts[idx] + 25].numpy()
    np.testing.assert_array_equal(got["fluorescence"].numpy()[:, 0], FLUOR[raw].astype(np.float32))
    np.testing.assert_array_equal(got["ids"].numpy(), np.where(raw >= 36, raw - 36, raw))


def test_parkinsons_layouts_agree(layouts, parkinsons_raw):
    """The same windows through the raw-pose branch and through the
    per-key files carry the same ids, pd_label and fluorescence."""
    keys = ["ids", "pd_label", "fluorescence"]
    stream = factory.mouse_data(data_config(parkinsons_raw, "parkinsons"), "train", data_keys=keys, device="cpu")
    files = factory.mouse_data(data_config(layouts["parkinsons", "port"], "parkinsons"), "train", data_keys=keys,
                               device="cpu")
    # the per-key split was cut from the whole recording, window for window
    assert len(stream) == len(files)
    a, b = stream.batch(torch.arange(len(stream))), files.batch(torch.arange(len(files)))
    for k in keys:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy().astype(a[k].numpy().dtype), err_msg=k)


def test_save_split_layout(tmp_path):
    """The port's ``save_split`` writes JAX's file names, with the (N, 1)
    fluorescence stored (N,)."""
    import h5py

    data = {k: np.zeros((5, 2), np.float32) for k in ("x6d", "root", "heading", "avg_speed_3d", "raw_pose")}
    data["fluorescence"] = np.arange(5, dtype=np.float32)[:, None]
    data["pd_label"] = np.ones((5, 1), np.int64)
    save_split(tmp_path / "port", data, "x360")
    jax_save_split(tmp_path / "jax", data, "x360")
    names = sorted(f.name for f in (tmp_path / "port").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert {"x6d_x360.h5", "root_x360.h5", "heading.h5", "fluorescence.h5"} <= set(names)
    with h5py.File(tmp_path / "port" / "fluorescence.h5") as f:
        assert f["fluorescence"].shape == (5,)


# ---------------------------------------------------------------------------
# another direction process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plain_windows():
    pose, ids = burst_stream()
    js = jax_build_frame_store(pose, ids, JSKEL, window=51, stride=2, speed_threshold=None)
    ts = build_frame_store(pose, ids, SKEL, window=51, stride=2, speed_threshold=None, device="cpu")
    want = jax_materialize(js, JSKEL.tree, SUPPORTED_KEYS, "none")
    return materialize(ts, SKEL.tree, SUPPORTED_KEYS, "none", chunk=100), want, f64_noise(ts, js, want, "none"), ts


@pytest.mark.parametrize("key", SUPPORTED_KEYS)
def test_other_direction_process_matches_jax(plain_windows, key):
    got, want, noise, _ = plain_windows
    assert set(got) == set(want) == set(SUPPORTED_KEYS)
    assert got[key].dtype == want[key].dtype
    _close(got[key], want[key], key, noise.get(key, 0.0))


def test_other_direction_process_centres_and_rotates_nothing(plain_windows):
    got, _, _, ts = plain_windows
    root = ts.pose[:, 0, :][ts.starts[:, None] + torch.arange(51)].numpy()
    np.testing.assert_array_equal(got["root"], root)
    np.testing.assert_array_equal(got["x6d"], ts.x6d[ts.starts[:, None] + torch.arange(51)].numpy())
