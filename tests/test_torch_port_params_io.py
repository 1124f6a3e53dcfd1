"""The port's own copies of the JAX package's jax-free helpers, held to
the originals exactly: the config reader (every shipped config: the same
dict and byte-equal re-serialized ``model_config.yaml``), pose I/O (each
package reads what the other wrote, bit for bit), the structured synthetic
stream (bitwise for two seeds) and ``MetricLogger`` (the same ``log()``
calls give byte-identical ``metrics.csv`` files and equal histories, in
the cases of ``tests/test_logging.py`` and three more).
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

from scrubvae_tpu.data import pose_io as jio
from scrubvae_tpu.data.skeleton import load_skeleton as jax_load_skeleton
from scrubvae_tpu.data.synthetic import structured_pose_stream as jax_structured
from scrubvae_tpu.params import read as jread
from scrubvae_tpu.utils.logging import MetricLogger as JaxMetricLogger
from scrubvae_torch.data import pose_io as tio
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import structured_pose_stream
from scrubvae_torch.params import read
from scrubvae_torch.utils.logging import MetricLogger

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(
    str(p.relative_to(ROOT)) for d in ("ladder", "sane", "sweep") for p in (ROOT / "configs" / d).glob("*.yaml")
)


@pytest.mark.parametrize("rel", CONFIGS)
def test_config_reader_matches(tmp_path, rel):
    out = {}
    for side, reader in (("jax", jread), ("port", read)):
        run = tmp_path / side
        run.mkdir()
        shutil.copy(ROOT / rel, run / "cfg.yaml")
        cfg = reader.config(run / "cfg.yaml")
        assert cfg["out_path"] == str(run) + "/"
        for folder in ("weights", "checkpoints", "latents", "losses"):
            assert (run / folder).is_dir()
        out[side] = (cfg, (run / "model_config.yaml").read_text())
    jcfg, jtext = out["jax"]
    cfg, text = out["port"]
    strip = lambda c: {k: v for k, v in c.items() if k != "out_path"}  # noqa: E731
    assert strip(cfg) == strip(jcfg)
    assert text.replace(str(tmp_path / "port"), "RUN") == jtext.replace(str(tmp_path / "jax"), "RUN")


def test_config_reader_fills_and_derives(tmp_path):
    (tmp_path / "c.yaml").write_text(
        "data: {batch_size: 8}\ndisentangle:\n  method: {linear: [heading], moving_avg_lsq: [avg_speed_3d, heading]}\n"
        "train:\nout_path: elsewhere/\n"
    )
    cfg = read.config(tmp_path / "c.yaml", make_dirs=False)
    assert cfg["disentangle"]["features"] == ["avg_speed_3d", "heading"]
    assert cfg["train"]["minimal_test"] is None and cfg["model"]["start_epoch"] is None
    assert cfg["out_path"] == "elsewhere/" and cfg["loss"] == {}
    assert not (tmp_path / "model_config.yaml").exists()


def _pose(seed: int):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((57, 18, 3)).astype(np.float32), rng.integers(0, 4, 57)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pose_io_crosses_bitwise(tmp_path, writer):
    pose, ids = _pose(0)
    w, r = (jio, tio) if writer == "jax" else (tio, jio)
    w.write_pose_h5(tmp_path / "a" / "pose.h5", pose, ids)
    w.write_key_h5(tmp_path / "b" / "heading.h5", "heading", pose[:, :2, 0])
    for reader in (r, w):
        got_pose, got_ids = reader.read_pose_h5(tmp_path / "a" / "pose.h5")
        assert got_pose.dtype == np.float32 and got_ids.dtype == np.int64
        assert got_pose.tobytes() == pose.tobytes()
        np.testing.assert_array_equal(got_ids, ids)
        key = reader.read_key_h5(tmp_path / "b" / "heading.h5", "heading")
        assert key.dtype == np.float32 and key.tobytes() == pose[:, :2, 0].tobytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_structured_pose_stream_bitwise(seed):
    pose, ids = structured_pose_stream(load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml"), 600, 3, seed=seed)
    jpose, jids = jax_structured(jax_load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml"), 600, 3, seed=seed)
    assert pose.dtype == jpose.dtype and pose.tobytes() == jpose.tobytes()
    assert ids.dtype == jids.dtype and ids.tobytes() == jids.tobytes()


# Each case: a list of steps, ("new", kwargs) opens a logger, ("log", metrics,
# epoch) logs a row. The cases of tests/test_logging.py come first.
LOGGER_CASES = {
    "schema_growth_rewrites_with_union_header": [
        ("new", {}), ("log", {"a_train": 1.0}, 1), ("log", {"a_train": 2.0, "a_test": 3.0}, 2),
    ],
    "resume_preserves_history_across_schema_growth": [
        ("new", {}), *[("log", {"a_train": float(e)}, e) for e in range(1, 4)],
        ("log", {"a_train": 4.0, "a_test": 9.0}, 4),
        ("new", {"resume": True}), ("log", {"a_train": 5.0}, 5),
        ("log", {"a_train": 6.0, "a_test": 10.0, "b_test": 1.0}, 6),
    ],
    "fresh_run_truncates_stale_file": [
        ("new", {}), ("log", {"a_train": 1.0}, 1), ("log", {"a_train": 2.0}, 2),
        ("new", {}), ("log", {"a_train": 7.0}, 1),
    ],
    "fresh_run_history_is_float_typed": [
        ("new", {}), ("log", {"total_train": 1.5}, 1), ("new", {"resume": True}),
    ],
    "readonly_construction_never_deletes_history": [
        ("new", {}), ("log", {"a_train": 1.0}, 1), ("new", {}), ("new", {}), ("log", {"a_train": 9.0}, 1),
    ],
    "resume_drops_rows_beyond_start_epoch": [
        ("new", {}), *[("log", {"a_train": float(e)}, e) for e in range(1, 8)],
        ("new", {"resume": True, "start_epoch": 5}), ("log", {"a_train": 60.0}, 6),
    ],
    "fresh_run": [
        ("new", {}), *[("log", {"total_train": 1.0 / e, "time": 0.25 * e, "lambda_mals_x": 0.9}, e) for e in range(1, 4)],
    ],
    "schema_growth_at_a_val_epoch": [
        ("new", {}), *[("log", {"total_train": float(e)}, e) for e in range(1, 5)],
        ("log", {"total_train": 5.0, "total_test": 4.5, "r2_gen_restrict_heading_test": -0.125}, 5),
        ("log", {"total_train": 6.0}, 6),
    ],
    "resume_from_an_earlier_epoch": [
        ("new", {}), *[("log", {"total_train": float(e), **({"total_test": 1.0} if e % 5 == 0 else {})}, e) for e in range(1, 13)],
        ("new", {"resume": True, "start_epoch": 10}), ("log", {"total_train": 11.5}, 11),
    ],
}


@pytest.mark.parametrize("case", list(LOGGER_CASES))
def test_metric_logger_matches_jax(tmp_path, case):
    paths = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    loggers = {}
    for step in LOGGER_CASES[case]:
        for side, cls in (("jax", JaxMetricLogger), ("port", MetricLogger)):
            if step[0] == "new":
                loggers[side] = cls(paths[side], **step[1])
            else:
                loggers[side].log(step[1], epoch=step[2])
        assert loggers["port"].history == loggers["jax"].history
        files = [p / "metrics.csv" for p in paths.values()]
        assert [f.exists() for f in files] == [files[0].exists()] * 2
        if files[0].exists():
            assert files[1].read_bytes() == files[0].read_bytes()
