"""The slice as a whole: the JAX package's ``train(config)`` and the port's
``train(config, device="cpu")``, 5 epochs each, from one YAML config read
by each package's own config reader, the same pose files on disk, the
same initial weights and the same batch order (both draw
``np.random.default_rng(seed)`` permutations), at the bench's ``--small``
widths (channels 8-8-16-16-32, z 16, window 51, batch 16, f32).

The port starts from the JAX model's initial weights: they are taken from
the JAX trainer when its ``train`` calls ``fit``, and the port's weight
init is replaced by loading them (``from_jax_variables``). The train split
gives one step an epoch and the val split is a tail alone: an XLA:CPU step
at the test tier's optimisation level costs seconds.

What cannot agree bit for bit, and so is held by a band: the sample noise
of the reparameterisation (JAX's key stream against the port's
``torch.Generator``), the per-epoch re-init of the gradient-reversal heads
(the same two initializers, different random streams) and the
restrictiveness draws of the epoch-5 validation. Per epoch, every column
of the port's ``metrics.csv`` lies within ``band`` relative of the JAX
package's; the readings are printed with ``-s``.
"""

import pytest
import torch
from _port_fit import check_bands, read_csv, run_both, write_pose_files

from scrubvae_torch import factory
from scrubvae_torch.data.synthetic import synthetic_pose_stream

torch.set_num_threads(1)

EPOCHS = 5
SCRUB_TERMS = ("_gr_", "_lin_", "_mals_")


def band(epoch: int, column: str) -> float:
    """The relative gap allowed between the port's and JAX's value of a
    ``metrics.csv`` column at ``epoch``, from this test's readings (worst
    over the 5 epochs, in PERF.md) with a margin:

    - epoch 1, the terms computed from mu alone (prior, the scrubbers' and
      the MALS lambda): the same weights, batch and state, so 1e-4 (read
      2.2e-6);
    - the reconstruction terms, the prior and the total: 0.08 (read 3.9e-2,
      root excepted); root 0.15 (read 9.7e-2), the largest term, whose
      decoded root moves most with the sample noise;
    - the scrubber terms (one batch of 16 an epoch, heads re-initialized
      every epoch from different random streams): 0.6 (read 0.40);
    - the restrictiveness R^2 (different draws): 0.5 (read 0.32).
    """
    name = column + "_"
    if column.startswith("r2_"):
        return 0.5
    if epoch == 1 and (column.startswith(("prior", "lambda_")) or any(s in name for s in SCRUB_TERMS)):
        return 1e-4
    if any(s in name for s in SCRUB_TERMS):
        return 0.6
    if column.startswith("root"):
        return 0.15
    return 0.08


CONFIG = {
    "data": {
        "dataset": "synthetic", "batch_size": 16, "direction_process": "midfwd",
        "arena_size": [[-290, -290, 0], [290, 290, 120]],
    },
    "disentangle": {
        "method": {
            "conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"],
            "moving_avg_lsq": ["avg_speed_3d"], "grad_reversal": ["avg_speed_3d"],
        },
        "alpha": 1.0,
    },
    "model": {
        "type": "rcnn", "z_dim": 16, "window": 51, "channel": [8, 8, 16, 16, 32], "kernel": 5,
        "start_epoch": 0,
    },
    "train": {
        "lr": 1e-4, "optimizer": "adamw", "lr_schedule": "cawr", "num_epochs": EPOCHS, "seed": 0,
        "clip_norm": 0, "eval_start_epoch": 5, "minimal_test": True, "scan_epoch": False,
    },
    "loss": {
        "rotation": 1.0, "prior": 0.001, "root": 0.01, "jpe": 1.0,
        "avg_speed_3d_mals": 0.1, "avg_speed_3d_lin": 1.0, "avg_speed_3d_gr": 1.0,
    },
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    # one step an epoch; the val split is a tail alone
    data = write_pose_files(
        root / "data", synthetic_pose_stream, (("train", 0, 100, 1), ("val", 1, 70, 1))
    )
    return run_both(root, dict(CONFIG, data=dict(CONFIG["data"], data_path=str(data) + "/")))


def test_metrics_csv_columns_match(runs):
    paths, _ = runs
    jcols, jrows = read_csv(paths["jax"] / "metrics.csv")
    cols, rows = read_csv(paths["port"] / "metrics.csv")
    assert cols == jcols
    assert [r["epoch"] for r in rows] == [r["epoch"] for r in jrows] == [str(e) for e in range(1, EPOCHS + 1)]


def test_losses_within_band_per_epoch(runs):
    check_bands(runs[0], band)


def test_epoch5_weights_written(runs):
    paths, trainer = runs
    assert (paths["port"] / "weights" / "epoch_5.pt").exists()
    assert list(factory.all_saved_epochs(paths["port"])) == [5]
    assert trainer.state.opt_state.step == EPOCHS * trainer.steps_per_epoch
