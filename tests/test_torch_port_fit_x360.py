"""``configs/sweep/8_structural.yaml`` (x360 target, heading-free midfwd
encoder view, decoding conditional on avg_speed_3d and heading) through
the JAX package's ``train(config)`` and the port's ``train(config,
device="cpu")``, 5 epochs of one step each, from pose files of the
structured stream, at the bench's ``--small`` widths (channels
8-8-16-16-32, z 16, batch 16) with f32 compute; every other setting is the
file's. Both start from the JAX model's initial weights and draw the same
batch order (``tests/_port_fit.py``); per epoch, every column of the
port's ``metrics.csv`` lies within ``band`` relative of the JAX package's,
and the readings are printed with ``-s``.
"""

from pathlib import Path

import pytest
import torch
import yaml
from _port_fit import check_bands, read_csv, run_both, write_pose_files

from scrubvae_torch.data.synthetic import structured_pose_stream

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
EPOCHS = 5


def band(epoch: int, column: str) -> float:
    """The relative gap allowed between the port's and JAX's value of a
    ``metrics.csv`` column at ``epoch``, from this test's readings (worst
    over the 5 epochs) with a margin, as tests/test_torch_port_fit.py sets
    them:

    - epoch 1, the prior (computed from mu alone): the same weights and
      batch, so 1e-4 (read 1.1e-6);
    - the reconstruction terms but root, the prior and the total: 0.08
      (read 3.5e-2); root 0.15 (read 8.1e-2), the largest term, whose
      decoded root moves most with the sample noise;
    - the restrictiveness R^2 (different draws of the conditionals over 10
      windows of one id): heading 0.5 (read 0.23); avg_speed_3d 1.0 (read
      0.60: its R^2 is near -1e5, as the speed barely varies over those
      windows, so it swings with the draws).
    """
    if column.startswith("r2_"):
        return 1.0 if "avg_speed_3d" in column else 0.5
    if epoch == 1 and column.startswith("prior"):
        return 1e-4
    if column.startswith("root"):
        return 0.15
    return 0.08


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit_x360")
    # one step an epoch; the val split is a tail alone (seed 2: seed 1's
    # first 70 frames are all above the speed threshold)
    data = write_pose_files(
        root / "data", structured_pose_stream, (("train", 0, 100, 1), ("val", 2, 70, 1))
    )
    with open(ROOT / "configs" / "sweep" / "8_structural.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(data_path=str(data) + "/", batch_size=16)
    cfg["model"].update(channel=[8, 8, 16, 16, 32], z_dim=16, precision="fp32")
    cfg["train"].update(
        num_epochs=EPOCHS, eval_start_epoch=EPOCHS, minimal_test=True, precision="fp32", scan_epoch=False
    )
    assert (cfg["data"]["direction_process"], cfg["data"]["encoder_direction_process"]) == ("x360", "midfwd")
    return run_both(root, cfg)


def test_metrics_csv_columns_match(runs):
    paths, _ = runs
    jcols, jrows = read_csv(paths["jax"] / "metrics.csv")
    cols, rows = read_csv(paths["port"] / "metrics.csv")
    assert cols == jcols
    assert "r2_gen_restrict_heading_test" in cols
    assert [r["epoch"] for r in rows] == [r["epoch"] for r in jrows] == [str(e) for e in range(1, EPOCHS + 1)]


def test_losses_within_band_per_epoch(runs):
    check_bands(runs[0], band)


def test_the_trainer_reads_the_view(runs):
    _, trainer = runs
    for ds in (trainer.train_ds, trainer.val_ds):
        assert ds.direction_process == "x360"
        assert {"x6d_enc", "root_enc"} <= set(ds.data_keys)
    assert trainer.state.opt_state.step == EPOCHS * trainer.steps_per_epoch
