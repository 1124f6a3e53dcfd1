"""The full scrubber stack's trajectory: the JAX package's ``train(config)``
and the port's ``train(config, device="cpu")`` on
``configs/ladder/5_full.yaml`` (QDA on ids; linear, MALS, gradient-reversal
and adversarial scrubbers on avg_speed_3d; mcmi and total correlation, so
the dense Cholesky head) at the bench's ``--small`` widths (channels
8-8-16-16-32, z 16, window 51, batch 16, f32) for 5 epochs, from the same
YAML config, pose files, initial weights and batch order
(``tests/_port_fit.py``). Two ids with one step an epoch; no validation
epoch (the step's own MCMI refresh runs every step; the validation losses
are held by ``tests/test_torch_port_eval.py``), which keeps the JAX side to
one compiled train step.

What cannot agree bit for bit, and so is held by a band per column: the
sample noise, the adversarial shuffles and the discriminator's init (JAX's
key stream against the port's generators), the gradient-reversal re-init
and the restrictiveness draws. The columns the full stack adds have bands
of their own: the generator loss of the adversarial scrubber
(``avg_speed_3d_an``), QDA's loss on the ids (``ids_qda``) and its
forgetting factor (``lambda_qda_ids``).
"""

import pytest
import torch
import yaml
from _port_fit import ROOT, check_bands, read_csv, run_both, write_pose_files

from scrubvae_torch.data.synthetic import synthetic_pose_stream

torch.set_num_threads(1)

EPOCHS = 5
SCRUB_TERMS = ("_gr_", "_lin_")


def band(epoch: int, column: str) -> float:
    """The relative gap allowed between the port's and JAX's value of a
    ``metrics.csv`` column at ``epoch``, from this test's readings (worst
    over the 5 epochs, in PERF.md) with a margin:

    - epoch 1, the terms computed from mu alone (the prior, the linear,
      gradient-reversal and MALS terms, the lambdas): the same weights,
      batch and state, so 1e-4 (read 1.4e-6);
    - the adversarial generator loss ``avg_speed_3d_an``: 0.05 (read
      1.5e-2); QDA's loss on the ids, ``ids_qda``: 0.3 (read 0.13); its
      forgetting factor ``lambda_qda_ids``: 1e-2, two steps of its delta
      (read equal at every epoch);
    - ``mcmi``: 0.01 (read 1.9e-3); ``total_correlation``: 0.05 (read
      1.3e-2);
    - the reconstruction terms, the prior and the total: 0.1 (read 4.1e-2,
      root excepted); root 0.2 (read 9.8e-2);
    - the linear and gradient-reversal terms (one batch of 16 an epoch,
      heads re-initialized every epoch from different random streams): 0.75
      (read 0.37); the MALS term, a fit of a few batches of 16 that nearly
      vanishes (0.18 to 0.47): 3 (read 1.40).
    """
    name = column + "_"
    if epoch == 1 and (column.startswith(("prior", "lambda_")) or any(s in name for s in SCRUB_TERMS + ("_mals_",))):
        return 1e-4
    if column.startswith("avg_speed_3d_an"):
        return 0.05
    if column.startswith("ids_qda"):
        return 0.3
    if column == "lambda_qda_ids":
        return 1e-2
    if column.startswith("mcmi"):
        return 0.01
    if column.startswith("total_correlation"):
        return 0.05
    if "_mals_" in name:
        return 3.0
    if any(s in name for s in SCRUB_TERMS):
        return 0.75
    if column.startswith("root"):
        return 0.2
    return 0.1


def full_config(data) -> dict:
    with open(ROOT / "configs" / "ladder" / "5_full.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(data_path=str(data) + "/", batch_size=16)
    cfg["model"].update(z_dim=16, channel=[8, 8, 16, 16, 32], start_epoch=0)
    cfg["train"].update(
        num_epochs=EPOCHS, precision="fp32", eval_start_epoch=EPOCHS + 1, minimal_test=True, scan_epoch=False,
        clip_norm=0,
    )
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit_full")
    # two ids of 80 frames: 30 windows, one step an epoch
    data = write_pose_files(root / "data", synthetic_pose_stream, (("train", 0, 160, 2), ("val", 1, 140, 2)))
    return run_both(root, full_config(data))


def test_metrics_csv_columns_match(runs):
    paths, _ = runs
    jcols, jrows = read_csv(paths["jax"] / "metrics.csv")
    cols, rows = read_csv(paths["port"] / "metrics.csv")
    assert cols == jcols
    assert {"avg_speed_3d_an_train", "ids_qda_train", "lambda_qda_ids", "mcmi_train"} <= set(cols)
    assert [r["epoch"] for r in rows] == [str(e) for e in range(1, EPOCHS + 1)]


def test_losses_within_band_per_epoch(runs):
    worst = check_bands(runs[0], band)
    assert {"avg_speed_3d_an_train", "ids_qda_train", "lambda_qda_ids"} <= set(worst)
