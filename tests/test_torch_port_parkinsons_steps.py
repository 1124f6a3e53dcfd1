"""The parkinsons training config of ``chip_smoke.py``'s surface phase
(``parkinsons_config``: the flagship with fluorescence scrubbed by the
linear, MALS and gradient-reversal scrubbers beside avg_speed_3d),
narrowed to channels 8-32, z 16, batch 16 and f32: JAX's
``data_and_model`` and ``Trainer`` accept it, and two train steps of the
port's ``Trainer`` on the same per-key parkinsons files (written by the
root ``preprocess_data.py``) hold JAX's from the same weights, rows and
sample noise, as ``tests/test_torch_port_step.py`` holds the flagship's.
The data layouts themselves are in ``tests/test_torch_port_window_data.py``.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _port_fit import check_states, check_updates, flat, run_steps
from scrubvae_tpu import factory as jfactory
from scrubvae_tpu.train.trainer import Trainer as JaxTrainer
from scrubvae_torch import factory
from scrubvae_torch.train import parity
from scrubvae_torch.train.trainer import Trainer
from scrubvae_torch.utils.weights import from_jax_variables
from test_torch_port_window_data import RAW_IDS, preprocess, write_raw

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

STEPS = 2
SCRUBBED = {"moving_avg_lsq/avg_speed_3d", "moving_avg_lsq/fluorescence"}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    root = tmp_path_factory.mktemp("parkinsons")
    write_raw(root, "parkinsons", RAW_IDS)
    preprocess(root, "parkinsons", "jax")
    cfg = cs.parkinsons_config(root)
    cfg["data"]["batch_size"] = 16
    cfg["model"].update(z_dim=16, channel=[8, 8, 16, 16, 32], precision="fp32", start_epoch=0)
    cfg["train"].update(param_dtype="f32", minimal_test=True, num_epochs=1)
    cfg["out_path"] = str(root / "run")
    with jax.default_matmul_precision("highest"):
        jdata, jmodel, jinfo = jfactory.data_and_model(cfg, data_keys=cs.PARKINSONS_KEYS, use_default_val_keys=False)
        jt = JaxTrainer(cfg, jdata, jmodel, jinfo)
        tdata, model, info = factory.data_and_model(
            cfg, data_keys=cs.PARKINSONS_KEYS, use_default_val_keys=False, device="cpu"
        )
        trainer = Trainer(cfg, tdata, model, info, device="cpu")
        variables = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
        trainer.model.load_state_dict(from_jax_variables(flat(variables)), strict=True)
        rows = np.random.default_rng(0).integers(0, len(trainer.train_ds), (STEPS, 16))
        ref, port = run_steps(jt, trainer, rows)
    return ref, port


def test_parkinsons_config_steps_match_jax(steps):
    """Every loss term, fluorescence's three included, at 1e-4 on step 1
    and 1e-2 after; the step-1 gradients and weights at the bounds of
    ``parity``; the updates and the MALS states of both scrubbed features."""
    ref, port = steps
    assert {"fluorescence_lin", "fluorescence_mals", "fluorescence_gr"} <= set(ref["losses"][0])
    for step in range(STEPS):
        parity.check_losses(ref["losses"][step], port["losses"][step], 1e-4 if step == 0 else 1e-2)
    readings = parity.check_grads(ref["grads"], port["grads"])
    readings.update(parity.check_weights(ref["w1"], port["w1"], ref["grads"], got_grads=port["grads"]))
    readings.update(check_updates(ref, port))
    assert set(port["states1"]) == set(ref["states1"]) == SCRUBBED
    readings["states_step1"] = check_states(ref, port, 1, 1e-4)
    readings[f"states_step{STEPS}"] = check_states(ref, port, STEPS, 1e-2)
    print("parkinsons config, port against JAX:", readings)
