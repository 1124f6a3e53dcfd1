"""Three train steps of the rcnn with the low-rank sigma head
(``model.sigma_head_rank``) and with the beta prior, the port's
``Trainer`` against the JAX ``Trainer.train_step`` from the same weights,
rows and draws (JAX's sample noise; for the beta prior JAX's own gamma
draws, injected), held as ``tests/test_torch_port_branches.py`` holds its
configuration. The config keeps the heads' own losses (the prior,
rotation and root) and MALS, so the JAX step compiles fast; the jpe loss
and the other scrubbers are held by ``tests/test_torch_port_step.py``.
The heads alone are in ``tests/test_torch_port_heads.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_fit import ARENA, check_states, check_updates, run_steps, step_pair
from scrubvae_torch.train import parity

torch.set_num_threads(1)

RANK = 8  # below min(sig_dim 136, flatten 128)
MODEL = {
    "type": "rcnn", "z_dim": 16, "window": 51, "diag": False, "channel": [8, 8, 16, 16, 32],
    "kernel": 5, "prior": "gaussian", "activation": "prelu", "precision": "fp32",
}
STEPS = 3


@pytest.fixture(autouse=True)
def _highest_precision():
    jax.config.update("jax_default_matmul_precision", "highest")


def steps_config(out_path, model: dict) -> dict:
    return {
        "data": {"batch_size": 16, "dataset": "synthetic", "direction_process": "midfwd", "arena_size": ARENA.tolist()},
        "disentangle": {
            "method": {"conditional": ["avg_speed_3d", "heading"], "moving_avg_lsq": ["avg_speed_3d"]},
            "features": ["avg_speed_3d", "heading"], "alpha": 1.0,
        },
        "model": {**MODEL, **model},
        "train": {
            "lr": 1e-4, "optimizer": "adamw", "lr_schedule": "cawr", "num_epochs": 1, "seed": 0,
            "clip_norm": 0, "fused_optimizer": True, "param_dtype": "f32", "minimal_test": True,
        },
        "loss": {"rotation": 1.0, "prior": 0.001, "root": 0.01, "avg_speed_3d_mals": 0.1},
        "out_path": str(out_path),
    }


def gamma_draws(jt, row):
    """JAX's gamma draws of its next step: the model's rng is
    ``split(state.rng, 5)[1]``, split again for alpha and beta."""
    r_sample = jax.random.split(jt.state.rng, 5)[1]
    k1, k2 = jax.random.split(r_sample)
    variables = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    out, _ = jt.model.apply(variables, jt.train_ds.batch(jnp.asarray(row, jnp.int32)), rng=r_sample, train=True,
                            mutable=["batch_stats"])
    return tuple(torch.from_numpy(np.array(jax.random.gamma(k, out[n]))) for k, n in ((k1, "alpha"), (k2, "beta")))


@pytest.fixture(scope="module", params=["low_rank", "beta"])
def runs(request, tmp_path_factory):
    model = {"sigma_head_rank": RANK} if request.param == "low_rank" else {"prior": "beta"}
    jt, trainer = step_pair(steps_config(tmp_path_factory.mktemp("heads_steps"), model))
    rows = np.random.default_rng(0).integers(0, len(trainer.train_ds), (STEPS, 16))
    noise = gamma_draws if request.param == "beta" else None
    ref, port = run_steps(jt, trainer, rows, **({"noise": noise} if noise else {}))
    return request.param, ref, port


def test_three_train_steps(runs):
    """Losses at 1e-4 on step 1 and 1e-2 after; the step-1 gradients and
    weights at the bounds of ``parity``; the updates over three steps and
    the MALS state as the other step tests hold them."""
    label, ref, port = runs
    for step in range(STEPS):
        parity.check_losses(ref["losses"][step], port["losses"][step], 1e-4 if step == 0 else 1e-2)
    readings = parity.check_grads(ref["grads"], port["grads"])
    readings.update(parity.check_weights(ref["w1"], port["w1"], ref["grads"], got_grads=port["grads"]))
    readings.update(check_updates(ref, port))
    readings["states_step1"] = check_states(ref, port, 1, 1e-4)
    readings["states_step3"] = check_states(ref, port, STEPS, 1e-2)
    heads = ("fc_sigma_u", "fc_sigma_v") if label == "low_rank" else ("fc_alpha", "fc_beta")
    assert all(any(h in n for n in port["grads"]) for h in heads)
    print(f"{label}: three steps, port against JAX:", readings)
