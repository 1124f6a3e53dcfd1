"""The flagship (small widths, f32) with ``train.optimizer: sgd`` at the
default clip (``train.clip_norm`` absent: optax's global-norm clip at
1e6): two train steps of the port's ``Trainer`` against JAX's from the
same weights, rows and sample noise give the same losses and the same
first update, and the same blow-up of the root loss after one step. At
``clip_norm: 1`` the port's root loss stays where it started. This is why
``chip_smoke.py`` trains its full-width sgd run at clip 1. The optimizer
alone, on fixed gradients, is in ``tests/test_torch_port_optim_paths.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_fit import check_updates, flat, gaussian_noise, step_pair
from scrubvae_torch import bench
from scrubvae_torch.train import parity
from scrubvae_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)


def sgd_config(out_path, clip_norm=None) -> dict:
    cfg = bench.bench_config(16, 51, 16, bench.SMALL_CH, False, precision="fp32")
    cfg["train"]["optimizer"] = "sgd"
    if clip_norm is None:
        del cfg["train"]["clip_norm"]  # the default: optax's global-norm clip at 1e6
    else:
        cfg["train"]["clip_norm"] = clip_norm
    return dict(cfg, out_path=str(out_path))


def port_steps(trainer, rows, noises) -> list:
    scale = trainer.loss_scale_for_epoch(1)
    losses = []
    for row, eps in zip(rows, noises):
        trainer.state, metrics = trainer.train_step(trainer.state, torch.as_tensor(row), scale, eps=eps)
        losses.append({k: float(v) for k, v in metrics.items()})
    return losses


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Two steps of each side at the default clip and the first update of
    every leaf; six steps of the port at clip 1 from the same weights and
    noise."""
    out = tmp_path_factory.mktemp("sgd")
    jt, trainer = step_pair(sgd_config(out))
    rows = np.random.default_rng(5).integers(0, len(trainer.train_ds), (6, 16))
    p0 = flat({"params": jt.state.params})
    w0 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    scale = jt.loss_scale_for_epoch(1)
    ref, port, noises = {"losses": []}, {}, []
    for s, row in enumerate(rows[:2]):
        noises.append(gaussian_noise(jt, row))
        jt.state, metrics = jt.train_step(jt.state, jnp.asarray(row, jnp.int32), scale)
        ref["losses"].append({k: float(v) for k, v in metrics.items()})
        if s == 0:
            p1 = flat({"params": jt.state.params})
            ref["dw"] = from_jax_variables({k: p1[k] - p0[k] for k in p1})
    port["losses"] = port_steps(trainer, rows[:1], noises[:1])
    port["dw"] = {n: p.detach() - w0[n] for n, p in trainer.model.named_parameters()}
    port["losses"] += port_steps(trainer, rows[1:2], noises[1:])
    noises += [gaussian_noise(jt, row) for row in rows[2:]]
    # step_pair carries the same JAX initial weights (seed 0) into the port
    clipped = step_pair(sgd_config(out, 1.0))[1]
    return ref, port, port_steps(clipped, rows, noises)


def test_sgd_train_steps_against_jax(steps):
    """The losses at 1e-4 on step 1 and 1e-2 on step 2; the first update of
    every leaf as ``check_updates`` holds it."""
    ref, port, _ = steps
    parity.check_losses(ref["losses"][0], port["losses"][0], 1e-4)
    parity.check_losses(ref["losses"][1], port["losses"][1], 1e-2)
    readings = check_updates(ref, port)
    roots = {side: [r["root"] for r in run["losses"]] for side, run in (("jax", ref), ("port", port))}
    print("sgd at the default clip, port against JAX:", readings, "root losses:", roots)


def test_sgd_root_loss_blows_up_at_the_default_clip_and_not_at_clip_1(steps):
    """At the default clip one sgd step at lr 1e-4 on the summed losses
    (the root term about 2e6) at least triples the root loss, on both
    sides alike; at clip 1 the port's root loss stays within a factor 1.5
    of its start over six steps."""
    ref, port, clipped = steps
    for run in (ref, port):
        assert run["losses"][1]["root"] > 3 * run["losses"][0]["root"]
    roots = [r["root"] for r in clipped]
    assert roots[0] == pytest.approx(port["losses"][0]["root"], rel=1e-6)
    assert max(roots) < 1.5 * roots[0], roots
    print("sgd at clip 1, the port's root loss over six steps:", roots)
