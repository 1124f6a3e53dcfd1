"""The full scrubber stack as a whole: three train steps of the port's
``Trainer`` against three of the JAX ``Trainer.train_step``, on the method
map and losses of ``configs/ladder/5_full.yaml`` (conditional decoding;
linear, MALS, gradient-reversal and adversarial scrubbers on avg_speed_3d;
QDA on ids; mcmi and total correlation, so the dense Cholesky head) at the
bench's ``--small`` widths (channels 8-8-16-16-32, z 16, window 51, batch
16, f32), with the loss weights of epoch 26 (beta annealing gives the
prior half its weight there, where epoch 1 gives it 0).

Both start from the same weights, MALS, QDA, discriminator and MCMI states
(carried from the JAX trainer's), the same window rows, and JAX's own
sample noise and shuffles: from ``split(state.rng, 5)``, the noise is
``normal([1], mu.shape)``, the generator loss's permutation
``permutation([3], B)`` and the inner fit's ``permutation(r, B)`` for r in
``split(split([4])[1], n_iter)``.

Step 1 is held to ``scrubvae_torch.train.parity`` (its docstring gives the
bounds and why): losses at rtol 1e-4, gradients, weights, MALS, QDA and the
discriminator's parameters after its 5-step fit at 1e-4, the MCMI state
(the batch re-encoded in eval mode under the updated weights) at 1e-2; the
same encode from JAX's own step-1 weights agrees to 1e-5. Steps 2 and 3
carry the drift of the weights (1e-3 after step 1, see
``tests/test_torch_port_step.py``): losses at rtol 1e-2, after step 3 the
MALS and QDA states at 1e-2 (the forgetting factors still exactly), the
MCMI state at 5e-2, the discriminator at 0.25 per leaf and 0.1 median.
"""

import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from scrubvae_tpu import factory as jfactory
from scrubvae_tpu.data.dataset import StreamDataset as JaxStreamDataset
from scrubvae_tpu.data.pipeline import build_frame_store as jax_build_frame_store
from scrubvae_tpu.data.skeleton import load_skeleton as jax_load_skeleton
from scrubvae_tpu.train.trainer import Trainer as JaxTrainer
from scrubvae_torch import factory
from scrubvae_torch.data.dataset import StreamDataset
from scrubvae_torch.data.pipeline import build_frame_store
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.train import parity
from scrubvae_torch.train.trainer import Trainer
from scrubvae_torch.utils.weights import (
    adv_from_jax,
    from_jax_variables,
    mals_state_from_numpy,
    mi_state_from_numpy,
    qda_state_from_numpy,
)

torch.set_num_threads(1)

B, Z, STEPS, EPOCH, N_ITER = 16, 16, 3, 26, 5
KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids")
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)
FEAT = "avg_speed_3d"


def full_config(out_path) -> dict:
    """configs/ladder/5_full.yaml at the bench's --small widths, f32."""
    with open("configs/ladder/5_full.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update(batch_size=B)
    cfg["model"].update(z_dim=Z, channel=[8, 8, 16, 16, 32], precision="fp32")
    cfg["train"].update(
        num_epochs=1, precision="fp32", minimal_test=True, clip_norm=0, param_dtype="f32", mesh=None,
    )
    cfg["disentangle"]["features"] = ["avg_speed_3d", "heading"]
    cfg["out_path"] = str(out_path)
    return cfg


def flat(tree) -> dict:
    return {k: np.array(v, copy=True) for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _arrays(st, keys) -> dict:
    return {k: np.array(getattr(st, k)) for k in keys}


def _jax_states(state) -> dict:
    return {
        "mals": _arrays(state.scrub_state["moving_avg_lsq"][FEAT], parity.MALS_KEYS),
        "qda": _arrays(state.scrub_state["qda"]["ids"], parity.QDA_KEYS),
        "adv": adv_from_jax(flat(state.adv_states[FEAT].params)),
        "mi": _arrays(state.mi_state, parity.MI_KEYS),
    }


def _port_states(state) -> dict:
    return {
        "mals": {k: getattr(state.scrub_state["moving_avg_lsq"][FEAT], k).clone() for k in parity.MALS_KEYS},
        "qda": {k: getattr(state.scrub_state["qda"]["ids"], k).clone() for k in parity.QDA_KEYS},
        "adv": {k: v.detach().clone() for k, v in state.adv_states[FEAT].net.state_dict().items()},
        "mi": {k: getattr(state.mi_state, k).clone() for k in parity.MI_KEYS},
    }


def _tensors(states: dict) -> dict:
    return {
        part: {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()} for part, d in states.items()
    }


def _jax_draws(state) -> tuple:
    """The sample noise and the adversarial permutations of JAX's next step."""
    _, r_sample, _, r_adv, r_adv_fit = jax.random.split(state.rng, 5)
    eps = np.array(jax.random.normal(r_sample, (B, Z)))
    _, sub = jax.random.split(r_adv_fit)
    perms = {
        "loss": torch.from_numpy(np.array(jax.random.permutation(r_adv, B))),
        "fit": {FEAT: [torch.from_numpy(np.array(jax.random.permutation(r, B))) for r in jax.random.split(sub, N_ITER)]},
    }
    return eps, perms


def _jax_run(jt, rows) -> tuple:
    loss_scale = jt.loss_scale_for_epoch(EPOCH)
    run, draws = {"losses": []}, []
    for s in range(STEPS):
        draws.append(_jax_draws(jt.state))
        jt.state, metrics = jt.train_step(jt.state, jnp.asarray(rows[s], jnp.int32), loss_scale)
        run["losses"].append({k: float(v) for k, v in metrics.items()})
        if s == 0:
            mu = flat({"params": jt.state.opt_state.mu})
            run["grads"] = from_jax_variables({k: v / (1.0 - jt.tx.b1) for k, v in mu.items()})
            run["w1"] = from_jax_variables(flat({"params": jt.state.params}))
            bs = from_jax_variables(flat({"batch_stats": jt.state.batch_stats}))
            run["bs1"] = {k: v for k, v in bs.items() if not k.endswith("num_batches_tracked")}
        if s in (0, STEPS - 1):
            run[f"states{s + 1}"] = _tensors(_jax_states(jt.state))
    return run, draws


def _port_trainer(setup):
    cfg = setup.cfg
    model, info = factory.build_model(
        cfg["model"], cfg["disentangle"], 18, "midfwd", arena_size=ARENA,
        discrete_classes=setup.tds.discrete_classes, loss_keys=cfg["loss"].keys(), device="cpu",
    )
    trainer = Trainer(cfg, {"train": setup.tds}, model, info, device="cpu")
    trainer.model.load_state_dict(setup.weights, strict=True)
    st = trainer.state
    s0 = setup.states0
    mals = st.scrub_state["moving_avg_lsq"]
    mals[FEAT] = mals_state_from_numpy(s0["mals"], mals[FEAT])
    qda = st.scrub_state["qda"]
    qda["ids"] = qda_state_from_numpy(s0["qda"], qda["ids"])
    st.adv_states[FEAT].net.load_state_dict(s0["adv"])
    trainer.state = st.replace(mi_state=mi_state_from_numpy(s0["mi"], st.mi_state))
    return trainer


def _port_run(trainer, rows, draws) -> dict:
    names = [n for n, _ in trainer.model.named_parameters()]
    loss_scale = trainer.loss_scale_for_epoch(EPOCH)
    run = {"losses": []}
    for s in range(STEPS):
        eps, perms = draws[s]
        trainer.state, metrics = trainer.train_step(
            trainer.state, torch.as_tensor(rows[s]), loss_scale, eps=torch.from_numpy(eps), perms=perms
        )
        run["losses"].append({k: float(v) for k, v in metrics.items()})
        if s == 0:
            run["grads"] = {n: m / (1.0 - trainer.tx.b1) for n, m in zip(names, trainer.state.opt_state.mu)}
            run["w1"] = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        if s in (0, STEPS - 1):
            run[f"states{s + 1}"] = _port_states(trainer.state)
    return run


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg = full_config(tmp_path_factory.mktemp("jax_full"))
    skel = load_skeleton("configs/mouse_skeleton.yaml")
    jskel = jax_load_skeleton("configs/mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=800, n_ids=4, seed=0)
    classes = {"ids": np.unique(ids)}
    jds = JaxStreamDataset(
        jax_build_frame_store(pose, ids, jskel, window=51, stride=2), jskel, KEYS, "midfwd",
        arena_size=ARENA, discrete_classes=classes,
    )
    tds = StreamDataset(
        build_frame_store(pose, ids, skel, window=51, stride=2, device="cpu"), skel, KEYS,
        "midfwd", arena_size=ARENA, discrete_classes=classes, device="cpu",
    )
    jmodel, jinfo = jfactory.build_model(
        cfg["model"], cfg["disentangle"], n_keypts=18, direction_process="midfwd",
        arena_size=ARENA, discrete_classes=jds.discrete_classes, loss_keys=cfg["loss"].keys(),
    )
    assert not jmodel.vae.packed_sigma
    jt = JaxTrainer(cfg, {"train": jds}, jmodel, jinfo)
    return types.SimpleNamespace(
        cfg=cfg, jt=jt, tds=tds,
        weights=from_jax_variables(flat({"params": jt.state.params, "batch_stats": jt.state.batch_stats})),
        states0=_jax_states(jt.state),
        rows=np.random.default_rng(0).integers(0, len(jds), (STEPS, B)),
    )


@pytest.fixture(scope="module")
def runs(setup):
    ref, draws = _jax_run(setup.jt, setup.rows)
    trainer = _port_trainer(setup)
    assert not trainer.model.vae.packed_sigma
    port = _port_run(trainer, setup.rows, draws)
    return ref, port


@pytest.mark.parametrize("step", range(STEPS))
def test_losses_per_step(runs, step):
    ref, port = runs
    want, got = ref["losses"][step], port["losses"][step]
    assert {"avg_speed_3d_an", "ids_qda", "mcmi", "total_correlation"} <= set(want)
    if step == 0:
        # the estimator is not valid before its first refresh
        assert want["mcmi"] == got["mcmi"] == 0.0
        want, got = ({k: v for k, v in d.items() if k != "mcmi"} for d in (want, got))
    parity.check_losses(want, got, 1e-4 if step == 0 else 1e-2)


def test_step1_gradients_and_weights(runs):
    ref, port = runs
    readings = parity.check_grads(ref["grads"], port["grads"])
    readings.update(parity.check_weights(ref["w1"], port["w1"], ref["grads"]))
    print(f"full stack step 1: {readings}")
    assert readings["zero_grad_leaves"] == 24


@pytest.mark.parametrize("after", [1, STEPS])
def test_scrubber_states(runs, after):
    ref, port = runs
    want, got = ref[f"states{after}"], port[f"states{after}"]
    first = after == 1
    tol = 1e-4 if first else 1e-2
    readings = {
        "mals": parity.check_mals(want["mals"], got["mals"], tol),
        "qda": parity.check_qda(want["qda"], got["qda"], tol),
        "adv": parity.check_adv(want["adv"], got["adv"], *((1e-4,) if first else (0.25, 0.1))),
        "mi": parity.check_mi(want["mi"], got["mi"], 1e-2 if first else 5e-2),
    }
    print(f"full stack states after step {after}: {readings}")


def test_mi_refresh_from_jax_step1_weights(setup, runs):
    """The MCMI refresh alone: the port's eval-mode encode of the step-1
    batch from JAX's step-1 weights and BatchNorm statistics gives JAX's
    MCMI state to 1e-5."""
    from scrubvae_torch.train.step import encode_mi_state

    ref, _ = runs
    trainer = _port_trainer(setup)
    # the JAX trainer has run three steps: its step-1 weights as recorded
    trainer.model.load_state_dict(dict(trainer.model.state_dict(), **ref["w1"], **ref["bs1"]))
    data = setup.tds.batch(torch.as_tensor(setup.rows[0]))
    mi = encode_mi_state(trainer.model, data, trainer.model.vae.build_conditionals(data), 1.0, "sphere")
    got = {k: getattr(mi, k) for k in parity.MI_KEYS}
    r = parity.check_mi(ref["states1"]["mi"], got, 1e-5)
    assert trainer.model.training
    print(f"MCMI refresh from JAX's step-1 weights: {r:.3e}")
