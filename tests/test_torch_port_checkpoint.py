"""The port's checkpoints, resume, per-epoch GR re-init, divergence
tripwire and CLI, on the CPU at a small size (channels 8-8-16-16-32, z 32,
window 51, batch 16, bf16 compute and bf16 storage: ``fc_sigma`` is the one
leaf of at least 65536 elements, so one leaf and its moments are bf16).

Everything here is held bitwise: a save and a load copy tensors, they do
not compute. The reference-layout ``.pth`` fallback is held against
``from_jax_variables`` on the weights of a JAX model.
"""

import csv
import shutil
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from scrubvae_torch import factory
from scrubvae_torch.data.pose_io import write_pose_h5
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.params import read
from scrubvae_torch.train.trainer import Trainer, train
from scrubvae_torch.train_model import main
from scrubvae_torch.utils import checkpoint as ckpt
from scrubvae_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MALS_FIELDS = ("Sxx0", "Sxy0", "Sxx1", "Sxy1", "lam0", "lam1")


def write_data(root: Path) -> Path:
    """Raw pose files of a train split (2 ids, 3 steps an epoch at batch
    16) and a val split of one partial batch, with the skeleton."""
    data = root / "data"
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    (data / "synthetic").mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
    for split, seed, n in (("train", 0, 200), ("val", 1, 70)):
        pose, ids = synthetic_pose_stream(skel, n_frames=n, n_ids=2 if split == "train" else 1, seed=seed)
        write_pose_h5(data / "synthetic" / split / "pose.h5", pose, ids)
    return data


def base_config(data: Path, num_epochs: int) -> dict:
    return {
        "data": {
            "data_path": str(data) + "/", "dataset": "synthetic", "batch_size": 16,
            "direction_process": "midfwd", "arena_size": [[-290, -290, 0], [290, 290, 120]],
        },
        "disentangle": {
            "method": {
                "conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"],
                "moving_avg_lsq": ["avg_speed_3d"], "grad_reversal": ["avg_speed_3d"],
            },
        },
        "model": {
            "type": "rcnn", "z_dim": 32, "window": 51, "channel": [8, 8, 16, 16, 32], "kernel": 5,
            "precision": "bf16",
        },
        "train": {
            "lr": 1e-3, "optimizer": "adamw", "lr_schedule": "cawr", "num_epochs": num_epochs,
            "seed": 0, "eval_start_epoch": 0, "minimal_test": True, "clip_norm": 0,
            "param_dtype": "bf16",
        },
        "loss": {
            "rotation": 1.0, "prior": 0.001, "root": 0.01, "jpe": 1.0,
            "avg_speed_3d_mals": 0.1, "avg_speed_3d_lin": 1.0, "avg_speed_3d_gr": 1.0,
        },
    }


def write_run(runs: Path, name: str, cfg: dict) -> Path:
    run = runs / "proj" / name
    run.mkdir(parents=True, exist_ok=True)
    with open(run / "model_config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return run


def fresh_model(trainer):
    return factory.build_model(
        trainer.config["model"], trainer.config["disentangle"], 18, "midfwd",
        arena_size=trainer.train_ds.arena_size, discrete_classes=trainer.train_ds.discrete_classes,
        loss_keys=trainer.loss_cfg.keys(), device="cpu",
    )[0]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float64: torch.int64}
        return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))
    return torch.equal(a, b)


def snapshot(trainer) -> dict:
    """Every piece of trainer state a full checkpoint restores, copied."""
    st = trainer.state
    mals = st.scrub_state["moving_avg_lsq"]["avg_speed_3d"]
    return {
        "model": {k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
        "mu": [m.clone() for m in st.opt_state.mu],
        "nu": [n.clone() for n in st.opt_state.nu],
        "count": st.opt_state.count.clone(),
        "opt_step": st.opt_state.step,
        "step": st.step,
        "mals": {f: getattr(mals, f).clone() for f in MALS_FIELDS},
        "generator": st.generator.get_state().clone(),
    }


def assert_same_state(a: dict, b: dict) -> None:
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert bits_equal(a["model"][k], b["model"][k]), k
    for part in ("mu", "nu"):
        assert all(bits_equal(x, y) for x, y in zip(a[part], b[part])), part
    assert bits_equal(a["count"], b["count"])
    assert (a["opt_step"], a["step"]) == (b["opt_step"], b["step"])
    for f in MALS_FIELDS:
        assert bits_equal(a["mals"][f], b["mals"][f]), f
    assert torch.equal(a["generator"], b["generator"])


@pytest.fixture(scope="module")
def run20(tmp_path_factory):
    """A 20-epoch CLI run; its trainer and the state it ended with."""
    root = tmp_path_factory.mktemp("ckpt")
    data = write_data(root)
    run = write_run(root / "runs", "a", base_config(data, 20))
    trainer = main(["-o", str(root / "runs"), "-p", "proj", "-n", "a", "--device", "cpu"])
    return root, data, run, trainer, snapshot(trainer)


def test_cli_run_writes_metrics_weights_and_state(run20):
    root, data, run, trainer, _ = run20
    with open(run / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == list(range(1, 21))
    assert all(np.isfinite(float(r["total_train"])) for r in rows)
    for r in rows:
        tested = int(r["epoch"]) % 5 == 0
        for k in ("total_test", "r2_gen_restrict_avg_speed_3d_test", "r2_gen_restrict_heading_test"):
            assert (r[k] != "") == tested, (r["epoch"], k)
            if tested:
                assert np.isfinite(float(r[k]))
    assert list(factory.all_saved_epochs(run)) == [5, 10, 15, 20]
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["epoch_20.pt"]
    dtypes = {p.dtype for p in trainer.model.parameters()}
    assert dtypes == {torch.float32, torch.bfloat16}
    # the val split is one partial batch: the eval tail alone
    assert 0 < len(trainer.val_ds) < trainer.batch_size


def test_weights_and_full_state_round_trip_bitwise(run20, tmp_path):
    _, _, _, trainer, snap = run20
    ckpt.save_weights(tmp_path, 3, trainer.model)
    ckpt.save_train_state(tmp_path, 3, trainer.model, trainer.state)
    fresh = Trainer(
        trainer.config, {"train": trainer.train_ds, "val": trainer.val_ds}, fresh_model(trainer),
        trainer.info, device="cpu",
    )
    before = snapshot(fresh)
    assert not all(bits_equal(before["model"][k], v) for k, v in snap["model"].items())
    ckpt.load_weights(tmp_path, 3, fresh.model)
    got = snapshot(fresh)
    for k, v in snap["model"].items():
        assert bits_equal(got["model"][k], v), k
    fresh.state = ckpt.load_train_state(tmp_path, 3, fresh.model, fresh.state)
    assert_same_state(snapshot(fresh), snap)
    assert ckpt.load_train_state(tmp_path, 4, fresh.model, fresh.state) is None


def test_resume_restores_everything_and_trains_on(run20):
    """Resume from epoch 20 (model.load_model + start_epoch): the restored
    state equals the first run's at the end of epoch 20, bit for bit; epoch
    21 then trains with finite losses, so the leaf table held."""
    root, data, run, _, snap = run20
    cfg = base_config(data, 21)
    cfg["model"].update(load_model=str(run), start_epoch=20)
    config = read.config(write_run(root / "runs", "b", cfg) / "model_config.yaml")
    datasets, model, info = factory.data_and_model(
        config, data_keys=("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading"), device="cpu",
    )
    trainer = Trainer(config, datasets, model, info, device="cpu")
    assert trainer.start_epoch == 20
    assert_same_state(snapshot(trainer), snap)
    trainer.fit()
    assert trainer.state.opt_state.step == snap["opt_step"] + trainer.steps_per_epoch
    with open(Path(config["out_path"]) / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["21"]
    assert all(np.isfinite(float(v)) for k, v in rows[0].items() if k.endswith("_train"))


def test_reset_gr_reinits_gr_leaves_in_place(run20):
    _, _, _, trainer, _ = run20
    before = {n: (p.data_ptr(), p.detach().clone()) for n, p in trainer.model.named_parameters()}
    moments = [m.clone() for m in trainer.state.opt_state.mu + trainer.state.opt_state.nu]
    trainer.reset_gr(99)
    for n, p in trainer.model.named_parameters():
        ptr, old = before[n]
        assert p.data_ptr() == ptr, n
        if n.startswith("grad_reversal.") and n.endswith(".weight"):
            assert not torch.equal(p, old), n
        elif not n.startswith("grad_reversal."):
            assert bits_equal(p.detach(), old), n
    after = trainer.state.opt_state.mu + trainer.state.opt_state.nu
    assert all(bits_equal(a, b) for a, b in zip(after, moments))
    # the same epoch draws the same heads
    w = trainer.model.grad_reversal["avg_speed_3d"].ensemble.mlp1_0.weight.detach().clone()
    trainer.reset_gr(99)
    assert bits_equal(trainer.model.grad_reversal["avg_speed_3d"].ensemble.mlp1_0.weight.detach(), w)


def test_nonfinite_loss_halts_with_a_diagnostic_state(run20, tmp_path):
    _, _, _, trainer, _ = run20
    trainer.out_path = str(tmp_path)
    with pytest.raises(FloatingPointError, match="non-finite training loss at epoch 7"):
        trainer._check_finite({"total": float("nan"), "rotation": 1.0}, 7)
    assert (tmp_path / "checkpoints" / "epoch_7.pt").exists()
    trainer.train_cfg["halt_on_nonfinite"] = False
    try:
        trainer._check_finite({"total": float("nan")}, 8)
    finally:
        trainer.train_cfg["halt_on_nonfinite"] = None
    assert not (tmp_path / "checkpoints" / "epoch_8.pt").exists()


def test_job_id_picks_the_sorted_folder(run20, tmp_path):
    _, data, _, _, _ = run20
    cfg = base_config(data, 1)
    for name, epochs in (("b_second", 2), ("a_first", 1)):
        write_run(tmp_path, name, cfg | {"train": cfg["train"] | {"num_epochs": epochs}})
    trainer = main(["-o", str(tmp_path), "-p", "proj", "--job_id", "1", "--device", "cpu"])
    assert Path(trainer.out_path).name == "b_second"
    assert (tmp_path / "proj" / "b_second" / "metrics.csv").exists()
    assert not (tmp_path / "proj" / "a_first" / "metrics.csv").exists()


def test_reference_pth_loads_through_the_fallback(tmp_path):
    """A reference-layout state dict (the JAX exporter's, saved with
    torch.save) at weights/epoch_5.pth loads to the same tensors as
    from_jax_variables gives for the same JAX weights."""
    from scrubvae_tpu import factory as jfactory
    from scrubvae_tpu.utils.torch_export import export_resvae_state_dict

    cfg = base_config(tmp_path, 1)
    cfg["model"]["precision"] = "fp32"
    arena = np.asarray(cfg["data"]["arena_size"], np.float32)
    dis = cfg["disentangle"] | {"features": ["avg_speed_3d", "heading"]}
    jmodel, _ = jfactory.build_model(
        cfg["model"], dis, 18, "midfwd", arena_size=arena, loss_keys=cfg["loss"].keys()
    )
    rng = np.random.default_rng(0)
    batch = {
        "x6d": jnp.asarray(rng.standard_normal((2, 51, 18, 6)), jnp.float32),
        "root": jnp.asarray(rng.standard_normal((2, 51, 3)), jnp.float32),
        "avg_speed_3d": jnp.zeros((2, 3)), "heading": jnp.zeros((2, 2)),
    }
    key = jax.random.PRNGKey(3)
    variables = jmodel.init({"params": key, "dropout": key}, batch, rng=key, train=True)
    flat = {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(variables, sep="/").items()}
    sd, unexported = export_resvae_state_dict(variables)
    assert not unexported
    (tmp_path / "weights").mkdir()
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, tmp_path / "weights" / "epoch_5.pth")

    model, _ = factory.build_model(
        cfg["model"], dis, 18, "midfwd", arena_size=arena, loss_keys=cfg["loss"].keys(), device="cpu"
    )
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    ckpt.load_weights(tmp_path, 5, model)
    want = from_jax_variables(flat)
    got = model.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        assert bits_equal(got[k], v.to(got[k].dtype)), k
    assert all(p.data_ptr() == ptrs[n] for n, p in model.named_parameters())


def test_decodability_is_not_ported_without_minimal_test(run20):
    """Decodability is ported: without ``minimal_test`` a ``Trainer``
    builds and ``decodability_metrics`` returns the JAX package's keys (the
    val split here is one partial batch, too small to split or of one id,
    so every fold is nan); with it, nothing."""
    _, _, _, trainer, _ = run20
    cfg = dict(trainer.config)
    cfg["train"] = dict(cfg["train"], minimal_test=None)
    full = Trainer(
        cfg, {"train": trainer.train_ds, "val": trainer.val_ds}, fresh_model(trainer), trainer.info, device="cpu"
    )
    _, z = full.test_epoch(20)
    with pytest.warns(UserWarning, match="clamping 5 folds"):
        out = full.decodability_metrics(z)
    assert [k for k in out if k.endswith("_mean")] == [
        "r2_avg_speed_3d_lin_mean", "r2_avg_speed_3d_mlp_mean", "r2_heading_lin_mean", "r2_heading_mlp_mean",
        "acc_ids_log_mean", "acc_ids_qda_mean",
    ]
    assert all(np.isnan(out[k]) for k in out if k.endswith("_mean"))
    assert all(out[k] >= 1 for k in out if k.endswith("_nanfolds"))
    assert trainer.decodability_metrics(z) == {}


def test_train_entry_takes_given_datasets(run20, tmp_path):
    _, _, _, trainer, _ = run20
    cfg = dict(trainer.config, out_path=str(tmp_path))
    cfg["train"] = dict(cfg["train"], num_epochs=1)
    out = train(cfg, {"train": trainer.train_ds}, fresh_model(trainer), trainer.info, device="cpu")
    assert out.val_ds is None and out.eval_step is None
    with open(tmp_path / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["1"] and not any(k.endswith("_test") for k in rows[0])


# ---------------------------------------------------------------------------
# the full scrubber stack: QDA, discriminator and MCMI states in the full state
# ---------------------------------------------------------------------------

QDA_FIELDS = ("m0a", "m1a", "m0b", "m1b", "S0a", "S1a", "S0b", "S1b", "lama", "lamb")
MI_FIELDS = ("x_s", "y_s", "var_s", "logA_x", "logA_y", "valid")
# the JAX package's columns for this config, in its order: the sorted train
# losses (their names are held to the JAX step's in
# tests/test_torch_port_step_full.py), the lambdas, the epoch time, then at a
# validation epoch the sorted validation losses, then restrictiveness
FULL_COLUMNS = [
    "epoch",
    *(f"{k}_train" for k in (
        "avg_speed_3d_an", "avg_speed_3d_gr", "avg_speed_3d_lin", "avg_speed_3d_mals", "ids_qda", "jpe",
        "mcmi", "prior", "root", "rotation", "total", "total_correlation",
    )),
    "lambda_mals_avg_speed_3d", "lambda_qda_ids", "time",
    *(f"{k}_test" for k in (
        "avg_speed_3d_an", "avg_speed_3d_gr", "avg_speed_3d_lin", "avg_speed_3d_mals", "ids_qda", "jpe",
        "mcmi", "prior", "root", "rotation", "total", "total_correlation",
        "r2_gen_restrict_avg_speed_3d", "r2_gen_restrict_heading",
    )),
]


def full_config(data: Path, num_epochs: int) -> dict:
    """configs/ladder/5_full.yaml's method map and losses at the small size
    above (z 16: the dense head), validation from epoch 20."""
    cfg = base_config(data, num_epochs)
    with open(ROOT / "configs" / "ladder" / "5_full.yaml") as f:
        full = yaml.safe_load(f)
    cfg["disentangle"] = full["disentangle"]
    cfg["loss"] = full["loss"]
    cfg["model"]["z_dim"] = 16
    cfg["train"].update(eval_start_epoch=20, beta_anneal=True)
    return cfg


def full_snapshot(trainer) -> dict:
    """``snapshot`` plus the QDA state, the discriminator's parameters,
    moments and counts, and the MCMI state."""
    st = trainer.state
    snap = snapshot(trainer)
    qda = st.scrub_state["qda"]["ids"]
    adv = st.adv_states["avg_speed_3d"]
    snap.update(
        qda={f: getattr(qda, f).clone() for f in QDA_FIELDS},
        adv={k: v.detach().clone() for k, v in adv.net.state_dict().items()},
        adv_mu=[m.clone() for m in adv.opt_state.mu],
        adv_nu=[n.clone() for n in adv.opt_state.nu],
        adv_counts=(adv.opt_state.count.clone(), adv.opt_state.step),
        mi={f: getattr(st.mi_state, f).clone() for f in MI_FIELDS},
    )
    return snap


def assert_same_full_state(a: dict, b: dict) -> None:
    assert_same_state(a, b)
    for part in ("qda", "adv", "mi"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert bits_equal(a[part][k], b[part][k]), (part, k)
    for part in ("adv_mu", "adv_nu"):
        assert all(bits_equal(x, y) for x, y in zip(a[part], b[part])), part
    assert bits_equal(a["adv_counts"][0], b["adv_counts"][0]) and a["adv_counts"][1] == b["adv_counts"][1]


@pytest.fixture(scope="module")
def run_full(tmp_path_factory):
    """A 21-epoch full-stack run; its state at the end of epochs 20 and 21."""
    root = tmp_path_factory.mktemp("ckpt_full")
    data = write_data(root)
    run = write_run(root / "runs", "full", full_config(data, 20))
    trainer = main(["-o", str(root / "runs"), "-p", "proj", "-n", "full", "--device", "cpu"])
    at20 = full_snapshot(trainer)
    trainer.start_epoch = 20
    trainer.fit(21)
    return root, data, run, trainer, at20, full_snapshot(trainer)


def test_full_stack_state_round_trips_bitwise(run_full, tmp_path):
    _, _, _, trainer, _, snap = run_full
    ckpt.save_train_state(tmp_path, 3, trainer.model, trainer.state)
    fresh = Trainer(
        trainer.config, {"train": trainer.train_ds, "val": trainer.val_ds}, fresh_model(trainer),
        trainer.info, device="cpu",
    )
    adv = fresh.state.adv_states["avg_speed_3d"]
    ptrs = [p.data_ptr() for p in adv.net.parameters()] + [m.data_ptr() for m in adv.opt_state.mu]
    assert not bits_equal(full_snapshot(fresh)["adv"]["ensemble.mlp1_0.weight"], snap["adv"]["ensemble.mlp1_0.weight"])
    fresh.state = ckpt.load_train_state(tmp_path, 3, fresh.model, fresh.state)
    assert_same_full_state(full_snapshot(fresh), snap)
    # loaded in place: the discriminator's leaf table still holds
    adv = fresh.state.adv_states["avg_speed_3d"]
    assert ptrs == [p.data_ptr() for p in adv.net.parameters()] + [m.data_ptr() for m in adv.opt_state.mu]
    adv.opt_state.table.check_storage([p.detach() for p in adv.net.parameters()], adv.opt_state.mu, adv.opt_state.nu)


def test_full_stack_resume_trains_epoch_21_bitwise(run_full):
    """Resume from epoch 20 (whose full state is saved after the validation
    epoch's MCMI refresh): the restored state is the run's at the end of
    epoch 20, and epoch 21 trains to the run's epoch-21 state bit for bit:
    model, moments, MALS, QDA, discriminator and MCMI states, generator."""
    root, data, run, _, at20, at21 = run_full
    cfg = full_config(data, 21)
    cfg["model"].update(load_model=str(run), start_epoch=20)
    config = read.config(write_run(root / "runs", "full_resumed", cfg) / "model_config.yaml")
    datasets, model, info = factory.data_and_model(
        config, data_keys=("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading", "ids"), device="cpu",
    )
    trainer = Trainer(config, datasets, model, info, device="cpu")
    assert_same_full_state(full_snapshot(trainer), at20)
    trainer.fit()
    assert_same_full_state(full_snapshot(trainer), at21)


def test_full_stack_metrics_columns(run_full):
    _, _, run, _, _, _ = run_full
    with open(run / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == FULL_COLUMNS
    assert [r["epoch"] for r in rows] == [str(e) for e in range(1, 22)]
    for r in rows:
        for k in FULL_COLUMNS[1:]:
            if k.endswith("_test"):
                assert (r[k] != "") == (r["epoch"] == "20"), (r["epoch"], k)
            if r[k]:
                assert np.isfinite(float(r[k])), (r["epoch"], k)
    lam = [float(r["lambda_qda_ids"]) for r in rows]
    assert lam[0] != 0.2 and len(set(lam)) > 1
