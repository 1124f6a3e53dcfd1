"""The port's reference-layout ``.pth`` export and import
(``scrubvae_torch/utils/torch_export.py``, ``utils/torch_import.py``) and
its three serving entry points, on the CPU at small widths.

- ``export_torch_weights`` of the port's model writes what the JAX
  package's writes for the same weights (carried with
  ``from_jax_variables``), key for key and bit for bit, but for the
  low-rank head's dense composition (each entry within 1e-6 of the sum of
  its terms' magnitudes: JAX composes in f32, the port in float64), and
  leaves as many leaves unexported: the rcnn with the packed head and the
  linear and gradient-reversal scrubbers, the dense head,
  ``sigma_head_rank``, the beta prior, the mlp (which JAX's exporter sends
  the rcnn's way: only its scrubber heads are written) and the transformer
  (its ``cond_proj`` and scrubber heads stay out);
- a JAX-written ``.pth``, with two keys no model maps, imported by the
  port into a freshly initialised model gives ``from_jax_variables`` of
  what JAX's importer gives, bit for bit, with the same unmapped keys and
  as many unfilled leaves; also the dense head's file into a model with
  ``sigma_head_rank``, whose head stays unfilled;
- ``python -m scrubvae_torch.export_model``, ``serve_bench`` and
  ``export_torch`` end to end with ``--device cpu`` on a run the port
  trained for a step and saved.
"""

import json
import shutil
from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from scrubvae_tpu import factory as jfactory
from scrubvae_tpu.utils import torch_export as jte
from scrubvae_tpu.utils import torch_import as jti
from scrubvae_torch import export_model, export_torch, factory, serve_bench
from scrubvae_torch.data.pose_io import write_pose_h5
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.params import read
from scrubvae_torch.train.trainer import Trainer
from scrubvae_torch.utils import checkpoint as ckpt
from scrubvae_torch.utils.export import load_exported
from scrubvae_torch.utils.torch_export import export_torch_weights
from scrubvae_torch.utils.torch_import import import_torch_weights
from scrubvae_torch.utils.weights import from_jax_variables

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
W, Z = 31, 8
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)
RCNN = {"type": "rcnn", "z_dim": Z, "window": W, "diag": False, "channel": [8, 8, 16, 16, 32], "kernel": 5,
        "prior": "gaussian", "activation": "prelu", "precision": "fp32", "packed_sigma": True}
VARIANTS = {
    "rcnn_packed": RCNN,
    "rcnn_dense": RCNN | {"packed_sigma": False},
    "rcnn_low_rank": RCNN | {"sigma_head_rank": 4},
    "rcnn_beta": RCNN | {"prior": "beta"},
    "mlp": {"type": "mlp", "z_dim": Z, "window": W, "diag": False, "hidden": [32, 16]},
    "transformer": {"type": "transformer", "z_dim": Z, "window": W, "n_heads": 2, "ff_size": 16, "n_layers": 1,
                    "diag": False},
}
DIS = {
    "method": {"conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"],
               "grad_reversal": ["avg_speed_3d"]},
    "features": ["avg_speed_3d", "heading"], "alpha": 1.0,
}
LOSS = ("rotation", "prior", "avg_speed_3d_lin", "avg_speed_3d_gr")
EXTRA_KEYS = ("arena_size", "disentangle.moving_avg.avg_speed_3d.m1")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def jax_variables(model_config: dict, seed: int):
    """The JAX model's every leaf (the VAE and the scrubber heads), each
    drawn from a normal at ``seed`` (BatchNorm variances positive)."""
    jmodel, _ = jfactory.build_model(model_config, DIS, 18, "midfwd", arena_size=ARENA, loss_keys=LOSS)
    data = {
        "x6d": jnp.zeros((2, W, 18, 6)), "root": jnp.zeros((2, W, 3)),
        "avg_speed_3d": jnp.zeros((2, 3)), "heading": jnp.zeros((2, 2)),
    }

    def every_leaf(m, data):  # without the beta prior's gamma draws
        mu = m.encode(data, train=False)["mu"]
        m.decode(mu, data, train=False)
        for head in (*m.linear.values(), *m.grad_reversal.values()):
            head(mu)

    shapes = jmodel.init({"params": jax.random.PRNGKey(0)}, data, method=every_leaf)
    rng = np.random.default_rng(seed)
    leaves = {
        k: np.abs(v) + 0.1 if k.endswith("/var") else v
        for k, v in ((k, rng.normal(size=np.shape(x)).astype(np.float32)) for k, x in flat(shapes).items())
    }
    return flax.traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in leaves.items()}, sep="/")


def flat(variables) -> dict:
    return {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(variables, sep="/").items()}


def port_model(model_config: dict, variables):
    model, _ = factory.build_model(model_config, DIS, 18, "midfwd", arena_size=ARENA, loss_keys=LOSS, device="cpu")
    model.load_state_dict(from_jax_variables(flat(variables)), strict=True)
    return model


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_export_matches_jax(variant, tmp_path):
    variables = jax_variables(VARIANTS[variant], 0)
    model = port_model(VARIANTS[variant], variables)
    jax_unexported = jte.export_torch_weights(variables, tmp_path / "jax.pth", verbose=False)
    port_unexported = export_torch_weights(model, tmp_path / "port.pth", verbose=False)
    want = torch.load(tmp_path / "jax.pth", weights_only=True)
    got = torch.load(tmp_path / "port.pth", weights_only=True)
    assert sorted(got) == sorted(want)
    assert len(port_unexported) == len(jax_unexported), (port_unexported, jax_unexported)
    for k, v in want.items():
        if variant == "rcnn_low_rank" and k.startswith("encoder.fc_sigma.0."):
            # each entry within 1e-6 of the sum of its terms' magnitudes
            # (JAX composes in f32: the bound of the products' rounding)
            f = {n: model.state_dict()[f"vae.encoder.fc_sigma_{n}"].double() for n in
                 ("u.weight", "u.bias", "v.weight", "v.bias")}
            kv = f["v.weight"].abs()
            scale = kv @ f["u.weight"].abs() if k.endswith("weight") else kv @ f["u.bias"].abs() + f["v.bias"].abs()
            assert ((got[k].double() - v.double()).abs() <= 1e-6 * scale).all(), k
        elif v.is_floating_point():
            assert bits_equal(got[k], v), k
        else:
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("source, target", [(v, v) for v in sorted(VARIANTS)] + [("rcnn_packed", "rcnn_low_rank")])
def test_import_matches_jax(source, target, tmp_path):
    path = tmp_path / "ref.pth"
    jte.export_torch_weights(jax_variables(VARIANTS[source], 0), path, verbose=False)
    sd = torch.load(path, weights_only=True)
    sd.update({k: torch.zeros(3) for k in EXTRA_KEYS})
    torch.save(sd, path)

    fresh = jax_variables(VARIANTS[target], 1)
    ref_sd = jti.load_torch_state_dict(path)
    convert = jti.convert_transformer_state_dict if target == "transformer" else jti.convert_resvae_state_dict
    want_vars, want_unmapped, want_unfilled = convert(ref_sd, fresh)
    assert flat(jti.import_torch_weights(path, fresh, verbose=False)).keys() == flat(want_vars).keys()

    model = port_model(VARIANTS[target], fresh)
    unmapped, unfilled = import_torch_weights(path, model, verbose=False)
    assert unmapped == want_unmapped
    assert len(unfilled) == len(want_unfilled), (unfilled, want_unfilled)
    want = from_jax_variables(flat(want_vars))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert bits_equal(got[k], v) if v.is_floating_point() else torch.equal(got[k], v), k
    if target != source:
        assert {k.rsplit(".", 2)[-2] for k in unfilled} == {"fc_sigma_u", "fc_sigma_v"}


def tiny_run(tmp: Path) -> tuple:
    """A run folder (the rcnn with the packed head, conditionals and the
    linear and gradient-reversal scrubbers, bf16 storage of its largest
    leaf) trained one step and saved at epoch 5, on raw pose files."""
    data = tmp / "data"
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    (data / "synthetic").mkdir(parents=True)
    shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
    pose, ids = synthetic_pose_stream(skel, n_frames=200, n_ids=2, seed=0)
    write_pose_h5(data / "synthetic" / "train" / "pose.h5", pose, ids)
    run = tmp / "runs" / "proj" / "name"
    run.mkdir(parents=True)
    cfg = {
        "data": {"data_path": str(data) + "/", "dataset": "synthetic", "batch_size": 8,
                 "direction_process": "midfwd", "arena_size": ARENA.tolist()},
        "disentangle": DIS | {"method": DIS["method"] | {"moving_avg_lsq": ["avg_speed_3d"]}},
        "model": RCNN | {"channel": [8, 8, 16, 16, 64], "z_dim": 32},
        "train": {"lr": 1e-3, "optimizer": "adamw", "lr_schedule": "cawr", "num_epochs": 1, "seed": 0,
                  "minimal_test": True, "clip_norm": 0, "param_dtype": "bf16"},
        "loss": {"rotation": 1.0, "prior": 0.001, "root": 0.01, "jpe": 1.0, "avg_speed_3d_mals": 0.1,
                 "avg_speed_3d_lin": 1.0, "avg_speed_3d_gr": 1.0},
    }
    (run / "model_config.yaml").write_text(yaml.safe_dump(cfg))
    cfg = read.config(run / "model_config.yaml")
    datasets, model, info = factory.data_and_model(
        cfg, train_val_test=("train",), data_keys=export_model.DATA_KEYS, device="cpu"
    )
    factory.init_weights(model, 0)
    trainer = Trainer(cfg, datasets, model, info, device="cpu")
    trainer.train_epoch(1, np.arange(8)[None])
    ckpt.save_weights(cfg["out_path"], 5, model)
    return run, model, datasets["train"]


def test_entry_points_end_to_end(tmp_path, capsys):
    run, model, ds = tiny_run(tmp_path)
    assert any(p.dtype == torch.bfloat16 for p in model.parameters())

    out = export_model.main(["--run", str(run), "--device", "cpu"])
    meta = json.loads((out / "meta.json").read_text())
    assert sorted(meta) == sorted(
        ["epoch", "z_dim", "encoder_inputs", "decoder_conditionals", "input_shapes", "conditional_shapes"]
    )
    assert meta["epoch"] == 5 and meta["encoder_inputs"] == ["x6d", "root"]
    assert meta["decoder_conditionals"] == ["avg_speed_3d", "heading"]
    data = ds.batch(np.arange(3))
    model.eval()
    with torch.no_grad():
        want = model.encode(data)
        want_dec = model.decode(want["mu"], data)
    got = load_exported(out / "encoder.pt2", "cpu")({k: data[k] for k in meta["encoder_inputs"]})
    got_mu = load_exported(out / "encoder_mu.pt2", "cpu")({k: data[k] for k in meta["encoder_inputs"]})
    got_dec = load_exported(out / "decoder.pt2", "cpu")(want["mu"], {k: data[k] for k in meta["decoder_conditionals"]})
    assert set(got) == {"mu", "Lp"} and set(got_mu) == {"mu"} and set(got_dec) == {"var", "x6d", "root"}
    for name, g, w in (("mu", got["mu"], want["mu"]), ("Lp", got["Lp"], want["Lp"]), ("mu", got_mu["mu"], want["mu"]),
                       ("x6d", got_dec["x6d"], want_dec["x6d"]), ("root", got_dec["root"], want_dec["root"])):
        atol = 1e-5 * (290.0 if name == "root" else 1.0)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=atol, err_msg=name)

    capsys.readouterr()
    serve_bench.main(["--run", str(run), "--batches", "1", "3", "--iters", "2", "--device", "cpu"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [(r["artifact"], r["batch"]) for r in lines] == [
        (a, n) for n in (1, 3) for a in ("encoder", "encoder_mu", "decoder")
    ]
    assert all(r["device_kind"] == "cpu" and r["latency_ms"] > 0 and r["samples_per_sec"] > 0 for r in lines)
    assert all(0 < r["latency_ms_sync_min"] <= r["latency_ms_sync_p50"] for r in lines)
    assert all(r["windows"] >= serve_bench.MIN_WINDOWS for r in lines)
    assert all(0 < r["latency_ms_min"] <= r["latency_ms"] <= r["latency_ms_max"] for r in lines)

    pth = export_torch.main(["--run", str(run), "--epoch", "5"])
    assert pth == run / "weights" / "epoch_5.pth"
    cfg = read.config(run / "model_config.yaml", make_dirs=False)
    fresh, _ = factory.build_model(
        cfg["model"], cfg["disentangle"], 18, "midfwd", arena_size=ARENA, loss_keys=cfg["loss"].keys(), device="cpu"
    )
    assert import_torch_weights(pth, fresh, verbose=False) == ([], [])
    saved = torch.load(run / "weights" / "epoch_5.pt", weights_only=True)
    for k, v in fresh.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 0, k
        else:
            assert bits_equal(v, saved[k].float()), k
