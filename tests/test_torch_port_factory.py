"""``factory.data_and_model`` from raw pose files on disk, the port against
the JAX package: the same splits (length, discrete classes, batches key by
key for the train keys and the val keys), the same model description; and
the host-streamed, preprocessed per-key and parkinsons data paths build
and train.

Batches are held to the tolerances of ``tests/test_torch_port_data.py``:
atol 1e-5, plus twice the JAX pipeline's own distance from float64 for the
two keys built from the per-frame IK (x6d, target_pose).
"""

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu import factory as jfactory
from scrubvae_torch import factory
from scrubvae_torch.data.dataset import StreamDataset
from scrubvae_torch.data.pose_io import write_pose_h5
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.ops import kinematics as tkin
from scrubvae_torch.ops import quaternion as tq

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TRAIN_KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading")


def write_data(root: Path) -> Path:
    data = root / "data"
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    (data / "synthetic").mkdir(parents=True)
    shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
    for split, seed, n, k in (("train", 0, 600, 3), ("val", 1, 300, 2)):
        pose, ids = synthetic_pose_stream(skel, n_frames=n, n_ids=k, seed=seed)
        write_pose_h5(data / "synthetic" / split / "pose.h5", pose, ids)
    return data


def config(data: Path) -> dict:
    return {
        "data": {
            "data_path": str(data) + "/", "dataset": "synthetic", "batch_size": 16,
            "direction_process": "midfwd", "arena_size": [[-290, -290, 0], [290, 290, 120]],
            "window": None, "stride": 2,
        },
        "disentangle": {
            "method": {"conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"]},
            "features": ["avg_speed_3d", "heading"],
        },
        "model": {"type": "rcnn", "z_dim": 16, "window": 51, "channel": [8, 8, 16, 16, 32]},
        "train": {"precision": "bf16"},
        "loss": {"rotation": 1.0, "prior": 0.001},
    }


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    data = write_data(tmp_path_factory.mktemp("factory"))
    cfg = config(data)
    jds, _, jinfo = jfactory.data_and_model(cfg, data_keys=TRAIN_KEYS)
    tds, model, info = factory.data_and_model(cfg, data_keys=TRAIN_KEYS, device="cpu")
    return cfg, jds, jinfo, tds, model, info


def _f32_noise(jds, skel) -> dict:
    """The JAX pipeline's own distance from a float64 evaluation of its
    per-frame x6d and zero-root FK."""
    p64 = torch.from_numpy(np.asarray(jds.store.pose, np.float64))
    x6d64 = tq.quaternion_to_cont6d(tkin.inv_kin(p64, skel.tree, forward_indices=[1, 0]))
    offs = torch.from_numpy(np.array(jds.store.offsets)).double()
    tpose64 = tkin.fwd_kin_cont6d(x6d64, skel.tree, offs, p64.new_zeros(len(p64), 3), eps=1e-8)
    return {
        "x6d": float(np.abs(np.asarray(jds.store.x6d) - x6d64.numpy()).max()),
        "target_pose": float(np.abs(np.asarray(jds.store.tpose) - tpose64.numpy()).max()),
    }


@pytest.mark.parametrize("split", ["train", "val"])
def test_splits_match(pair, split):
    _, jds, _, tds, _, _ = pair
    j, t = jds[split], tds[split]
    assert len(t) == len(j) > 0
    assert t.label == split and t.n_keypts == j.n_keypts == 18
    assert t.discrete_classes.keys() == j.discrete_classes.keys()
    for k in j.discrete_classes:
        np.testing.assert_array_equal(t.discrete_classes[k], np.asarray(j.discrete_classes[k]))
    assert set(t.data_keys) == set(j.data_keys)
    np.testing.assert_array_equal(np.asarray(t.arena_size), np.asarray(j.arena_size))
    for k in ("mean", "std"):
        np.testing.assert_array_equal(
            t.norm_params["avg_speed_3d"][k].numpy(), np.asarray(j.norm_params["avg_speed_3d"][k])
        )
    idx = np.random.default_rng(0).integers(0, len(j), 32)
    want, got = j.batch(jnp.asarray(idx)), t.batch(idx)
    assert set(got) == set(want)
    noise = _f32_noise(j, t.skeleton)
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_allclose(a, b, atol=1e-5 + 2 * noise.get(k, 0.0), rtol=0, err_msg=k)


def test_model_description_matches(pair):
    _, _, jinfo, _, model, info = pair
    assert info == jinfo
    assert model.vae.window == 51 and model.vae.encoder.compute_dtype == torch.bfloat16


def test_all_saved_epochs(tmp_path):
    (tmp_path / "weights").mkdir()
    for name in ("epoch_20.pt", "epoch_5.pt", "epoch_5.pth", "epoch_15.pt"):
        (tmp_path / "weights" / name).touch()
    assert list(factory.all_saved_epochs(tmp_path)) == [5, 15, 20]


@pytest.mark.parametrize("what", ["host_stream", "preprocessed_layout", "parkinsons"])
def test_data_paths_build_and_train(pair, tmp_path, what):
    """The host-streamed train split, the preprocessed per-key layout
    (written by the port's ``preprocess_data`` from the raw files) and the
    parkinsons recoding (a ``metadata.csv`` beside the raw files) through
    ``data_and_model``: each split's kind and length, its discrete classes
    and the model description as JAX's; then one epoch of ``train`` with
    finite losses."""
    import csv

    from scrubvae_tpu.data.hoststream import HostStreamDataset as JaxHostStreamDataset
    from scrubvae_torch import preprocess_data
    from scrubvae_torch.data.dataset import WindowDataset
    from scrubvae_torch.data.hoststream import HostStreamDataset
    from scrubvae_torch.train.trainer import train

    cfg = config(Path(pair[0]["data"]["data_path"]))
    data = Path(cfg["data"]["data_path"])
    kind = StreamDataset
    if what == "host_stream":
        cfg["data"]["host_stream"] = True
        kind = HostStreamDataset
    elif what == "preprocessed_layout":
        shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", tmp_path / "mouse_skeleton.yaml")
        skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
        for split in ("train", "val"):
            from scrubvae_torch.data.pose_io import read_pose_h5, save_split

            pose, ids = read_pose_h5(data / "synthetic" / split / "pose.h5")
            windows = preprocess_data.preprocess_split(pose, ids, skel, device="cpu")
            save_split(tmp_path / "synthetic" / split, windows, "midfwd")
        cfg["data"]["data_path"] = str(tmp_path) + "/"
        kind = WindowDataset
    else:
        shutil.copytree(data / "synthetic", tmp_path / "parkinsons")
        shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", tmp_path / "mouse_skeleton.yaml")
        rows = ["Subject,Fluorescence"] + [f"{i},{1.5 + i}" for i in range(40)]
        (tmp_path / "parkinsons" / "metadata.csv").write_text("\n".join(rows) + "\n")
        cfg["data"].update(data_path=str(tmp_path) + "/", dataset="parkinsons")
    jds, _, jinfo = jfactory.data_and_model(cfg, data_keys=TRAIN_KEYS)
    tds, model, info = factory.data_and_model(cfg, data_keys=TRAIN_KEYS, device="cpu")
    assert info == jinfo
    for split in ("train", "val"):
        want = kind if split == "train" or kind is WindowDataset else StreamDataset
        assert type(tds[split]) is want, (split, type(tds[split]))
        assert len(tds[split]) == len(jds[split])
        assert tds[split].discrete_classes.keys() == jds[split].discrete_classes.keys()
        for k, v in jds[split].discrete_classes.items():
            np.testing.assert_array_equal(tds[split].discrete_classes[k], v, err_msg=k)
    if what == "host_stream":
        assert isinstance(jds["train"], JaxHostStreamDataset)
    if what == "parkinsons":
        assert {"pd_label", "fluorescence"} <= set(tds["val"].batch(torch.arange(4)))
    cfg["train"].update(num_epochs=1, minimal_test=True, precision="fp32")
    cfg["model"]["precision"] = "fp32"
    cfg["out_path"] = str(tmp_path / "run")
    train(cfg, tds, model, info, device="cpu")
    with open(tmp_path / "run" / "metrics.csv", newline="") as f:
        row = next(csv.DictReader(f))
    assert all(np.isfinite(float(row[k])) for k in row if k.endswith("_train"))


# ---------------------------------------------------------------------------
# the full scrubber stack: head rule, scrubber states, adversarial bundle
# ---------------------------------------------------------------------------

FULL_DIS = {
    "method": {
        "conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"],
        "moving_avg_lsq": ["avg_speed_3d"], "grad_reversal": ["avg_speed_3d"],
        "adversarial_net": ["avg_speed_3d"], "qda": ["ids"],
    },
    "features": ["avg_speed_3d", "heading"],
}
FULL_MODEL = {"type": "rcnn", "z_dim": 16, "window": 51, "channel": [8, 8, 16, 16, 32]}
ARENA = np.asarray([[-290, -290, 0], [290, 290, 120]], np.float32)


@pytest.mark.parametrize(
    "loss_keys,packed_sigma,packed",
    [
        (("rotation", "prior", "total_correlation"), None, False),
        (("rotation", "prior", "mcmi"), None, True),
        (None, None, False),
        (("rotation", "prior", "total_correlation"), True, True),
        (("rotation", "prior"), False, False),
    ],
)
def test_packed_head_rule_matches_jax(loss_keys, packed_sigma, packed):
    """Packed unless total correlation is a loss key or the keys are unknown;
    an explicit ``model.packed_sigma`` wins. The same ``fc_sigma`` either
    way."""
    model_cfg = dict(FULL_MODEL, packed_sigma=packed_sigma)
    jmodel, _ = jfactory.build_model(model_cfg, FULL_DIS, 18, "midfwd", arena_size=ARENA, loss_keys=loss_keys)
    model, _ = factory.build_model(model_cfg, FULL_DIS, 18, "midfwd", arena_size=ARENA, loss_keys=loss_keys, device="cpu")
    assert jmodel.vae.packed_sigma == model.vae.packed_sigma == packed
    assert model.vae.sigma_key == ("Lp" if packed else "L")
    assert tuple(model.vae.encoder.fc_sigma[0].weight.shape) == (16 * 17 // 2, 32 * 4)
    batch = {
        "x6d": torch.zeros(2, 51, 18, 6), "root": torch.zeros(2, 51, 3),
        "avg_speed_3d": torch.zeros(2, 3), "heading": torch.zeros(2, 2),
    }
    L = model.vae.encode(batch)[model.vae.sigma_key]
    assert tuple(L.shape) == ((2, 136) if packed else (2, 16, 16))


def test_init_scrub_state_and_adv_bundle_match_jax():
    """QDA over the discrete classes, MALS as before, and one discriminator
    per adversarial feature over (z, conditionals) with the JAX tree's
    leaves and shapes, its own fused AdamW (lr 0.1, weight decay 1e-4, f32
    moments) and one launch of the f32 variant a step."""
    from scrubvae_tpu.models import scrubbers as jscr
    from scrubvae_torch.train.optim import FusedAdamW
    from scrubvae_torch.utils.weights import adv_from_jax
    import flax
    import jax

    classes = {"ids": np.array([0, 3, 4])}
    fdims = factory.feat_dims(FULL_MODEL, classes)
    loss = {"avg_speed_3d_mals": 0.1, "ids_qda": 0.01}
    jscrub, jbundle = jfactory.init_scrub_state(jax.random.PRNGKey(0), FULL_DIS, loss, 16, fdims, classes)
    scrub = factory.init_scrub_state(FULL_DIS, loss, 16, fdims, "cpu", discrete_classes=classes)
    assert scrub.keys() == jscrub.keys() == {"moving_avg_lsq", "qda"}
    jq, q = jscrub["qda"]["ids"], scrub["qda"]["ids"]
    np.testing.assert_array_equal(q.classes.numpy(), np.asarray(jq.classes))
    for f in ("m0a", "S1b", "lama", "lamb"):
        np.testing.assert_array_equal(getattr(q, f).numpy(), np.asarray(getattr(jq, f)))

    bundle = factory.init_adv_bundle(FULL_DIS, 16, fdims, seed=0, device="cpu")
    assert bundle["states"].keys() == jbundle["states"].keys() == {"avg_speed_3d"}
    tx = bundle["tx"]
    assert isinstance(tx, FusedAdamW)
    assert (tx.lr, tx.wd, tx.m_dtype, tx.clip_norm) == (0.1, 1e-4, torch.float32, None)
    st = bundle["states"]["avg_speed_3d"]
    want = adv_from_jax(
        {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(jbundle["states"]["avg_speed_3d"].params, sep="/").items()}
    )
    got = st.net.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert got["ensemble.mlp1_0.weight"].shape == (21, 21)  # z 16 + avg_speed_3d 3 + heading 2
    assert all(float(got[k].abs().max()) == 0.0 for k in got if k.endswith(".bias"))
    assert len(st.opt_state.table.w) == 22 and len(st.opt_state.table.batches) == 1
    assert all(m.dtype == torch.float32 for m in st.opt_state.mu + st.opt_state.nu)
    # not a parameter of the model, and drawn from a seed of its own
    again = factory.init_adv_bundle(FULL_DIS, 16, fdims, seed=0, device="cpu")["states"]["avg_speed_3d"]
    assert all(torch.equal(a, b) for a, b in zip(again.net.parameters(), st.net.parameters()))
    assert factory.init_adv_bundle({"method": {"linear": ["avg_speed_3d"]}}, 16, fdims, 0, "cpu") is None


def _shipped(name: str) -> dict:
    """A shipped config: ``configs/ladder/{name}.yaml``, or
    ``configs/{name}.yaml`` for a name with its folder."""
    import yaml

    with open(ROOT / "configs" / f"{name if '/' in name else 'ladder/' + name}.yaml") as f:
        return yaml.safe_load(f)


# every shipped config: ladder 1-5 (1_vanilla_mlp the mlp model), sane and
# sweep; the rcnn's dense head where total correlation is a loss
SHIPPED = (
    ["1_vanilla_mlp", "2_conditional", "3_mals", "4_adversarial", "5_full"]
    + [f"sane/{p.stem}" for p in sorted((ROOT / "configs" / "sane").glob("*.yaml"))]
    + [f"sweep/{p.stem}" for p in sorted((ROOT / "configs" / "sweep").glob("*.yaml"))]
)


@pytest.mark.parametrize(
    "ladder,packed",
    [
        (n, _shipped(n)["model"].get("type", "rcnn") == "rcnn" and "total_correlation" not in _shipped(n)["loss"])
        for n in SHIPPED
    ],
)
def test_ladder_configs_build_and_train(pair, tmp_path, ladder, packed):
    """``data_and_model`` and ``train`` take every shipped config, its data
    section but the data path included (so the x360 process and the
    encoder view of configs/sane and configs/sweep), at small widths for
    one epoch: the rcnn's dense head where total correlation is a loss,
    else the packed head, and the mlp model's dense head; the scrubber
    states of its method map; every loss term of the config in
    ``metrics.csv`` and finite."""
    import csv

    from scrubvae_torch.train.trainer import train

    cfg = _shipped(ladder)
    cfg["data"]["data_path"] = pair[0]["data"]["data_path"]
    if cfg["model"]["type"] == "mlp":
        cfg["model"].update(hidden=[32, 16])
    else:
        cfg["model"].update(z_dim=16, channel=[8, 8, 16, 16, 32], precision="fp32")
    cfg["train"].update(num_epochs=1, minimal_test=True, precision="fp32")
    cfg["disentangle"]["features"] = ["avg_speed_3d", "heading"]
    cfg["out_path"] = str(tmp_path)
    methods = cfg["disentangle"].get("method") or {}
    datasets, model, info = factory.data_and_model(cfg, data_keys=TRAIN_KEYS, device="cpu")
    assert model.vae.packed_sigma == packed
    enc = cfg["data"].get("encoder_direction_process") not in (None, cfg["data"]["direction_process"])
    for ds in datasets.values():
        assert ds.direction_process == cfg["data"]["direction_process"]
        assert {"x6d_enc", "root_enc"} <= set(ds.data_keys) if enc else not {"x6d_enc", "root_enc"} & set(ds.data_keys)
    trainer = train(cfg, datasets, model, info, device="cpu")
    assert trainer.state.adv_states.keys() == set(methods.get("adversarial_net", []))
    assert trainer.state.scrub_state.get("qda", {}).keys() == set(methods.get("qda", []))
    assert (trainer.state.mi_state is not None) == ("mcmi" in cfg["loss"])

    with open(tmp_path / "metrics.csv", newline="") as f:
        row = next(csv.DictReader(f))
    terms = {k for k in row if k.endswith("_train")}
    assert {f"{k}_train" for k in cfg["loss"]} | {"total_train"} <= terms
    assert all(np.isfinite(float(row[k])) for k in terms)
    assert ("lambda_qda_ids" in row) == ("qda" in methods)


def test_vanilla_mlp_config_builds_the_mlp_and_trains(pair, tmp_path):
    """``configs/ladder/1_vanilla_mlp.yaml`` at its own widths (z 16,
    hidden 256-128, the diagonal head) through ``data_and_model`` and
    ``train``: the JAX package's model description and parameter shapes,
    and the 2 optimizer launches a step of a table holding every leaf (f32
    weights; bf16 moments for the two 1.45 M-element kernels, f32 for the
    rest)."""
    import csv

    from scrubvae_torch.models.mlp_vae import MLPVAE
    from scrubvae_torch.train.trainer import train
    from scrubvae_torch.utils.weights import from_jax_variables
    import flax
    import jax

    cfg = _shipped("1_vanilla_mlp")
    cfg["data"]["data_path"] = pair[0]["data"]["data_path"]
    cfg["train"].update(num_epochs=1, minimal_test=True)
    cfg["out_path"] = str(tmp_path)
    datasets, model, info = factory.data_and_model(cfg, data_keys=TRAIN_KEYS, device="cpu")
    _, jmodel, jinfo = jfactory.data_and_model(cfg, data_keys=TRAIN_KEYS)
    assert info == jinfo
    assert isinstance(model.vae, MLPVAE) and model.vae.is_diag and model.vae.hidden == (256, 128)
    assert (model.vae.sigma_key, model.vae.packed_sigma) == ("L", False)
    batch = datasets["train"].batch(np.arange(2))
    variables = jmodel.init(jax.random.PRNGKey(0), {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, rng=jax.random.PRNGKey(0))
    want = from_jax_variables({k: np.array(v) for k, v in flax.traverse_util.flatten_dict(variables, sep="/").items()})
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {k: tuple(v.shape) for k, v in want.items()}
    trainer = train(cfg, datasets, model, info, device="cpu")
    table = trainer.state.opt_state.table
    assert len(table.w) == len(list(model.parameters())) and len(table.batches) == 2
    with open(tmp_path / "metrics.csv", newline="") as f:
        row = next(csv.DictReader(f))
    assert {"rotation_train", "prior_train", "root_train", "total_train"} <= set(row)
    assert all(np.isfinite(float(row[k])) for k in row if k.endswith("_train"))


def test_transformer_conditional_decode_and_factory_dispatch():
    """As the JAX package's own dispatch test (tests/test_models.py): a
    transformer with conditional decoding on avg_speed_3d and the one-hot
    ids builds, and its training forward has the JAX model's shapes; the
    factory's defaults are the JAX package's."""
    from scrubvae_torch.models.transformer import TransformerVAE

    mc = {"type": "transformer", "z_dim": 8, "window": 16, "n_heads": 2, "ff_size": 16, "n_layers": 1}
    dis = {"method": {"conditional": ["avg_speed_3d", "ids"]}}
    kw = dict(n_keypts=18, direction_process="midfwd", arena_size=ARENA, discrete_classes={"ids": np.arange(4)})
    model, info = factory.build_model(mc, dis, device="cpu", **kw)
    jmodel, jinfo = jfactory.build_model(mc, dis, **kw)
    assert info == jinfo and isinstance(model.vae, TransformerVAE)
    assert model.vae.conditional_dim == jmodel.vae.conditional_dim == 3 + 4
    data = {
        "x6d": torch.zeros(2, 16, 18, 6), "root": torch.zeros(2, 16, 3),
        "avg_speed_3d": torch.zeros(2, 3), "ids": torch.tensor([[0], [3]]),
    }
    out = model.train()(data, eps=torch.zeros(2, 8), generator=torch.Generator().manual_seed(0))
    assert out["x6d"].shape == (2, 16, 18, 6) and out["root"].shape == (2, 16, 3)
    assert out["mu"].shape == (2, 8) and out["L"].shape == (2, 8, 8) and out["var"].shape == (2, 7)
    assert bool(torch.isfinite(out["x6d"]).all())
    defaults, _ = factory.build_model({"type": "transformer", "z_dim": 8, "window": 16}, dis, device="cpu", **kw)
    jdefaults, _ = jfactory.build_model({"type": "transformer", "z_dim": 8, "window": 16}, dis, **kw)
    enc = defaults.vae.encoder
    assert len(enc.transformer_encoder.layers) == jdefaults.vae.n_layers == 4
    layer = enc.transformer_encoder.layers[0]
    assert (layer.self_attn.n_heads, layer.linear1.out_features, layer.activation, layer.dropout) == (
        jdefaults.vae.n_heads, jdefaults.vae.ff_size, jdefaults.vae.activation, 0.1,
    ) == (4, 512, "gelu", 0.1)
    assert defaults.vae.is_diag == jdefaults.vae.is_diag is False
    with pytest.raises(ValueError, match="unknown model type"):
        factory.build_model({"type": "lstm"}, dis, device="cpu", **kw)
