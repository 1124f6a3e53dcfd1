"""Configs -> data, model and scrubber state (counterpart of ``feat_dims``,
``in_channels_for``, ``build_model``, ``init_scrub_state``,
``_discrete_classes_for``, ``mouse_data``, ``data_and_model`` and
``all_saved_epochs`` in ``scrubvae_tpu/factory.py``, and the adversarial
bundle of its ``init_scrub_state``): the ``rcnn``, ``transformer`` and
``mlp`` models; raw pose files (a frame store, optionally streamed from
host memory) and the preprocessed per-key layout; the parkinsons recoding
of ids into ``ids``, ``pd_label`` and ``fluorescence``."""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from scrubvae_torch.data.dataset import StreamDataset, WindowDataset
from scrubvae_torch.data.hoststream import HostStreamDataset
from scrubvae_torch.data.pipeline import AVG_SPEED_3D_MEAN, AVG_SPEED_3D_STD, build_frame_store
from scrubvae_torch.data.pose_io import key_file, read_key_h5, read_pose_h5
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.device import resolve_device
from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.models.layers import (
    BatchNorm1d,
    Conv1d,
    ConvTranspose1d,
    Linear,
    PReLU,
    lecun_normal_,
)
from scrubvae_torch.models.mlp_vae import MLPVAE
from scrubvae_torch.models.residual import ResVAE
from scrubvae_torch.models.scrubvae import ScrubVAE
from scrubvae_torch.models.transformer import LayerNorm, MultiheadAttention, TransformerVAE

__all__ = [
    "feat_dims",
    "in_channels_for",
    "build_model",
    "init_weights",
    "init_scrub_state",
    "init_adv_bundle",
    "mouse_data",
    "data_and_model",
    "all_saved_epochs",
    "latents",
]


def feat_dims(model_config: dict, discrete_classes: Optional[dict] = None) -> dict:
    """Feature-name -> dimension map."""
    window = model_config.get("window") or 51
    dims = {
        "avg_speed": 1,
        "part_speed": 4,
        "frame_speed": window - 1,
        "avg_speed_3d": 3,
        "heading": 2,
        "heading_change": 1,
        "fluorescence": 1,
    }
    if discrete_classes:
        dims.update({k: len(v) for k, v in discrete_classes.items()})
    return dims


def in_channels_for(n_keypts: int, direction_process: Optional[str]) -> int:
    """x6d channels, +3 root channels unless the representation drops the root."""
    c = n_keypts * 6
    if direction_process in ("x360", "midfwd", None):
        c += 3
    return c


def build_model(
    model_config: dict,
    disentangle_config: dict,
    n_keypts: int,
    direction_process: Optional[str],
    arena_size=None,
    discrete_classes: Optional[dict] = None,
    loss_keys=None,
    device="cuda",
) -> tuple:
    """Construct the ScrubVAE on ``device``. Returns (model, info).

    ``model.type`` picks the VAE, with the JAX package's defaults: ``rcnn``
    (the default), ``transformer`` (gelu, 4 heads, ``ff_size`` 512, 4
    layers) or ``mlp`` (``hidden`` 512-256; ``diag`` read as
    ``bool(get("diag", True))``, so an unset ``diag`` that the config reader
    filled with None is False, as in the JAX package). The rcnn's Cholesky
    head is packed unless a loss needs the dense (B, z, z) factor: with
    ``model.packed_sigma`` unset it is packed when the loss keys are known,
    exclude ``total_correlation`` and the prior is gaussian; an explicit
    ``model.packed_sigma`` wins. The other two always have the dense head.
    Only the rcnn reads ``precision``."""
    dev = resolve_device(device)
    mtype = model_config.get("type") or "rcnn"
    methods = disentangle_config.get("method") or {}
    fdims = feat_dims(model_config, discrete_classes)
    conditional_keys = list(methods.get("conditional", []))
    conditional_dim = sum(fdims[k] for k in conditional_keys)
    in_ch = in_channels_for(n_keypts, direction_process)
    if in_ch > n_keypts * 6 and arena_size is None:
        raise ValueError(
            f"direction_process={direction_process!r} includes the 3 root channels, "
            "which requires data.arena_size for root normalization"
        )
    common = dict(
        in_channels=in_ch,
        z_dim=model_config.get("z_dim") or 128,
        window=model_config.get("window") or 51,
        conditional_dim=conditional_dim,
        prior=model_config.get("prior") or "gaussian",
        arena_size=None if arena_size is None else np.asarray(arena_size, np.float32),
        conditional_keys=conditional_keys,
        discrete_classes={k: len(v) for k, v in (discrete_classes or {}).items()} or None,
    )
    if mtype == "rcnn":
        packed = model_config.get("packed_sigma")
        if packed is None:
            packed = (
                loss_keys is not None
                and "total_correlation" not in set(loss_keys)
                and (model_config.get("prior") or "gaussian") == "gaussian"
            )
        vae = ResVAE(
            ch=tuple(model_config.get("channel") or (64, 128, 256, 512, 1024)),
            kernel=model_config.get("kernel") or 5,
            activation=model_config.get("activation") or "prelu",
            is_diag=bool(model_config.get("diag")),
            init_dilation=model_config.get("init_dilation"),
            precision=model_config.get("precision") or "fp32",
            sigma_head_rank=model_config.get("sigma_head_rank"),
            packed_sigma=bool(packed),
            **common,
        )
    elif mtype == "transformer":
        vae = TransformerVAE(
            activation=model_config.get("activation") or "gelu",
            n_heads=model_config.get("n_heads") or 4,
            ff_size=model_config.get("ff_size") or 512,
            n_layers=model_config.get("n_layers") or 4,
            is_diag=bool(model_config.get("diag")),
            **common,
        )
    elif mtype == "mlp":
        vae = MLPVAE(
            hidden=tuple(model_config.get("hidden") or (512, 256)),
            is_diag=bool(model_config.get("diag", True)),
            **common,
        )
    else:
        raise ValueError(f"unknown model type {mtype!r}")
    model = ScrubVAE(
        vae,
        linear_dims={k: fdims[k] for k in methods.get("linear", [])},
        gr_dims={k: fdims[k] for k in methods.get("grad_reversal", [])},
        gr_alpha=float(disentangle_config.get("alpha") or 1.0),
    ).to(dev)
    info = dict(
        in_channels=in_ch,
        conditional_keys=conditional_keys,
        conditional_dim=conditional_dim,
        disentangle_keys=list(disentangle_config.get("features") or []),
        feat_dims=fdims,
        window=common["window"],
        z_dim=common["z_dim"],
    )
    return model, info


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """Deterministic init from ``seed``, drawn on the CPU so every device
    gets the same weights: flax's defaults (lecun-normal kernels, the
    attention's q, k and v projections each over its input width, zero
    biases, unit BatchNorm and LayerNorm scales, PReLU 0.25) and fresh
    running stats."""
    gen = torch.Generator().manual_seed(seed)

    def lecun(w: torch.Tensor, fan_in: int) -> None:
        tmp = torch.empty(w.shape, dtype=torch.float32)
        lecun_normal_(tmp, fan_in, gen)
        w.copy_(tmp)

    for m in model.modules():
        if isinstance(m, (Conv1d, ConvTranspose1d, Linear)):
            fan_in = m.in_features if isinstance(m, Linear) else m.in_channels * m.kernel_size[0]
            lecun(m.weight, fan_in)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, scr.LinearProjection):
            lecun(m.weight, m.weight.shape[0])
        elif isinstance(m, MultiheadAttention):
            lecun(m.in_proj_weight, m.in_proj_weight.shape[1])
            m.in_proj_bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, BatchNorm1d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        elif isinstance(m, PReLU):
            m.weight.fill_(0.25)


def init_scrub_state(
    disentangle_config: dict,
    loss_config: dict,
    z_dim: int,
    fdims: dict,
    device="cuda",
    discrete_classes: Optional[dict] = None,
) -> Dict[str, Dict]:
    """Streaming scrubber states per feature: MALS, and QDA and the
    moving-average class means over ``discrete_classes[feat]``."""
    dev = resolve_device(device)
    methods = disentangle_config.get("method") or {}
    scrub_state: Dict[str, Dict] = {}
    if "moving_avg_lsq" in methods:
        scrub_state["moving_avg_lsq"] = {
            feat: scr.mals_init(
                z_dim,
                fdims[feat],
                bias=(loss_config or {}).get(feat + "_mals", 0) < 0,
                polynomial_order=int(disentangle_config.get("polynomial") or 1),
                l2_reg=float(disentangle_config.get("l2_reg") or 0.0),
                device=dev,
            )
            for feat in methods["moving_avg_lsq"]
        }
    if "qda" in methods:
        scrub_state["qda"] = {
            feat: scr.qda_init(z_dim, np.asarray(discrete_classes[feat]), device=dev)
            for feat in methods["qda"]
        }
    if "moving_avg" in methods:
        scrub_state["moving_avg"] = {
            feat: scr.ma_init(z_dim, np.asarray(discrete_classes[feat]), device=dev)
            for feat in methods["moving_avg"]
        }
    return scrub_state


# the discriminators draw their init from seeds of their own
ADV_SEED_OFFSET = 1 << 20


def init_adv_bundle(disentangle_config: dict, z_dim: int, fdims: dict, seed: int, device="cuda") -> Optional[dict]:
    """The adversarial discriminators, one ``AdvNet`` over (z, conditionals)
    per ``adversarial_net`` feature, initialised as ``init_weights`` does
    from seed ``seed + ADV_SEED_OFFSET + i`` for the i-th feature, and their
    AdamW: ``FusedAdamW`` at lr 0.1, weight decay 1e-4, f32 moments (optax's
    ``adamw(0.1)`` in the JAX package), with a state, and so a leaf table,
    per net. Returns ``{"tx", "states"}``, or None without such a feature."""
    from scrubvae_torch.train.optim import FusedAdamW

    methods = disentangle_config.get("method") or {}
    if "adversarial_net" not in methods:
        return None
    dev = resolve_device(device)
    conditional_dim = sum(fdims[k] for k in methods.get("conditional", []))
    tx = FusedAdamW(0.1, weight_decay=1e-4, moment_dtype=torch.float32)
    states = {}
    for i, feat in enumerate(methods["adversarial_net"]):
        net = scr.AdvNet(z_dim + conditional_dim)
        init_weights(net, seed + ADV_SEED_OFFSET + i)
        net.to(dev)
        states[feat] = scr.AdvState(net=net, opt_state=tx.init(list(net.parameters())))
    return {"tx": tx, "states": states}


PD_ID_OFFSET = 36  # parkinsons: raw ids >= 36 are the disease animals


def _read_fluorescence(path) -> np.ndarray:
    """The ``Fluorescence`` column of a ``metadata.csv``, row by row (the
    row number is the raw animal id); empty cells are nan."""
    with open(path, newline="") as f:
        return np.asarray(
            [float(r["Fluorescence"]) if r["Fluorescence"].strip() else np.nan for r in csv.DictReader(f)],
            dtype=np.float64,
        )


def _discrete_classes_for(data: dict, dataset_name: str, data_keys, data_path: Optional[Path] = None) -> dict:
    """Discrete-class maps (reference get/data.py:73-95): the ids seen, or,
    for the parkinsons data, the recoding. It writes into ``data``: from
    the raw ids, ``pd_label`` = ids >= 36 (N, 1) and ``fluorescence`` =
    ``metadata.csv``'s column at the raw id (N, 1) f32, each when among
    ``data_keys``; then ``ids`` with 36 taken off the disease animals'.
    The class map of ids is then ``arange`` of the count of distinct ids."""
    discrete = {}
    ids = np.asarray(data["ids"])
    if dataset_name == "parkinsons":
        if "pd_label" in data_keys:
            data["pd_label"] = (ids >= PD_ID_OFFSET).astype(np.int64)[:, None]
            discrete["pd_label"] = np.unique(data["pd_label"])
        if "fluorescence" in data_keys and data_path is not None:
            fluor = _read_fluorescence(Path(data_path) / dataset_name / "metadata.csv")[ids]
            data["fluorescence"] = fluor.astype(np.float32)[:, None]
        ids = np.where(ids >= PD_ID_OFFSET, ids - PD_ID_OFFSET, ids)
        data["ids"] = ids
        discrete["ids"] = np.arange(len(np.unique(ids)))
    else:
        discrete["ids"] = np.unique(ids)
    return discrete


def _arena(data_config: dict) -> Optional[np.ndarray]:
    a = data_config.get("arena_size")
    return None if a is None else np.asarray(a, dtype=np.float32)


def mouse_data(
    data_config: dict,
    train_val_test: str = "train",
    data_keys: Sequence[str] = ("x6d", "root", "offsets"),
    skeleton_path: Optional[str] = None,
    stride: Optional[int] = None,
    window: Optional[int] = None,
    device="cuda",
):
    """The split's dataset on ``device``. From the raw pose file
    ``{data_path}/{dataset}/{split}/pose.h5`` (or ``{dataset}/pose.h5`` for
    ``full``): a ``StreamDataset`` (frame store built once, windows
    assembled per batch; the recoded ids and the metadata columns as
    per-window extras), or, with ``data.host_stream`` on the train split,
    a ``HostStreamDataset`` with the store in host memory. Without one: a
    ``WindowDataset`` of the preprocessed per-key files of the split
    (``pose_io.save_split``'s layout), whose raw ``avg_speed_3d`` is
    normalized here by the reference dataset's mean and std."""
    dev = resolve_device(device)
    data_path = Path(data_config["data_path"])
    skeleton = load_skeleton(skeleton_path or data_path / "mouse_skeleton.yaml")
    dataset_name = data_config.get("dataset") or "synthetic"
    window = window or data_config.get("window") or 51
    stride = stride or data_config.get("stride") or 2
    data_keys = list(data_keys)
    if "ids" not in data_keys:
        data_keys = data_keys + ["ids"]

    split_dir = data_path / dataset_name / train_val_test
    split_pose_file = split_dir / "pose.h5"
    pose_file = data_path / dataset_name / "pose.h5"
    if split_pose_file.exists() or (train_val_test == "full" and pose_file.exists()):
        pose, ids = read_pose_h5(split_pose_file if split_pose_file.exists() else pose_file)
        store = build_frame_store(
            pose, ids, skeleton, window=window, stride=stride,
            speed_threshold=2.25 if data_config.get("remove_speed_outliers") is not False else None,
            exact_offsets=bool(data_config.get("exact_offsets")),
            part_centered_speed=bool(data_config.get("part_centered_speed")),
            device=dev,
        )
        per_window = {"ids": store.ids[store.starts + window // 2].cpu().numpy()}
        discrete = _discrete_classes_for(per_window, dataset_name, data_keys, data_path=data_path)
        ds = StreamDataset(
            store=store,
            skeleton=skeleton,
            data_keys=tuple(data_keys),
            direction_process=data_config.get("direction_process") or "midfwd",
            arena_size=_arena(data_config),
            discrete_classes=discrete,
            device=dev,
            label=train_val_test,
            extras={k: v for k, v in per_window.items() if k == "ids" or k in data_keys},
        )
        # host streaming applies to the train split; the others stay on the
        # device, where the validation epoch reads them again and again
        if data_config.get("host_stream") and train_val_test == "train":
            ds = HostStreamDataset.from_stream(ds)
        return ds

    dp = data_config.get("direction_process")
    data = {
        key: read_key_h5(split_dir / key_file(key, dp), key)
        for key in data_keys
        if key not in ("pd_label", "fluorescence")
    }
    norm_params = {
        "avg_speed_3d": {
            "mean": np.asarray(AVG_SPEED_3D_MEAN, dtype=np.float32),
            "std": np.asarray(AVG_SPEED_3D_STD, dtype=np.float32),
        }
    }
    if "avg_speed_3d" in data:
        stats = norm_params["avg_speed_3d"]
        data["avg_speed_3d"] = (data["avg_speed_3d"] - stats["mean"]) / stats["std"]
    discrete = _discrete_classes_for(data, dataset_name, data_keys, data_path=data_path)
    return WindowDataset(
        data=data,
        arena_size=_arena(data_config),
        skeleton=skeleton,
        label=train_val_test,
        discrete_classes=discrete,
        norm_params=norm_params,
        device=dev,
    )


def data_and_model(
    config: dict,
    train_val_test: Sequence[str] = ("train", "val"),
    data_keys: Sequence[str] = ("x6d", "root", "offsets", "target_pose"),
    use_default_val_keys: bool = True,
    device="cuda",
):
    """Datasets of the splits and the model built for them (reference
    get/get.py:7-75). Returns (datasets, model, info)."""
    if use_default_val_keys:
        if config["data"].get("dataset") == "parkinsons":
            val_keys = ["ids", "x6d", "root", "offsets", "target_pose", "fluorescence", "pd_label"]
        else:
            val_keys = ["ids", "x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading"]
    else:
        val_keys = list(data_keys)
    # one window for the loaders and the model, from model or data
    window = config["model"].get("window") or config["data"].get("window") or 51
    # data.encoder_direction_process: the encoder reads a heading-free view
    # while the target keeps the configured representation
    # (ResVAE.encode, assemble_windows)
    enc_dp = config["data"].get("encoder_direction_process")
    enc_keys = ["x6d_enc", "root_enc"] if enc_dp and enc_dp != config["data"].get("direction_process") else []

    datasets = {
        label: mouse_data(
            config["data"], train_val_test=label,
            data_keys=(val_keys if label == "val" else list(data_keys)) + enc_keys,
            window=window, device=device,
        )
        for label in train_val_test
    }
    first = datasets[list(train_val_test)[0]]
    model_config = dict(config["model"])
    model_config["window"] = window
    if (config.get("train") or {}).get("precision"):
        model_config.setdefault("precision", config["train"]["precision"])
    model, info = build_model(
        model_config,
        config["disentangle"],
        n_keypts=first.n_keypts,
        direction_process=config["data"].get("direction_process"),
        arena_size=first.arena_size,
        discrete_classes=first.discrete_classes,
        loss_keys=(config.get("loss") or {}).keys(),
        device=device,
    )
    return datasets, model, info


def all_saved_epochs(path: str) -> np.ndarray:
    """Epoch numbers with saved weights (reference get/get.py:78-84)."""
    epochs = {int(re.findall(r"\d+", f.name)[0]) for f in (Path(path) / "weights").glob("epoch*")}
    return np.asarray(sorted(epochs), dtype=int)


def latents(*args, **kwargs):
    """``evals.latents.latents`` (the reference exposes it as
    ``get.latents``)."""
    from scrubvae_torch.evals.latents import latents as _latents

    return _latents(*args, **kwargs)
