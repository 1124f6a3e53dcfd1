"""The measured program, reached through its own entries only: the frame
store and window dataset (``data.pipeline``, ``data.dataset``), the model
(``factory.build_model``) and the trainer (``train.trainer.Trainer``),
whose ``train_epoch`` the window drives; and what the comparison reads
of the trained state afterwards."""

from __future__ import annotations

import pathlib
from typing import Dict

import numpy as np
import torch

from benchmark.reference.step import ADAM_B1, KEYS, QDA_FIELDS, norm

HERE = pathlib.Path(__file__).resolve().parent
SKELETON = HERE / "data" / "mouse_skeleton.yaml"


def build(sections: dict, pose: np.ndarray, ids: np.ndarray, device):
    """(trainer, train dataset) of the configuration's sections on ``device``."""
    from scrubvae_torch import factory
    from scrubvae_torch.data.dataset import StreamDataset
    from scrubvae_torch.data.pipeline import build_frame_store
    from scrubvae_torch.data.skeleton import load_skeleton
    from scrubvae_torch.train.trainer import Trainer

    data_cfg, model_cfg, train_cfg = sections["data"], dict(sections["model"]), sections["train"]
    window = model_cfg.get("window") or 51
    if train_cfg.get("precision"):
        model_cfg.setdefault("precision", train_cfg["precision"])
    arena = np.asarray(data_cfg["arena_size"], np.float32)
    dp = data_cfg.get("direction_process") or "midfwd"
    skel = load_skeleton(SKELETON)
    store = build_frame_store(pose, ids, skel, window=window, stride=int(data_cfg.get("stride") or 2), device=device)
    ds = StreamDataset(store, skel, KEYS, dp, arena_size=arena, discrete_classes={"ids": np.unique(ids)}, device=device)
    model, info = factory.build_model(
        model_cfg, sections["disentangle"], n_keypts=skel.n_keypts, direction_process=dp, arena_size=arena,
        discrete_classes=ds.discrete_classes, loss_keys=sections["loss"].keys(), device=device,
    )
    cfg = {**sections, "model": model_cfg, "out_path": str(HERE.parent / "build" / "bench_run") + "/"}
    return Trainer(cfg, {"train": ds}, model, info, device=device), ds


def adv_nets(trainer) -> Dict[str, torch.nn.Module]:
    return {k: st.net for k, st in trainer.state.adv_states.items()}


def first_grads(trainer) -> Dict[str, float]:
    """Each leaf's norm of the first gradient as the optimizer took it,
    worked out from its first moment after one update: m1 = (1 - b1) g."""
    names = [n for n, _ in trainer.model.named_parameters()]
    return {n: norm(m.float() / (1.0 - ADAM_B1)) for n, m in zip(names, trainer.state.opt_state.mu)}


def changes(trainer, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: norm(p.detach().float() - start[n]) for n, p in trainer.model.named_parameters()}


def state_norms(trainer, adv_start: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The norms the reference's ``state_norms`` gives, of the program's
    state: BatchNorm's running statistics, MALS and QDA, MCMI's samples
    and each discriminator's change."""
    model, st = trainer.model, trainer.state
    out = {f"bn.{n}": norm(b) for n, b in model.named_buffers() if b.is_floating_point() and "running" in n}
    for k, s in st.scrub_state.get("moving_avg_lsq", {}).items():
        out.update({f"mals.{k}.{f}": norm(getattr(s, f)) for f in ("Sxx0", "Sxy0", "Sxx1", "Sxy1", "lam0", "lam1")})
    for k, s in st.scrub_state.get("qda", {}).items():
        out.update({f"qda.{k}.{f}": norm(getattr(s, f)) for f in QDA_FIELDS})
    if trainer.use_mcmi:
        out.update({"mi.x_s": norm(st.mi_state.x_s), "mi.y_s": norm(st.mi_state.y_s)})
    for k, net in adv_nets(trainer).items():
        out.update({f"adv.{k}.{n}": norm(p.detach() - adv_start[k][n]) for n, p in net.named_parameters()})
    return out
