"""Latent extraction with npy caching (counterpart of
``scrubvae_tpu/evals/latents.py``; reference get/eval.py:8-70): encode the
whole dataset in batches, cache to ``latents/{label}_{epoch}.npy``, report
the active dims.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

__all__ = ["latents", "encode_dataset"]


@torch.no_grad()
def encode_dataset(model, dataset, batch_size: int = 512) -> np.ndarray:
    """Every sample's mu, in batches of ``batch_size`` in dataset order, on
    the dataset's device. The encoder runs in eval mode (BatchNorm running
    statistics) with ``mu_only``, so the Cholesky head never runs; the
    model's train/eval mode is restored afterwards."""
    vae = getattr(model, "vae", model)
    was_training = model.training
    model.eval()
    try:
        n = len(dataset)
        zs = []
        for lo in range(0, n, batch_size):
            idx = torch.arange(lo, min(lo + batch_size, n), device=dataset.device)
            zs.append(vae.encode(dataset.batch(idx), mu_only=True)["mu"].cpu())
    finally:
        model.train(was_training)
    return torch.cat(zs).numpy()


def latents(
    config: dict,
    model=None,
    epoch: Optional[int] = None,
    dataset=None,
    label: str = "test",
    overwrite: bool = False,
    batch_size: int = 512,
    device=None,
) -> np.ndarray:
    """mu of every sample of ``dataset`` under the weights of ``epoch``,
    read from ``{out_path}/latents/{label}_{epoch}.npy`` when it exists
    (unless ``overwrite``), else encoded and written there. Without
    ``model``, the model is built from ``config`` on ``device`` and loads
    ``weights/epoch_{epoch}`` from ``model.load_model`` or ``out_path``."""
    path = Path(config["out_path"]) / "latents" / f"{label}_{epoch}.npy"
    if path.exists() and not overwrite:
        z = np.load(path)
        if dataset is not None and z.shape[0] != len(dataset):
            raise ValueError(f"{path} holds {z.shape[0]} latents for a dataset of {len(dataset)}")
    else:
        if model is None:
            from scrubvae_torch import factory
            from scrubvae_torch.utils import checkpoint as ckpt

            model, _ = factory.build_model(
                config["model"],
                config["disentangle"],
                n_keypts=dataset.n_keypts,
                direction_process=config["data"].get("direction_process"),
                arena_size=dataset.arena_size,
                discrete_classes=dataset.discrete_classes,
                device=device,
            )
            load_path = config["model"].get("load_model") or config["out_path"]
            ckpt.load_weights(load_path, epoch, model)
        z = encode_dataset(model, dataset, batch_size)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.save(path, z)

    nonzero = int((z.std(axis=0) > 0.1).sum())
    print(f"Latent dims with std > 0.1 over dataset: {nonzero}")
    return z
