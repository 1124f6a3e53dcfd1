"""Loss-curve plotting (the port's own copy of ``scrubvae_tpu/plot/eval.py``):
grouped log-scale curves for VAE losses, disentanglement losses, and MCMI."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from scrubvae_torch.plot.constants import PALETTE_DICT
from scrubvae_torch.plot.plot import to_numpy

__all__ = ["loss"]


def loss(loss_dict: dict, out_path: str, disentangle_keys=()):
    import matplotlib.pyplot as plt

    gr_keys = [k + "_gr" for k in disentangle_keys]
    dis_keys = [k for k in loss_dict if k in (list(disentangle_keys) + gr_keys)]
    vae_keys = [k for k in loss_dict if k not in dis_keys + ["mcmi", "epoch"]]
    plots = [("vae", vae_keys)]
    if dis_keys:
        plots.append(("disentangle", dis_keys))
    if "mcmi" in loss_dict:
        plots.append(("mcmi", ["mcmi"]))

    out_paths = []
    for name, keys in plots:
        if not keys:
            continue
        fig = plt.figure(figsize=(15, 10))
        for i, k in enumerate(keys):
            vals = np.asarray(to_numpy(loss_dict[k]), dtype=float)
            plt.plot(
                np.arange(1, len(vals) + 1),
                vals,
                label=k,
                c=PALETTE_DICT[i % len(PALETTE_DICT)],
            )
        if name != "mcmi":
            plt.yscale("log")
        plt.xlabel("Epoch")
        plt.ylabel("Log Loss")
        plt.legend()
        out = Path(out_path) / "losses" / f"{name}.png"
        out.parent.mkdir(parents=True, exist_ok=True)
        plt.savefig(out)
        plt.close(fig)
        out_paths.append(str(out))
    return out_paths
