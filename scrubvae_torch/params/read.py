"""YAML config reading with schema default-filling (the port's own copy of
``scrubvae_tpu/params/read.py``).

Missing ``PARAM_KEYS`` entries become None (so code reads ``cfg[k] or
default``, never ``cfg.get(k, default)``), ``disentangle.features`` derives
as the sorted union of the method map's value lists, ``out_path: current``
resolves to the config's folder, the ``weights/ checkpoints/ latents/
losses/`` folders are created, and the resolved config is written back as
``model_config.yaml`` next to the outputs.
"""

from __future__ import annotations

from pathlib import Path

import yaml

from scrubvae_torch.params.param_keys import PARAM_KEYS

__all__ = ["config"]


def config(path: str | Path, make_dirs: bool = True) -> dict:
    path = Path(path)
    with open(path) as f:
        cfg = yaml.safe_load(f)

    for section, keys in PARAM_KEYS.items():
        cfg.setdefault(section, {})
        if cfg[section] is None:
            cfg[section] = {}
        for param in keys:
            cfg[section].setdefault(param, None)

    if not cfg["disentangle"].get("method"):
        cfg["disentangle"]["method"] = {}

    if not cfg["disentangle"].get("features"):
        feats = [f for v in cfg["disentangle"]["method"].values() for f in v]
        cfg["disentangle"]["features"] = sorted(set(feats))

    cfg.setdefault("loss", {})
    cfg.setdefault("out_path", "current")
    if cfg["out_path"] == "current":
        cfg["out_path"] = str(path.parent) + "/"

    if make_dirs:
        for folder in ("weights", "checkpoints", "latents", "losses"):
            Path(cfg["out_path"], folder).mkdir(parents=True, exist_ok=True)
        with open(Path(cfg["out_path"], "model_config.yaml"), "w") as f:
            yaml.dump(cfg, f)

    return cfg
