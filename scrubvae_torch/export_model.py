"""Export a trained run's encoder, mu-only encoder and decoder as serving
artifacts (counterpart of ``tools/export_model.py``):

    python -m scrubvae_torch.export_model --run RUNS/PROJ/NAME [--epoch E]
                                          [--out DIR] [--device cuda]

reads the run's ``model_config.yaml``, builds its data and model through
``factory.data_and_model`` (the train split), loads ``weights/epoch_E.pt``
(the newest epoch when ``--epoch`` is not given; a reference
``epoch_E.pth`` through the importer) and writes ``encoder.pt2``,
``encoder_mu.pt2`` and ``decoder.pt2`` (``torch.export`` programs with a
symbolic batch dimension, ``utils/export.py``) from an example batch of 2,
plus ``meta.json`` describing their inputs, into ``DIR`` (the run's
``export/`` by default). ``--device`` defaults to ``cuda``, which raises
without a GPU; the artifacts hold their weights on that device, and
``utils.export.load_exported`` moves them to another.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

DATA_KEYS = ("x6d", "root", "offsets", "target_pose", "avg_speed_3d", "heading")


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(prog="scrubvae_torch.export_model", description=__doc__.split("\n")[0])
    ap.add_argument("--run", required=True)
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from scrubvae_torch import factory
    from scrubvae_torch.params import read
    from scrubvae_torch.utils import checkpoint as ckpt
    from scrubvae_torch.utils.export import ENCODER_KEYS, export_decoder, export_encoder

    run = Path(args.run)
    cfg = read.config(run / "model_config.yaml", make_dirs=False)
    cfg["out_path"] = str(run) + "/"
    datasets, model, info = factory.data_and_model(
        cfg, train_val_test=("train",), data_keys=DATA_KEYS, device=args.device
    )
    epoch = args.epoch or int(max(factory.all_saved_epochs(run)))
    ckpt.load_weights(str(run) + "/", epoch, model)

    batch = datasets["train"].batch(np.arange(2))
    out_dir = Path(args.out or run / "export")
    out_dir.mkdir(parents=True, exist_ok=True)
    export_encoder(model, batch, out_dir / "encoder.pt2")
    export_encoder(model, batch, out_dir / "encoder_mu.pt2", mu_only=True)
    cond = tuple(info.get("conditional_keys") or ())
    export_decoder(model, batch, info["z_dim"], cond, out_dir / "decoder.pt2")
    enc_keys = [k for k in ENCODER_KEYS if k in batch]
    (out_dir / "meta.json").write_text(json.dumps({
        "epoch": epoch, "z_dim": info["z_dim"],
        "encoder_inputs": enc_keys, "decoder_conditionals": list(cond),
        # per-input trailing shapes (the batch dimension is symbolic)
        "input_shapes": {k: list(batch[k].shape[1:]) for k in enc_keys},
        "conditional_shapes": {k: list(batch[k].shape[1:]) for k in cond},
    }, indent=1))
    print(f"exported epoch {epoch} -> {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
