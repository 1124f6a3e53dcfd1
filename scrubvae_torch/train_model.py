"""Training entry point of the port (counterpart of the repository's
``train_model.py``):

    python -m scrubvae_torch.train_model -o OUT -p PROJECT -n NAME [--device cpu]

reads ``OUT/PROJECT/NAME/model_config.yaml``, trains, and writes
``metrics.csv``, ``weights/`` and ``checkpoints/`` next to it. ``--job_id
I`` picks the I-th of the project's run folders in sorted order instead of
``--name`` (array jobs); ``--wandb`` also logs to wandb when it can.
``--device`` defaults to ``cuda``, which raises without a GPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="scrubvae_torch.train_model", description="Train SC-VAE models with the PyTorch port"
    )
    parser.add_argument("--out_path", "-o", type=str, dest="out_path")
    parser.add_argument("--job_id", type=int, dest="job_id", default=None)
    parser.add_argument("--project", "-p", type=str, dest="project")
    parser.add_argument("--name", "-n", type=str, dest="name", default=None)
    parser.add_argument("--wandb", action="store_true", dest="use_wandb")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    if args.job_id is not None:
        z_path = Path(args.out_path) / args.project
        folders = sorted(str(f.parts[-1]) for f in z_path.iterdir() if f.is_dir())
        name = folders[args.job_id]
    else:
        name = args.name

    from scrubvae_torch.params import read

    config = read.config(Path(args.out_path) / args.project / name / "model_config.yaml")

    run = None
    if args.use_wandb:
        try:
            import wandb

            wandb.login()
            run = wandb.init(project=args.project, name=name, config=config)
        except Exception as e:  # hermetic machines have no wandb or no network
            print(f"wandb unavailable ({e}); falling back to CSV metrics")

    from scrubvae_torch.train.trainer import train

    trainer = train(config, run=run, device=args.device)
    if run is not None:
        run.finish()
    return trainer


if __name__ == "__main__":
    main()
