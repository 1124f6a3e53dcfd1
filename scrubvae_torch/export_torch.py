"""Write a trained run's weights as a reference-layout torch ``.pth``
(counterpart of ``tools/export_torch.py``):

    python -m scrubvae_torch.export_torch --run RUNS/PROJ/NAME --epoch E
                                          [--out RUNS/PROJ/NAME/weights/epoch_E.pth]

reads ``weights/epoch_E.pt`` from the run folder (a state dict; no model is
built, and nothing runs on a device) and writes the state dict the
reference codebase loads with ``strict=False``
(``utils/torch_export.py``), so runs trained with the port plug into the
reference's eval and plot tooling.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(prog="scrubvae_torch.export_torch", description=__doc__.split("\n")[0])
    ap.add_argument("--run", required=True)
    ap.add_argument("--epoch", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from scrubvae_torch.utils.torch_export import export_torch_weights

    run = Path(args.run)
    src = run / "weights" / f"epoch_{args.epoch}.pt"
    if not src.exists():
        sys.exit(f"no checkpoint at {src}")
    out = Path(args.out or run / "weights" / f"epoch_{args.epoch}.pth")
    unexported = export_torch_weights(torch.load(src, map_location="cpu", weights_only=True), out)
    print(f"wrote {out} ({len(unexported)} port-only leaves skipped)")
    return out


if __name__ == "__main__":
    main()
