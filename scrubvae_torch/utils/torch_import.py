"""Reference torch ``.pth`` checkpoints into the port (counterpart of
``scrubvae_tpu/utils/torch_import.py``).

The reference saves ``model.state_dict()`` every 5 epochs and reloads it
with ``strict=False``. The port's modules carry the reference's names and
layouts under the VAE's scope (``vae.``), so importing renames and copies
in place (``reference_to_port``, the inverse of ``utils/torch_export.py``):

- ``encoder.*`` and ``decoder.*`` take the scope;
- ``disentangle.linear.{f}.decoder.weight`` -> ``linear.{f}.weight``;
- ``disentangle.grad_reversal.{f}.reversal.1.mlpN.{2j}.*`` ->
  ``grad_reversal.{f}.ensemble.mlpN_{j}.*``.

A reference TransformerVAE (its state dict names
``encoder.pose_embedding.*``) maps its encoder and decoder alone, as the JAX
package's importer does; its ``disentangle.*`` keys stay unmapped.

``strict=False`` as in the JAX package: the reference keys left unmapped
(under their reference names) and the port's leaves left unfilled are
reported, never fatal; a shape that differs raises ``ValueError``. The
unfilled leaves follow the JAX package's exclusions: no PReLU weight, and
for a ResVAE nothing outside its encoder and decoder; BatchNorm's
``num_batches_tracked`` has no JAX leaf and is never listed. A reference
``encoder.fc_sigma.0`` imported into a model with ``sigma_head_rank`` maps
to no leaf, and the low-rank head stays unfilled.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Tuple, Union

import torch
from torch import nn

from scrubvae_torch.models.layers import PReLU
from scrubvae_torch.utils.checkpoint import copy_into
from scrubvae_torch.utils.torch_export import vae_scope

__all__ = ["load_torch_state_dict", "reference_to_port", "import_torch_weights"]


def load_torch_state_dict(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """A reference ``weights/epoch_E.pth`` as CPU tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _is_transformer(sd) -> bool:
    return any(k.startswith("encoder.pose_embedding.") for k in sd)


def reference_to_port(sd: Dict[str, torch.Tensor], port_keys) -> tuple:
    """Rename a reference-layout state dict to the port's names. Returns
    (renamed, the reference keys with no port counterpart)."""
    scope = vae_scope(port_keys)
    scrubbers = not _is_transformer(sd)
    out, unmapped = {}, []
    for k, v in sd.items():
        if k.startswith(("encoder.", "decoder.")):
            out[scope + k] = v
        elif scrubbers and (m := re.fullmatch(r"disentangle\.linear\.([^.]+)\.decoder\.weight", k)):
            out[f"linear.{m.group(1)}.weight"] = v
        elif scrubbers and (
            m := re.fullmatch(r"disentangle\.grad_reversal\.([^.]+)\.reversal\.1\.(mlp\d)\.(\d+)\.(weight|bias)", k)
        ):
            feat, mlp, idx, wb = m.groups()
            out[f"grad_reversal.{feat}.ensemble.{mlp}_{int(idx) // 2}.{wb}"] = v
        else:
            unmapped.append(k)
    return out, sorted(unmapped)


def import_torch_weights(path: Union[str, Path], model: nn.Module, verbose: bool = True) -> Tuple[list, list]:
    """Load ``path`` into ``model`` in place. Returns ``(unmapped reference
    keys, unfilled port keys)``, printed when ``verbose``."""
    sd = load_torch_state_dict(path)
    own = model.state_dict()
    renamed, unmapped = reference_to_port(sd, own)
    missing = copy_into(model, renamed, strict=False)
    prelu = {f"{name}.weight" for name, m in model.named_modules() if isinstance(m, PReLU)}
    scope = vae_scope(own)
    vae_only = ("",) if _is_transformer(sd) else (scope + "encoder.", scope + "decoder.")
    unfilled = [
        k for k in missing
        if k not in prelu and not k.endswith("num_batches_tracked") and k.startswith(vae_only)
    ]
    if verbose and unmapped:
        print(f"torch_import: {len(unmapped)} reference keys not mapped: "
              f"{unmapped[:8]}{'...' if len(unmapped) > 8 else ''}")
    if verbose and unfilled:
        print(f"torch_import: {len(unfilled)} port leaves left as they were: "
              f"{unfilled[:8]}{'...' if len(unfilled) > 8 else ''}")
    return unmapped, unfilled
