"""The port's weights as the reference torch model's ``state_dict``
(counterpart of ``scrubvae_tpu/utils/torch_export.py``), so a run trained
with the port plugs into the reference's eval and plot tooling, which loads
``weights/epoch_E.pth`` with ``strict=False``.

The port's modules already carry the reference's names and layouts under
the VAE's scope ``vae.`` (``utils/weights.py``), so the export is a filter
over ``state_dict()`` that renames; ``utils/torch_import.py`` inverts it:

- ``vae.encoder.*`` and ``vae.decoder.*`` lose the scope;
- ``linear.{f}.weight`` -> ``disentangle.linear.{f}.decoder.weight``;
- ``grad_reversal.{f}.ensemble.mlpN_{j}.*`` ->
  ``disentangle.grad_reversal.{f}.reversal.1.mlpN.{2j}.*``;
- the low-rank sigma head (``fc_sigma_u`` then ``fc_sigma_v``, a deviation
  with no reference counterpart) is written as the dense
  ``encoder.fc_sigma.0`` it factors, W = Kv Ku and b = Kv bu + bv, composed
  in float64 and rounded once;
- ``num_batches_tracked`` is written as 0, as the JAX package writes it
  (its BatchNorm counts nothing);
- every value as an f32 CPU tensor (bf16 storage widens exactly).

The leaves the JAX package's exporter leaves out stay out here as well and
are returned as ``unexported``: a transformer writes its encoder and
decoder only (not ``cond_proj``, not the scrubber heads), and any other
model goes the rcnn's way, which for an ``mlp`` writes the scrubber heads
alone.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping, Tuple, Union

import torch
from torch import nn

__all__ = ["export_resvae_state_dict", "export_transformer_state_dict", "export_torch_weights"]


def _state(model_or_state_dict: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    if isinstance(model_or_state_dict, nn.Module):
        return model_or_state_dict.state_dict()
    return dict(model_or_state_dict)


def vae_scope(keys) -> str:
    """The prefix under which the VAE's encoder lives (``vae.`` in the
    port's ``ScrubVAE``); "" when no key names the encoder's entry layer,
    as for an ``mlp``, whose layers the reference layout does not name."""
    for k in keys:
        if m := re.fullmatch(r"(.*?)encoder\.(conv_in|pose_embedding)\.weight", k):
            return m.group(1)
    return ""


def _f32(v: torch.Tensor) -> torch.Tensor:
    return v.detach().to("cpu", torch.float32, copy=True)


def _vae_part(sd: Dict[str, torch.Tensor], out: dict, used: set) -> None:
    """The encoder's and decoder's leaves, their scope stripped."""
    scope = vae_scope(sd)
    for k, v in sd.items():
        if scope and not k.startswith(scope):
            continue
        name = k[len(scope):]
        if name.startswith(("encoder.", "decoder.")):
            used.add(k)
            if name.endswith("num_batches_tracked"):
                out[name] = torch.zeros((), dtype=torch.int64)
            else:
                out[name] = _f32(v)


def export_resvae_state_dict(model_or_state_dict) -> Tuple[Dict[str, torch.Tensor], list]:
    """The reference ResVAE's ``state_dict`` (encoder, decoder and the
    ``disentangle`` heads) from the port's model or its state dict.
    Returns ``(state_dict, unexported port keys)``."""
    sd = _state(model_or_state_dict)
    out: Dict[str, torch.Tensor] = {}
    used: set = set()
    _vae_part(sd, out, used)
    if "encoder.fc_sigma_v.weight" in out:
        ku, bu = (out.pop(f"encoder.fc_sigma_u.{p}").double() for p in ("weight", "bias"))
        kv, bv = (out.pop(f"encoder.fc_sigma_v.{p}").double() for p in ("weight", "bias"))
        out["encoder.fc_sigma.0.weight"] = (kv @ ku).float()
        out["encoder.fc_sigma.0.bias"] = (kv @ bu + bv).float()
    for k, v in sd.items():
        if m := re.fullmatch(r"linear\.([^.]+)\.weight", k):
            out[f"disentangle.linear.{m.group(1)}.decoder.weight"] = _f32(v)
        elif m := re.fullmatch(r"grad_reversal\.([^.]+)\.ensemble\.(mlp\d)_(\d+)\.(weight|bias)", k):
            feat, mlp, j, wb = m.groups()
            out[f"disentangle.grad_reversal.{feat}.reversal.1.{mlp}.{2 * int(j)}.{wb}"] = _f32(v)
        else:
            continue
        used.add(k)
    return out, sorted(set(sd) - used)


def export_transformer_state_dict(model_or_state_dict) -> Tuple[Dict[str, torch.Tensor], list]:
    """The reference TransformerVAE's ``state_dict`` (encoder and decoder)
    from the port's model or its state dict. Returns ``(state_dict,
    unexported port keys)``."""
    sd = _state(model_or_state_dict)
    out: Dict[str, torch.Tensor] = {}
    used: set = set()
    _vae_part(sd, out, used)
    return out, sorted(set(sd) - used)


def export_torch_weights(model_or_state_dict, path: Union[str, Path], verbose: bool = True) -> list:
    """Write ``path`` (a torch ``.pth``) in the reference layout, a
    transformer's where a key names ``pose_embedding``, else the ResVAE's;
    returns the unexported port keys."""
    sd = _state(model_or_state_dict)
    if any("pose_embedding" in k for k in sd):
        out, unexported = export_transformer_state_dict(sd)
    else:
        out, unexported = export_resvae_state_dict(sd)
    torch.save(out, path)
    if verbose and unexported:
        print(
            f"torch_export: {len(unexported)} port leaves with no reference counterpart: "
            f"{unexported[:8]}{'...' if len(unexported) > 8 else ''}"
        )
    return unexported
