"""Serving export (counterpart of ``scrubvae_tpu/utils/export.py``): the
trained encoder, its mu-only variant and the decoder as ``torch.export``
programs (``.pt2``) with a symbolic batch dimension, which a serving host
loads and calls with torch alone, without this package's model code.

Artifacts:
  encoder:    {x6d, root} (or the x6d_enc/root_enc view when the model was
              trained with one) -> {"mu", and "Lp" (packed) or "L" (dense)};
              under the beta prior {"alpha", "beta", "mu"}
  encoder_mu: the same inputs -> {"mu"}
  decoder:    (z, {conditionals}) -> {"x6d", "root"}, and "var" when it
              decodes conditionally

The module that is traced owns no parameters: it calls the model without
holding it, so the trace lifts as constants exactly the tensors the call
reads. The mu-only artifact therefore embeds no sigma head (``fc_sigma``, or
``fc_sigma_u`` and ``fc_sigma_v`` under ``sigma_head_rank``), the encoder
artifacts no decoder and the decoder artifact no encoder. The beta prior
computes mu from both of its heads, so its mu-only artifact only restricts
the outputs to ``{"mu"}``.

An artifact holds its constants on the device it was exported on, and its
graph names that device; ``load_exported(..., device=...)`` moves both
(``torch.export.passes.move_to_device_pass``), so an artifact exported on
the CPU runs on the card, and the other way round.
"""

from __future__ import annotations

import contextlib
import io
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from scrubvae_torch.device import resolve_device

__all__ = ["ENCODER_KEYS", "export_encoder", "export_decoder", "load_exported"]

ENCODER_KEYS = ("x6d", "root", "x6d_enc", "root_enc")


class _Call(nn.Module):
    """Calls ``fn``; the model ``fn`` closes over is not a submodule, so
    none of its tensors is state of the exported program unless read."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


@contextlib.contextmanager
def _eval(model: nn.Module):
    was = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was)


def _export(model: nn.Module, fn: Callable, args: tuple, dynamic_shapes: tuple, path) -> bytes:
    with _eval(model), torch.no_grad():
        ep = torch.export.export(_Call(fn), args, dynamic_shapes=(dynamic_shapes,), strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    if path is not None:
        Path(path).write_bytes(blob)
    return blob


def export_encoder(
    model: nn.Module,
    example_batch: Dict[str, torch.Tensor],
    path: Optional[str | Path] = None,
    mu_only: bool = False,
) -> bytes:
    """Serialize ``model.encode`` in eval mode with a symbolic batch
    dimension on every encoder input the batch holds; returns the ``.pt2``
    bytes (and writes them to ``path`` when given). The artifact is called
    with a dict of those inputs."""
    keys = [k for k in ENCODER_KEYS if k in example_batch]

    def encode(data):
        out = model.encode(data, mu_only=mu_only)
        return {"mu": out["mu"]} if mu_only else out

    batch = torch.export.Dim("B", min=1)
    data = {k: example_batch[k] for k in keys}
    return _export(model, encode, (data,), ({k: {0: batch} for k in keys},), path)


def export_decoder(
    model: nn.Module,
    example_batch: Dict[str, torch.Tensor],
    z_dim: int,
    conditional_keys: Sequence[str] = (),
    path: Optional[str | Path] = None,
) -> bytes:
    """Serialize ``model.decode`` (z and the conditionals -> the pose) in
    eval mode with a symbolic batch dimension; called as ``fn(z, cond)``
    with ``cond`` a dict of the conditionals."""
    cond = {k: example_batch[k] for k in conditional_keys}
    n = next(iter(example_batch.values())).shape[0]
    z = torch.zeros(n, z_dim, device=next(model.parameters()).device)

    def decode(z, cond):
        return model.decode(z, dict(cond))

    batch = torch.export.Dim("B", min=1)
    dynamic = ({0: batch}, {k: {0: batch} for k in conditional_keys})
    return _export(model, decode, (z, cond), dynamic, path)


def load_exported(blob_or_path, device=None) -> Callable:
    """Deserialize an artifact into a callable (a ``torch.fx.GraphModule``
    that needs no code of this package), moved to ``device`` when given."""
    device = None if device is None else resolve_device(device)
    if isinstance(blob_or_path, (str, Path)):
        blob = Path(blob_or_path).read_bytes()
    else:
        blob = bytes(blob_or_path)
    ep = torch.export.load(io.BytesIO(blob))
    if device is not None:
        ep = move_to_device_pass(ep, str(device))
    return ep.module()
