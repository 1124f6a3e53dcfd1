"""Checkpoint and resume (counterpart of ``scrubvae_tpu/utils/checkpoint.py``).

The directory layout is the JAX package's and the reference's:
``weights/epoch_E.*`` every save interval, the full train state in
``checkpoints/epoch_E.*`` at the coarser one. The port's own files are
``torch.save`` of CPU tensors (``.pt``); the JAX package's msgpack files
are not read.

- Weights: the model's ``state_dict`` (parameters and BatchNorm buffers) in
  their storage dtype, so bf16 leaves stay bf16.
- Full state: the weights plus the optimizer's moments, its device step
  count and host step (the Philox counter of the rounding bits), the
  streaming scrubber states and the reparameterisation generator's state.

Loading writes into the live tensors in place (``copy_``): the optimizer's
leaf table records where every parameter and moment lies and refuses a
step after one moved.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, Optional

import torch
from torch import nn

from scrubvae_torch.train.state import TrainState

__all__ = [
    "save_weights",
    "load_weights",
    "save_train_state",
    "load_train_state",
    "reference_to_port",
]


def _cpu_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


@torch.no_grad()
def _copy_into(model: nn.Module, sd: Dict[str, torch.Tensor], strict: bool = True) -> list:
    """Copy ``sd`` into the model's parameters and buffers in place; returns
    the model's keys that ``sd`` did not fill (an error when ``strict``)."""
    own = model.state_dict(keep_vars=True)
    unknown = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    if strict and (unknown or missing):
        raise KeyError(f"checkpoint keys differ from the model's: unknown {unknown}, missing {missing}")
    for k, v in sd.items():
        if k not in own:
            continue
        dst = own[k]
        if dst.shape != v.shape:
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)} != model {tuple(dst.shape)}")
        dst.copy_(v)
    return missing


def save_weights(out_path: str, epoch: int, model: nn.Module) -> str:
    path = Path(out_path) / "weights" / f"epoch_{epoch}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(_cpu_state_dict(model), path)
    return str(path)


def reference_to_port(sd: Dict[str, torch.Tensor], port_keys) -> tuple:
    """Rename a reference-layout state dict (the reference torch model's
    ``model.state_dict()``, as ``scrubvae_tpu/utils/torch_export.py``
    writes it) to the port's names. The port's modules carry the reference's
    layouts, so only names change: the VAE's keys take the scope under
    which the port's encoder entry conv lives (``vae.``), the linear
    projection's ``disentangle.linear.{k}.decoder.weight`` becomes
    ``linear.{k}.weight``, and the gradient-reversal ensembles'
    ``disentangle.grad_reversal.{k}.reversal.1.mlpN.{2j}`` become
    ``grad_reversal.{k}.ensemble.mlpN_{j}``. Returns (renamed, the
    reference keys with no port counterpart)."""
    # The port nests the VAE under an enclosing scope; detect the prefix
    # from wherever the encoder entry conv actually lives.
    scope = ""
    for k in port_keys:
        m = re.match(r"(.*?)encoder\.conv_in\.weight$", k)
        if m:
            scope = m.group(1)
            break
    out, unmapped = {}, []
    for k, v in sd.items():
        if k.startswith(("encoder.", "decoder.")):
            out[scope + k] = v
        elif m := re.fullmatch(r"disentangle\.linear\.([^.]+)\.decoder\.weight", k):
            out[f"linear.{m.group(1)}.weight"] = v
        elif m := re.fullmatch(
            r"disentangle\.grad_reversal\.([^.]+)\.reversal\.1\.(mlp\d)\.(\d+)\.(weight|bias)", k
        ):
            feat, mlp, idx, wb = m.groups()
            out[f"grad_reversal.{feat}.ensemble.{mlp}_{int(idx) // 2}.{wb}"] = v
        else:
            unmapped.append(k)
    return out, sorted(unmapped)


def load_weights(load_path: str, epoch: int, model: nn.Module) -> None:
    """Load ``weights/epoch_E.pt`` into ``model`` in place, falling back to
    ``weights/epoch_E.pth``, a reference-trained torch checkpoint (loaded
    like the reference's ``strict=False``: mismatches are printed, never
    fatal), so a config's ``model.load_model`` can point at a reference run
    directly."""
    path = Path(load_path) / "weights" / f"epoch_{epoch}.pt"
    if not path.exists():
        pth = path.with_suffix(".pth")
        if pth.exists():
            sd = torch.load(pth, map_location="cpu", weights_only=True)
            renamed, unmapped = reference_to_port(sd, model.state_dict().keys())
            unfilled = _copy_into(model, renamed, strict=False)
            if unmapped:
                print(f"load_weights: {len(unmapped)} reference keys not mapped: {unmapped[:8]}")
            if unfilled:
                print(f"load_weights: {len(unfilled)} port leaves left as they were: {unfilled[:8]}")
            return
    _copy_into(model, torch.load(path, map_location="cpu", weights_only=True))


def _scrub_tensors(scrub_state: dict) -> dict:
    return {
        method: {
            feat: {
                f.name: getattr(st, f.name).detach().cpu()
                for f in dataclasses.fields(st)
                if isinstance(getattr(st, f.name), torch.Tensor)
            }
            for feat, st in states.items()
        }
        for method, states in scrub_state.items()
    }


def save_train_state(out_path: str, epoch: int, model: nn.Module, state: TrainState) -> str:
    path = Path(out_path) / "checkpoints" / f"epoch_{epoch}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    opt = state.opt_state
    torch.save(
        {
            "model": _cpu_state_dict(model),
            "step": state.step,
            "opt": {
                "count": opt.count.detach().cpu(),
                "step": opt.step,
                "mu": [m.detach().cpu() for m in opt.mu],
                "nu": [n.detach().cpu() for n in opt.nu],
            },
            "scrub": _scrub_tensors(state.scrub_state),
            "generator": state.generator.get_state(),
        },
        path,
    )
    return str(path)


@torch.no_grad()
def load_train_state(
    load_path: str, epoch: int, model: nn.Module, state: TrainState
) -> Optional[TrainState]:
    """Restore ``checkpoints/epoch_E.pt`` into ``model`` and ``state``'s
    moments in place; returns the state with the step counts, scrubber
    states and generator restored, or None when there is no such file."""
    path = Path(load_path) / "checkpoints" / f"epoch_{epoch}.pt"
    if not path.exists():
        return None
    ck = torch.load(path, map_location="cpu", weights_only=True)
    _copy_into(model, ck["model"])
    opt = state.opt_state
    for dst, src in zip(opt.mu + opt.nu, ck["opt"]["mu"] + ck["opt"]["nu"]):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(
                f"moment {tuple(src.shape)} {src.dtype} in the checkpoint, "
                f"{tuple(dst.shape)} {dst.dtype} in the optimizer"
            )
        dst.copy_(src)
    scrub = {
        method: {
            feat: st.replace(**{k: v.to(getattr(st, k).device) for k, v in ck["scrub"][method][feat].items()})
            for feat, st in states.items()
        }
        for method, states in state.scrub_state.items()
    }
    state.generator.set_state(ck["generator"])
    return state.replace(
        step=int(ck["step"]),
        opt_state=dataclasses.replace(
            opt, count=ck["opt"]["count"].to(opt.count.device), step=int(ck["opt"]["step"])
        ),
        scrub_state=scrub,
    )
