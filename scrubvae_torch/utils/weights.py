"""Carry weights from the JAX package into the port.

``from_jax_variables`` maps a flax ``params``/``batch_stats`` tree,
flattened to ``"params/vae/encoder/..."`` numpy arrays, onto the port's
``ScrubVAE`` state-dict names. The port keeps its own copy of the layout
rules (``scrubvae_tpu/utils/torch_export.py`` holds the same ones):

- conv kernel (k, in, out)                  -> Conv1d weight (out, in, k)
- input-dilated correlation kernel          -> ConvTranspose1d weight
  (k, in, out)                                 (in, out, k), flipped along k
- dense kernel (in, out)                    -> Linear weight (out, in)
- flax flattens the encoder output length-major (L, C); the port's NCW
  flatten is channel-major (C, L): fc_mu / fc_sigma inputs and fc_in
  outputs take the permutation
- BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_*
- scalar PReLU alpha                        -> weight of shape (1,)

The maps are linear rearrangements, so they carry gradients and updates
as well as weights.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from scrubvae_torch.models.scrubbers import MALSState

__all__ = ["from_jax_variables", "mals_state_from_numpy"]


def _conv_w(k: np.ndarray) -> np.ndarray:
    return k.transpose(2, 1, 0)


def _convT_w(k: np.ndarray) -> np.ndarray:
    return k[::-1].transpose(1, 2, 0)


def _lc_to_cl(C: int, L: int) -> np.ndarray:
    """p with flat_port[p[j]] == flat_flax[j] for j = l*C + c."""
    j = np.arange(L * C)
    return (j % C) * L + j // C


def _strip_scope(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """params/vae/encoder/... -> params/encoder/... (and for batch_stats)."""
    out = {}
    for p, v in flat.items():
        for root in ("params/", "batch_stats/"):
            if p.startswith(root + "vae/"):
                p = root + p[len(root) + 4 :]
        out[p] = v
    return out


def from_jax_variables(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Port state dict (CPU f32 tensors) from a flattened flax tree. Takes
    whatever leaves are present (a gradient tree has no batch_stats) and
    raises on a leaf it cannot place."""
    flat = {k: np.asarray(v, dtype=np.float32) for k, v in _strip_scope(flat).items()}
    sd: Dict[str, np.ndarray] = {}
    used = set()

    def take(path):
        if path in flat:
            used.add(path)
            return flat[path]
        return None

    def conv(src, dst, transpose=False):
        w, b = take(f"params/{src}/kernel"), take(f"params/{src}/bias")
        if w is not None:
            sd[f"vae.{dst}.weight"] = _convT_w(w) if transpose else _conv_w(w)
        if b is not None:
            sd[f"vae.{dst}.bias"] = b

    def bn(mod, name, dst):
        for src, key in (
            (f"params/{mod}/{name}/scale", "weight"),
            (f"params/{mod}/{name}/bias", "bias"),
            (f"batch_stats/{mod}/{name}/mean", "running_mean"),
            (f"batch_stats/{mod}/{name}/var", "running_var"),
        ):
            v = take(src)
            if v is not None:
                sd[f"vae.{dst}.{key}"] = v
        if f"vae.{dst}.running_var" in sd:
            sd[f"vae.{dst}.num_batches_tracked"] = np.zeros((), np.int64)

    def prelu(src, dst):
        a = take(f"params/{src}/alpha")
        if a is not None:
            sd[f"vae.{dst}.weight"] = a.reshape(1)

    def blocks(prefix):
        pat = re.compile(rf"(?:params|batch_stats)/{prefix}_(\d+)/")
        return sorted({int(m.group(1)) for p in flat if (m := pat.match(p))})

    conv("encoder/Conv1d_0/Conv_0", "encoder.conv_in")
    prelu("encoder/PReLU_0", "encoder.activation")
    for i in blocks("encoder/ResidualBlock"):
        f, t = f"encoder/ResidualBlock_{i}", f"encoder.res_layers.{i}"
        conv(f"{f}/Conv1d_0/Conv_0", f"{t}.residual.0")
        bn(f, "BatchNorm_0", f"{t}.residual.1")
        prelu(f"{f}/PReLU_0", f"{t}.residual.2")
        conv(f"{f}/Conv1d_1/Conv_0", f"{t}.residual.3")
        conv(f"{f}/Conv1d_2/Conv_0", f"{t}.skip")
        bn(f, "BatchNorm_1", f"{t}.add.0")
        prelu(f"{f}/PReLU_1", f"{t}.add.1")

    # encoder output channels: the widest second conv of the encoder blocks
    widths = [
        v.shape[-1]
        for p, v in flat.items()
        if re.fullmatch(r"params/encoder/ResidualBlock_\d+/Conv1d_1/Conv_0/kernel", p)
    ]
    C = max(widths) if widths else None

    def perm(n):
        return _lc_to_cl(C, n // C) if C and n % C == 0 else np.arange(n)

    for src, dst in (("encoder/fc_mu", "encoder.fc_mu"), ("encoder/fc_sigma", "encoder.fc_sigma.0")):
        k, b = take(f"params/{src}/kernel"), take(f"params/{src}/bias")
        if k is not None:
            w = np.empty((k.shape[1], k.shape[0]), np.float32)
            w[:, perm(k.shape[0])] = k.T
            sd[f"vae.{dst}.weight"] = w
        if b is not None:
            sd[f"vae.{dst}.bias"] = b
    k, b = take("params/decoder/fc_in/kernel"), take("params/decoder/fc_in/bias")
    if k is not None:
        w = np.empty((k.shape[1], k.shape[0]), np.float32)
        w[perm(k.shape[1])] = k.T
        sd["vae.decoder.fc_in.weight"] = w
    if b is not None:
        bt = np.empty_like(b)
        bt[perm(b.shape[0])] = b
        sd["vae.decoder.fc_in.bias"] = bt

    for i in blocks("decoder/ResidualBlockTranspose"):
        f, t = f"decoder/ResidualBlockTranspose_{i}", f"decoder.res_layers.{i}"
        conv(f"{f}/ConvTranspose1d_0", f"{t}.residual.0", transpose=True)
        bn(f, "BatchNorm_0", f"{t}.residual.1")
        prelu(f"{f}/PReLU_0", f"{t}.residual.2")
        conv(f"{f}/ConvTranspose1d_1", f"{t}.residual.3", transpose=True)
        conv(f"{f}/Conv1d_0/Conv_0", f"{t}.skip.1")
        bn(f, "BatchNorm_1", f"{t}.add.0")
        prelu(f"{f}/PReLU_1", f"{t}.add.1")
    conv("decoder/conv_out", "decoder.conv_out", transpose=True)

    for p in list(flat):
        if m := re.fullmatch(r"params/linear_([^/]+)/kernel", p):
            sd[f"linear.{m.group(1)}.weight"] = take(p)  # (out, z) in both
        elif m := re.fullmatch(r"params/gr_([^/]+)/ensemble/(mlp\d_\d)/(kernel|bias)", p):
            feat, layer, kind = m.groups()
            v = take(p)
            key = f"grad_reversal.{feat}.ensemble.{layer}."
            sd[key + ("weight" if kind == "kernel" else "bias")] = v.T if kind == "kernel" else v

    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"from_jax_variables: no port counterpart for {unused}")
    # ascontiguousarray makes a 0-d array 1-d; the reshape keeps scalars 0-d
    return {k: torch.from_numpy(np.ascontiguousarray(v).reshape(v.shape)) for k, v in sd.items()}


def mals_state_from_numpy(arrays: Dict[str, np.ndarray], like: MALSState, device=None) -> MALSState:
    """A MALS state with the arrays of a JAX ``MALSState`` (Sxx0, Sxy0, Sxx1,
    Sxy1, lam0, lam1) and ``like``'s static settings."""
    dev = like.Sxx0.device if device is None else device
    return like.replace(
        **{
            k: torch.as_tensor(np.asarray(arrays[k], np.float32), device=dev)
            for k in ("Sxx0", "Sxy0", "Sxx1", "Sxy1", "lam0", "lam1")
        }
    )
