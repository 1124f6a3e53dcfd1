"""Carry weights from the JAX package into the port.

``from_jax_variables`` maps a flax ``params``/``batch_stats`` tree,
flattened to ``"params/vae/encoder/..."`` numpy arrays, onto the port's
``ScrubVAE`` state-dict names, for each of the three model families (the
tree's own keys tell them apart). The port keeps its own copy of the
layout rules (``scrubvae_tpu/utils/torch_export.py`` holds the same ones
for the rcnn and the transformer):

- conv kernel (k, in, out)                  -> Conv1d weight (out, in, k)
- input-dilated correlation kernel          -> ConvTranspose1d weight
  (k, in, out)                                 (in, out, k), flipped along k
- dense kernel (in, out)                    -> Linear weight (out, in)
- flax flattens the encoder output length-major (L, C); the port's NCW
  flatten is channel-major (C, L): the inputs of the heads that read it
  (fc_mu, fc_sigma, the low-rank head's fc_sigma_u, the beta prior's
  fc_alpha and fc_beta) and fc_in's outputs take the permutation;
  fc_sigma_v reads the rank and is a plain dense kernel
- BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_*
- scalar PReLU alpha                        -> weight of shape (1,)
- attention ``query``/``key``/``value``       -> ``in_proj_weight`` (3d, d),
  kernels (d, heads, head_dim) and biases      rows in q, k, v order, and
                                               ``in_proj_bias``
- attention ``out`` kernel (heads, head_dim, d) -> ``out_proj.weight`` (d, d)
- LayerNorm scale                           -> weight
- the transformer's flax layers ``EncoderLayer_{i}``/``DecoderLayer_{i}``
  (``MultiHeadDotProductAttention_{0,1}``, ``Dense_{0,1}``,
  ``LayerNorm_{0,1,2}``) -> ``transformer_encoder.layers.{i}``/
  ``transformer_decoder.layers.{i}`` (``self_attn``, ``multihead_attn``,
  ``linear1``/``linear2``, ``norm1``/``norm2``/``norm3``); the MLP's
  ``enc_{i}``, ``fc_mu``, ``fc_sigma``, ``dec_{i}`` and ``dec_out`` keep
  their names

The maps are linear rearrangements, so they carry gradients and updates
as well as weights. ``adv_from_jax`` does the same for an adversarial
discriminator's tree, and ``*_state_from_numpy`` carry the arrays of the
JAX package's streaming-scrubber and MCMI states.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from scrubvae_torch.models.scrubbers import MAFilterState, MALSState, MIState, QDAState

__all__ = [
    "from_jax_variables",
    "adv_from_jax",
    "mals_state_from_numpy",
    "ma_state_from_numpy",
    "qda_state_from_numpy",
    "mi_state_from_numpy",
]


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


def _rcnn(take, sd: dict, flat: dict) -> None:
    """The rcnn ResVAE's leaves (``ResidualBlock_{i}``, ``fc_mu``,
    ``fc_sigma``, ``fc_in``, ``ResidualBlockTranspose_{i}``, ``conv_out``)."""

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

    for src, dst in (
        ("encoder/fc_mu", "encoder.fc_mu"), ("encoder/fc_sigma", "encoder.fc_sigma.0"),
        ("encoder/fc_sigma_u", "encoder.fc_sigma_u"), ("encoder/fc_alpha", "encoder.fc_alpha"),
        ("encoder/fc_beta", "encoder.fc_beta"),
    ):
        k, b = take(f"params/{src}/kernel"), take(f"params/{src}/bias")
        if k is not None:
            w = np.empty((k.shape[1], k.shape[0]), np.float32)
            w[:, perm(k.shape[0])] = k.T
            sd[f"vae.{dst}.weight"] = w
        if b is not None:
            sd[f"vae.{dst}.bias"] = b
    # the low-rank head's second factor reads the rank, not the flatten
    k, b = take("params/encoder/fc_sigma_v/kernel"), take("params/encoder/fc_sigma_v/bias")
    if k is not None:
        sd["vae.encoder.fc_sigma_v.weight"] = k.T
    if b is not None:
        sd["vae.encoder.fc_sigma_v.bias"] = b
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


def _mha_in_proj(ks, bs):
    """q, k, v kernels (d, heads, head_dim) and biases (heads, head_dim) ->
    ``in_proj_weight`` (3d, d) and ``in_proj_bias`` (3d,)."""
    d = ks[0].shape[0]
    w = np.concatenate([k.reshape(d, -1).T for k in ks], axis=0)
    b = None if any(x is None for x in bs) else np.concatenate([x.reshape(-1) for x in bs])
    return w, b


def _transformer(take, dense, sd: dict, flat: dict) -> None:
    """The transformer's leaves: ``pose_embedding``, the encoder and
    decoder layers, ``fc_mu``, ``fc_sigma``, ``fc_out`` and ``cond_proj``."""

    def mha(src, dst):
        ks = [take(f"params/{src}/{n}/kernel") for n in ("query", "key", "value")]
        bs = [take(f"params/{src}/{n}/bias") for n in ("query", "key", "value")]
        if all(k is not None for k in ks):
            sd[f"vae.{dst}.in_proj_weight"], b = _mha_in_proj(ks, bs)
            if b is not None:
                sd[f"vae.{dst}.in_proj_bias"] = b
        ok, ob = take(f"params/{src}/out/kernel"), take(f"params/{src}/out/bias")
        if ok is not None:
            sd[f"vae.{dst}.out_proj.weight"] = ok.reshape(-1, ok.shape[-1]).T
        if ob is not None:
            sd[f"vae.{dst}.out_proj.bias"] = ob

    def norm(src, dst):
        w, b = take(f"params/{src}/scale"), take(f"params/{src}/bias")
        if w is not None:
            sd[f"vae.{dst}.weight"] = w
        if b is not None:
            sd[f"vae.{dst}.bias"] = b

    def layers(side, name):
        pat = re.compile(rf"params/{side}/{name}_(\d+)/")
        return sorted({int(m.group(1)) for p in flat if (m := pat.match(p))})

    dense("encoder/pose_embedding", "encoder.pose_embedding")
    for i in layers("encoder", "EncoderLayer"):
        f, t = f"encoder/EncoderLayer_{i}", f"encoder.transformer_encoder.layers.{i}"
        mha(f"{f}/MultiHeadDotProductAttention_0", f"{t}.self_attn")
        dense(f"{f}/Dense_0", f"{t}.linear1")
        dense(f"{f}/Dense_1", f"{t}.linear2")
        norm(f"{f}/LayerNorm_0", f"{t}.norm1")
        norm(f"{f}/LayerNorm_1", f"{t}.norm2")
    dense("encoder/fc_mu", "encoder.fc_mu")
    dense("encoder/fc_sigma", "encoder.fc_sigma.0")
    for i in layers("decoder", "DecoderLayer"):
        f, t = f"decoder/DecoderLayer_{i}", f"decoder.transformer_decoder.layers.{i}"
        mha(f"{f}/MultiHeadDotProductAttention_0", f"{t}.self_attn")
        mha(f"{f}/MultiHeadDotProductAttention_1", f"{t}.multihead_attn")
        dense(f"{f}/Dense_0", f"{t}.linear1")
        dense(f"{f}/Dense_1", f"{t}.linear2")
        for j in range(3):
            norm(f"{f}/LayerNorm_{j}", f"{t}.norm{j + 1}")
    dense("decoder/fc_out", "decoder.fc_out")
    dense("cond_proj", "cond_proj")


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

    def dense(src, dst):
        k, b = take(f"params/{src}/kernel"), take(f"params/{src}/bias")
        if k is not None:
            sd[f"vae.{dst}.weight"] = k.T
        if b is not None:
            sd[f"vae.{dst}.bias"] = b

    if any(p.startswith("params/encoder/pose_embedding/") for p in flat):
        _transformer(take, dense, sd, flat)
    elif any(p.startswith(("params/enc_0/", "params/dec_out/")) for p in flat):
        for p in sorted({p.split("/")[1] for p in flat if p.startswith("params/")}):
            if re.fullmatch(r"(enc|dec)_\d+|fc_mu|fc_sigma|dec_out", p):
                dense(p, p)
    else:
        _rcnn(take, sd, flat)

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


def adv_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``AdvNet`` state dict (CPU f32 tensors) from a flattened flax
    ``AdvNet`` tree (``params/MLPEnsemble_0/mlpN_j/{kernel,bias}``, or the
    same leaves of an AdamW moment tree), kernels transposed."""
    sd = {}
    for p, v in flat.items():
        m = re.fullmatch(r"(?:params/)?MLPEnsemble_0/(mlp\d_\d)/(kernel|bias)", p)
        if m is None:
            raise KeyError(f"adv_from_jax: no port counterpart for {p}")
        layer, kind = m.groups()
        v = np.array(v, dtype=np.float32)
        sd[f"ensemble.{layer}." + ("weight" if kind == "kernel" else "bias")] = v.T if kind == "kernel" else v
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _from_numpy(arrays: Dict[str, np.ndarray], like, fields, device):
    return like.replace(
        **{k: torch.as_tensor(np.array(arrays[k], np.float32), device=device) for k in fields}
    )


def ma_state_from_numpy(arrays: Dict[str, np.ndarray], like: MAFilterState, device=None) -> MAFilterState:
    """A moving-average state with the arrays of a JAX ``MAFilterState``
    (m1, m2, lam1, lam2) and ``like``'s classes and static settings."""
    dev = like.m1.device if device is None else device
    return _from_numpy(arrays, like, ("m1", "m2", "lam1", "lam2"), dev)


def mals_state_from_numpy(arrays: Dict[str, np.ndarray], like: MALSState, device=None) -> MALSState:
    """A MALS state with the arrays of a JAX ``MALSState`` (Sxx0, Sxy0, Sxx1,
    Sxy1, lam0, lam1) and ``like``'s static settings."""
    dev = like.Sxx0.device if device is None else device
    return _from_numpy(arrays, like, ("Sxx0", "Sxy0", "Sxx1", "Sxy1", "lam0", "lam1"), dev)


QDA_FIELDS = ("m0a", "m1a", "m0b", "m1b", "S0a", "S1a", "S0b", "S1b", "lama", "lamb")
MI_FIELDS = ("x_s", "y_s", "var_s", "logA_x", "logA_y", "valid")


def qda_state_from_numpy(arrays: Dict[str, np.ndarray], like: QDAState, device=None) -> QDAState:
    """A QDA state with the f32 arrays of a JAX ``QDAState`` and ``like``'s
    classes and static settings."""
    dev = like.m0a.device if device is None else device
    return _from_numpy(arrays, like, QDA_FIELDS, dev)


def mi_state_from_numpy(arrays: Dict[str, np.ndarray], like: MIState, device=None) -> MIState:
    """An MCMI state with the arrays of a JAX ``MIState`` and ``like``'s
    bandwidth and variance mode."""
    dev = like.x_s.device if device is None else device
    return _from_numpy(arrays, like, MI_FIELDS, dev)
