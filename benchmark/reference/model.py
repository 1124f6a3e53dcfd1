"""The VAE with its scrubber heads, plain PyTorch in f32.

The ``rcnn`` here is a frozen copy of the measured program's residual conv
VAE under the gaussian prior: NCW convolutions, flax-style BatchNorm (f32
statistics, biased variance, momentum 0.9, eps 1e-4), single-parameter
PReLU, the packed or dense Cholesky head, arena root normalisation and
one-hot/continuous conditional decoding; the linear null-space
projection, the gradient-reversal MLP ensemble and the adversarial
discriminator. Parameter names equal the program's, so weights go to both
by name.

``quant`` is where the VAE computes below f32: None (the reference) or
``fp8`` (the control), a per-tensor scaled e4m3 rounding of each conv and
dense layer's input, weight and output and of each BatchNorm output, with
e5m2 rounding of the gradient flowing back, at the places where the
program computes in bf16.

The VAE of another ``model.type`` is the module
``benchmark/reference/vae_<type>.py``, found by that name (``build``). It
keeps the interface that the losses and the step read from the rcnn's
``ResVAE``:

- ``build_vae(model_cfg, in_ch, cond_dim, conditional_keys,
  discrete_classes, arena, loss_keys, quant)``: the VAE, in f32, wrapped
  by ``build`` in the same ``ScrubVAE`` with the same scrubber heads;
- ``compute_precision(model_cfg, train_cfg)``: "bf16" or "f32", what the
  program computes this VAE in; the control is one step below it
  (``CONTROL``), and ``quant`` is ``fp8`` only under a "bf16" one;
- ``SMALL``: the model keys of the CPU tests' size (``--small``);
- on the VAE, ``z_dim`` and ``cond_dim`` (the conditionals' width);
  ``encode(data, mu_only=False)``, ``{"mu"}`` and, unless ``mu_only``, the
  head's factor (``"L"``, dense (B, z, z), or ``"Lp"``, packed rows);
  ``forward(data, eps=None, generator=None)``, in training mode with
  ``eps`` z = mu + L eps, else z = mu, returning the encoding with ``z``,
  ``var`` (the conditionals, where there are any), ``x6d`` (B, W, J, 6)
  and ``root`` (B, W, 3). ``generator`` is the step's own, handed over
  after the sample noise and the adversarial shuffles: a VAE with dropout
  draws its masks from it in the program's order, one without draws
  nothing. MCMI's eval-mode ``encode`` gets none;
- parameter names equal to the program's ``model.vae``'s;
- ``init_kind(pname) -> (kind, fan_in)`` on a sub-module whose own
  parameters the rcnn's rules of ``init_kinds`` do not cover (a LayerNorm:
  ``one`` and ``zero``; an attention's bare ``in_proj_weight``: ``kernel``
  over its input width).
"""

from __future__ import annotations

import importlib
import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference import geometry as geo

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _round_scaled(x: torch.Tensor, dtype: torch.dtype, fmax: float) -> torch.Tensor:
    scale = fmax / x.detach().abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_scaled(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_scaled(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)


def _q(quant: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if quant is None else quant(x)


def conv_out_len(l, kernel, stride, pad, dilation=1):
    return (l + 2 * pad - dilation * (kernel - 1) - 1) // stride + 1


def conv_transpose_out_len(l, kernel, stride, pad):
    return (l - 1) * stride - 2 * pad + (kernel - 1) + 1


def encoder_lengths(window, kernel, n_blocks):
    lens = [conv_out_len(window, 7, 1, 3)]
    for _ in range(n_blocks):
        lens.append(conv_out_len(lens[-1], kernel, 2, kernel // 2))
    return lens


def decoder_lengths(latent_len, kernel, n_blocks):
    lens = [latent_len]
    for _ in range(n_blocks):
        lens.append(conv_transpose_out_len(conv_transpose_out_len(lens[-1], kernel, 1, kernel // 2), kernel, 2, kernel // 2))
    return lens


class PReLU(nn.Module):
    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x):
        return torch.clamp(x, min=0.0) + self.weight * torch.clamp(x, max=0.0)


class Conv1d(nn.Conv1d):
    def __init__(self, *args, quant: Quant = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        q = self.quant
        b = None if self.bias is None else _q(q, self.bias)
        y = F.conv1d(_q(q, x), _q(q, self.weight), b, self.stride, self.padding, self.dilation)
        return _q(q, y)


class ConvTranspose1d(nn.ConvTranspose1d):
    def __init__(self, *args, quant: Quant = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        q = self.quant
        b = None if self.bias is None else _q(q, self.bias)
        y = F.conv_transpose1d(_q(q, x), _q(q, self.weight), b, self.stride, self.padding, self.output_padding,
                               self.groups, self.dilation)
        return _q(q, y)


class Linear(nn.Linear):
    def __init__(self, *args, quant: Quant = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        q = self.quant
        b = None if self.bias is None else _q(q, self.bias)
        return _q(q, F.linear(_q(q, x), _q(q, self.weight), b))


class BatchNorm1d(nn.Module):
    def __init__(self, n: int, eps: float = 1e-4, momentum: float = 0.9, quant: Quant = None):
        super().__init__()
        self.eps, self.momentum, self.quant = eps, momentum, quant
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2))
            var = torch.clamp((x * x).mean(dim=(0, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1.0 - m) * mean)
                self.running_var.mul_(m).add_((1.0 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return _q(self.quant, (x - mean[:, None]) * mul[:, None] + self.bias[:, None])


def upsample_linear_1d(x):
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    nxt = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    return torch.stack([0.75 * x + 0.25 * prev, 0.75 * x + 0.25 * nxt], dim=-1).flatten(-2)


class UpsampleLinear(nn.Module):
    def forward(self, x):
        return upsample_linear_1d(x)


def tril_index(D: int, device):
    rows = np.repeat(np.arange(D), np.arange(1, D + 1))
    cols = np.concatenate([np.arange(i + 1) for i in range(D)])
    t = lambda a: torch.as_tensor(a.astype(np.int64), device=device)  # noqa: E731
    return t(rows), t(cols), t(np.nonzero(rows == cols)[0])


def packed_softplus_diag(xp, D):
    rows, cols, _ = tril_index(D, xp.device)
    return torch.where(rows == cols, F.softplus(xp) + 1e-6, xp)


def packed_diag(xp, D):
    return xp[:, tril_index(D, xp.device)[2]]


def packed_matvec(xp, v, D):
    rows, cols, _ = tril_index(D, xp.device)
    return (xp * v[:, cols]).new_zeros(xp.shape[0], D).index_add(1, rows, xp * v[:, cols])


def packed_to_L(xp, D):
    rows, cols, _ = tril_index(D, xp.device)
    return xp.new_zeros(xp.shape[0], D * D).index_copy(1, rows * D + cols, xp).view(xp.shape[0], D, D)


class ResidualBlock(nn.Module):
    def __init__(self, in_ch, features, kernel, quant: Quant):
        super().__init__()
        k, p = kernel, kernel // 2
        self.residual = nn.Sequential(
            Conv1d(in_ch, features // 2, k, 2, p, 1, quant=quant), BatchNorm1d(features // 2, quant=quant), PReLU(),
            Conv1d(features // 2, features, k, 1, p, 1, quant=quant),
        )
        self.skip = Conv1d(in_ch, features, k, 2, p, 1, quant=quant)
        self.add = nn.Sequential(BatchNorm1d(features, quant=quant), PReLU())

    def forward(self, x):
        return self.add(self.residual(x) + self.skip(x))


class ResidualBlockTranspose(nn.Module):
    def __init__(self, in_ch, features, kernel, quant: Quant):
        super().__init__()
        k, p = kernel, kernel // 2
        self.residual = nn.Sequential(
            ConvTranspose1d(in_ch, in_ch // 2, k, 1, p, quant=quant), BatchNorm1d(in_ch // 2, quant=quant), PReLU(),
            ConvTranspose1d(in_ch // 2, features, k, 2, p, quant=quant),
        )
        self.skip = nn.Sequential(UpsampleLinear(), Conv1d(in_ch, features, k + 1, 1, p, quant=quant))
        self.add = nn.Sequential(BatchNorm1d(features, quant=quant), PReLU())

    def forward(self, x):
        return self.add(self.residual(x) + self.skip(x))


class ResidualEncoder(nn.Module):
    def __init__(self, in_ch, ch, kernel, z_dim, window, packed, quant: Quant):
        super().__init__()
        n = len(ch) - 1
        self.z_dim, self.packed = z_dim, packed
        self.conv_in = Conv1d(in_ch, ch[0], 7, 1, 3, quant=quant)
        self.activation = PReLU()
        self.res_layers = nn.Sequential(*[ResidualBlock(ch[i], ch[i + 1], kernel, quant) for i in range(n)])
        flat = ch[-1] * encoder_lengths(window, kernel, n)[-1]
        self.fc_mu = Linear(flat, z_dim, quant=quant)
        self.fc_sigma = nn.Sequential(Linear(flat, z_dim * (z_dim + 1) // 2, quant=quant))

    def forward(self, x, mu_only=False):
        h = self.res_layers(self.activation(self.conv_in(x.transpose(1, 2)))).flatten(1)
        mu = self.fc_mu(h)
        if mu_only:
            return mu, None
        sig = packed_softplus_diag(self.fc_sigma(h), self.z_dim)
        return mu, sig if self.packed else packed_to_L(sig, self.z_dim)


class ResidualDecoder(nn.Module):
    def __init__(self, out_ch, ch, kernel, z_dim, window, cond_dim, quant: Quant):
        super().__init__()
        n = len(ch) - 1
        self.latent_len = encoder_lengths(window, kernel, n)[-1]
        self.ch_last = ch[-1]
        self.fc_in = Linear(z_dim + cond_dim, self.latent_len * ch[-1], quant=quant)
        self.res_layers = nn.Sequential(
            *[ResidualBlockTranspose(ch[-i], ch[-i - 1], kernel, quant) for i in range(1, len(ch))]
        )
        l_out = decoder_lengths(self.latent_len, kernel, n)[-1]
        self.conv_out = ConvTranspose1d(ch[0], out_ch, window - l_out + 7, 1, 3, quant=quant)

    def forward(self, z):
        h = self.fc_in(z).reshape(z.shape[0], self.ch_last, self.latent_len)
        return torch.tanh(self.conv_out(self.res_layers(h))).transpose(1, 2)


class ResVAE(nn.Module):
    def __init__(self, in_ch, ch, kernel, z_dim, window, cond_dim, arena, conditional_keys, discrete_classes,
                 packed: bool, quant: Quant = None):
        super().__init__()
        self.z_dim, self.window, self.packed = z_dim, window, packed
        self.conditional_keys = tuple(conditional_keys)
        self.discrete_classes = dict(discrete_classes)
        self.cond_dim = cond_dim
        self.register_buffer("arena", torch.as_tensor(np.asarray(arena, np.float32)), persistent=False)
        self.encoder = ResidualEncoder(in_ch, ch, kernel, z_dim, window, packed, quant)
        self.decoder = ResidualDecoder(in_ch, ch, kernel, z_dim, window, cond_dim, quant)

    @property
    def sigma_key(self):
        return "Lp" if self.packed else "L"

    def build_conditionals(self, data):
        if self.cond_dim <= 0:
            return None
        parts = []
        for k in self.conditional_keys:
            v = data[k]
            parts.append(F.one_hot(v.reshape(-1).long(), self.discrete_classes[k]).float()
                         if k in self.discrete_classes else v)
        return torch.cat(parts, dim=-1)

    def encode(self, data, mu_only=False):
        B, W = data["x6d"].shape[:2]
        x_in = torch.cat([data["x6d"].reshape(B, W, -1), geo.normalize_root(data["root"], self.arena)], dim=-1)
        mu, L = self.encoder(x_in, mu_only=mu_only)
        return {"mu": mu} if L is None else {"mu": mu, self.sigma_key: L}

    def forward(self, data, eps=None, generator=None):
        """``generator``: the step's; the rcnn has no dropout and draws nothing from it."""
        out = self.encode(data)
        L = out[self.sigma_key]
        if self.training and eps is not None:
            lv = packed_matvec(L, eps, self.z_dim) if self.packed else torch.einsum("bij,bj->bi", L, eps)
            out["z"] = out["mu"] + lv
        else:
            out["z"] = out["mu"]
        z = out["z"]
        var = self.build_conditionals(data)
        if var is not None:
            out["var"] = var
            z = torch.cat([z, var], dim=-1)
        x_hat = self.decoder(z)
        out["root"] = geo.inv_normalize_root(x_hat[..., -3:], self.arena)
        out["x6d"] = x_hat[..., :-3].reshape(x_hat.shape[0], self.window, -1, 6)
        return out


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


class MLPEnsemble(nn.Module):
    def __init__(self, d: int, out_dim: int):
        super().__init__()
        self.mlp1_0, self.mlp1_1, self.mlp1_2 = Linear(d, d), Linear(d, d), Linear(d, out_dim)
        self.mlp2_0, self.mlp2_1 = Linear(d, d), Linear(d, out_dim)
        self.mlp3_0, self.mlp3_1, self.mlp3_2 = Linear(d, d), Linear(d, d // 2), Linear(d // 2, out_dim)
        self.mlp4_0, self.mlp4_1, self.mlp4_2 = Linear(d, 2 * d), Linear(2 * d, 2 * d), Linear(2 * d, out_dim)

    def forward(self, z):
        r = F.relu
        return [
            self.mlp1_2(r(self.mlp1_1(r(self.mlp1_0(z))))),
            self.mlp2_1(r(self.mlp2_0(z))),
            self.mlp3_2(r(self.mlp3_1(r(self.mlp3_0(z))))),
            self.mlp4_2(r(self.mlp4_1(r(self.mlp4_0(z))))),
        ]


def spd_solve(A, B):
    vec = B.dim() == A.dim() - 1
    out = torch.linalg.solve(A, B.unsqueeze(-1) if vec else B)
    return out.squeeze(-1) if vec else out


class LinearProjection(nn.Module):
    def __init__(self, z_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_dim, z_dim))

    def forward(self, z):
        w = self.weight
        v = z @ w.T
        return {"v": v, "z_null": z - spd_solve(w @ w.T, v.T).T @ w}


class GRScrubber(nn.Module):
    def __init__(self, z_dim: int, out_dim: int, alpha: float):
        super().__init__()
        self.alpha = alpha
        self.ensemble = MLPEnsemble(z_dim, out_dim)

    def forward(self, z):
        return self.ensemble(_GradReverse.apply(z, self.alpha))


class AdvNet(nn.Module):
    def __init__(self, in_dim: int):
        super().__init__()
        self.ensemble = MLPEnsemble(in_dim, 2)

    def forward(self, z, v):
        return [torch.softmax(o, dim=-1) for o in self.ensemble(torch.cat([z, v], dim=-1))]


class ScrubVAE(nn.Module):
    def __init__(self, vae: nn.Module, linear_dims: Dict[str, int], gr_dims: Dict[str, int], gr_alpha: float):
        super().__init__()
        self.vae = vae
        self.linear = nn.ModuleDict({k: LinearProjection(vae.z_dim, d) for k, d in linear_dims.items()})
        self.grad_reversal = nn.ModuleDict({k: GRScrubber(vae.z_dim, d, gr_alpha) for k, d in gr_dims.items()})

    def forward(self, data, eps=None, generator=None):
        out = self.vae(data, eps=eps, generator=generator)
        dis = {}
        if len(self.linear):
            dis["linear"] = {k: m(out["mu"]) for k, m in self.linear.items()}
        if len(self.grad_reversal):
            dis["grad_reversal"] = {
                k: m(dis["linear"][k]["z_null"] if k in self.linear else out["mu"]) for k, m in self.grad_reversal.items()
            }
        out["disentangle"] = dis
        return out


FEAT_DIMS = {"avg_speed": 1, "part_speed": 4, "avg_speed_3d": 3, "heading": 2, "heading_change": 1}


def feat_dims(window: int, discrete_classes: Dict[str, int]) -> Dict[str, int]:
    return {**FEAT_DIMS, "frame_speed": window - 1, **discrete_classes}


# the control of a configuration, by the precision the program computes
# its VAE in: the reference one step below it
CONTROL = {"bf16": "fp8", "f32": "tf32"}
# the rcnn's model keys at the CPU tests' size: the bench's smoke widths
RCNN_SMALL = {"channel": [8, 8, 16, 16, 32], "z_dim": 16}


def model_type(model_cfg: dict) -> str:
    return model_cfg.get("type") or "rcnn"


def vae_module(mtype: str):
    """``benchmark/reference/vae_<mtype>.py``, the reference VAE of a
    ``model.type`` other than the rcnn (module docstring)."""
    name = f"benchmark.reference.vae_{mtype}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as err:
        if err.name != name:
            raise
        raise ValueError(f"no reference VAE for model.type {mtype!r}: benchmark/reference/vae_{mtype}.py "
                         "is missing") from err


def compute_precision(model_cfg: dict, train_cfg: dict) -> str:
    """"bf16" or "f32": what the program computes the configuration's VAE
    in. The rcnn reads ``model.precision``, or ``train.precision`` where the
    model section has no such key, as the program's set-up does; another
    type's module says."""
    mtype = model_type(model_cfg)
    if mtype != "rcnn":
        return vae_module(mtype).compute_precision(model_cfg, train_cfg)
    precision = model_cfg["precision"] if "precision" in model_cfg else train_cfg.get("precision")
    return "bf16" if precision == "bf16" else "f32"


def control(sections: dict) -> str:
    """The control of the configuration's sections: "fp8" (the VAE's
    layers rounded to fp8) where the program computes in bf16, "tf32"
    (products and convolutions in TF32) where it computes in f32."""
    return CONTROL[compute_precision(sections["model"], sections["train"])]


def small_shape(model_cfg: dict) -> dict:
    """The model keys of the configuration's type at the CPU tests' size."""
    mtype = model_type(model_cfg)
    return dict(RCNN_SMALL if mtype == "rcnn" else vae_module(mtype).SMALL)


def build(model_cfg: dict, dis_cfg: dict, loss_keys: Sequence[str], n_keypts: int, arena, discrete_classes,
          quant: Quant = None) -> ScrubVAE:
    """The model of the configuration's sections under the gaussian prior,
    midfwd input with the root channels: the rcnn here, another type's VAE
    from its module (module docstring)."""
    if (model_cfg.get("prior") or "gaussian") != "gaussian":
        raise ValueError("the reference holds the gaussian prior only")
    mtype = model_type(model_cfg)
    methods = dis_cfg.get("method") or {}
    window = model_cfg.get("window") or 51
    fd = feat_dims(window, discrete_classes)
    cond = list(methods.get("conditional", []))
    cond_dim = sum(fd[k] for k in cond)
    in_ch = n_keypts * 6 + 3
    if mtype == "rcnn":
        packed = model_cfg.get("packed_sigma")
        if packed is None:
            packed = "total_correlation" not in set(loss_keys)
        vae = ResVAE(
            in_ch, tuple(model_cfg.get("channel") or (64, 128, 256, 512, 1024)), model_cfg.get("kernel") or 5,
            model_cfg.get("z_dim") or 128, window, cond_dim, arena, cond, discrete_classes,
            packed=bool(packed), quant=quant,
        )
    else:
        vae = vae_module(mtype).build_vae(model_cfg, in_ch=in_ch, cond_dim=cond_dim, conditional_keys=cond,
                                          discrete_classes=discrete_classes, arena=arena, loss_keys=loss_keys,
                                          quant=quant)
    return ScrubVAE(
        vae, {k: fd[k] for k in methods.get("linear", [])}, {k: fd[k] for k in methods.get("grad_reversal", [])},
        float(dis_cfg.get("alpha") or 1.0),
    )


def fan_in(module: nn.Module) -> Optional[int]:
    """The fan-in of a module's kernel under flax's lecun-normal init."""
    if isinstance(module, Linear):
        return module.in_features
    if isinstance(module, (Conv1d, ConvTranspose1d)):
        return module.in_channels * module.kernel_size[0]
    if isinstance(module, LinearProjection):
        return module.weight.shape[0]
    return None


def init_kinds(model: nn.Module):
    """(name, parameter, kind, fan_in) of every parameter: ``kernel`` (a
    normal draw over sqrt(fan_in)), ``zero``, ``one`` or ``prelu``. A
    module's own ``init_kind(pname)`` decides for its parameters; the
    rcnn's modules go by the rules below."""
    out = []
    for mname, m in model.named_modules():
        own = getattr(m, "init_kind", None)
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if own is not None:
                out.append((name, p, *own(pname)))
            elif isinstance(m, PReLU):
                out.append((name, p, "prelu", None))
            elif isinstance(m, BatchNorm1d):
                out.append((name, p, "one" if pname == "weight" else "zero", None))
            elif pname == "bias":
                out.append((name, p, "zero", None))
            else:
                out.append((name, p, "kernel", fan_in(m)))
    return out


LECUN_TRUNC = 0.87962566103423978


def lecun_std(n: int) -> float:
    return math.sqrt(1.0 / n) / LECUN_TRUNC
