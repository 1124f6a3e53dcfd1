"""The post-norm tail of a transformer block, ``LayerNorm(x + dropout(y))``
with flax's arithmetic: the Hopper kernels and their plain PyTorch version.

No JAX counterpart: the JAX package's transformer leaves the tail to XLA.
The kernels are ``csrc/residual_norm.cu`` (one forward launch, two backward
launches), built with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at
first use and bound with ctypes (``utils.cuda_build``); the source says
what they compute and what bounds them.

``residual_norm`` takes the keep mask as drawn by the caller (bool, of
``y``'s shape) or ``None`` (eval mode or a rate of 0: the tail is then
``norm(x + y)``); it draws nothing. On a CUDA tensor it is one autograd
function whose forward and backward are the kernels, f32 only (another
dtype raises). On the CPU, and while ``torch.export`` traces, it runs the
plain version, the same ops the model ran before the kernels, which
autograd differentiates: the non-strict export of ``utils.export`` runs
this code on fake tensors, which have no memory to hand a kernel, and an
exported program holds no foreign call, so a served transformer artifact
runs the plain tails, on the card as on the CPU.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from scrubvae_torch.utils import step_cost
from scrubvae_torch.utils.cuda_build import CudaLibrary, counted

__all__ = [
    "SOURCE",
    "LIBRARY",
    "build",
    "layer_norm_reference",
    "residual_norm",
    "residual_norm_grad",
    "residual_norm_reference",
]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "residual_norm.cu"
# f32 operations an element of the forward and of the backward (their
# bound's operation count; the bytes bound them)
OPS_FORWARD, OPS_BACKWARD = 10, 20
# the most features a row: the backward keeps 8 warps x 2 x d f32 sums in
# the 227 KB of shared memory a block may use
MAX_D = 3632


def _bind(lib: ctypes.CDLL) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.residual_norm_forward_launch.argtypes = [p, p, p, p, p, p, p, i64, i, i, f, f, f, p]
    lib.residual_norm_forward_launch.restype = i
    lib.residual_norm_backward_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i64, i, i, f, f, p]
    lib.residual_norm_backward_launch.restype = i
    lib.residual_norm_backward_blocks.argtypes = [i64]
    lib.residual_norm_backward_blocks.restype = i


LIBRARY = CudaLibrary(SOURCE, _bind)


def build(force: bool = False) -> Path:
    """Compile ``csrc/residual_norm.cu`` (``CudaLibrary.build``) and return
    the shared library's path."""
    return LIBRARY.build(force)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def layer_norm_reference(s: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with flax's arithmetic:
    (s - E[s]) * (rsqrt(max(E[s^2] - E[s]^2, 0) + eps) * weight) + bias."""
    mean = s.mean(-1, keepdim=True)
    var = torch.clamp((s * s).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (s - mean) * (torch.rsqrt(var + eps) * weight.to(s.dtype)) + bias.to(s.dtype)


def residual_norm_reference(
    x: torch.Tensor,
    y: torch.Tensor,
    keep: Optional[torch.Tensor],
    rate: float,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
) -> torch.Tensor:
    """``layer_norm_reference(x + where(keep, y / (1 - rate), 0))``, or of
    ``x + y`` without a mask: flax's ``nn.Dropout`` of ``y``, the residual
    add and the LayerNorm as separate torch ops."""
    if keep is not None:
        y = torch.where(keep, y / (1.0 - rate), torch.zeros((), dtype=y.dtype, device=y.device))
    return layer_norm_reference(x + y, weight, bias, eps)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _f32(v: float) -> float:
    return float(np.float32(v))


def _inv_d(rows: int, d: int) -> float:
    """The f32 factor of a CUDA mean over the last axis: rows / (rows * d)."""
    return _f32(np.float32(rows) / np.float32(rows * d))


def _bytes(x: torch.Tensor, keep: Optional[torch.Tensor], tensors: int) -> int:
    """Bytes of a pass: ``tensors`` f32 tensors of x's size and the mask,
    each once."""
    return x.numel() * (4 * tensors + (1 if keep is not None else 0))


def _vec(d: int, *tensors: Optional[torch.Tensor]) -> int:
    """1 where the kernels may move 16-byte chunks: d a multiple of 4 and
    every float pointer on 16 bytes (the mask's on 4)."""
    return int(d % 4 == 0 and all(t is None or t.data_ptr() % (4 if t.dtype == torch.bool else 16) == 0
                                  for t in tensors))


def _check(x: torch.Tensor, y: torch.Tensor, keep: Optional[torch.Tensor], weight: torch.Tensor, bias: torch.Tensor):
    d = x.shape[-1]
    for name, t in (("x", x), ("y", y), ("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"residual_norm: {name} must be f32 on the card (got {t.dtype})")
        if t.device != x.device:
            raise ValueError(f"residual_norm: {name} must lie on {x.device} (got {t.device})")
    if y.shape != x.shape or weight.shape != (d,) or bias.shape != (d,):
        raise ValueError(
            f"residual_norm: x {tuple(x.shape)}, y {tuple(y.shape)}, weight {tuple(weight.shape)}, "
            f"bias {tuple(bias.shape)}: y must have x's shape and weight and bias ({d},)"
        )
    if keep is not None and (keep.dtype != torch.bool or keep.shape != x.shape or keep.device != x.device):
        raise ValueError("residual_norm: keep must be a bool tensor of x's shape on x's device")
    if not 0 < d <= MAX_D:
        raise ValueError(f"residual_norm: the kernels take 1 to {MAX_D} features a row (got {d})")


def _forward_launch(x, y, keep, inv_keep: float, weight, bias, eps: float):
    """``(out, stats)``: the tail and its (rows, 2) mean and signed rstd."""
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    if rows == 0:
        return out, stats
    with step_cost.kernel_launches("residual norm", [(_bytes(x, keep, 3), OPS_FORWARD * x.numel())]):
        LIBRARY.launch(
            "residual_norm_forward_launch",
            x.data_ptr(), y.data_ptr(), keep.data_ptr() if keep is not None else None,
            weight.data_ptr(), bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
            rows, d, _vec(d, x, y, keep, weight, bias, out), inv_keep, _inv_d(rows, d), eps,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    residual_norm.launches += 1
    return out, stats


@counted
def residual_norm_grad(g, x, y, keep, inv_keep: float, weight, stats, need_dx: bool = True, need_dy: bool = True):
    """The backward kernels of a tail whose forward kept ``stats``: returns
    ``(dx or None, dy or None, dweight, dbias)`` for the output gradient
    ``g``. ``launches`` counts its kernel launches, two a call."""
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x) if need_dx else None
    dy = torch.empty_like(x) if need_dy else None
    if rows == 0:
        return dx, dy, torch.zeros_like(weight), torch.zeros_like(weight)
    blocks = LIBRARY.load().residual_norm_backward_blocks(rows)
    partial = torch.empty((blocks, 2, d), dtype=torch.float32, device=x.device)
    dwb = torch.empty((2, d), dtype=torch.float32, device=x.device)
    nbytes = _bytes(x, keep, 3 + int(need_dx) + int(need_dy))
    with step_cost.kernel_launches("residual norm", [(nbytes, OPS_BACKWARD * x.numel()), (2 * partial.numel() * 4, 0)]):
        LIBRARY.launch(
            "residual_norm_backward_launch",
            g.data_ptr(), x.data_ptr(), y.data_ptr(), keep.data_ptr() if keep is not None else None,
            weight.data_ptr(), stats.data_ptr(), dx.data_ptr() if need_dx else None,
            dy.data_ptr() if need_dy else None, partial.data_ptr(), dwb[0].data_ptr(), dwb[1].data_ptr(),
            rows, d, _vec(d, g, x, y, keep, weight, dx, dy), inv_keep, _inv_d(rows, d),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    residual_norm_grad.launches += 2
    return dx, dy, dwb[0], dwb[1]


class _ResidualNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, keep, inv_keep, weight, bias, eps):
        out, stats = _forward_launch(x, y, keep, inv_keep, weight, bias, eps)
        ctx.save_for_backward(x, y, keep, weight, stats)
        ctx.inv_keep = inv_keep
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, keep, weight, stats = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx, dy, dw, db = residual_norm_grad(g.contiguous(), x, y, keep, ctx.inv_keep, weight, stats, need[0], need[1])
        return dx, dy, None, None, dw, db, None


@counted
def residual_norm(
    x: torch.Tensor,
    y: torch.Tensor,
    keep: Optional[torch.Tensor],
    rate: float,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float,
) -> torch.Tensor:
    """``LayerNorm(x + where(keep, y / (1 - rate), 0))`` over the last axis
    with flax's arithmetic (``layer_norm_reference``), or of ``x + y`` where
    ``keep`` is None: on the card one forward kernel, and in the backward
    two (``residual_norm_grad``); elsewhere the plain version.

    ``launches`` counts the forward kernel launches; a launch recorded
    while a CUDA graph is captured counts once for each replay
    (``train.graph.StepGraph``), as the backward's do."""
    if x.device.type != "cuda" or torch.compiler.is_exporting():
        return residual_norm_reference(x, y, keep, rate, weight, bias, eps)
    _check(x, y, keep, weight, bias)
    inv_keep = _f32(np.float32(1.0) / np.float32(1.0 - rate)) if keep is not None else 1.0
    keep = keep.contiguous() if keep is not None else None
    return _ResidualNorm.apply(x.contiguous(), y.contiguous(), keep, inv_keep, weight.contiguous(), bias.contiguous(), _f32(eps))
