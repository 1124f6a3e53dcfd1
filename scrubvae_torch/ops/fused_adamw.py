"""Fused AdamW update of one parameter leaf: the Hopper kernel and its plain
PyTorch version.

Counterpart of ``scrubvae_tpu/ops/fused_adamw.py`` (``fused_adamw_leaf`` /
``leaf_update_reference``). The kernel is ``csrc/fused_adamw.cu``, built with
``nvcc`` for ``sm_90a`` into ``build/kernels/`` at first use and bound with
ctypes; the source says what it computes and what bounds it.

``fused_adamw_leaf`` updates ``w``, ``mu`` and ``nu`` in place. A CUDA tensor
launches the kernel (or raises); a CPU tensor runs the plain version, which
is the same formula as separate torch ops. Storage dtypes pick the variant:
a bf16 ``w`` and/or bf16 moments are stored with stochastic rounding.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

__all__ = [
    "BUILD_DIR",
    "SOURCE",
    "build",
    "fused_adamw_leaf",
    "fused_adamw_leaf_reference",
    "leaf_bytes",
    "sround_bf16",
]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_adamw.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib_handle = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(force: bool = False) -> Path:
    """Compile ``csrc/fused_adamw.cu`` into a shared library (keyed by the
    source and flags) and return its path; reuse an existing build unless
    ``force``."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"fused_adamw_{key.hexdigest()[:16]}.so"
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _lib():
    global _lib_handle
    with _lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.fused_adamw_launch
            p, f = ctypes.c_void_p, ctypes.c_float
            fn.argtypes = [
                p, p, p, p, p, p, ctypes.c_int64,  # w g mu nu scal noise n
                ctypes.c_int, ctypes.c_int,  # w_bf16 m_bf16
                f, f, f, f, f, f,  # b1 1-b1 b2 1-b2 eps wd
                ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,  # seed leaf step
                p,  # stream
            ]
            fn.restype = ctypes.c_int
            _lib_handle = lib
    return _lib_handle


def sround_bf16(x: torch.Tensor, noise16: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 with stochastic rounding: add the 16-bit noise to the f32
    word and keep its high half (``_sround_bits`` of the JAX package)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + noise16.to(torch.int64)) & 0xFFFF0000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    return r.view(torch.float32).to(torch.bfloat16)


def fused_adamw_leaf_reference(
    w: torch.Tensor,
    g: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    *,
    lr,
    b1c,
    b2c,
    gscale,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    wd: float = 0.0,
):
    """Plain PyTorch version of the kernel: returns ``(new_w, new_mu,
    new_nu)`` in the storage dtypes of ``w`` and ``mu``. ``noise`` (int,
    ``(3, numel)``, rows w, m, n, values in [0, 65536)) feeds the bf16
    stochastic rounding; without it the noise is drawn from ``generator``."""
    f32 = torch.float32
    dev = w.device
    lr, b1c, b2c, gscale = (
        torch.as_tensor(v, dtype=f32, device=dev) for v in (lr, b1c, b2c, gscale)
    )
    gf = g.to(f32) * gscale
    m = b1 * mu.to(f32) + (1.0 - b1) * gf
    n = b2 * nu.to(f32) + (1.0 - b2) * (gf * gf)
    upd = (m / b1c) / (torch.sqrt(torch.clamp(n, min=0.0) / b2c) + eps)
    wf = w.to(f32)
    new_w = wf - lr * (upd + wd * wf)
    w_lowp = w.dtype == torch.bfloat16
    m_lowp = mu.dtype == torch.bfloat16
    if not (w_lowp or m_lowp):
        return new_w, m, n
    if noise is None:
        noise = torch.randint(
            0, 1 << 16, (3, w.numel()), generator=generator, device=dev
        )
    nz = noise.reshape(3, *w.shape)
    if w_lowp:
        new_w = sround_bf16(new_w, nz[0])
    if m_lowp:
        m, n = sround_bf16(m, nz[1]), sround_bf16(n, nz[2])
    return new_w, m, n


def _check(w, g, mu, nu, scal, noise):
    for name, t in (("g", g), ("mu", mu), ("nu", nu)):
        if t.device != w.device or t.shape != w.shape or not t.is_contiguous():
            raise ValueError(
                f"fused_adamw_leaf: {name} must be a contiguous tensor of "
                f"w's shape {tuple(w.shape)} on {w.device}"
            )
    if not w.is_contiguous():
        raise ValueError("fused_adamw_leaf: w must be contiguous")
    if w.dtype not in (torch.float32, torch.bfloat16) or g.dtype != w.dtype:
        raise TypeError(
            f"fused_adamw_leaf: w must be f32 or bf16 and g of w's dtype "
            f"(got {w.dtype}, {g.dtype})"
        )
    if mu.dtype != nu.dtype or mu.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_adamw_leaf: moments must share f32 or bf16 ({mu.dtype}, {nu.dtype})")
    if scal.dtype != torch.float32 or scal.numel() != 4 or scal.device != w.device:
        raise ValueError("fused_adamw_leaf: scal must be 4 f32 values on w's device")
    if noise is not None and (
        noise.dtype != torch.int32
        or noise.shape != (3, w.numel())
        or noise.device != w.device
        or not noise.is_contiguous()
    ):
        raise ValueError("fused_adamw_leaf: noise must be contiguous int32 (3, numel) on w's device")


def fused_adamw_leaf(
    w: torch.Tensor,
    g: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    scal: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    wd: float = 0.0,
    seed: int = 0,
    leaf: int = 0,
    step: int = 0,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> None:
    """One AdamW step on one leaf, in place on ``w``, ``mu`` and ``nu``.

    ``scal`` holds the per-step f32 scalars ``[lr, b1c, b2c, gscale]`` on
    ``w``'s device. On the card the stochastic-rounding bits come from
    Philox keyed by ``seed`` and countered by (element, ``leaf``, ``step``);
    on the CPU from ``generator``. ``noise`` overrides both.
    """
    _check(w, g, mu, nu, scal, noise)
    if w.device.type == "cpu":
        lr, b1c, b2c, gscale = scal.unbind(0)
        nw, nm, nn = fused_adamw_leaf_reference(
            w, g, mu, nu, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale,
            noise=noise, generator=generator, b1=b1, b2=b2, eps=eps, wd=wd,
        )
        w.copy_(nw)
        mu.copy_(nm)
        nu.copy_(nn)
        return
    if w.device.type != "cuda":
        raise RuntimeError(f"fused_adamw_leaf: no kernel for device {w.device}")
    err = _lib().fused_adamw_launch(
        w.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
        scal.data_ptr(), noise.data_ptr() if noise is not None else None,
        w.numel(),
        int(w.dtype == torch.bfloat16), int(mu.dtype == torch.bfloat16),
        b1, 1.0 - b1, b2, 1.0 - b2, eps, wd,
        seed & 0xFFFFFFFFFFFFFFFF, leaf & 0xFFFFFFFF, step & 0xFFFFFFFF,
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: cudaError {err}")
    fused_adamw_leaf.launches += 1


fused_adamw_leaf.launches = 0


def leaf_bytes(shapes: Sequence[tuple], w_bytes: int, m_bytes: int) -> int:
    """Bytes one update pass must move: read w, g, mu, nu once and write w,
    mu, nu once (g has w's dtype)."""
    elems = sum(int(torch.Size(s).numel()) for s in shapes)
    return elems * (3 * w_bytes + 4 * m_bytes)
