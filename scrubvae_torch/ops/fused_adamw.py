"""Fused AdamW update of a list of parameter leaves: the Hopper kernel and
its plain PyTorch version.

Counterpart of ``scrubvae_tpu/ops/fused_adamw.py`` (``fused_adamw_leaf`` /
``leaf_update_reference``). The kernel is ``csrc/fused_adamw.cu``, built with
``nvcc`` for ``sm_90a`` into ``build/kernels/`` at first use and bound with
ctypes (``utils.cuda_build``); the source says what it computes and what
bounds it.

``LeafTable`` describes a fixed list of leaves (w, mu, nu) once; then
``fused_adamw_multi`` updates all of them in place with one kernel launch
per dtype variant present (per ``MAX_LEAVES`` leaves). A CUDA tensor
launches the kernel (or raises); a CPU tensor runs the plain version, which
is the same formula as separate torch ops. Storage dtypes pick the variant:
a bf16 ``w`` and/or bf16 moments are stored with stochastic rounding, whose
bits come from the kernel's Philox-4x32-10 layout (``philox_noise``) on both
devices, so the CPU and the card round bit for bit alike.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence

import torch

from scrubvae_torch.utils import step_cost
from scrubvae_torch.utils.cuda_build import CudaLibrary, counted

__all__ = [
    "CHUNK_ELEMS",
    "MAX_LEAVES",
    "OPS_PER_ELEM",
    "SOURCE",
    "LIBRARY",
    "LeafTable",
    "build",
    "fused_adamw_leaf_reference",
    "fused_adamw_multi",
    "fused_adamw_multi_reference",
    "leaf_bytes",
    "philox4x32_10",
    "philox_noise",
    "sround_bf16",
]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_adamw.cu"
# the kernel's chunk (kThreads * kGroup) and the most gradient pointers its
# parameter struct holds (kMaxLeaves)
CHUNK_ELEMS = 1024
MAX_LEAVES = 256
# f32 operations an element of one update, on the CUDA cores (its bound's
# operation count; the bytes, ``leaf_bytes``, bound it)
OPS_PER_ELEM = 20


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.fused_adamw_multi_launch
    p, f = ctypes.c_void_p, ctypes.c_float
    fn.argtypes = [
        p, p, ctypes.c_int,  # leaves chunks n_chunks
        p, ctypes.c_int,  # grads (host array) n_leaves
        ctypes.c_int, ctypes.c_int, p,  # w_bf16 m_bf16 scal
        f, f, f, f, f, f,  # b1 1-b1 b2 1-b2 eps wd
        ctypes.c_uint64, p, ctypes.c_int64,  # seed step (device int32) chunk_elems
        p,  # stream
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, _bind)


def build(force: bool = False) -> Path:
    """Compile ``csrc/fused_adamw.cu`` (``CudaLibrary.build``) and return
    the shared library's path."""
    return LIBRARY.build(force)


# ---------------------------------------------------------------------------
# Philox-4x32-10 (Random123), on int64 tensors holding 32-bit words
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """High and low words of the 64-bit product of the 32-bit constant ``a``
    and the 32-bit words ``b``, from 16-bit halves (a 32x32 product would
    overflow int64)."""
    ah, al = a >> 16, a & 0xFFFF
    bh, bl = b >> 16, b & 0xFFFF
    mid = ah * bl + al * bh
    low = ((mid & 0xFFFF) << 16) + al * bl
    return ah * bh + (mid >> 16) + (low >> 32), low & _U32


def philox4x32_10(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox-4x32-10 of counters ``ctr`` (int64, ``(..., 4)`` words) under
    keys ``key`` (int64, ``(..., 2)`` words, broadcast against ``ctr``);
    returns the ``(..., 4)`` output words, as the kernel computes them."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key.unbind(-1)
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _U32
        k1 = (k1 + _PHILOX_W[1]) & _U32
    return torch.stack([c0, c1, c2, c3], -1)


def philox_noise(numel: int, seed: int, leaf: int, step, *, start: int = 0, device=None) -> torch.Tensor:
    """The kernel's rounding noise of elements ``start .. start + numel - 1``
    of a leaf: int32 ``(3, numel)``, rows w, m, n, values in [0, 65536).
    ``step`` is an int or an integer tensor of one element (the optimizer's
    update count, as the kernel reads it).

    Group q (elements 8q .. 8q + 7) takes three draws, counter (q low word,
    (q >> 32) << 2 | d, leaf, step) for d = 0, 1, 2 and key (seed low word,
    seed high word); element 8q + j takes, for row r, 16-bit half 3j + r of
    the 24 (half h is word h >> 1 of draw h >> 3, its low half when h is
    even)."""
    q0, q1 = start // 8, (start + numel + 7) // 8
    q = torch.arange(q0, q1, dtype=torch.int64, device=device)
    d = torch.arange(3, dtype=torch.int64, device=device)
    step = torch.as_tensor(step).reshape(()).to(device=device, dtype=torch.int64) & _U32
    ctr = torch.stack(torch.broadcast_tensors(
        (q & _U32)[:, None], ((q >> 32) << 2)[:, None] | d,
        torch.tensor(leaf & _U32, device=device), step,
    ), -1)  # (groups, 3 draws, 4 words)
    key = torch.tensor([seed & _U32, (seed >> 32) & _U32], dtype=torch.int64, device=device)
    r = philox4x32_10(ctr, key)
    halves = torch.stack([r & 0xFFFF, r >> 16], -1).reshape(-1, 8, 3)  # [q, j, row]
    nz = halves.permute(2, 0, 1).reshape(3, -1)
    off = start - 8 * q0
    return nz[:, off:off + numel].to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


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


def fused_adamw_multi_reference(
    ws: Sequence[torch.Tensor],
    gs: Sequence[torch.Tensor],
    mus: Sequence[torch.Tensor],
    nus: Sequence[torch.Tensor],
    *,
    lr,
    b1c,
    b2c,
    gscale,
    seed: int = 0,
    step=0,
    leaf_ids: Optional[Sequence[int]] = None,
    noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
    starts: Optional[Sequence[int]] = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    wd: float = 0.0,
) -> List[tuple]:
    """The plain version over a list of leaves: ``fused_adamw_leaf_reference``
    of each leaf with its Philox noise (``philox_noise`` of its leaf word,
    ``leaf_ids[i]``, by default ``i``, from element ``starts[i]`` of the
    whole leaf, by default 0), or with ``noise[i]`` where given; ``step``
    as ``philox_noise`` takes it. Returns one ``(new_w, new_mu, new_nu)``
    per leaf."""
    out = []
    for i, (w, g, mu, nu) in enumerate(zip(ws, gs, mus, nus)):
        nz = noise[i] if noise is not None else None
        if nz is None and torch.bfloat16 in (w.dtype, mu.dtype):
            lid = leaf_ids[i] if leaf_ids is not None else i
            start = starts[i] if starts is not None else 0
            nz = philox_noise(w.numel(), seed, lid, step, start=start, device=w.device)
        out.append(fused_adamw_leaf_reference(
            w, g, mu, nu, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale, noise=nz,
            b1=b1, b2=b2, eps=eps, wd=wd,
        ))
    return out


# ---------------------------------------------------------------------------
# the leaf table and the wrappers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Batch:
    """One launch: the leaves ``idx`` of one dtype variant, rows ``row0 ..``
    of the device leaf table and chunks ``chunk0 .. chunk0 + n_chunks - 1``."""

    w_bf16: bool
    m_bf16: bool
    idx: List[int]
    row0: int
    chunk0: int
    n_chunks: int


class LeafTable:
    """A fixed list of leaves ``(w, mu, nu)``, checked once and laid out for
    the kernel: one batch per dtype variant (and per ``MAX_LEAVES`` leaves),
    a leaf table of seven int64 words a leaf (w, mu, nu, noise pointers,
    numel, Philox leaf word | aligned << 32, first Philox group) and a chunk table of int32
    ``(slot in the batch, chunk of the leaf)`` per block, each chunk
    ``CHUNK_ELEMS`` elements of one leaf. Both tables live on the leaves'
    device. The table keeps its tensors alive and records their storage:
    ``check_storage`` raises if a tensor it was built on has been replaced.

    ``leaf_ids`` are the Philox leaf words (by default the positions);
    ``noise[i]`` (int32 ``(3, numel)``), where given, replaces the Philox
    bits of leaf i. ``starts[i]``, where given, says that leaf i is a slice
    of a larger leaf beginning at that element (a rank's rows of a split
    leaf, ``parallel.mesh``): a multiple of 8 where the leaf is rounded, so
    that the slice draws the bits of the same elements of the whole leaf."""

    def __init__(
        self,
        w: Sequence[torch.Tensor],
        mu: Sequence[torch.Tensor],
        nu: Sequence[torch.Tensor],
        *,
        leaf_ids: Optional[Sequence[int]] = None,
        noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
        starts: Optional[Sequence[int]] = None,
    ):
        if not (len(w) == len(mu) == len(nu)) or not w:
            raise ValueError("LeafTable: w, mu and nu must be non-empty lists of one length")
        self.w, self.mu, self.nu = list(w), list(mu), list(nu)
        self.noise = list(noise) if noise is not None else [None] * len(w)
        self.leaf_ids = list(leaf_ids) if leaf_ids is not None else list(range(len(w)))
        self.starts = [int(s) for s in starts] if starts is not None else [0] * len(w)
        if not (len(self.noise) == len(self.leaf_ids) == len(self.starts) == len(w)):
            raise ValueError("LeafTable: noise, leaf_ids and starts need one entry a leaf")
        bad = [
            i for i, s in enumerate(self.starts)
            if s < 0 or (s % 8 and torch.bfloat16 in (self.w[i].dtype, self.mu[i].dtype))
        ]
        if bad:
            raise ValueError(f"LeafTable: rounded leaves {bad} start at an element that is not a multiple of 8")
        self.device = self.w[0].device
        for i in range(len(w)):
            self._check_leaf(i)
        self.numel = [t.numel() for t in self.w]
        self._ptrs = self._storage(self.w, self.mu, self.nu)

        groups = {}
        for i, (t, m) in enumerate(zip(self.w, self.mu)):
            groups.setdefault((t.dtype == torch.bfloat16, m.dtype == torch.bfloat16), []).append(i)
        self.batches: List[_Batch] = []
        rows, chunks = [], []
        for (wb, mb), idx in groups.items():
            for s in range(0, len(idx), MAX_LEAVES):
                part = idx[s:s + MAX_LEAVES]
                batch_chunks = []
                for slot, i in enumerate(part):
                    nc = -(-self.numel[i] // CHUNK_ELEMS)
                    batch_chunks += [(slot, c) for c in range(nc)]
                self.batches.append(_Batch(wb, mb, part, len(rows), len(chunks), len(batch_chunks)))
                rows += [self._row(i) for i in part]
                chunks += batch_chunks
        self.chunks = torch.tensor(chunks, dtype=torch.int32).reshape(-1, 2).to(self.device)
        self.rows = torch.tensor(rows, dtype=torch.int64).to(self.device)
        # (bytes, f32 operations) of each batch's launch, for a step's cost count
        self.launch_costs = [
            (leaf_bytes([self.w[i].shape for i in b.idx], 2 if b.w_bf16 else 4, 2 if b.m_bf16 else 4),
             OPS_PER_ELEM * sum(self.numel[i] for i in b.idx))
            for b in self.batches
        ]

    def _check_leaf(self, i: int) -> None:
        w, mu, nu, nz = self.w[i], self.mu[i], self.nu[i], self.noise[i]
        if w.device != self.device or not w.is_contiguous():
            raise ValueError(f"LeafTable: leaf {i}: w must be contiguous on {self.device}")
        if w.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"LeafTable: leaf {i}: w must be f32 or bf16 (got {w.dtype})")
        for name, t in (("mu", mu), ("nu", nu)):
            if t.device != self.device or t.shape != w.shape or not t.is_contiguous():
                raise ValueError(
                    f"LeafTable: leaf {i}: {name} must be a contiguous tensor of w's shape "
                    f"{tuple(w.shape)} on {self.device}"
                )
        if mu.dtype != nu.dtype or mu.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"LeafTable: leaf {i}: moments must share f32 or bf16 ({mu.dtype}, {nu.dtype})")
        if nz is not None and (
            nz.dtype != torch.int32
            or nz.shape != (3, w.numel())
            or nz.device != self.device
            or not nz.is_contiguous()
        ):
            raise ValueError(f"LeafTable: leaf {i}: noise must be contiguous int32 (3, numel) on w's device")

    def _row(self, i: int) -> List[int]:
        w, mu, nu, nz = self.w[i], self.mu[i], self.nu[i], self.noise[i]
        aligned = all(t.data_ptr() % 16 == 0 for t in (w, mu, nu))
        return [
            w.data_ptr(), mu.data_ptr(), nu.data_ptr(), nz.data_ptr() if nz is not None else 0,
            self.numel[i], (self.leaf_ids[i] & 0xFFFFFFFF) | (int(aligned) << 32), self.starts[i] // 8,
        ]

    @staticmethod
    def _storage(w, mu, nu) -> List[tuple]:
        return [(a.data_ptr(), b.data_ptr(), c.data_ptr()) for a, b, c in zip(w, mu, nu)]

    def check_storage(self, w: Sequence[torch.Tensor], mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor]) -> None:
        """Raise if ``w``, ``mu`` or ``nu`` are not the storage the table was
        built on (a parameter's ``.data`` replaced after the table was
        built, say): the kernel would write to the old, perhaps freed,
        memory."""
        if self._storage(w, mu, nu) != self._ptrs:
            raise RuntimeError(
                "LeafTable: a parameter or moment no longer lies where the table was built; "
                "build the table (the optimizer state) again after replacing parameters"
            )


def _check_call(table: LeafTable, grads: Sequence[torch.Tensor], scal: torch.Tensor) -> None:
    if len(grads) != len(table.w):
        raise ValueError(f"fused_adamw: {len(grads)} gradients for {len(table.w)} leaves")
    for i, (w, g) in enumerate(zip(table.w, grads)):
        if g.dtype != w.dtype:
            raise TypeError(f"fused_adamw: gradient {i} must have w's dtype {w.dtype} (got {g.dtype})")
        if g.shape != w.shape or g.device != table.device or not g.is_contiguous():
            raise ValueError(
                f"fused_adamw: gradient {i} must be a contiguous tensor of w's shape "
                f"{tuple(w.shape)} on {table.device}"
            )
    if scal.dtype != torch.float32 or scal.numel() != 4 or scal.device != table.device:
        raise ValueError("fused_adamw: scal must be 4 f32 values on the leaves' device")


def _step_word(step, device: torch.device) -> torch.Tensor:
    """The Philox step as the kernel reads it: an int32 word on ``device``
    (the optimizer's count as it is, an int filled into a new word)."""
    if isinstance(step, torch.Tensor):
        if step.dtype != torch.int32 or step.numel() != 1 or step.device != device:
            raise ValueError(f"fused_adamw: a step tensor must be one int32 word on {device}")
        return step
    return torch.full((), step & 0xFFFFFFFF, dtype=torch.int64, device=device).to(torch.int32)


def _apply(table: LeafTable, grads, scal, **kw) -> int:
    """Update every leaf of ``table`` in place; returns the kernel launches
    made (0 on the CPU, where the plain version runs). An active
    ``step_cost.CostCounter`` counts one launch a batch of the table on
    either device."""
    _check_call(table, grads, scal)
    with step_cost.kernel_launches("fused AdamW", table.launch_costs):
        return _launch(table, grads, scal, **kw)


def _launch(table: LeafTable, grads, scal, *, b1, b2, eps, wd, seed, step) -> int:
    if table.device.type == "cpu":
        lr, b1c, b2c, gscale = scal.unbind(0)
        outs = fused_adamw_multi_reference(
            table.w, grads, table.mu, table.nu, lr=lr, b1c=b1c, b2c=b2c, gscale=gscale,
            seed=seed, step=step, leaf_ids=table.leaf_ids, noise=table.noise, starts=table.starts,
            b1=b1, b2=b2, eps=eps, wd=wd,
        )
        for dst, src in zip(zip(table.w, table.mu, table.nu), outs):
            for d, s in zip(dst, src):
                d.copy_(s)
        return 0
    if table.device.type != "cuda":
        raise RuntimeError(f"fused_adamw: no kernel for device {table.device}")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    step = _step_word(step, table.device)
    rows, chunks = table.rows.data_ptr(), table.chunks.data_ptr()
    for b in table.batches:
        gptrs = (ctypes.c_void_p * len(b.idx))(*[grads[i].data_ptr() for i in b.idx])
        LIBRARY.launch(
            "fused_adamw_multi_launch",
            rows + 56 * b.row0, chunks + 8 * b.chunk0, b.n_chunks, gptrs, len(b.idx),
            int(b.w_bf16), int(b.m_bf16), scal.data_ptr(),
            b1, 1.0 - b1, b2, 1.0 - b2, eps, wd,
            seed & 0xFFFFFFFFFFFFFFFF, step.data_ptr(), CHUNK_ELEMS, stream,
        )
    return len(table.batches)


@counted
def fused_adamw_multi(
    table: LeafTable,
    grads: Sequence[torch.Tensor],
    scal: torch.Tensor,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    wd: float = 0.0,
    seed: int = 0,
    step=0,
) -> None:
    """One AdamW step on every leaf of ``table``, in place on its ``w``,
    ``mu`` and ``nu``: on the card one kernel launch per batch of the table
    (one per dtype variant present, up to ``MAX_LEAVES`` leaves each).

    ``grads`` are contiguous, one per leaf, of its ``w``'s shape and dtype;
    ``scal`` holds the per-step f32 scalars ``[lr, b1c, b2c, gscale]`` on the
    leaves' device. The stochastic-rounding bits are ``philox_noise`` of
    ``seed``, the leaf's word and ``step``, unless the table gives noise.
    ``step`` is an int or, as the optimizer passes it, an int32 word on the
    leaves' device that the kernel reads when it runs (so a launch captured
    in a CUDA graph takes the step of each replay).

    ``launches`` counts the kernel launches; a launch recorded while a CUDA
    graph is captured counts once for each replay of the graph
    (``train.graph.StepGraph``), not at the capture."""
    fused_adamw_multi.launches += _apply(
        table, grads, scal, b1=b1, b2=b2, eps=eps, wd=wd, seed=seed, step=step
    )


def leaf_bytes(shapes: Sequence[tuple], w_bytes: int, m_bytes: int) -> int:
    """Bytes one update pass must move: read w, g, mu, nu once and write w,
    mu, nu once (g has w's dtype)."""
    elems = sum(int(torch.Size(s).numel()) for s in shapes)
    return elems * (3 * w_bytes + 4 * m_bytes)
