"""The FLOPs, bytes and a lower bound of time of what one call launches,
counted from the shapes of every ATen operator it dispatches, the backward
included, and by operator class.

Counterpart of ``scrubvae_tpu/utils/hlo_flops.py`` (``static_mxu_flops``:
2*M*N*K over every dot and convolution of the compiled program) and of the
JAX bench's ``compiled.cost_analysis()`` ("bytes accessed"); its classes are
those of ``tools/hlo_opclass.py`` and its bound is what
``tools/hbm_bound.py`` bounds, for the port's eager operators:

- FLOPs: 2*M*N*K for every matrix product and convolution, forward and
  backward, from ``torch.utils.flop_counter``'s formulas, so the total equals
  ``FlopCounterMode``'s to the FLOP. Elementwise arithmetic is not counted.
- bytes: each input tensor read once and each output written once, from
  shapes and dtypes (the distinct elements a strided view spans: an
  expanded dimension is read once). Views and aliases move none; an
  in-place operator reads and writes its target, an ``out=`` argument or an
  overwrite (``copy_``, ``fill_``) only writes it. A gather reads the source
  elements it returns, not the whole source; an in-place scatter reads and
  writes (accumulates) or writes (copies) the elements its values land on,
  not the whole target. Collectives are a class of their own and never
  HBM traffic: they count as operators, with no bytes.
- bound: ``max(flops / peak, bytes / HBM_BYTES_PER_S)`` an operator, summed.
  Products and convolutions in bf16 or f16 take the tensor cores' dense
  peak, in f32 the CUDA cores' unless TF32 is allowed (cuBLAS's flag for
  products, cuDNN's for convolutions), in f64 the FP64 tensor cores'. The
  rates are the H100 SXM data sheet's at 700 W, whatever device the count
  runs on: on the CPU the bound is a count from shapes, not a claim about a
  device.

A hand-written kernel launched outside the dispatcher (the fused AdamW
kernel, through ``ctypes``) reports each launch with ``kernel_launches``:
its bytes and operations enter its own class, and the torch operators of
its plain version, which runs in its place on the CPU, are not counted, so
the CPU and the card count the same launches.

What no ATen operator shows is not counted: the layout transposes cuDNN
runs inside a convolution, and the kernels of a library call beyond its
inputs and outputs. The byte count is a lower bound there. It follows what
the port launches, as XLA's cost analysis follows what it compiled: a
change to the step changes the count.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = [
    "CLASSES",
    "ClassCost",
    "CostCounter",
    "StepCost",
    "count",
    "kernel_launches",
    "op_class",
    "op_bytes",
]

# NVIDIA H100 SXM data sheet, dense, at 700 W
HBM_BYTES_PER_S = 3.35e12
TENSOR_16_FLOP_PER_S = 989.4e12  # bf16 and f16 tensor cores
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12  # CUDA cores
F64_FLOP_PER_S = 67e12  # FP64 tensor cores

CLASSES = (
    "product", "convolution", "elementwise", "reduction", "copy/layout", "indexing/scatter",
    "collective", "fused AdamW", "other",
)

# the queries FlopCounterMode passes through uncounted
_QUERIES = {
    torch.ops.aten.sym_is_contiguous.default, torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format, torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default, torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default, torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default, torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default, torch.ops.aten.dim.default,
    torch.ops.prim.layout.default,
}
# no kernel: an allocation, or a view whose schema does not say so
_NO_TRAFFIC = {"_unsafe_view", "lift_fresh", "empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "resize_", "set_"}
_COPY = {
    "copy_", "_to_copy", "clone", "cat", "stack", "constant_pad_nd", "flip", "roll", "repeat", "contiguous",
    "slice_backward", "select_backward", "as_strided_scatter", "slice_scatter", "select_scatter",
    "diagonal_scatter", "diagonal_backward", "fill_", "zero_", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "new_zeros", "new_ones", "new_full", "scalar_tensor", "arange", "lift_fresh_copy",
    "_copy_from", "_copy_from_and_resize", "tril", "triu", "col2im", "im2col",
}
_GATHER = {"index", "index_select", "gather", "take", "embedding", "masked_select"}
# in place: the target's elements its values land on, read and written where
# it accumulates (always, or with ``accumulate``), else written
_SCATTER = {"index_add_", "scatter_add_", "scatter_reduce_", "index_put_", "_index_put_impl_", "index_copy_",
            "scatter_"}
_ACCUMULATE = {"index_add_", "scatter_add_", "scatter_reduce_"}
_INDEXING = _GATHER | _SCATTER | {
    "index_add", "index_copy", "index_put", "scatter", "scatter_add", "scatter_reduce", "index_fill",
    "index_fill_", "masked_scatter", "masked_scatter_", "nonzero", "embedding_dense_backward",
    "diag_embed", "put_",
}
_REDUCTION = {
    "_softmax", "_log_softmax", "_softmax_backward_data", "_log_softmax_backward_data", "native_batch_norm",
    "native_batch_norm_backward", "_native_batch_norm_legit", "_native_batch_norm_legit_functional",
    "_native_batch_norm_legit_no_training", "cudnn_batch_norm", "cudnn_batch_norm_backward",
    "native_layer_norm", "native_layer_norm_backward", "_foreach_norm", "linalg_vector_norm", "norm",
    "cumsum", "cumprod", "logcumsumexp", "topk", "sort", "var_mean", "std_mean", "_unique2",
}
_ELEMENTWISE = {
    "linalg_cross", "native_dropout", "native_dropout_backward", "_masked_scale", "bernoulli", "bernoulli_",
    "normal", "normal_", "uniform_", "random_", "exponential_", "randn", "rand", "randint", "randn_like",
    "rand_like", "softplus_backward", "sigmoid_backward", "tanh_backward", "gelu_backward", "elu_backward",
    "_prelu_kernel", "_prelu_kernel_backward", "logit_backward",
}
_OVERWRITE = {"copy_", "fill_", "zero_", "normal_", "uniform_", "bernoulli_", "random_", "exponential_",
              "index_copy_", "scatter_"}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional", "_dtensor")


def _name(func) -> str:
    return func._overloadpacket.__name__


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)


def op_class(func) -> str:
    """The class of the ATen operator ``func`` (an ``OpOverload``)."""
    name = _name(func)
    if func.namespace in _COLLECTIVE_NAMESPACES:
        return "collective"
    if func._overloadpacket in flop_registry:
        return "convolution" if "conv" in name else "product"
    if name in _INDEXING:
        return "indexing/scatter"
    if name in _COPY or name in _NO_TRAFFIC or _is_view(func):
        return "copy/layout"
    if name in _REDUCTION or torch.Tag.reduction in func.tags:
        return "reduction"
    if name in _ELEMENTWISE or torch.Tag.pointwise in func.tags or name.startswith("_foreach_"):
        return "elementwise"
    return "other"


def _tensors(value) -> list:
    return [t for t in tree_flatten(value)[0] if isinstance(t, torch.Tensor)]


def _span_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a strided tensor spans (a dimension of
    stride 0 counted once)."""
    if t.layout != torch.strided:
        return t.numel() * t.element_size()
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _bind(args: Sequence, kwargs: dict, func) -> Dict[str, object]:
    """The schema's arguments by name."""
    schema = func._schema
    out = {}
    for i, a in enumerate(schema.arguments):
        if i < len(args) and not a.kwarg_only:
            out[a.name] = (a, args[i])
        elif a.name in kwargs:
            out[a.name] = (a, kwargs[a.name])
    return out


def op_bytes(func, args: Sequence, kwargs: dict, out) -> int:
    """Bytes the operator ``func`` moves on these arguments (the module
    docstring's rules)."""
    name = _name(func)
    if name in _NO_TRAFFIC or _is_view(func) or func.namespace in _COLLECTIVE_NAMESPACES:
        return 0
    reads: Dict[int, torch.Tensor] = {}
    writes: Dict[int, torch.Tensor] = {}
    touched = 0
    named = _bind(args, kwargs, func)
    first = func._schema.arguments[0].name if func._schema.arguments else None
    for arg_name, (a, value) in named.items():
        ts = _tensors(value)
        write = a.alias_info is not None and a.alias_info.is_write
        if write:
            writes.update((id(t), t) for t in ts)
        if name in _GATHER and arg_name == first:
            continue  # the source: read where gathered (below)
        if write and (a.kwarg_only or name in _OVERWRITE or name in _SCATTER):
            continue  # not read: an out= argument, an overwrite, or a scatter's target (below)
        reads.update((id(t), t) for t in ts)
    outs = _tensors(out)
    if name in _GATHER and first in named:
        src = _tensors(named[first][1])
        if src:
            touched = sum(t.numel() for t in outs) * src[0].element_size()
    if name in _SCATTER:
        target = _tensors(named[first][1])[0]
        values = next((v for k, (_, v) in named.items() if k in ("source", "src", "values")), None)
        n = values.numel() if isinstance(values, torch.Tensor) else 0
        acc = name in _ACCUMULATE or bool(named.get("accumulate", (None, False))[1])
        touched = n * target.element_size() * (2 if acc else 1)
        outs = []
        writes.pop(id(target), None)
    writes.update((id(t), t) for t in outs)
    return touched + sum(_span_bytes(t) for t in reads.values()) + sum(_span_bytes(t) for t in writes.values())


def _peak(func, args: Sequence, cls: str) -> float:
    """FLOP/s of a product or convolution on its first tensor's dtype."""
    ts = _tensors(list(args))
    dtype = ts[0].dtype if ts else torch.float32
    if dtype in (torch.bfloat16, torch.float16):
        return TENSOR_16_FLOP_PER_S
    if dtype == torch.float64:
        return F64_FLOP_PER_S
    tf32 = torch.backends.cudnn.allow_tf32 if cls == "convolution" else torch.backends.cuda.matmul.allow_tf32
    return TF32_FLOP_PER_S if tf32 else F32_FLOP_PER_S


@dataclasses.dataclass
class ClassCost:
    """One class's operators: their count, 2*M*N*K FLOPs, bytes and the sum
    of their bounds."""

    ops: int = 0
    flops: int = 0
    bytes: int = 0
    bound_ms: float = 0.0

    def add(self, flops: int, nbytes: int, bound_ms: float) -> None:
        self.ops += 1
        self.flops += flops
        self.bytes += nbytes
        self.bound_ms += bound_ms


@dataclasses.dataclass
class StepCost:
    """What ``CostCounter`` counted: totals over every class and one
    ``ClassCost`` a class that occurred, in ``CLASSES`` order."""

    flops: int
    bytes: int
    bound_ms: float
    ops: int
    classes: Dict[str, ClassCost]

    def by_class(self) -> dict:
        """The classes as plain dicts (a JSON record's)."""
        return {k: dataclasses.asdict(v) for k, v in self.classes.items()}

    def table(self, device_ms: Optional[Dict[str, float]] = None, note: str = "") -> str:
        """The classes as a text table; ``device_ms`` adds a column of
        measured device ms by class, and ``note`` a line under it."""
        head = f"{'class':18s} {'ops':>7s} {'GFLOP':>10s} {'MB':>11s} {'bound ms':>10s}"
        head += f" {'device ms':>10s}" if device_ms is not None else ""
        lines = [head]
        for k, c in self.classes.items():
            line = f"{k:18s} {c.ops:7d} {c.flops / 1e9:10.3f} {c.bytes / 1e6:11.3f} {c.bound_ms:10.4f}"
            if device_ms is not None:
                ms = device_ms.get(k)
                line += f" {ms:10.4f}" if ms is not None else f" {'-':>10s}"
            lines.append(line)
        line = f"{'total':18s} {self.ops:7d} {self.flops / 1e9:10.3f} {self.bytes / 1e6:11.3f} {self.bound_ms:10.4f}"
        if device_ms is not None:
            line += f" {sum(device_ms.values()):10.4f}"
        lines.append(line)
        if device_ms is not None:
            lines += [f"{k:18s} {'':7s} {'':10s} {'':11s} {'':10s} {v:10.4f}"
                      for k, v in device_ms.items() if k not in self.classes]
        if note:
            lines.append(note)
        return "\n".join(lines) + "\n"


class CostCounter(TorchDispatchMode):
    """A dispatch mode that counts every ATen operator run under it (the
    backward too: autograd carries the mode to its threads) and the
    launches hand-written kernels report (``kernel_launches``)::

        with CostCounter() as counter:
            step()
        counter.cost()  # a StepCost

    Operators ``torch.utils.flop_counter`` has no formula for are decomposed
    where they have a decomposition, as ``FlopCounterMode`` does, and only
    the operators that run are counted: a composite is never counted beside
    its parts."""

    def __init__(self):
        super().__init__()
        self._classes = {k: ClassCost() for k in CLASSES}
        self._paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        if self._paused:
            return func(*args, **kwargs)
        if func._overloadpacket not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        cls = op_class(func)
        flops = 0
        if func._overloadpacket in flop_registry:
            flops = int(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
        nbytes = op_bytes(func, args, kwargs, out)
        bound = max(flops / _peak(func, args, cls) if flops else 0.0, nbytes / HBM_BYTES_PER_S) * 1e3
        self._classes[cls].add(flops, nbytes, bound)
        return out

    def _launch(self, cls: str, nbytes: int, ops: int) -> None:
        """One kernel launch: ``nbytes`` moved and ``ops`` f32 operations on
        the CUDA cores (they enter the bound, not ``flops``)."""
        self._classes.setdefault(cls, ClassCost()).add(
            0, nbytes, max(ops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        )

    def cost(self) -> StepCost:
        classes = {k: dataclasses.replace(c) for k, c in self._classes.items() if c.ops}
        return StepCost(
            flops=sum(c.flops for c in classes.values()),
            bytes=sum(c.bytes for c in classes.values()),
            bound_ms=sum(c.bound_ms for c in classes.values()),
            ops=sum(c.ops for c in classes.values()),
            classes=classes,
        )


@contextlib.contextmanager
def kernel_launches(cls: str, launches: Iterable[Tuple[int, int]]):
    """Report kernel launches made outside the dispatcher to every active
    ``CostCounter``: ``launches`` holds ``(bytes, f32 operations)`` a launch.
    The block makes those launches (or runs their plain version); no
    operator it dispatches is counted. With no counter active this is one
    check."""
    if not torch._C._len_torch_dispatch_stack():
        yield
        return
    counters = [m for m in _get_current_dispatch_mode_stack() if isinstance(m, CostCounter)]
    for c in counters:
        for nbytes, ops in launches:
            c._launch(cls, nbytes, ops)
        c._paused += 1
    try:
        yield
    finally:
        for c in counters:
            c._paused -= 1


def count(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under a ``CostCounter``; returns (its
    result, the ``StepCost``)."""
    with CostCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost()
