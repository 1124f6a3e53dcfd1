"""``scrubvae_torch.utils.step_cost`` (the counterpart of the JAX package's
``utils/hlo_flops.py`` and of the bench's cost analysis) on the CPU.

FLOPs: single products and convolutions against JAX's ``static_mxu_flops``
of the compiled function, exactly, and the differences of convention named
and pinned (XLA counts the zeros that padding and strides insert into a
convolution's input gradient and a transposed convolution's input); the
bench's ``--small`` step against the JAX trainer's compiled step by class,
within the tolerances stated in ``test_small_step_against_jax``, and
against ``FlopCounterMode`` exactly. Bytes: a short sequence of operators
against hand counts, the fused AdamW kernel's entry against ``leaf_bytes``
and its launches a step. The bench and profile entries' new fields.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from _port_fit import step_pair
from scrubvae_tpu.utils.hlo_flops import static_mxu_flops
from scrubvae_torch import bench, profile_step
from scrubvae_torch.ops import fused_adamw as fa
from scrubvae_torch.train.trainer import Trainer
from scrubvae_torch.utils import step_cost
from scrubvae_torch.utils.step_cost import CostCounter, count

torch.set_num_threads(1)

SMALL = ["--small", "--device", "cpu", "--steps", "2", "--warmup", "1"]
CPU = torch.device("cpu")
B, W, CIN, K, COUT = 4, 32, 8, 5, 16


def jax_flops(fn, *shapes) -> int:
    args = [jnp.asarray(np.random.default_rng(0).normal(size=s), jnp.float32) for s in shapes]
    return static_mxu_flops(jax.jit(fn).lower(*args).compile().as_text())


def port_flops(fn, *shapes, grad: bool = False) -> int:
    rng = np.random.default_rng(0)
    ts = [torch.tensor(rng.normal(size=s), dtype=torch.float32, requires_grad=grad) for s in shapes]

    def body():
        y = fn(*ts)
        if grad:
            y.sum().backward()

    return count(body)[1].flops


def value_and_grad(fn):
    """The function's value and the gradients of its sum in every
    argument, as one compiled program (the forward kept, as autograd
    keeps it)."""
    return lambda *a: jax.value_and_grad(lambda *b: fn(*b).sum(), argnums=tuple(range(len(a))))(*a)


def jax_conv(x, w, stride=1):
    return jax.lax.conv_general_dilated(x, w, (stride,), "VALID", dimension_numbers=("NWC", "WIO", "NWC"))


def port_conv(x, w, stride=1):
    """``jax_conv`` on the port's layouts: (B, W, Cin) and (K, Cin, Cout)
    taken as (B, Cin, W) and (Cout, Cin, K) views."""
    return F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride)


CONV_FWD = 2 * B * (W - K + 1) * COUT * K * CIN


@pytest.mark.parametrize(
    "case,shapes,grad,want",
    [
        ("product", ((128, 256), (256, 64)), False, 2 * 128 * 256 * 64),
        ("batched product", ((8, 32, 64), (8, 64, 16)), False, 2 * 8 * 32 * 64 * 16),
        ("conv1d", ((B, W, CIN), (K, CIN, COUT)), False, CONV_FWD),
        ("product and its gradients", ((128, 256), (256, 64)), True, 3 * 2 * 128 * 256 * 64),
        ("batched product and its gradients", ((8, 32, 64), (8, 64, 16)), True, 3 * 2 * 8 * 32 * 64 * 16),
    ],
)
def test_single_op_flops_equal_static_mxu_flops(case, shapes, grad, want):
    """The port's count equals the static HLO count of the same function,
    compiled, and the hand count. The batched product's shape is one XLA
    keeps as a ``dot``."""
    conv = case.startswith("conv")
    jfn = jax_conv if conv else (lambda a, b: a @ b)
    pfn = port_conv if conv else (lambda a, b: a @ b)
    j = jax_flops(value_and_grad(jfn) if grad else jfn, *shapes)
    p = port_flops(pfn, *shapes, grad=grad)
    assert p == j == want


def test_conv_input_gradient_convention():
    """A named difference: XLA computes a VALID convolution's input
    gradient as a convolution over the gradient padded by K - 1 on each
    side and counts the padded positions; the port counts the products of
    the operands as given. So JAX's count is higher by exactly
    2 * B * (K - 1) * Cin * K * Cout."""
    shapes = ((B, W, CIN), (K, CIN, COUT))
    j = jax_flops(value_and_grad(jax_conv), *shapes)
    p = port_flops(port_conv, *shapes, grad=True)
    assert p == 3 * CONV_FWD
    assert j - p == 2 * B * (K - 1) * CIN * K * COUT


def test_transposed_conv_convention():
    """A named difference: XLA runs a transposed convolution of stride s as
    a convolution over the input dilated by s (s - 1 zeros between
    samples) and counts the zeros; the port counts the input's own
    samples. So JAX's count is s times the port's."""
    s, pad = 2, 2

    def jfn(x, w):
        return jax.lax.conv_transpose(x, w, (s,), "SAME", dimension_numbers=("NWC", "WIO", "NWC"))

    def pfn(x, w):
        return F.conv_transpose1d(x.transpose(1, 2), w.permute(1, 2, 0), stride=s, padding=pad, output_padding=1)

    shapes = ((B, 16, CIN), (K, CIN, COUT))
    j = jax_flops(jfn, *shapes)
    p = port_flops(pfn, *shapes)
    assert p == 2 * B * 16 * CIN * COUT * K
    assert j == s * p


def small_trainer(ch=bench.SMALL_CH, fused=True, **train):
    """The bench's ``--small`` trainer on the CPU (f32 storage), with
    ``train`` overriding its train section."""
    trainer, ds = bench.build(16, 51, 16, ch, CPU, precision="fp32", bf16_params=False, fused=fused)
    if train:
        cfg = copy.deepcopy(trainer.config)
        cfg["train"].update(train)
        trainer = Trainer(cfg, {"train": ds}, trainer.model, trainer.info, device=CPU)
    return trainer


ROW = np.arange(16)


def test_small_step_against_jax():
    """The bench's ``--small`` train step (window rows in, the update
    applied) as the JAX trainer compiles it and as the port runs it.
    Measured: the port 82,764,704 FLOPs, JAX 82,373,472 (+0.47%). By class:

    - convolutions: JAX higher by 2.8% (79,803,648 against 77,587,200): the
      zeros of padded and dilated operands that XLA counts in the input
      gradients and the decoder's transposed convolutions
      (``test_conv_input_gradient_convention``,
      ``test_transposed_conv_convention``); bound: port <= JAX <= 1.03 port;
    - products: the forward kinematics' 3x3 products (the port's ``bmm``),
      2,746,656 FLOPs, are folded by XLA into elementwise fusions and
      appear in no ``dot``; held to the hand count of
      ``tests/test_torch_port_bench.py``. The port's other products
      (``mm``, ``addmm``: the dense layers, the scrubbers) within 6% of
      JAX's dots (measured -5.4%: XLA keeps some of the scrubbers'
      small reductions as dots that the port sums elementwise);
    - the whole step within 1%.
    """
    jt, trainer = step_pair(bench.bench_config(16, 51, 16, bench.SMALL_CH, False, "fp32"))
    ls = jt.loss_scale_for_epoch(1)
    hlo = jt.train_step.lower(jt.state, jnp.asarray(ROW, jnp.int32), ls).compile().as_text()
    j_conv = static_mxu_flops("\n".join(line for line in hlo.splitlines() if " dot(" not in line))
    j_dot = static_mxu_flops("\n".join(line for line in hlo.splitlines() if " convolution(" not in line))
    assert j_conv + j_dot == static_mxu_flops(hlo)
    with FlopCounterMode(display=False) as fc:
        _, cost = count(trainer.train_step, trainer.state, torch.as_tensor(ROW), trainer.loss_scale_for_epoch(1))
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    fk = by_op.pop("aten.bmm")
    frames, joints = 16 * 51, 17
    conv, prod = cost.classes["convolution"].flops, cost.classes["product"].flops
    print(f"port {cost.flops} (conv {conv}, products {prod}, FK {fk}); JAX {j_conv + j_dot} (conv {j_conv}, dot {j_dot})")
    assert fk == frames * joints * (3 * 2 * 27 + 2 * 2 * 9)
    assert prod == fk + sum(v for k, v in by_op.items() if "conv" not in k)
    assert conv <= j_conv <= 1.03 * conv
    assert abs((prod - fk) / j_dot - 1) <= 0.06
    assert abs(cost.flops / (j_conv + j_dot) - 1) <= 0.01


def test_step_flops_equal_flop_counter_mode():
    """The whole small step's FLOPs, the backward on autograd's side
    included, equal ``FlopCounterMode``'s to the FLOP."""
    trainer = small_trainer()
    rows = ROW[None]
    with FlopCounterMode(display=False) as fc:
        trainer.train_epoch(1, rows)
    _, cost = count(trainer.train_epoch, 1, rows)
    assert cost.flops == fc.get_total_flops() > 0
    assert cost.classes["convolution"].ops > 0 and cost.classes["product"].ops > 0


def f32(*shape):
    return torch.tensor(np.random.default_rng(len(shape)).normal(size=shape), dtype=torch.float32)


NB = 4  # bytes of an f32
IDX = 8 * 5  # five int64 indices


@pytest.mark.parametrize(
    "case,operands,op,want_bytes,want_class",
    [
        # a and the bias read once (its broadcast is not read again), a's shape written
        ("add", lambda: (f32(64, 32), f32(32)), torch.add, NB * (64 * 32 + 32 + 64 * 32), "elementwise"),
        ("product", lambda: (f32(64, 32), f32(32, 16)), torch.mm, NB * (64 * 32 + 32 * 16 + 64 * 16), "product"),
        ("conv", lambda: (f32(2, 4, 10), f32(8, 4, 3)), F.conv1d, NB * (2 * 4 * 10 + 8 * 4 * 3 + 2 * 8 * 8),
         "convolution"),
        ("view", lambda: (f32(64, 32),), lambda a: a.view(-1), 0, "copy/layout"),
        ("transpose", lambda: (f32(64, 32),), torch.t, 0, "copy/layout"),
        # in place: the target read and written, the other operand read
        ("in-place add", lambda: (f32(64, 32), f32(64, 32)), lambda a, b: a.add_(b), NB * 3 * 64 * 32,
         "elementwise"),
        # an overwrite only writes its target
        ("copy", lambda: (f32(64, 32), f32(64, 32)), lambda a, b: a.copy_(b), NB * 2 * 64 * 32, "copy/layout"),
        # a gather reads the index and the rows it returns
        ("gather", lambda: (f32(64, 32), torch.arange(5)), lambda a, i: a[i], NB * 2 * 5 * 32 + IDX,
         "indexing/scatter"),
        # an accumulating scatter reads and writes the rows it lands on, not the whole target
        ("scatter", lambda: (f32(64, 32), torch.arange(5), f32(5, 32)), lambda a, i, v: a.index_add_(0, i, v),
         NB * (5 * 32 + 2 * 5 * 32) + IDX, "indexing/scatter"),
    ],
)
def test_bytes_of_single_ops(case, operands, op, want_bytes, want_class):
    """Bytes a hand counts from shapes, exactly: each input read once, each
    output written once, the module docstring's rules for views, in-place
    operators, overwrites, gathers and scatters."""
    _, cost = count(op, *operands())
    assert cost.bytes == want_bytes
    assert list(cost.classes) == [want_class] and cost.classes[want_class].ops == 1
    assert cost.bound_ms == pytest.approx(want_bytes / step_cost.HBM_BYTES_PER_S * 1e3)


def test_a_composite_is_counted_once():
    """``F.linear`` reaches the dispatcher as its parts (a transpose view
    and one ``addmm``), which are counted; the composite is not counted
    beside them. Its FLOPs are one product's, its bytes the product's
    operands and output."""
    x, w, b = f32(16, 32), f32(8, 32), f32(8)
    _, cost = count(F.linear, x, w, b)
    assert cost.flops == 2 * 16 * 32 * 8
    assert cost.classes["product"].ops == 1 and cost.ops == 2
    assert cost.bytes == NB * (16 * 32 + 8 * 32 + 8 + 16 * 8)


def test_a_product_bound_follows_its_dtype():
    """The bound of a product: its FLOPs over the peak of its dtype (bf16's
    tensor cores, f32's CUDA cores with TF32 off) where that exceeds its
    bytes over the memory rate."""
    a, b = f32(512, 512), f32(512, 512)
    flops = 2 * 512 ** 3
    for x, y, peak in ((a, b, step_cost.F32_FLOP_PER_S), (a.bfloat16(), b.bfloat16(), step_cost.TENSOR_16_FLOP_PER_S)):
        _, cost = count(torch.mm, x, y)
        want = max(flops / peak, cost.bytes / step_cost.HBM_BYTES_PER_S) * 1e3
        assert cost.flops == flops and cost.bound_ms == pytest.approx(want)


# the bench's small model with a last channel of 128: fc_sigma then keeps
# bf16 moments, so the table has two dtype variants and two launches
TWO_VARIANTS = (8, 8, 16, 16, 128)


def table_bytes(trainer) -> int:
    params, mu = list(trainer.model.parameters()), trainer.state.opt_state.mu
    return sum(fa.leaf_bytes([p.shape], p.element_size(), m.element_size()) for p, m in zip(params, mu))


def test_kernel_entry_equals_leaf_bytes():
    """The fused AdamW class of one step: one launch a dtype variant of the
    leaf table, its bytes ``leaf_bytes`` of the model's leaves and moments,
    its bound theirs over the memory rate (the 20 f32 operations an element
    are below it); the plain version's torch operators, which run in the
    kernel's place on the CPU, are not counted."""
    trainer = small_trainer(TWO_VARIANTS)
    assert len(trainer.state.opt_state.table.batches) == 2
    _, cost = count(trainer.train_epoch, 1, ROW[None])
    adamw = cost.classes["fused AdamW"]
    want = table_bytes(trainer)
    assert (adamw.ops, adamw.bytes, adamw.flops) == (2, want, 0)
    assert adamw.bound_ms == pytest.approx(want / step_cost.HBM_BYTES_PER_S * 1e3)
    # the pass alone: the launches and nothing else
    st = trainer.state.opt_state
    grads = [torch.zeros_like(w) for w in st.table.w]
    scal = torch.tensor([1e-4, 0.1, 0.001, 1.0])
    _, alone = count(fa.fused_adamw_multi, st.table, grads, scal, step=1)
    assert list(alone.classes) == ["fused AdamW"] and (alone.ops, alone.bytes) == (2, want)


@pytest.mark.parametrize(
    "variant,train,fused,launches",
    [("fused", {}, True, 2), ("sgd", {"optimizer": "sgd"}, True, 0), ("unfused", {}, False, 0)],
)
def test_kernel_counted_once_a_launch(variant, train, fused, launches):
    """Two launches a step on the fused path (two dtype variants), none
    under ``train.optimizer: sgd`` or ``train.fused_optimizer: false``,
    whose updates are torch operators counted like any others."""
    trainer = small_trainer(TWO_VARIANTS, fused=fused, **train)
    _, cost = count(trainer.train_epoch, 1, np.stack([ROW, ROW + 16]))
    got = cost.classes["fused AdamW"].ops if "fused AdamW" in cost.classes else 0
    assert got == 2 * launches
    assert cost.classes["elementwise"].ops > 0


def test_bench_line_carries_the_cost_fields():
    """``bench.run`` at ``--small`` on the CPU: the new fields beside
    ``gflops_per_step``, which stays the ``FlopCounterMode`` count of a
    step."""
    out = bench.run(bench.parse_args(SMALL))
    trainer = small_trainer()
    trainer.train_epoch(1, ROW[None])  # the bench counts after its warm-up epoch
    with FlopCounterMode(display=False) as fc:
        trainer.train_epoch(1, ROW[None])
    assert out["gflops_per_step"] * 1e9 == pytest.approx(fc.get_total_flops(), rel=1e-12)
    assert out["bytes_per_step"] > 0 and out["bound_ms_per_step"] > 0
    assert out["bytes_accessed_gb_per_s"] == pytest.approx(out["bytes_per_step"] / out["step_ms"] / 1e6)
    classes = out["step_cost"]
    assert sum(c["bytes"] for c in classes.values()) == out["bytes_per_step"]
    assert sum(c["flops"] for c in classes.values()) == round(out["gflops_per_step"] * 1e9)
    assert classes["fused AdamW"]["ops"] == 1


def test_profile_step_line_and_class_table():
    """``profile_step --small --device cpu``: the line's bytes and bound,
    the class table in ``build/``; no device column on the CPU."""
    rec = profile_step.run(profile_step.parse_args(["--small", "--device", "cpu", "--steps", "1", "--per-step"]))
    assert rec["bytes_per_step"] > 0 and rec["bound_ms_per_step"] > 0
    table = (profile_step.ROOT / rec["classes_table"]).read_text()
    for cls in ("product", "convolution", "elementwise", "fused AdamW", "total"):
        assert cls in table
    assert "device ms: none (no device)" in table


class _Event:
    def __init__(self, key, device_type, self_device_time_total):
        self.key, self.device_type, self.self_device_time_total = key, device_type, self_device_time_total


def test_device_ms_by_class():
    """The eager profile's attribution: an operator's self device time
    under its class, the kernel launched through ctypes by its name, the
    rest unattributed; a step's share."""
    from torch.autograd import DeviceType

    events = [
        _Event("aten::mm", DeviceType.CPU, 3000.0),
        _Event("aten::cudnn_convolution", DeviceType.CPU, 5000.0),
        _Event("aten::add_", DeviceType.CPU, 1000.0),
        _Event("aten::conv1d", DeviceType.CPU, 0.0),
        _Event("void fused_adamw_multi_kernel<true, true>", DeviceType.CUDA, 400.0),
        _Event("sm90_xmma_gemm", DeviceType.CUDA, 3000.0),
    ]
    got = profile_step.device_ms_by_class(events, busy_ms=10.0, steps=2)
    assert got == pytest.approx(
        {"product": 1.5, "convolution": 2.5, "elementwise": 0.5, "fused AdamW": 0.2, "unattributed": 0.3}
    )


@pytest.mark.parametrize(
    "op,cls",
    [
        (torch.ops.aten.mm.default, "product"),
        (torch.ops.aten.convolution_backward.default, "convolution"),
        (torch.ops.aten.mul.Tensor, "elementwise"),
        (torch.ops.aten.native_batch_norm.default, "reduction"),
        (torch.ops.aten.clone.default, "copy/layout"),
        (torch.ops.aten._unsafe_view.default, "copy/layout"),
        (torch.ops.aten.index_add.default, "indexing/scatter"),
        (torch.ops.c10d.allreduce_.default, "collective"),
        (torch.ops.aten._linalg_solve_ex.default, "other"),
    ],
)
def test_op_class(op, cls):
    assert step_cost.op_class(op) == cls


def test_a_collective_moves_no_hbm_bytes(tmp_path):
    """An all-reduce (gloo, one rank) is counted in its own class, as an
    operator with no bytes."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        _, cost = count(dist.all_reduce, f32(64, 32))
    finally:
        dist.destroy_process_group()
    assert list(cost.classes) == ["collective"] and cost.classes["collective"].ops == 1 and cost.bytes == 0
