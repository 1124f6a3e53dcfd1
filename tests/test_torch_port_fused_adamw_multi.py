"""The multi-tensor fused AdamW of the port (scrubvae_torch/ops/fused_adamw.py
``LeafTable``, ``fused_adamw_multi``, ``philox_noise``) on the CPU.

On the CPU the wrappers run the plain version with the kernel's own
Philox-4x32-10 bits, so what is checked here is the layout the CUDA kernel
shares: the Random123 known answers, noise that depends on the element and
not on how a leaf is cut, the leaf and chunk tables (every element in
exactly one chunk, one batch per dtype variant and per ``MAX_LEAVES``
leaves), bitwise agreement of the multi-tensor call with the per-leaf plain
version, and the optimizer's refusal of a table whose storage moved. The
kernel itself is held bitwise against the same plain version on the card by
chip_smoke.py. The optimizer's agreement with JAX is in
test_torch_port_fused_adamw.py.
"""

import numpy as np
import pytest
import torch

from scrubvae_torch.ops import fused_adamw as fa
from scrubvae_torch.train import optim as toptim

torch.set_num_threads(1)

HYPER = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
SCAL = dict(lr=3e-4, b1c=0.19, b2c=0.002, gscale=0.5)


def _words(text: str) -> torch.Tensor:
    return torch.tensor([int(x, 16) for x in text.split()], dtype=torch.int64)


@pytest.mark.parametrize("ctr,key,want", [
    ("00000000 00000000 00000000 00000000", "00000000 00000000",
     "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ("ffffffff ffffffff ffffffff ffffffff", "ffffffff ffffffff",
     "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ("243f6a88 85a308d3 13198a2e 03707344", "a4093822 299f31d0",
     "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_matches_random123_known_answers(ctr, key, want):
    got = fa.philox4x32_10(_words(ctr), _words(key))
    assert torch.equal(got, _words(want))


def test_philox_noise_depends_on_the_element_only():
    """A leaf's noise is the concatenation of the noise of its pieces, cut
    off the groups of 8; values are 16-bit and the three rows differ."""
    seed, leaf, step = (1 << 40) + 17, 3, 5
    full = fa.philox_noise(1000, seed, leaf, step)
    cuts = [0, 13, 100, 517, 999, 1000]
    pieces = [fa.philox_noise(b - a, seed, leaf, step, start=a) for a, b in zip(cuts, cuts[1:])]
    assert full.shape == (3, 1000) and full.dtype == torch.int32
    assert torch.equal(full, torch.cat(pieces, 1))
    assert int(full.min()) >= 0 and int(full.max()) < 1 << 16
    for a, b in ((0, 1), (0, 2), (1, 2)):
        assert float((full[a] == full[b]).float().mean()) < 0.01
    # another leaf word, step or seed gives other bits
    for other in (fa.philox_noise(1000, seed, leaf + 1, step), fa.philox_noise(1000, seed, leaf, step + 1),
                  fa.philox_noise(1000, seed + (1 << 32), leaf, step)):
        assert float((other == full).float().mean()) < 0.01
    # roughly uniform: the mean of 3000 uniform 16-bit values is 32767.5 +- 343
    assert abs(float(full.double().mean()) - 32767.5) < 4 * 343


def _mixed_tree(seed=0):
    """(w, mu, nu, g, noise) of: a bf16/bf16 leaf of 66563 elements, f32
    leaves of 1, 3 and 111 elements, an f32/bf16 leaf, and a bf16/f32 leaf
    given injected noise."""
    rng = np.random.default_rng(seed)
    spec = [((257, 259), "bf16", "bf16"), ((1,), "f32", "f32"), ((3,), "f32", "f32"),
            ((111,), "f32", "f32"), ((37, 29), "f32", "bf16"), ((5, 41), "bf16", "f32")]
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    leaves = []
    for i, (shape, wk, mk) in enumerate(spec):
        w = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dt[wk])
        g = torch.from_numpy((rng.normal(size=shape) * 3.0).astype(np.float32)).to(dt[wk])
        mu = torch.from_numpy((rng.normal(size=shape) * 0.1).astype(np.float32)).to(dt[mk])
        nu = torch.from_numpy((np.abs(rng.normal(size=shape)) * 0.01).astype(np.float32)).to(dt[mk])
        nz = None
        if i == len(spec) - 1:
            nz = torch.from_numpy(rng.integers(0, 1 << 16, (3, w.numel())).astype(np.int32))
        leaves.append((w, mu, nu, g, nz))
    return leaves


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def test_multi_matches_per_leaf_plain_version_bitwise():
    leaves = _mixed_tree()
    ws, mus, nus, gs, nzs = (list(x) for x in zip(*leaves))
    ids = [11, 0, 7, 3, 100, 5]
    seed, step = 1234, 9
    table = fa.LeafTable(
        [w.clone() for w in ws], [m.clone() for m in mus], [n.clone() for n in nus],
        leaf_ids=ids, noise=nzs,
    )
    assert [(b.w_bf16, b.m_bf16, b.idx) for b in table.batches] == [
        (True, True, [0]), (False, False, [1, 2, 3]), (False, True, [4]), (True, False, [5]),
    ]
    scal = torch.tensor([SCAL["lr"], SCAL["b1c"], SCAL["b2c"], SCAL["gscale"]])
    before = fa.fused_adamw_multi.launches
    fa.fused_adamw_multi(table, gs, scal, seed=seed, step=step, **HYPER)
    assert fa.fused_adamw_multi.launches == before  # the CPU runs the plain version
    for i, (w, mu, nu, g, nz) in enumerate(leaves):
        if nz is None and (w.dtype == torch.bfloat16 or mu.dtype == torch.bfloat16):
            nz = fa.philox_noise(w.numel(), seed, ids[i], step)
        want = fa.fused_adamw_leaf_reference(w, g, mu, nu, **SCAL, **HYPER, noise=nz)
        # the one-leaf wrapper agrees too
        one = [t.clone() for t in (w, mu, nu)]
        fa.fused_adamw_leaf(one[0], g, one[1], one[2], scal, seed=seed, leaf=ids[i], step=step,
                            noise=nzs[i], **HYPER)
        got = (table.w[i], table.mu[i], table.nu[i])
        for a, b, c in zip(got, want, one):
            assert a.dtype == b.dtype
            assert torch.equal(_bits(a), _bits(b)), i
            assert torch.equal(_bits(c), _bits(b)), i
    # the bf16 leaf really was rounded with Philox bits, not truncated
    exact = fa.fused_adamw_leaf_reference(*(t.float() for t in (ws[0], gs[0], mus[0], nus[0])),
                                          **SCAL, **HYPER)[0]
    assert not torch.equal(table.w[0], exact.to(torch.bfloat16))


@pytest.mark.parametrize("sizes", [
    [1, 3, 111, 0, 1023, 1024, 1025, 66563],
    [7] * 300,  # more leaves than one launch's parameter struct holds
])
def test_chunk_table_covers_every_element_once(sizes):
    ws = [torch.zeros(n) for n in sizes]
    table = fa.LeafTable(ws, [torch.zeros(n) for n in sizes], [torch.zeros(n) for n in sizes])
    assert sum(len(b.idx) for b in table.batches) == len(sizes)
    assert all(len(b.idx) <= fa.MAX_LEAVES for b in table.batches)
    assert len(table.batches) == -(-len(sizes) // fa.MAX_LEAVES)
    rows = table.rows.tolist()
    hits = [torch.zeros(n, dtype=torch.int64) for n in sizes]
    chunks = table.chunks.tolist()
    for b in table.batches:
        for r, i in enumerate(b.idx):
            row = rows[b.row0 + r]
            assert row[0] == ws[i].data_ptr() and row[4] == sizes[i] and row[5] & 0xFFFFFFFF == i
        for slot, c in chunks[b.chunk0:b.chunk0 + b.n_chunks]:
            i = b.idx[slot]
            lo = c * fa.CHUNK_ELEMS
            assert 0 <= lo < sizes[i]  # a chunk never starts past its leaf
            hits[i][lo:lo + fa.CHUNK_ELEMS] += 1
    assert sum(b.n_chunks for b in table.batches) == len(chunks)
    for h in hits:
        assert bool((h == 1).all())


def test_update_refuses_storage_moved_after_init():
    params = [torch.nn.Parameter(torch.randn(70000)), torch.nn.Parameter(torch.randn(5))]
    tx = toptim.FusedAdamW(1e-3)
    state = tx.init(params)
    assert [m.dtype for m in state.mu] == [torch.bfloat16, torch.float32]
    grads = [torch.randn_like(p) for p in params]
    state = tx.update_and_apply(grads, state, params)
    params[0].data = params[0].data.to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="no longer lies"):
        tx.update_and_apply([g.bfloat16() if i == 0 else g for i, g in enumerate(grads)], state, params)
    state = tx.init(params)  # a new table accepts the new storage
    state.nu[1] = state.nu[1].clone()
    with pytest.raises(RuntimeError, match="no longer lies"):
        tx.update_and_apply(grads, state, params)


def test_multi_rejects_a_gradient_of_another_dtype_or_shape():
    table = fa.LeafTable([torch.zeros(8), torch.zeros(3)], [torch.zeros(8), torch.zeros(3)],
                         [torch.zeros(8), torch.zeros(3)])
    scal = torch.ones(4)
    with pytest.raises(TypeError):
        fa.fused_adamw_multi(table, [torch.zeros(8), torch.zeros(3, dtype=torch.bfloat16)], scal)
    with pytest.raises(ValueError):
        fa.fused_adamw_multi(table, [torch.zeros(8), torch.zeros(4)], scal)
    with pytest.raises(ValueError):
        fa.fused_adamw_multi(table, [torch.zeros(8)], scal)


def test_default_clip_leaves_gradients_unscaled():
    """The users' default clip (1e6) computes the global norm in f32 and
    leaves gscale exactly 1.0 below it; above it, clip / norm."""
    grads = [torch.full((300,), 2.0), torch.full((1,), -3.0, dtype=torch.bfloat16)]
    norm = (300 * 4.0 + 9.0) ** 0.5
    count = torch.ones((), dtype=torch.int32)
    assert float(toptim.FusedAdamW(1e-3, clip_norm=1e6)._scalars(count, grads)[3]) == 1.0
    got = float(toptim.FusedAdamW(1e-3, clip_norm=1.0)._scalars(count, grads)[3])
    assert got == pytest.approx(1.0 / norm, rel=1e-6)
