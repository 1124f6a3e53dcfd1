"""The scrubbers' SPD solves (``scrubvae_torch.ops.smallsolve``: one Cholesky
factor, no row swaps) on the CPU.

- ``spd_solve`` and ``spd_slogdet`` in f32 against float64 NumPy at the
  shapes the scrubbers solve: QDA's 16 covariances of 128x128 with 512
  right-hand sides, MALS's 128x128 normal equations with one, the linear
  projection's 3x3 Gram matrix with a batch of 512, and a vector
  right-hand side; relative error <= 1e-4 (these matrices' condition
  numbers are about 1e2), log-determinants to 1e-5.
- Gradients, in float64, against ``torch.linalg.solve``'s autograd:
  to ``B`` and to the leaf ``X`` of ``A = X X^T + n I`` equal to 1e-10;
  to ``A`` itself the symmetric part of LU's (a Cholesky factor reads
  ``A`` as symmetric), as every caller's ``A`` is a symmetric function of
  its leaves.
- Conditioning: SPD matrices of condition 1e2, 1e4 and 1e6 in f32, the
  error of the solve against float64 bounded by 8 * cond * 2^-24, which
  pivoted LU (``torch.linalg.solve``) meets too.
- ``profiling.SolveCounts``: a matrix that is not positive definite counts
  once in ``spd_not_pd``; nothing is counted outside ``counting_solves``.
- QDA: the batched ``qda_loss`` (the four models of every class in one
  factor) against the four separate ``_cgll`` calls on the same state, to
  f32 roundoff (rtol 1e-6), and against the JAX package's ``qda_loss`` at
  full5's shape (4 classes, z 128, batch 512) from a moved state (loss
  rtol 1e-4, the forgetting factors exactly).
- The trainer's counters at the bench's ``--small`` sizes: the factorizations
  of each step (3 for the flagship, 4C + 3 for ``configs/ladder/5_full.yaml``)
  read in the epoch's one readback, and a QDA covariance made not positive
  definite counted every step and warned of once a readback.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scrubvae_tpu.models import scrubbers as jscr
from scrubvae_torch import bench, profile_step
from scrubvae_torch.models import scrubbers as scr
from scrubvae_torch.ops import smallsolve as ss
from scrubvae_torch.utils import profiling
from scrubvae_torch.utils.weights import qda_state_from_numpy

torch.set_num_threads(1)

STEPS = 3
EPS32 = 2.0**-24


def _spd(batch: tuple, n: int, seed: int, dtype=torch.float32) -> torch.Tensor:
    """A covariance-like SPD matrix: a Gram matrix of 4n samples plus I."""
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(*batch, n, 4 * n, generator=g, dtype=torch.float64)
    return (X @ X.mT / (4 * n) + torch.eye(n, dtype=torch.float64)).to(dtype)


# label -> (batch, n, right-hand side columns; None for a vector)
SHAPES = {
    "qda": ((16,), 128, 512),
    "mals": ((), 128, 1),
    "projection": ((), 3, 512),
    "vector": ((4,), 16, None),
}


@pytest.mark.parametrize("label", list(SHAPES))
def test_solve_and_logdet_against_float64(label):
    batch, n, m = SHAPES[label]
    A = _spd(batch, n, seed=1)
    g = torch.Generator().manual_seed(2)
    B = torch.randn(*batch, n, *(() if m is None else (m,)), generator=g)
    got = ss.spd_solve(A, B)
    assert got.shape == B.shape and got.dtype == torch.float32
    want = np.linalg.solve(A.double().numpy(), B.double().numpy()[..., None] if m is None else B.double().numpy())
    want = want[..., 0] if m is None else want
    err = np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want)
    assert err <= 1e-4, err
    np.testing.assert_allclose(ss.spd_slogdet(A).double().numpy(), np.linalg.slogdet(A.double().numpy())[1],
                               rtol=1e-5)


@pytest.mark.parametrize("label", list(SHAPES))
def test_gradients_against_lu(label):
    batch, n, m = SHAPES[label]
    m = None if m is None else min(m, 8)
    g = torch.Generator().manual_seed(3)
    X = torch.randn(*batch, n, n, generator=g, dtype=torch.float64)
    B = torch.randn(*batch, n, *(() if m is None else (m,)), generator=g, dtype=torch.float64)
    G = torch.randn(B.shape, generator=g, dtype=torch.float64)
    grads = {}
    for name, solve in (("chol", ss.spd_solve), ("lu", torch.linalg.solve)):
        Xl, Bl = X.clone().requires_grad_(True), B.clone().requires_grad_(True)
        A = (Xl @ Xl.mT + n * torch.eye(n, dtype=torch.float64)).detach().requires_grad_(True)
        gA, gB = torch.autograd.grad((solve(A, Bl) * G).sum(), [A, Bl])
        (gX,) = torch.autograd.grad((solve(Xl @ Xl.mT + n * torch.eye(n, dtype=torch.float64), Bl) * G).sum(), [Xl])
        grads[name] = gA, gB, gX
    (cA, cB, cX), (lA, lB, lX) = grads["chol"], grads["lu"]
    torch.testing.assert_close(cB, lB, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(cX, lX, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(cA, 0.5 * (lA + lA.mT), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("cond", [1e2, 1e4, 1e6])
def test_conditioning_holds_lus_tolerance(cond):
    n = 64
    g = torch.Generator().manual_seed(4)
    Q, _ = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=torch.float64))
    A = ((Q * torch.logspace(0, np.log10(cond), n, dtype=torch.float64)) @ Q.T).float()
    A = 0.5 * (A + A.T)
    B = torch.randn(n, 8, generator=g)
    want = torch.linalg.solve(A.double(), B.double())
    tol = 8 * cond * EPS32

    def err(x):
        return float(torch.linalg.norm(x.double() - want) / torch.linalg.norm(want))

    lu, chol = err(torch.linalg.solve(A, B)), err(ss.spd_solve(A, B))
    assert lu <= tol, (lu, tol)
    assert chol <= tol, (chol, lu, tol)
    logdet = float(torch.linalg.slogdet(A.double())[1])
    assert abs(float(ss.spd_slogdet(A)) - logdet) <= tol * abs(logdet)


def test_not_positive_definite_counts_once():
    A = _spd((3,), 8, seed=5)
    A[1] = -A[1]
    counts, other = profiling.SolveCounts("cpu"), profiling.SolveCounts("cpu")
    ss.spd_solve(A, torch.ones(3, 8))  # nothing active: nothing counted
    with profiling.counting_solves(counts):
        ss.spd_solve(A, torch.ones(3, 8))
    assert counts.buf.tolist() == [3, 1] and other.buf.tolist() == [0, 0]
    with profiling.counting_solves(counts):
        ss.spd_slogdet(A[:1])
    assert counts.take(counts.buf.tolist()) == 1
    assert (counts.spd_factorizations, counts.spd_not_pd) == (4, 1)
    assert counts.take(counts.buf.tolist()) == 0


def _moved_qda(C: int, D: int, B: int, seed: int):
    """A QDA state after three updates, and a fourth batch."""
    rng = np.random.default_rng(seed)
    classes = np.arange(C)
    batches = []
    for _ in range(4):
        y = rng.choice(classes, size=B).astype(np.int32)
        x = rng.standard_normal((B, D)).astype(np.float32) + 0.5 * y[:, None].astype(np.float32)
        batches.append((x, y))
    jst = jscr.qda_init(D, classes)
    for x, y in batches[:3]:
        jst = jscr.qda_update(jst, jnp.asarray(x), jnp.asarray(y))
    tst = qda_state_from_numpy({f: np.asarray(getattr(jst, f)) for f in ("m0a", "m1a", "m0b", "m1b", "S0a", "S1a",
                                                                          "S0b", "S1b", "lama", "lamb")},
                               scr.qda_init(D, classes, device="cpu"))
    return jst, tst, batches[3]


def test_qda_batched_equals_four_calls():
    _, st, (x, y) = _moved_qda(3, 8, 32, seed=6)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    loss, new = scr.qda_loss(st, x, y)
    lla0, lla1, llb0, llb1 = (scr._cgll(x, getattr(st, f"m{k}"), getattr(st, f"S{k}")) for k in ("0a", "1a", "0b", "1b"))
    i1 = (y[None, :] == st.classes[:, None]).float()
    sign = 2.0 * i1 - 1.0
    want = ((sign * (lla1 - lla0)).sum(1) + (sign * (llb1 - llb0)).sum(1)).sum() * 0.5 / 3
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    a_better = ((1 - i1) * lla0 + i1 * lla1).sum(1) > ((1 - i1) * llb0 + i1 * llb1).sum(1)
    torch.testing.assert_close(new.lama, torch.where(a_better, st.lama - st.delta, st.lamb + st.delta - st.lamdiff))


def test_qda_loss_against_jax_at_full5s_shape():
    jst, tst, (x, y) = _moved_qda(4, 128, 512, seed=7)
    jl, jnew = jscr.qda_loss(jst, jnp.asarray(x), jnp.asarray(y))
    tl, tnew = scr.qda_loss(tst, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_array_equal(tnew.lama.numpy(), np.asarray(jnew.lama))
    np.testing.assert_array_equal(tnew.lamb.numpy(), np.asarray(jnew.lamb))


def _build(kind: str):
    if kind == "flagship":
        return bench.build(16, 51, 16, bench.SMALL_CH, "cpu", precision="fp32", bf16_params=False)
    return profile_step.build_from_config(profile_step.ROOT / "configs" / "ladder" / "5_full.yaml", "cpu", small=True)


def _per_step(trainer) -> int:
    """The factorizations a step: QDA's four models a class, MALS's two
    systems and the projection's Gram matrix, a scrubbed key each."""
    scrub = trainer.state.scrub_state
    qda = sum(4 * s.classes.shape[0] for s in scrub.get("qda", {}).values())
    return qda + 2 * len(scrub.get("moving_avg_lsq", {})) + len(trainer.dis_cfg["method"].get("linear") or [])


@pytest.mark.parametrize("kind", ["flagship", "full5"])
def test_trainer_counts_factorizations(kind):
    trainer, ds = _build(kind)
    per_step = _per_step(trainer)
    assert per_step == (3 if kind == "flagship" else 4 * len(trainer.train_ds.discrete_classes["ids"]) + 3)
    rows = np.random.default_rng(0).integers(0, len(ds), (STEPS, 16))
    for epoch in (1, 2):
        syncs = trainer.host_syncs
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            trainer.train_epoch(epoch, rows)
        assert not [w for w in seen if "positive definite" in str(w.message)]
        assert trainer.host_syncs - syncs == 1
        assert (trainer.spd_factorizations, trainer.spd_not_pd) == (epoch * STEPS * per_step, 0)


def test_trainer_warns_of_a_covariance_not_positive_definite():
    trainer, ds = _build("full5")
    (qda,) = trainer.state.scrub_state["qda"].values()
    qda.S0a[0] = -qda.S0a[0]  # -I: forgotten at a weight of 0.8 a step, it stays indefinite over these steps
    rows = np.random.default_rng(0).integers(0, len(ds), (STEPS, 16))
    with pytest.warns(UserWarning, match="not numerically positive definite") as seen:
        trainer.train_epoch(1, rows)
    assert sum("positive definite" in str(w.message) for w in seen) == 1
    assert (trainer.spd_not_pd, trainer.spd_factorizations) == (STEPS, STEPS * _per_step(trainer))
