"""The port's decodability (``scrubvae_torch/evals/metrics.py`` and
``probes.py``, torch on the CPU here) against the JAX package's
``scrubvae_tpu/evals/metrics.py`` (sklearn on the host), on latents made
from a numpy seed with collapsed (x1e-7) dims, as ``tests/test_decodability.py``
makes them.

Bands (the readings print with ``-s``):

- folds: index for index sklearn's ``KFold(shuffle=True, random_state=100)``;
- linear R^2: 1e-4 absolute per fold (sklearn solves in float32 on
  float32 latents, the port in float64 with float32's rank cutoff);
- QDA and LDA: at most one differing prediction per test fold, printed with
  the port's decision margin; fold accuracies then within one sample;
- logistic: the port's elastic-net objective at its solution at most
  sklearn's at ``max_iter=10000, tol=1e-10`` times (1 + 1e-6), on every
  binary, one-vs-rest and softmax problem; fold accuracies within one
  test sample of ``log_class_rand_cv``'s (sklearn's saga stops at 300
  epochs of an unseeded shuffle, the port at the optimum; on these small,
  well-conditioned problems the gap reads 0);
- MLP probe, from JAX's own initial weights: predictions within
  ``MLP_PRED_REL`` relative norm, fold R^2 within ``MLP_R2_ABS``. The
  port trains the probe in float64, JAX in float32, and 200 full-batch
  AdamW steps amplify float32 rounding: JAX's probe lies 1.5e-3 from the
  same probe in float64 (a witness test below), so the prediction band is
  5e-3, not 1e-3;
- ``Trainer.decodability_metrics``: the same keys in the same order, each
  value within its estimator's band.
"""

import csv
import shutil
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from sklearn.discriminant_analysis import LinearDiscriminantAnalysis, QuadraticDiscriminantAnalysis
from sklearn.linear_model import LogisticRegression
from sklearn.model_selection import KFold
from sklearn.multiclass import OneVsRestClassifier

from scrubvae_tpu.evals import metrics as jem
from scrubvae_tpu.train.trainer import Trainer as JaxTrainer
from scrubvae_torch.data.pose_io import write_pose_h5
from scrubvae_torch.data.skeleton import load_skeleton
from scrubvae_torch.data.synthetic import synthetic_pose_stream
from scrubvae_torch.evals import metrics as em
from scrubvae_torch.evals import probes
from scrubvae_torch.params import read
from scrubvae_torch.train.trainer import Trainer, train
from scrubvae_torch.train_model import main

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
MLP_PRED_REL = 5e-3
MLP_R2_ABS = 1e-3


def _latents(n=2400, d=16, n_cls=4, sep=4.0, seed=0, collapsed=6):
    """Window-expanded latents (window 8 leaves n/8 rows) with
    class-separated means and ``collapsed`` near-constant dims."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_cls, size=n)
    z = rng.normal(size=(n, d)).astype(np.float32)
    z[:, :n_cls] += sep * np.eye(n_cls, dtype=np.float32)[y]
    z[:, d - collapsed:] *= 1e-7
    return z, y


def _regression(n=2400, d=12, seed=2, collapsed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, 3)).astype(np.float32)
    y = np.tanh(z @ w) + noise * rng.normal(size=(n, 3)).astype(np.float32)
    if collapsed:
        z[:, d - collapsed:] *= 1e-7
        z[:, 0] = z[:, 1]  # an exactly repeated column as well
    return z, y.astype(np.float32)


def _folds(z, y, window):
    dz, dy = z[::window], y[::window]
    return dz, dy, em.kfold_indices(len(dz), 5)


# ---------------------------------------------------------------------------
# folds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(23, 5), (101, 5), (301, 2), (7, 3)])
def test_kfold_indices_equal_sklearn(n, k):
    ours = em.kfold_indices(n, k)
    theirs = list(KFold(n_splits=k, shuffle=True, random_state=100).split(np.zeros(n)))
    assert len(ours) == len(theirs) == k
    for (tr, te), (str_, ste) in zip(ours, theirs):
        np.testing.assert_array_equal(tr, str_)
        np.testing.assert_array_equal(te, ste)


def test_clamp_and_too_few_samples_match_jax():
    z, y = _regression(n=24)
    for fn, jfn in ((em.linear_rand_cv, jem.linear_rand_cv),):
        with pytest.warns(UserWarning, match="clamping 5 folds to 3"):
            got = fn(z, y, 8, 5, device=CPU)
        with pytest.warns(UserWarning, match="clamping 5 folds to 3"):
            want = jfn(z, y, 8, 5)
        assert got.folds_used == want.folds_used == 3
        np.testing.assert_allclose(got, want, atol=1e-4)
        with pytest.warns(UserWarning, match="clamping 5 folds to 1"):
            one = fn(z[:8], y[:8], 8, 5, device=CPU)
        assert one.folds_used == 1 and len(one) == 1 and np.isnan(one[0])


# ---------------------------------------------------------------------------
# linear regression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("collapsed", [0, 6], ids=["full-rank", "rank-deficient"])
def test_linear_fold_r2_matches_jax(collapsed):
    z, y = _regression(collapsed=collapsed)
    got = np.asarray(em.linear_rand_cv(z, y, 8, 5, device=CPU))
    want = np.asarray(jem.linear_rand_cv(z, y, 8, 5))
    print(f"linear R^2 ({collapsed} collapsed): port {got} JAX {want} max gap {np.abs(got - want).max():.2e}")
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_r2_score_edge_cases_match_sklearn():
    from sklearn.metrics import r2_score

    rng = np.random.default_rng(0)
    y = rng.normal(size=(10, 3))
    p = y + rng.normal(size=(10, 3)) * 0.1
    y[:, 1] = 2.0  # a constant target column predicted badly: 0.0
    p[:, 2] = y[:, 2]  # a column predicted exactly: 1.0
    for yy, pp in ((y, p), (y[:, 1:2], y[:, 1:2]), (y[:, 0], p[:, 0])):
        assert probes.r2_score(torch.from_numpy(yy), torch.from_numpy(pp)) == pytest.approx(
            r2_score(yy, pp), abs=1e-12
        )
    with pytest.warns(UserWarning, match="less than two samples"):
        assert np.isnan(probes.r2_score(torch.zeros(1, 2), torch.zeros(1, 2)))


# ---------------------------------------------------------------------------
# QDA and LDA
# ---------------------------------------------------------------------------


def _sk_qda(ztr, ytr):
    """The JAX function's fit, with its retry."""
    try:
        return QuadraticDiscriminantAnalysis().fit(ztr, ytr)
    except ValueError as e:
        if "full rank" not in str(e):
            raise
        return QuadraticDiscriminantAnalysis(reg_param=1e-3).fit(ztr, ytr)


def _margin(scores: torch.Tensor, i: int) -> float:
    top = torch.sort(scores[i], descending=True).values
    return float(top[0] - top[1]) if scores.shape[1] > 1 else float(scores[i, 0])


CLASS_CASES = {
    "separated-collapsed": dict(sep=4.0, collapsed=6),
    "weak-collapsed": dict(sep=1.0, collapsed=6),
    "noise-full-rank": dict(sep=0.0, collapsed=0),
    "binary": dict(sep=1.0, collapsed=6, n_cls=2),
}


@pytest.mark.parametrize("case", list(CLASS_CASES))
def test_qda_predictions_match_sklearn(case):
    z, y = _latents(**CLASS_CASES[case])
    dz, dy, folds = _folds(z, y, 8)
    for i, (tr, te) in enumerate(folds):
        sk = _sk_qda(dz[tr], dy[tr])
        fit = em.qda_fit_retry(torch.from_numpy(dz[tr]), torch.from_numpy(dy[tr]))
        got = probes.qda_predict(fit, torch.from_numpy(dz[te])).numpy()
        want = sk.predict(dz[te])
        diff = np.flatnonzero(got != want)
        if diff.size:
            scores = probes.qda_decision(fit, torch.from_numpy(dz[te]))
            print(f"QDA {case} fold {i}: {diff.size} differ, margins {[_margin(scores, j) for j in diff]}")
        assert diff.size <= 1, (case, i, diff)
    got = np.asarray(em.qda_rand_cv(z, y, 8, 5, device=CPU))
    want = np.asarray(jem.qda_rand_cv(z, y, 8, 5))
    print(f"QDA {case}: port {got} JAX {want}")
    np.testing.assert_allclose(got, want, atol=1.0 / min(len(te) for _, te in folds) + 1e-12)


def test_qda_collapsed_dims_take_the_retry():
    z, y = _latents()
    dz, dy, folds = _folds(z, y, 8)
    tr = folds[0][0]
    with pytest.raises(np.linalg.LinAlgError, match="not full rank"):
        probes.qda_fit(torch.from_numpy(dz[tr]), torch.from_numpy(dy[tr]))
    with pytest.raises(np.linalg.LinAlgError, match="not full rank"):
        QuadraticDiscriminantAnalysis().fit(dz[tr], dy[tr])
    folds_ = np.asarray(em.qda_rand_cv(z, y, 8, 5, device=CPU))
    assert not np.isnan(folds_).any() and folds_.mean() > 0.8


@pytest.mark.parametrize("case", ["one-sample-class", "class-smaller-than-dims"])
def test_qda_failed_folds_match_jax(case):
    """A class of one sample raises ValueError, a class of no more samples
    than dims fails the retry as well: both are nan folds, in the same
    folds as the JAX function's, with a warning."""
    z, y = _latents(sep=3.0, collapsed=0)
    dy = y[::8].copy()
    if case == "one-sample-class":
        dy[dy == 3] = 2
        dy[5] = 3
    else:
        rare = np.flatnonzero(dy == 3)[12:]
        dy[rare] = 0
    y = y.copy()
    y[::8] = dy
    with pytest.warns(UserWarning, match="qda_rand_cv fold"):
        got = np.asarray(em.qda_rand_cv(z, y, 8, 5, device=CPU))
    with pytest.warns(UserWarning, match="qda_rand_cv fold"):
        want = np.asarray(jem.qda_rand_cv(z, y, 8, 5))
    print(f"QDA {case}: port {got} JAX {want}")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any()
    ok = ~np.isnan(got)
    np.testing.assert_allclose(got[ok], want[ok], atol=1.0 / 60 + 1e-12)


@pytest.mark.parametrize("case", list(CLASS_CASES))
def test_lda_predictions_match_sklearn(case):
    z, y = _latents(**CLASS_CASES[case])
    dz, dy, folds = _folds(z, y, 8)
    for i, (tr, te) in enumerate(folds):
        sk = LinearDiscriminantAnalysis().fit(dz[tr], dy[tr])
        fit = probes.lda_fit(torch.from_numpy(dz[tr]), torch.from_numpy(dy[tr]))
        got = probes.lda_predict(fit, torch.from_numpy(dz[te])).numpy()
        want = sk.predict(dz[te])
        diff = np.flatnonzero(got != want)
        if diff.size:
            scores = torch.from_numpy(dz[te]).double() @ fit["coef"].T + fit["intercept"]
            print(f"LDA {case} fold {i}: {diff.size} differ, margins {[_margin(scores, j) for j in diff]}")
        assert diff.size <= 1, (case, i, diff)
    got = np.asarray(em.lda_rand_cv(z, y, 8, 5, device=CPU))
    want = np.asarray(jem.lda_rand_cv(z, y, 8, 5))
    print(f"LDA {case}: port {got} JAX {want}")
    np.testing.assert_allclose(got, want, atol=1.0 / min(len(te) for _, te in folds) + 1e-12)


# ---------------------------------------------------------------------------
# logistic regression
# ---------------------------------------------------------------------------


LOG_CASES = {
    "binary": (dict(sep=1.0, n_cls=2), "ovr"),
    "ovr-4": (dict(sep=1.5), "ovr"),
    "multinomial-4": (dict(sep=1.5), "multinomial"),
}


@pytest.mark.parametrize("case", list(LOG_CASES))
def test_logistic_objective_at_most_sklearns_converged(case):
    kw, multi_class = LOG_CASES[case]
    z, y = _latents(**kw)
    dz, dy, folds = _folds(z, y, 8)
    tr = folds[0][0]
    X, yy = dz[tr].astype(np.float64), dy[tr]
    classes = np.unique(yy)
    onehot = torch.from_numpy((yy[:, None] == classes[None]).astype(np.float64))
    base = LogisticRegression(l1_ratio=0.5, penalty="elasticnet", solver="saga", max_iter=10000, tol=1e-10)
    multinomial = multi_class == "multinomial"
    if len(classes) == 2:
        target = onehot[:, 1:]
        sk = base.fit(X, yy)
        W_sk, b_sk = sk.coef_.T, sk.intercept_
    elif multinomial:
        target = onehot
        sk = base.fit(X, yy)
        W_sk, b_sk = sk.coef_.T, sk.intercept_
    else:
        target = onehot
        sk = OneVsRestClassifier(base).fit(X, yy)
        W_sk = np.stack([e.coef_[0] for e in sk.estimators_], 1)
        b_sk = np.array([e.intercept_[0] for e in sk.estimators_])
    W, b, iters = probes.logistic_fit(torch.from_numpy(dz[tr]), target, multinomial=multinomial)
    Xt = torch.from_numpy(X)
    ours = probes.logistic_objective(Xt, target, W, b, multinomial=multinomial)
    theirs = probes.logistic_objective(Xt, target, torch.from_numpy(W_sk), torch.from_numpy(b_sk), multinomial=multinomial)
    print(f"logistic {case}: {iters} iterations, objective port {ours.numpy()} sklearn {theirs.numpy()}")
    assert bool((ours <= theirs * (1 + 1e-6)).all()), (ours, theirs)
    assert iters < probes.LOGISTIC_MAX_ITER


@pytest.mark.parametrize("case", list(LOG_CASES))
def test_logistic_fold_accuracy_within_band_of_jax(case):
    kw, multi_class = LOG_CASES[case]
    z, y = _latents(**kw)
    got = np.asarray(em.log_class_rand_cv(z, y, 8, 5, device=CPU, multi_class=multi_class))
    want = np.asarray(jem.log_class_rand_cv(z, y, 8, 5, multi_class=multi_class))
    band = 1.0 / min(len(te) for _, te in em.kfold_indices(len(z[::8]), 5)) + 1e-12
    print(f"logistic {case}: port {got} JAX {want} max gap {np.abs(got - want).max():.4f} (band {band:.4f})")
    np.testing.assert_allclose(got, want, atol=band, rtol=0)


def test_logistic_warns_at_its_iteration_cap():
    z, y = _latents(sep=1.5)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(y[:300])).double()
    with pytest.warns(probes.ConvergenceWarning, match="did not converge"):
        _, _, iters = probes.logistic_fit(torch.from_numpy(z[:300]), onehot, max_iter=2)
    assert iters == 2


def test_logistic_single_class_is_a_nan_fold():
    z, y = _latents()
    y = np.zeros_like(y)
    y[0] = 1  # a second class in one fold's test set only
    with pytest.warns(UserWarning, match="log_class_rand_cv fold"):
        got = np.asarray(em.log_class_rand_cv(z, y, 8, 5, device=CPU))
    with pytest.warns(UserWarning, match="log_class_rand_cv fold"):
        want = np.asarray(jem.log_class_rand_cv(z, y, 8, 5))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


# ---------------------------------------------------------------------------
# MLP probe
# ---------------------------------------------------------------------------


def jax_probe_init(d: int, out_dim: int, seed: int = 0) -> list:
    """The JAX probe's initial weights, drawn as ``_probe_fns`` draws them
    (scrubvae_tpu/evals/metrics.py:210-236), as (weight (out, in), bias)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    out = []
    for i, (fi, fo) in enumerate([(d, d), (d, d), (d, out_dim)]):
        kk, kb = jax.random.split(keys[i])
        bound = 1.0 / jnp.sqrt(fi)
        kernel = jax.random.uniform(kk, (fi, fo), minval=-bound, maxval=bound)
        bias = jax.random.uniform(kb, (fo,), minval=-bound, maxval=bound)
        out.append((np.asarray(kernel).T.copy(), np.asarray(bias)))
    return out


def test_mlp_probe_predictions_match_jax():
    z, y = _regression(n=400, d=12)
    predict_j = jem.train_mlp_probe(z[:320], y[:320], 200)
    predict_t = probes.train_mlp_probe(z[:320], y[:320], 200, init=jax_probe_init(12, 3), device=CPU)
    want = np.asarray(predict_j(z[320:]))
    got = predict_t(z[320:]).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"MLP probe predictions: relative gap {rel:.2e} (band {MLP_PRED_REL})")
    assert rel <= MLP_PRED_REL


def test_mlp_probe_gap_is_jaxs_own_float32_rounding():
    """The witness behind ``MLP_PRED_REL``: the port's probe is the float64
    one; JAX's float32 run of the same probe (data, init, steps) lies
    1.5e-3 from it. How far a float32 run lands depends on its rounding
    and its path: torch's float32 run lies 1.7e-6 from it here."""
    z, y = _regression(n=400, d=12)
    init = jax_probe_init(12, 3)
    model = probes.MLPProbe(init, device=CPU).float()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
    zt, yt = torch.as_tensor(z[:320]), torch.as_tensor(y[:320])
    for _ in range(200):
        opt.zero_grad()
        ((model(zt) - yt) ** 2).sum().backward()
        opt.step()
    with torch.no_grad():
        torch32 = model(torch.as_tensor(z[320:])).double().numpy()
    port = probes.train_mlp_probe(z[:320], y[:320], 200, init=init, device=CPU)(z[320:]).numpy()
    jax32 = np.asarray(jem.train_mlp_probe(z[:320], y[:320], 200)(z[320:]), np.float64)
    gap = {k: np.linalg.norm(v - port) / np.linalg.norm(port) for k, v in (("JAX", jax32), ("torch", torch32))}
    print(f"MLP probe in float32 against the port's float64 probe: JAX {gap['JAX']:.2e}, torch {gap['torch']:.2e}")
    assert 1e-4 < gap["JAX"] <= MLP_PRED_REL and gap["torch"] <= MLP_PRED_REL


def test_mlp_fold_r2_matches_jax(monkeypatch):
    z, y = _regression(n=1600, d=12)
    # the port's probe starts from JAX's initial weights
    monkeypatch.setattr(probes, "probe_init", jax_probe_init)
    got = np.asarray(em.mlp_rand_cv(z, y, 8, 5, device=CPU))
    want = np.asarray(jem.mlp_rand_cv(z, y, 8, 5))
    print(f"MLP R^2: port {got} JAX {want} max gap {np.abs(got - want).max():.2e} (band {MLP_R2_ABS})")
    np.testing.assert_allclose(got, want, atol=MLP_R2_ABS, rtol=0)


def test_mlp_probe_draws_no_global_random_numbers():
    state = torch.get_rng_state()
    probes.train_mlp_probe(np.ones((8, 4), np.float32), np.ones((8, 2), np.float32), 2, device=CPU)
    assert torch.equal(state, torch.get_rng_state())


# ---------------------------------------------------------------------------
# the other helpers
# ---------------------------------------------------------------------------


def test_mmd_entropy_hungarian_match_jax():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(40, 5))
    Y = rng.normal(size=(30, 5)) + 0.5
    assert em.mmd_estimate(X, Y, device=CPU) == pytest.approx(jem.mmd_estimate(X, Y), rel=1e-10)
    # counts of distances: 2415 with 30 rows of Y (odd), 2346 with 29 (even)
    assert em.mmd_estimate(X, Y[:29], device=CPU) == pytest.approx(jem.mmd_estimate(X, Y[:29]), rel=1e-10)
    assert em.mmd_estimate(X, Y, h=2.0, device=CPU) == pytest.approx(jem.mmd_estimate(X, Y, h=2.0), rel=1e-10)
    labels = rng.integers(0, 6, size=200)
    assert em.shannon_entropy(labels, device=CPU) == pytest.approx(jem.shannon_entropy(labels), rel=1e-12)
    x1 = rng.integers(0, 5, size=300)
    x2 = (x1 + 2) % 5
    x2[rng.random(300) < 0.2] = 7
    np.testing.assert_array_equal(em.hungarian_match(x1, x2, device=CPU), jem.hungarian_match(x1, x2))


def test_custom_cv_and_class_window_match_jax():
    ids = np.repeat([3, 1, 2], [11, 7, 9])
    for i in range(5):
        for a, b in zip(em.custom_cv_5folds(i, ids), jem.custom_cv_5folds(i, ids)):
            np.testing.assert_array_equal(a, b)
    for name in ("4_mice", "synthetic", "parkinsons", None):
        for w in (5, 9, 51):
            assert em.decodability_class_window(name, w) == jem.decodability_class_window(name, w)


# ---------------------------------------------------------------------------
# Trainer.decodability_metrics
# ---------------------------------------------------------------------------

WINDOW = 21


class _ValStream:
    """A val split stand-in: ``batch(idx)`` returns the label arrays."""

    def __init__(self, arrays: dict, to):
        self.arrays, self.to = arrays, to

    def __len__(self):
        return len(next(iter(self.arrays.values())))

    def batch(self, idx):
        idx = np.asarray(idx)
        return {k: self.to(v[idx]) for k, v in self.arrays.items()}


def _val_problem(dataset: str, n=4200, d=16, seed=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 4, size=n)
    z = rng.normal(size=(n, d)).astype(np.float32)
    z[:, :4] += 1.5 * np.eye(4, dtype=np.float32)[ids]
    z[:, d - 5:] *= 1e-7
    if dataset == "parkinsons":
        return z, {"ids": ids, "pd_label": (ids >= 2).astype(np.int64) ^ (rng.random(n) < 0.1)}
    ang = np.arctan2(z[:, 5], z[:, 6]) + 0.2 * rng.normal(size=n)
    speed = np.stack([z[:, 4] * 2, np.abs(z[:, 5]), z[:, 4] * z[:, 6]], 1) + 0.2 * rng.normal(size=(n, 3))
    return z, {
        "avg_speed_3d": speed.astype(np.float32),
        "heading": np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32),
        "ids": ids,
    }


def _bands(key: str, n_test_class: int) -> float:
    if key.endswith("_nanfolds"):
        return 0.0
    if "_lin_" in key:
        return 1e-4
    if "_mlp_" in key:
        return MLP_R2_ABS
    return 1.0 / n_test_class + 1e-12  # logistic, QDA: one sample of the smallest test fold


@pytest.mark.parametrize("dataset", ["synthetic", "parkinsons"])
def test_decodability_metrics_match_jax(dataset, monkeypatch):
    z, arrays = _val_problem(dataset)
    stand_in = dict(
        info={"window": WINDOW}, config={"data": {"dataset": dataset}}, train_cfg={},
    )
    jself = types.SimpleNamespace(
        **stand_in, val_ds=_ValStream(arrays, jnp.asarray), _fold_summary=JaxTrainer._fold_summary
    )
    tself = types.SimpleNamespace(
        **stand_in, val_ds=_ValStream(arrays, torch.as_tensor), device=torch.device(CPU),
        _fold_summary=Trainer._fold_summary,
    )
    # the port's probe starts from JAX's initial weights
    monkeypatch.setattr(probes, "probe_init", jax_probe_init)
    want = JaxTrainer.decodability_metrics(jself, z)
    got = Trainer.decodability_metrics(tself, z)
    assert list(got) == list(want)
    n_test_class = (len(z) // (WINDOW // 10)) // 5
    for k, v in want.items():
        print(f"decodability {dataset} {k}: port {got[k]:.6f} JAX {v:.6f}")
        assert np.isfinite(got[k]) and abs(got[k] - v) <= _bands(k, n_test_class), (k, got[k], v)
    # nothing under minimal_test
    tself.train_cfg = {"minimal_test": True}
    assert Trainer.decodability_metrics(tself, z) == {}


def test_fold_summary_counts_nan_folds_as_jax_does():
    for folds in ([0.5, float("nan"), 0.7], [0.1, 0.2], [float("nan")] * 2):
        got, want = {}, {}
        Trainer._fold_summary(got, "m", folds)
        JaxTrainer._fold_summary(want, "m", folds)
        assert list(got) == list(want)
        np.testing.assert_array_equal(np.asarray(list(got.values())), np.asarray(list(want.values())))


# ---------------------------------------------------------------------------
# the trainer and the CLI without minimal_test
# ---------------------------------------------------------------------------

DECODABILITY_COLUMNS = [
    f"{m}_{s}"
    for m in (
        "r2_avg_speed_3d_lin", "r2_avg_speed_3d_mlp", "r2_heading_lin", "r2_heading_mlp",
        "acc_ids_log", "acc_ids_qda",
    )
    for s in ("mean", "std")
]


def _cli_config(data: Path, num_epochs: int) -> dict:
    return {
        "data": {
            "data_path": str(data) + "/", "dataset": "synthetic", "batch_size": 16,
            "direction_process": "midfwd", "arena_size": [[-290, -290, 0], [290, 290, 120]],
        },
        "disentangle": {
            "method": {
                "conditional": ["avg_speed_3d", "heading"], "linear": ["avg_speed_3d"],
                "moving_avg_lsq": ["avg_speed_3d"], "grad_reversal": ["avg_speed_3d"],
            },
        },
        "model": {"type": "rcnn", "z_dim": 8, "window": 51, "channel": [8, 8, 16, 16, 32], "kernel": 5},
        "train": {
            "lr": 1e-3, "optimizer": "adamw", "lr_schedule": "cawr", "num_epochs": num_epochs,
            "seed": 0, "eval_start_epoch": 0, "clip_norm": 0,
        },
        "loss": {
            "rotation": 1.0, "prior": 0.001, "root": 0.01, "jpe": 1.0,
            "avg_speed_3d_mals": 0.1, "avg_speed_3d_lin": 1.0, "avg_speed_3d_gr": 1.0,
        },
    }


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A 6-epoch CLI run without ``minimal_test`` (decodability at epoch 5,
    then a sixth epoch of training) on a train split of 3 steps an epoch
    and a val split of 2 ids."""
    root = tmp_path_factory.mktemp("decod")
    data = root / "data"
    skel = load_skeleton(ROOT / "configs" / "mouse_skeleton.yaml")
    (data / "synthetic").mkdir(parents=True)
    shutil.copy(ROOT / "configs" / "mouse_skeleton.yaml", data / "mouse_skeleton.yaml")
    for split, seed, n in (("train", 0, 200), ("val", 1, 1200)):
        pose, ids = synthetic_pose_stream(skel, n_frames=n, n_ids=2, seed=seed)
        write_pose_h5(data / "synthetic" / split / "pose.h5", pose, ids)
    run = root / "runs" / "proj" / "a"
    run.mkdir(parents=True)
    with open(run / "model_config.yaml", "w") as f:
        yaml.safe_dump(_cli_config(data, 6), f)
    with warnings.catch_warnings():
        warnings.simplefilter("error", probes.ConvergenceWarning)
        trainer = main(["-o", str(root / "runs"), "-p", "proj", "-n", "a", "--device", "cpu"])
    return root, data, run, trainer


def test_cli_writes_decodability_columns_at_epoch_5(cli_run):
    _, _, run, trainer = cli_run
    assert trainer.train_cfg.get("minimal_test") is None
    with open(run / "metrics.csv", newline="") as f:
        reader = csv.DictReader(f)
        cols, rows = list(reader.fieldnames), list(reader)
    assert cols[-len(DECODABILITY_COLUMNS):] == DECODABILITY_COLUMNS
    assert not any(c.endswith("_nanfolds") for c in cols)
    for r in rows:
        for c in DECODABILITY_COLUMNS:
            if r["epoch"] == "5":
                assert np.isfinite(float(r[c])), (c, r[c])
            else:
                assert r[c] == "", (r["epoch"], c)
    print("epoch 5 decodability:", {c: float(rows[4][c]) for c in DECODABILITY_COLUMNS})


def test_decodability_leaves_training_bit_for_bit(cli_run):
    """The same run with ``minimal_test: true`` ends in the same state, bit
    for bit: decodability draws from no training stream."""
    root, data, run, trainer = cli_run
    cfg = _cli_config(data, 6)
    cfg["train"]["minimal_test"] = True
    other = root / "runs" / "proj" / "b"
    other.mkdir(parents=True)
    with open(other / "model_config.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    quiet = train(read.config(other / "model_config.yaml"), device=CPU)
    a, b = trainer.model.state_dict(), quiet.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for x, y in zip(trainer.state.opt_state.mu + trainer.state.opt_state.nu,
                    quiet.state.opt_state.mu + quiet.state.opt_state.nu):
        assert torch.equal(x, y)
    assert torch.equal(trainer.state.generator.get_state(), quiet.state.generator.get_state())
    assert trainer.np_rng.bit_generator.state == quiet.np_rng.bit_generator.state
    with open(other / "metrics.csv", newline="") as f:
        assert not any(c in DECODABILITY_COLUMNS for c in csv.DictReader(f).fieldnames)
