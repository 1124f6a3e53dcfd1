"""The port's clustering (``scrubvae_torch/evals/cluster.py``) against the
JAX package's ``scrubvae_tpu/evals/cluster.py``, which calls sklearn 1.9,
on the CPU.

- ``gmm`` under the same ``np.random.seed``: the same k-means++ centres
  (against sklearn's ``kmeans_plusplus``), the same ``n_iter_`` and
  convergence, identical labels for all four covariance types; in float64
  the parameters within 1e-8 of the largest entry (EM in another order of
  float64 sums, about 1e-14 apart here), in float32 labels identical on
  separated blobs and parameters within 1e-4; the same verbose lines.
- the pickle and ``.npy`` cache round trip, and a ``ValueError`` on a
  covariance that is not positive definite, as sklearn raises.
- ``dbscan`` (sklearn's HDBSCAN) with identical labels, noise included.
"""

import pickle
import warnings

import numpy as np
import pytest
import torch
from sklearn.cluster import kmeans_plusplus as sk_kmeans_plusplus
from sklearn.exceptions import ConvergenceWarning as SkConvergenceWarning
from sklearn.mixture import GaussianMixture as SkGaussianMixture

from scrubvae_tpu.evals import cluster as jcluster
from scrubvae_torch.evals import cluster

torch.set_num_threads(1)

PARAMS = ("weights_", "means_", "covariances_", "precisions_cholesky_", "precisions_")


def blobs(seed: int, n_blobs: int, per_blob: int, dim: int, spread: float = 10.0) -> np.ndarray:
    """Gaussian blobs, each with its own rotated covariance of condition
    number at most 9 (axis scales 0.5 to 1.5)."""
    rng = np.random.default_rng(seed)
    out = []
    for c in rng.normal(size=(n_blobs, dim)) * spread:
        rot = np.linalg.qr(rng.normal(size=(dim, dim)))[0]
        out.append(rng.normal(size=(per_blob, dim)) * rng.uniform(0.5, 1.5, dim) @ rot + c)
    return np.concatenate(out)


X = blobs(0, 5, 200, 6)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_kmeans_plusplus_picks_sklearns_centres(dtype):
    Xd = X.astype(dtype)
    want = sk_kmeans_plusplus(Xd, 7, random_state=np.random.RandomState(4))[1]
    got = cluster.kmeans_plusplus(torch.from_numpy(Xd), 7, np.random.RandomState(4))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("covariance_type", cluster.COVARIANCE_TYPES)
def test_gmm_matches_jax(covariance_type, dtype, capsys):
    Xd = X.astype(dtype)
    np.random.seed(7)
    want, sk = jcluster.gmm(Xd, n_components=5, covariance_type=covariance_type)
    sk_out = capsys.readouterr().out
    np.random.seed(7)
    got, port = cluster.gmm(Xd, n_components=5, covariance_type=covariance_type, device="cpu")
    assert capsys.readouterr().out == sk_out
    assert "Initialization converged." in sk_out
    np.testing.assert_array_equal(got, want)
    assert (port.n_iter_, port.converged_) == (sk.n_iter_, sk.converged_)
    tol = 1e-8 if dtype == np.float64 else 1e-4
    for name in PARAMS:
        p, s = getattr(port, name), getattr(sk, name)
        assert p.dtype == s.dtype == dtype and p.shape == s.shape, name
        err = np.abs(p - s).max() / np.abs(s).max()
        assert err <= tol, (name, err)
    assert abs(port.lower_bound_ - sk.lower_bound_) <= tol * abs(sk.lower_bound_)
    # a final E-step gives the labels predict gives
    np.random.seed(7)
    fp = cluster.GaussianMixture(5, covariance_type, max_iter=150, reg_covar=1e-5).fit_predict(Xd, device="cpu")
    np.testing.assert_array_equal(fp, want)


def test_gmm_cache_round_trip(tmp_path, monkeypatch):
    path = str(tmp_path) + "/"
    np.random.seed(1)
    k1, m1 = cluster.gmm(X, label="t", path=path, n_components=5, device="cpu")
    assert (tmp_path / "t_gmm.p").exists() and (tmp_path / "t_gmm.npy").exists()
    with open(tmp_path / "t_gmm.p", "rb") as f:
        loaded = pickle.load(f)
    # numpy only: the pickle loads and predicts without the device it was fitted on
    assert all(isinstance(getattr(loaded, n), np.ndarray) for n in PARAMS)
    np.testing.assert_array_equal(loaded.predict(X, device="cpu"), k1)

    def no_fit(*a, **k):
        raise AssertionError("the cache should have been read")

    monkeypatch.setattr(cluster.GaussianMixture, "fit", no_fit)
    k2, m2 = cluster.gmm(X, label="t", path=path, n_components=5, device="cpu")
    np.testing.assert_array_equal(k2, k1)
    assert isinstance(m2, cluster.GaussianMixture) and m2.n_iter_ == m1.n_iter_
    # without the predictions file they are computed again from the cached model
    (tmp_path / "t_gmm.npy").unlink()
    k3, _ = cluster.gmm(X, label="t", path=path, n_components=5, device="cpu")
    np.testing.assert_array_equal(k3, k1)
    assert (tmp_path / "t_gmm.npy").exists()


def test_degenerate_covariance_raises_as_sklearn_does():
    # three distinct points, each repeated: every component collapses
    Xd = np.repeat(np.asarray([[0.0, 0.0], [5.0, 1.0], [1.0, 7.0]]), 20, axis=0)
    for ctype in ("full", "diag"):
        np.random.seed(0)
        with pytest.raises(ValueError, match="ill-defined empirical covariance") as sk_err:
            SkGaussianMixture(3, covariance_type=ctype, init_params="k-means++", reg_covar=0.0).fit(Xd)
        np.random.seed(0)
        with pytest.raises(ValueError, match="ill-defined empirical covariance") as port_err:
            cluster.GaussianMixture(3, covariance_type=ctype, reg_covar=0.0).fit(Xd, device="cpu")
        assert str(port_err.value) == str(sk_err.value)
    with pytest.raises(ValueError, match="n_samples >= n_components"):
        cluster.GaussianMixture(5).fit(Xd[:3], device="cpu")


def test_unconverged_em_warns_as_sklearn_does():
    Xd = blobs(3, 4, 100, 4, spread=1.0)
    np.random.seed(2)
    with pytest.warns(SkConvergenceWarning):
        sk = SkGaussianMixture(4, init_params="k-means++", max_iter=2).fit(Xd)
    np.random.seed(2)
    with pytest.warns(cluster.ConvergenceWarning, match="did not converge"):
        port = cluster.GaussianMixture(4, max_iter=2).fit(Xd, device="cpu")
    assert port.n_iter_ == sk.n_iter_ == 2 and not port.converged_
    np.testing.assert_allclose(port.means_, sk.means_, rtol=0, atol=1e-8 * np.abs(sk.means_).max())


HDBSCAN_SETS = {
    # separated blobs: 5 x 1,000 points in 16-d at min_samples 50
    "blobs_16d": (lambda: blobs(5, 5, 1000, 16, spread=3.0), 50),
    # overlapping blobs of unequal spread in 4-d, uniform noise, exact ties
    "noisy_4d_rounded": (
        lambda: np.round(
            np.concatenate([blobs(6, 4, 600, 4, spread=2.5),
                            np.random.default_rng(6).uniform(-8, 8, size=(300, 4))]), 1
        ),
        20,
    ),
}


@pytest.mark.parametrize("name", sorted(HDBSCAN_SETS))
def test_dbscan_matches_jax(name, tmp_path):
    make, min_samples = HDBSCAN_SETS[name]
    Xd = make()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # sklearn's note on HDBSCAN's copy default
        want = jcluster.dbscan(Xd, min_samples=min_samples, label="j", path=str(tmp_path) + "/")
    got = cluster.dbscan(Xd, min_samples=min_samples, label="p", path=str(tmp_path) + "/", device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "p_sc_pred.npy"), want)
    assert len(np.unique(want[want >= 0])) >= 3
    if name == "blobs_16d":
        # each blob is recovered: nine tenths of it in a cluster of its own
        owners = [np.bincount(got[b * 1000 : (b + 1) * 1000][got[b * 1000 : (b + 1) * 1000] >= 0]).argmax()
                  for b in range(5)]
        assert len(set(owners)) == 5
        assert all((got[b * 1000 : (b + 1) * 1000] == o).mean() >= 0.9 for b, o in enumerate(owners))
    else:
        assert (want == -1).sum() > 0


def test_hdbscan_core_distances_are_the_exact_kth_neighbour():
    """The candidate pruning gives the exact squared distance to the k-th
    neighbour, the point itself counted, also where many points coincide
    (every row then takes the full-row path)."""
    rng = np.random.default_rng(8)
    pts = torch.from_numpy(np.concatenate([rng.normal(size=(300, 8)), np.zeros((200, 8))]))
    full = torch.cdist(pts, pts, compute_mode="donot_use_mm_for_euclid_dist")
    for k in (1, 5, 250):
        got = cluster._core_sq(pts, k)
        want = full.kthvalue(k, dim=1).values ** 2
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
        # the same bits as the squared distances the MST compares
        rows = torch.stack([cluster._tree_sq(pts - p) for p in pts])
        assert torch.equal(got, rows.kthvalue(k, dim=1).values)
    assert float(cluster._core_sq(pts, 5)[-1]) == 0.0


def test_hdbscan_rejects_what_sklearn_rejects():
    with pytest.raises(ValueError, match="n_samples=1"):
        cluster.hdbscan(np.zeros((1, 3)), device="cpu")
    with pytest.raises(ValueError, match="min_samples"):
        cluster.hdbscan(np.zeros((4, 3)), min_cluster_size=5, device="cpu")
    with pytest.raises(ValueError, match="NaN or infinity"):
        cluster.hdbscan(np.full((6, 2), np.nan), device="cpu")
