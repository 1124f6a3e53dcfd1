"""Latent clustering with pickle caching (counterpart of
``scrubvae_tpu/evals/cluster.py``): a Gaussian mixture fitted by EM from a
k-means++ start, and HDBSCAN, computed in torch on the latents' device
(CUDA unless the caller asks for another), with no sklearn.

Both follow sklearn 1.9, which the JAX package calls, step for step:

- ``GaussianMixture`` is ``sklearn.mixture.GaussianMixture`` with
  ``init_params="k-means++"`` and ``n_init=1``: EM in the data's own dtype
  (float32 stays float32), the k-means++ centres drawn from numpy's global
  ``RandomState``, as sklearn draws them when given no ``random_state``, so
  ``np.random.seed(s)`` before either gives the same start. The fitted model holds numpy arrays and pickles in this
  module's own format, not sklearn's.
- ``hdbscan`` is ``sklearn.cluster.HDBSCAN`` on its euclidean, Prim's-MST
  route: core distances (the ``min_samples``-th neighbour, the point itself
  counted) and the MST over mutual-reachability distances on the device,
  the single-linkage tree, its condensation, the cluster stabilities, the
  excess-of-mass selection and the labelling on the host in numpy.
"""

from __future__ import annotations

import functools
import math
import pickle
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from scrubvae_torch.device import resolve_device

__all__ = ["ConvergenceWarning", "GaussianMixture", "kmeans_plusplus", "hdbscan", "gmm", "dbscan"]

COVARIANCE_TYPES = ("full", "tied", "diag", "spherical")
# sklearn's defaults: EM stops when the lower bound moves by less than TOL;
# verbose mode prints every VERBOSE_INTERVAL-th iteration
TOL = 1e-3
VERBOSE_INTERVAL = 10
# device memory for one chunk of HDBSCAN's core-distance rows
CORE_CHUNK_BYTES = 1 << 29

_PRECISION_ERROR = (
    "Fitting the mixture model failed because some components have "
    "ill-defined empirical covariance (for instance caused by singleton "
    "or collapsed samples). Try to decrease the number of components, "
    "increase reg_covar, or scale the input data."
)


class ConvergenceWarning(UserWarning):
    """EM stopped at ``max_iter`` before the lower bound settled (sklearn's
    ``ConvergenceWarning``)."""


def _check_model_exists(func):
    @functools.wraps(func)
    def wrapper(
        latents: np.ndarray,
        label: str = "cluster",
        path: Optional[str] = None,
        device=None,
        **kwargs,
    ):
        model_path = preds_path = None
        model_exists = False
        if path is not None:
            model_path = Path(f"{path}{label}_{func.__name__}.p")
            preds_path = Path(f"{path}{label}_{func.__name__}.npy")
            model_exists = model_path.exists()

        if model_exists:
            with open(model_path, "rb") as f:
                model = pickle.load(f)
        else:
            model = func(latents=latents, device=device, **kwargs)
            if path is not None:
                with open(model_path, "wb") as f:
                    pickle.dump(model, f)

        if model_exists and preds_path is not None and preds_path.exists():
            k_pred = np.load(preds_path)
        else:
            k_pred = model.predict(latents, device=device)
            if path is not None:
                np.save(preds_path, k_pred)
        return k_pred, model

    return wrapper


def _as_samples(X, device: torch.device, keep_float32: bool = True) -> torch.Tensor:
    """``X`` as a 2-D tensor of finite values on ``device``: float32 kept
    when ``keep_float32``, anything else as float64 (sklearn's
    ``validate_data`` dtypes)."""
    X = torch.as_tensor(X)
    if X.dim() != 2:
        raise ValueError(f"expected a 2-D array of samples, got shape {tuple(X.shape)}")
    if not (keep_float32 and X.dtype == torch.float32):
        X = X.to(torch.float64)
    X = X.to(device)
    if not bool(torch.isfinite(X).all()):
        raise ValueError("Input X contains NaN or infinity.")
    return X


# ---------------------------------------------------------------------------
# Gaussian mixture
# ---------------------------------------------------------------------------


def kmeans_plusplus(X: torch.Tensor, n_clusters: int, random_state: np.random.RandomState) -> np.ndarray:
    """Indices of the k-means++ centres sklearn's ``_kmeans_plusplus`` picks
    with unit sample weights and the same ``random_state``. The squared
    distances are computed on ``X``'s device in float64 (float32 data upcast,
    the result cast back, as sklearn's ``_euclidean_distances_upcast``); the
    potential, its cumulative sum and the draws run in numpy on the host
    with sklearn's arithmetic."""
    n = X.shape[0]
    np_dtype = np.float32 if X.dtype == torch.float32 else np.float64
    sample_weight = np.ones(n, dtype=np_dtype)
    n_local_trials = 2 + int(np.log(n_clusters))
    X64 = X.double()
    norms = torch.sum(X64 * X64, dim=1)

    def sq_dist(rows: np.ndarray) -> np.ndarray:
        r = torch.as_tensor(rows, device=X.device)
        d = -2 * (X64[r] @ X64.T)
        d += norms[r, None]
        d += norms[None, :]
        return np.maximum(d.to(X.dtype).cpu().numpy(), 0)

    center_id = random_state.choice(n, p=sample_weight / sample_weight.sum())
    indices = np.full(n_clusters, -1, dtype=int)
    indices[0] = center_id
    closest_dist_sq = sq_dist(np.asarray([center_id]))
    current_pot = closest_dist_sq @ sample_weight
    for c in range(1, n_clusters):
        rand_vals = random_state.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(np.cumsum(sample_weight * closest_dist_sq), rand_vals)
        np.clip(candidate_ids, None, closest_dist_sq.size - 1, out=candidate_ids)
        distance_to_candidates = sq_dist(candidate_ids)
        np.minimum(closest_dist_sq, distance_to_candidates, out=distance_to_candidates)
        candidates_pot = distance_to_candidates @ sample_weight.reshape(-1, 1)
        best = np.argmin(candidates_pot)
        current_pot = candidates_pot[best]
        closest_dist_sq = distance_to_candidates[best]
        indices[c] = candidate_ids[best]
    return indices


def _estimate_gaussian_parameters(X: torch.Tensor, resp: torch.Tensor, reg_covar: float, covariance_type: str):
    nk = resp.sum(0) + 10 * torch.finfo(resp.dtype).eps
    means = (resp.T @ X) / nk[:, None]
    if covariance_type == "full":
        covariances = torch.empty((len(means), X.shape[1], X.shape[1]), dtype=X.dtype, device=X.device)
        for k in range(len(means)):
            diff = X - means[k]
            covariances[k] = ((resp[:, k] * diff.T) @ diff) / nk[k]
            covariances[k].diagonal().add_(reg_covar)
    elif covariance_type == "tied":
        covariances = (X.T @ X - (nk * means.T) @ means) / nk.sum()
        covariances.diagonal().add_(reg_covar)
    else:
        covariances = (resp.T @ (X * X)) / nk[:, None] - means**2 + reg_covar
        if covariance_type == "spherical":
            covariances = covariances.mean(1)
    return nk, means, covariances


def _compute_precision_cholesky(covariances: torch.Tensor, covariance_type: str) -> torch.Tensor:
    """Cholesky factors of the precisions; ``ValueError`` on a covariance
    that is not positive definite, as sklearn raises."""
    message = _PRECISION_ERROR
    if covariances.dtype == torch.float32:
        message += " The numerical accuracy can also be improved by passing float64 data instead of float32."
    if covariance_type in ("full", "tied"):
        chol, info = torch.linalg.cholesky_ex(covariances)
        if bool((info != 0).any()):
            raise ValueError(message)
        eye = torch.eye(covariances.shape[-1], dtype=covariances.dtype, device=covariances.device)
        return torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False).mT
    if bool((covariances <= 0.0).any()):
        raise ValueError(message)
    return 1.0 / torch.sqrt(covariances)


def _estimate_log_gaussian_prob(X: torch.Tensor, means: torch.Tensor, precisions_chol: torch.Tensor,
                                covariance_type: str) -> torch.Tensor:
    n_features = X.shape[1]
    if covariance_type == "full":
        log_det = torch.log(torch.diagonal(precisions_chol, dim1=-2, dim2=-1)).sum(-1)
        log_prob = torch.empty((X.shape[0], len(means)), dtype=X.dtype, device=X.device)
        for k in range(len(means)):
            y = (X @ precisions_chol[k]) - (means[k] @ precisions_chol[k])
            log_prob[:, k] = torch.sum(torch.square(y), dim=1)
    elif covariance_type == "tied":
        log_det = torch.log(torch.diagonal(precisions_chol)).sum()
        xp = X @ precisions_chol
        log_prob = torch.stack(
            [torch.sum(torch.square(xp - means[k] @ precisions_chol), dim=1) for k in range(len(means))], dim=1
        )
    elif covariance_type == "diag":
        log_det = torch.log(precisions_chol).sum(1)
        precisions = precisions_chol**2
        log_prob = (
            torch.sum(means**2 * precisions, dim=1) - 2.0 * (X @ (means * precisions).T) + (X**2 @ precisions.T)
        )
    else:
        log_det = n_features * torch.log(precisions_chol)
        precisions = precisions_chol**2
        log_prob = (
            torch.sum(means**2, dim=1) * precisions
            - 2 * (X @ means.T * precisions)
            + torch.outer(torch.sum(X * X, dim=1), precisions)
        )
    return -0.5 * (n_features * math.log(2 * math.pi) + log_prob) + log_det


def _logsumexp(a: torch.Tensor) -> torch.Tensor:
    """sklearn's ``_logsumexp`` over axis 1: the maxima counted apart,
    log1p of the rest's scaled sum."""
    a_max = a.max(dim=1, keepdim=True).values
    at_max = a == a_max
    m = at_max.sum(dim=1, keepdim=True, dtype=a.dtype)
    shift = torch.where(torch.isfinite(a_max), a_max, torch.zeros_like(a_max))
    s = torch.exp(a.masked_fill(at_max, -math.inf) - shift).sum(dim=1, keepdim=True)
    s = torch.where(s == 0, s, s / m)
    return (torch.log1p(s) + torch.log(m) + a_max).squeeze(1)


class GaussianMixture:
    """sklearn's ``GaussianMixture`` with ``init_params="k-means++"``, one
    initialisation and no ``random_state`` (numpy's global ``RandomState``),
    fitted in torch on a device the caller names.

    After ``fit``: ``weights_``, ``means_``, ``covariances_``,
    ``precisions_cholesky_``, ``precisions_`` (numpy, in the data's dtype),
    ``n_iter_``, ``converged_``, ``lower_bound_``, ``lower_bounds_``.
    """

    def __init__(
        self,
        n_components: int = 1,
        covariance_type: str = "full",
        reg_covar: float = 1e-6,
        max_iter: int = 100,
        verbose: int = 0,
    ):
        if covariance_type not in COVARIANCE_TYPES:
            raise ValueError(f"covariance_type must be one of {COVARIANCE_TYPES}, got {covariance_type!r}")
        self.n_components = n_components
        self.covariance_type = covariance_type
        self.reg_covar = reg_covar
        self.max_iter = max_iter
        self.verbose = verbose

    def _weighted_log_prob(self, X: torch.Tensor, weights, means, precisions_chol) -> torch.Tensor:
        return _estimate_log_gaussian_prob(X, means, precisions_chol, self.covariance_type) + torch.log(weights)

    def fit(self, X, device=None) -> "GaussianMixture":
        self.fit_predict(X, device=device)
        return self

    def fit_predict(self, X, device=None) -> np.ndarray:
        """EM as sklearn's ``fit_predict``; returns the labels of a final
        E-step."""
        X = _as_samples(X, resolve_device(device))
        n_samples = X.shape[0]
        if n_samples < 2:
            raise ValueError(f"Found array with {n_samples} sample(s) while a minimum of 2 is required.")
        if n_samples < self.n_components:
            raise ValueError(
                f"Expected n_samples >= n_components but got n_components = {self.n_components}, "
                f"n_samples = {n_samples}"
            )
        if self.verbose:
            print("Initialization 0")
        indices = kmeans_plusplus(X, self.n_components, np.random.mtrand._rand)
        resp = torch.zeros((n_samples, self.n_components), dtype=X.dtype, device=X.device)
        resp[torch.as_tensor(indices, device=X.device), torch.arange(self.n_components, device=X.device)] = 1
        weights, means, covariances = _estimate_gaussian_parameters(X, resp, self.reg_covar, self.covariance_type)
        weights = weights / n_samples
        precisions_chol = _compute_precision_cholesky(covariances, self.covariance_type)

        lower_bound = -math.inf
        lower_bounds = []
        converged = False
        n_iter = 0
        for n_iter in range(1, self.max_iter + 1):
            prev_lower_bound = lower_bound
            weighted = self._weighted_log_prob(X, weights, means, precisions_chol)
            log_prob_norm = _logsumexp(weighted)
            log_resp = weighted - log_prob_norm[:, None]
            weights, means, covariances = _estimate_gaussian_parameters(
                X, torch.exp(log_resp), self.reg_covar, self.covariance_type
            )
            weights = weights / weights.sum()
            precisions_chol = _compute_precision_cholesky(covariances, self.covariance_type)
            lower_bound = float(log_prob_norm.mean())
            lower_bounds.append(lower_bound)
            change = lower_bound - prev_lower_bound
            if self.verbose and n_iter % VERBOSE_INTERVAL == 0:
                print("  Iteration %d" % n_iter)
            if abs(change) < TOL:
                converged = True
                break
        if self.verbose and self.max_iter > 0:
            print(f"Initialization {'converged' if converged else 'did not converge'}.")
        if not converged and self.max_iter > 0:
            warnings.warn(
                "Best performing initialization did not converge. Try different init parameters, "
                "or increase max_iter, tol, or check for degenerate data.",
                ConvergenceWarning,
            )

        self.weights_, self.means_, self.covariances_, self.precisions_cholesky_ = (
            t.cpu().numpy() for t in (weights, means, covariances, precisions_chol)
        )
        if self.covariance_type == "full":
            self.precisions_ = self.precisions_cholesky_ @ np.swapaxes(self.precisions_cholesky_, 1, 2)
        elif self.covariance_type == "tied":
            self.precisions_ = self.precisions_cholesky_ @ self.precisions_cholesky_.T
        else:
            self.precisions_ = self.precisions_cholesky_**2
        self.n_iter_ = n_iter
        self.converged_ = converged
        self.lower_bound_ = lower_bound
        self.lower_bounds_ = lower_bounds
        weighted = self._weighted_log_prob(X, weights, means, precisions_chol)
        return (weighted - _logsumexp(weighted)[:, None]).argmax(1).cpu().numpy()

    def predict(self, X, device=None) -> np.ndarray:
        """The most probable component of each sample, computed on
        ``device`` (CUDA unless the caller asks for another)."""
        X = _as_samples(X, resolve_device(device))
        dtype = torch.promote_types(X.dtype, torch.from_numpy(self.means_).dtype)
        params = [
            torch.as_tensor(p).to(device=X.device, dtype=dtype)
            for p in (self.weights_, self.means_, self.precisions_cholesky_)
        ]
        return self._weighted_log_prob(X.to(dtype), *params).argmax(1).cpu().numpy()


@_check_model_exists
def gmm(latents, n_components: int = 25, covariance_type: str = "full", device=None):
    return GaussianMixture(
        n_components=n_components,
        covariance_type=covariance_type,
        max_iter=150,
        reg_covar=1e-5,
        verbose=1,
    ).fit(latents, device=device)


# ---------------------------------------------------------------------------
# HDBSCAN
# ---------------------------------------------------------------------------


def _tree_sq(diff: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, whose length is a power of two,
    by halving: a fixed order of IEEE additions, so the same pair of points
    gives the same bits whatever the batch shape or device."""
    s = diff * diff
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s[..., 0]


def _core_sq(Xp: torch.Tensor, k: int) -> torch.Tensor:
    """Squared distance of every point to its ``k``-th nearest neighbour,
    the point itself counted. Candidates are the ``2k + 64`` nearest by the
    product form |x|^2 + |y|^2 - 2 x.y; their exact squared distances
    (``_tree_sq``) give the ``k``-th, which is kept when it lies below
    every excluded point's product-form value by more than that form's
    rounding; rows where it does not are computed over all points."""
    n, dim = Xp.shape
    norms = torch.sum(Xp * Xp, dim=1)
    m = min(n, 2 * k + 64)
    chunk = max(1, min(CORE_CHUNK_BYTES // (8 * n), CORE_CHUNK_BYTES // (16 * m * dim)))
    core = torch.empty(n, dtype=Xp.dtype, device=Xp.device)
    for lo in range(0, n, chunk):
        q = Xp[lo : lo + chunk]
        approx = norms[lo : lo + chunk, None] + norms[None, :] - 2 * (q @ Xp.T)
        vals, cand = torch.topk(approx, m, dim=1, largest=False)
        kth = torch.kthvalue(_tree_sq(Xp[cand] - q[:, None, :]), k, dim=1).values
        if m < n:
            slack = 1e-12 * (norms[lo : lo + chunk] + norms.max()) + 1e-300
            for r in torch.nonzero(~(kth < vals[:, -1] - slack)).flatten().tolist():
                kth[r] = torch.kthvalue(_tree_sq(Xp - q[r]), k).values
        core[lo : lo + chunk] = kth
    return core


def _prim_mst(Xp: torch.Tensor, core_sq: torch.Tensor):
    """sklearn's ``mst_from_data_matrix`` on the device: Prim's algorithm
    from node 0 over mutual-reachability distances max(core_i, core_j,
    d_ij), one row of distances a step, ties to the lowest index, a node's
    source changed only on a strict improvement. The device compares
    squares (``core_sq``, ``_tree_sq``: additions, products and maxima,
    which round alike on every device; the square root need not). Returns
    (source, node, distance) numpy arrays in the order the nodes join, the
    distance's square root taken on the host.

    The arrays of the nodes still out of the tree are compacted whenever a
    quarter of them has joined; between two compactions every step has the
    same shapes, so on CUDA the step is captured once as a CUDA graph and
    replayed (the same kernels on the same addresses as the eager step,
    without a host launch per operation)."""
    n = Xp.shape[0]
    dev = Xp.device
    out_src = torch.empty(n - 1, dtype=torch.long, device=dev)
    out_dst = torch.empty(n - 1, dtype=torch.long, device=dev)
    out_dist = torch.empty(n - 1, dtype=Xp.dtype, device=dev)
    row = torch.zeros(1, dtype=torch.long, device=dev)  # the output row the next step writes
    cur_g = torch.zeros(1, dtype=torch.long, device=dev)  # the node that joined last
    # the nodes out of the tree: points, core distances, best reach, its
    # source, global index; node 0 joins first
    st = {
        "x": Xp, "c": core_sq.clone(), "reach": torch.full((n,), math.inf, dtype=Xp.dtype, device=dev),
        "src": torch.ones(n, dtype=torch.long, device=dev), "g": torch.arange(n, device=dev),
    }
    st["c"][0] = math.inf

    def step():
        d = _tree_sq(st["x"] - Xp.index_select(0, cur_g))
        mr = torch.maximum(torch.maximum(st["c"], core_sq.index_select(0, cur_g)), d)
        better = mr < st["reach"]
        st["reach"].copy_(torch.where(better, mr, st["reach"]))
        st["src"].copy_(torch.where(better, cur_g, st["src"]))
        p = torch.argmin(st["reach"]).view(1)
        cur_g.copy_(st["g"].index_select(0, p))
        out_src.index_copy_(0, row, st["src"].index_select(0, p))
        out_dst.index_copy_(0, row, cur_g)
        out_dist.index_copy_(0, row, st["reach"].index_select(0, p))
        row.add_(1)
        # the node joins the tree: an infinite core distance keeps it from
        # ever improving, an infinite reach from being picked again
        st["c"].index_fill_(0, p, math.inf)
        st["reach"].index_fill_(0, p, math.inf)

    done = 0
    while done < n - 1:
        left = n - 1 - done
        steps = min(left, max(1, left - 3 * st["x"].shape[0] // 4))
        if dev.type == "cuda" and steps > 2:
            # a first step eagerly on a side stream, as capture requires
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
            for _ in range(steps - 1):
                graph.replay()
            del graph
        else:
            for _ in range(steps):
                step()
        done += steps
        if done < n - 1:
            keep = torch.nonzero(torch.isfinite(st["c"])).flatten()
            st = {k: v[keep] for k, v in st.items()}
    return out_src.cpu().numpy(), out_dst.cpu().numpy(), np.sqrt(out_dist.cpu().numpy())


def _single_linkage(src: np.ndarray, dst: np.ndarray, dist: np.ndarray):
    """sklearn's ``make_single_linkage`` over MST edges sorted by distance:
    (left, right, distance, size) lists of the merges."""
    n = len(dist) + 1
    parent = [-1] * (2 * n - 1)
    size = [1] * n + [0] * (n - 1)

    def find(x: int) -> int:
        p = x
        while parent[x] != -1:
            x = parent[x]
        while parent[p] != x and p != x:
            p, parent[p] = parent[p], x
        return x

    left, right, sizes = [], [], []
    next_label = n
    for a, b in zip(src.tolist(), dst.tolist()):
        ra, rb = find(a), find(b)
        left.append(ra)
        right.append(rb)
        sizes.append(size[ra] + size[rb])
        parent[ra] = parent[rb] = next_label
        size[next_label] = size[ra] + size[rb]
        next_label += 1
    return left, right, dist.tolist(), sizes


def _bfs_from_hierarchy(left: list, right: list, root: int, n: int) -> list:
    result, queue = [], [root]
    while queue:
        result.extend(queue)
        queue = [x - n for x in queue if x >= n]
        if queue:
            queue = [c for node in queue for c in (left[node], right[node])]
    return result


def _condense_tree(left: list, right: list, dist: list, sizes: list, min_cluster_size: int):
    """sklearn's ``_condense_tree``: (parent, child, lambda, size) rows."""
    n = len(dist) + 1
    root = 2 * (n - 1)
    next_label = n + 1
    node_list = _bfs_from_hierarchy(left, right, root, n)
    relabel = [0] * (root + 1)
    relabel[root] = n
    ignore = [False] * len(node_list)
    rows = []

    def count(node: int) -> int:
        return sizes[node - n] if node >= n else 1

    def dissolve(parent: int, child: int, lam: float) -> None:
        for sub in _bfs_from_hierarchy(left, right, child, n):
            if sub < n:
                rows.append((parent, sub, lam, 1))
            ignore[sub] = True

    for node in node_list:
        if ignore[node] or node < n:
            continue
        lo, hi, d = left[node - n], right[node - n], dist[node - n]
        lam = 1.0 / d if d > 0.0 else math.inf
        lc, rc = count(lo), count(hi)
        if lc >= min_cluster_size and rc >= min_cluster_size:
            relabel[lo] = next_label
            next_label += 1
            rows.append((relabel[node], relabel[lo], lam, lc))
            relabel[hi] = next_label
            next_label += 1
            rows.append((relabel[node], relabel[hi], lam, rc))
        elif lc < min_cluster_size and rc < min_cluster_size:
            dissolve(relabel[node], lo, lam)
            dissolve(relabel[node], hi, lam)
        elif lc < min_cluster_size:
            relabel[hi] = relabel[node]
            dissolve(relabel[node], lo, lam)
        else:
            relabel[lo] = relabel[node]
            dissolve(relabel[node], hi, lam)
    return rows


def _compute_stability(rows: list) -> dict:
    parents = [r[0] for r in rows]
    smallest = min(parents)
    largest_child = max(max(r[1] for r in rows), smallest)
    births = [math.nan] * (largest_child + 1)
    for _, child, lam, _ in rows:
        births[child] = lam
    births[smallest] = 0.0
    result = [0.0] * (max(parents) - smallest + 1)
    for parent, _, lam, size in rows:
        result[parent - smallest] += (lam - births[parent]) * size
    return {i + smallest: v for i, v in enumerate(result)}


def _eom_labels(rows: list, stability: dict) -> np.ndarray:
    """sklearn's ``_get_clusters`` with excess-of-mass selection, no single
    cluster, no epsilon and no size cap, then ``_do_labelling``."""
    node_list = sorted(stability.keys(), reverse=True)[:-1]
    cluster_rows = [r for r in rows if r[3] > 1]
    ct_parent = np.asarray([r[0] for r in cluster_rows], dtype=np.intp)
    ct_child = np.asarray([r[1] for r in cluster_rows], dtype=np.intp)
    is_cluster = {c: True for c in node_list}

    def bfs_from_cluster_tree(root: int) -> list:
        result, queue = [], np.asarray([root], dtype=np.intp)
        while len(queue) > 0:
            result.extend(queue.tolist())
            queue = ct_child[np.isin(ct_parent, queue)]
        return result

    for node in node_list:
        subtree_stability = np.sum([stability[c] for c in ct_child[ct_parent == node]])
        if subtree_stability > stability[node]:
            is_cluster[node] = False
            stability[node] = subtree_stability
        else:
            for sub in bfs_from_cluster_tree(node):
                if sub != node:
                    is_cluster[sub] = False
    clusters = {c for c in is_cluster if is_cluster[c]}
    cluster_map = {c: i for i, c in enumerate(sorted(clusters))}

    # _do_labelling's TreeUnionFind: union by rank, path compression
    root_cluster = min(r[0] for r in rows)
    uf_parent = list(range(max(r[0] for r in rows) + 1))
    rank = [0] * len(uf_parent)

    def find(x: int) -> int:
        path = []
        while uf_parent[x] != x:
            path.append(x)
            x = uf_parent[x]
        for p in path:
            uf_parent[p] = x
        return x

    for parent, child, _, _ in rows:
        if child not in clusters:
            xr, yr = find(parent), find(child)
            if rank[xr] < rank[yr]:
                uf_parent[xr] = yr
            elif rank[xr] > rank[yr]:
                uf_parent[yr] = xr
            else:
                uf_parent[yr] = xr
                rank[xr] += 1
    labels = np.empty(root_cluster, dtype=np.intp)
    for i in range(root_cluster):
        c = find(i)
        labels[i] = -1 if c == root_cluster else cluster_map[c]
    return labels


def hdbscan(X, min_cluster_size: int = 5, device=None) -> np.ndarray:
    """Labels of sklearn's ``HDBSCAN(min_cluster_size).fit_predict(X)`` at
    its other defaults (min_samples equal to min_cluster_size, euclidean,
    alpha 1, excess of mass, no single cluster, epsilon 0), noise -1; in
    float64 on ``device`` (CUDA unless the caller asks for another)."""
    X = _as_samples(X, resolve_device(device), keep_float32=False)
    n, dim = X.shape
    if n == 1:
        raise ValueError("n_samples=1 while HDBSCAN requires more than one sample")
    if min_cluster_size > n:
        raise ValueError(f"min_samples ({min_cluster_size}) must be at most the number of samples in X ({n})")
    # zero columns up to a power of two: _tree_sq halves exactly
    Xp = torch.nn.functional.pad(X, (0, (1 << (dim - 1).bit_length()) - dim))
    src, dst, dist = _prim_mst(Xp, _core_sq(Xp, min_cluster_size))
    order = np.argsort(dist)
    rows = _condense_tree(*_single_linkage(src[order], dst[order], dist[order]), min_cluster_size)
    return _eom_labels(rows, _compute_stability(rows))


def dbscan(
    latents,
    min_samples: int = 500,
    label: str = "cluster",
    path: str = "./results/",
    device=None,
):
    k_pred = hdbscan(latents, min_cluster_size=min_samples, device=device)
    if path is not None:
        np.save(f"{path}{label}_sc_pred.npy", k_pred)
    return k_pred
