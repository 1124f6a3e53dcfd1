"""Cross-validated decodability and the offline per-epoch harness
(counterpart of ``scrubvae_tpu/evals/metrics.py``): window-downsampled
5-fold CV of linear and MLP regressions and of elastic-net logistic, QDA
and LDA classifications of a factor from the latent, the pickle-cached
per-saved-epoch sweep, MMD, Shannon entropy and Hungarian matching.

The folds are sklearn's ``KFold(n_splits, shuffle=True, random_state=100)``,
drawn on the host by ``kfold_indices``; the estimators are torch code in
``scrubvae_torch.evals.probes`` and run on ``device`` (CUDA unless the
caller asks for another), with no sklearn.
"""

from __future__ import annotations

import functools
import pickle
import warnings
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from scrubvae_torch.device import resolve_device
from scrubvae_torch.evals import probes

__all__ = [
    "linear_rand_cv",
    "log_class_rand_cv",
    "qda_rand_cv",
    "lda_rand_cv",
    "mlp_rand_cv",
    "qda_fit_retry",
    "train_mlp_probe",
    "kfold_indices",
    "custom_cv_5folds",
    "decodability_class_window",
    "mmd_estimate",
    "shannon_entropy",
    "hungarian_match",
    "epoch_metric",
    "epoch_regression",
]

train_mlp_probe = probes.train_mlp_probe


def decodability_class_window(dataset_name, window: int) -> int:
    """Downsample interval for *classification* decodability folds: the
    window over a stride of 10, or of 1 on ``4_mice``, at least 1;
    regression folds use the full window (reference
    eval/metrics.py:160,204-211)."""
    stride = 1 if dataset_name == "4_mice" else 10
    return max(window // stride, 1)


def custom_cv_5folds(i: int, ids: np.ndarray, folds: int = 5):
    """Per-id contiguous folds (reference metrics.py:218-228)."""
    full_ind = np.arange(len(ids), dtype=int)
    idx = []
    for uid in np.unique(ids):
        id_idx = full_ind[ids == uid]
        split = np.linspace(0, len(id_idx), folds + 1).astype(int)
        idx.append(id_idx[split[i] : split[i + 1]])
    idx_test = np.concatenate(idx, axis=0)
    idx_train = full_ind[~np.isin(full_ind, idx_test)]
    return idx_train, idx_test


def kfold_indices(n: int, n_splits: int) -> list:
    """sklearn's ``KFold(n_splits, shuffle=True, random_state=100).split``
    of ``n`` samples: ``np.arange(n)`` shuffled by
    ``np.random.RandomState(100)``, cut into contiguous test folds of
    which the first ``n % n_splits`` hold one more; each fold's train and
    test indices in ascending order. Returns [(train, test), ...]."""
    order = np.arange(n)
    np.random.RandomState(100).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    out, lo = [], 0
    for size in sizes:
        mask = np.zeros(n, dtype=bool)
        mask[order[lo : lo + size]] = True
        out.append((np.flatnonzero(~mask), np.flatnonzero(mask)))
        lo += size
    return out


class FoldResults(list):
    """Per-fold metric list; ``folds_used`` records how many folds actually
    ran (the requested count unless the downsampled set was too small to
    split, in which case ``rand_cv`` clamps and says so)."""

    folds_used: int = 0


def rand_cv(func):
    """Window-stride downsample + ``kfold_indices`` (seed 100) wrapper
    (reference metrics.py:231-260). ``func(z_train, y_train, z_test,
    y_test, **kwargs)`` gets tensors on ``device``; a fold whose fit raises
    ``ValueError`` is a nan fold, with a warning that names the error."""

    @functools.wraps(func)
    def wrapper(z, y_true, window: int = 51, folds: int = 5, device=None, **kwargs):
        dev = resolve_device(device)
        met = FoldResults()
        dz = torch.as_tensor(z[::window], device=dev)
        dy = torch.as_tensor(y_true[::window], device=dev)
        # tiny datasets (smoke runs) may downsample below the fold count
        requested = folds
        folds = int(min(folds, len(dz)))
        if folds < requested:
            warnings.warn(
                f"{func.__name__}: only {len(dz)} downsampled samples — "
                f"clamping {requested} folds to {folds}",
                stacklevel=2,
            )
        met.folds_used = folds
        if folds < 2:
            met.append(float("nan"))
            return met
        for fold_i, (train_i, test_i) in enumerate(kfold_indices(len(dz), folds)):
            tr = torch.as_tensor(train_i, device=dev)
            te = torch.as_tensor(test_i, device=dev)
            try:
                met.append(func(dz[tr], dy[tr], dz[te], dy[te], **kwargs))
            except ValueError as e:
                warnings.warn(
                    f"{func.__name__} fold {fold_i}/{folds} failed "
                    f"({len(dz)} downsampled samples): {e}",
                    stacklevel=2,
                )
                met.append(float("nan"))
        return met

    return wrapper


def _accuracy(y_test: torch.Tensor, pred: torch.Tensor) -> float:
    return float((y_test.reshape(-1) == pred).double().mean())


@rand_cv
def linear_rand_cv(z_train, y_train, z_test, y_test):
    return probes.r2_score(y_test, probes.linear_predict(z_train, y_train, z_test))


@rand_cv
def log_class_rand_cv(z_train, y_train, z_test, y_test, multi_class="ovr"):
    """Elastic-net logistic decodability (reference eval/metrics.py:271-284):
    one-vs-rest over more than 2 classes, as the reference's
    ``multi_class="ovr"``; ``multi_class="multinomial"`` fits the softmax
    probe instead."""
    return _accuracy(y_test, probes.logistic_predict(z_train, y_train, z_test, multi_class))


def qda_fit_retry(z_train, y_train) -> dict:
    """``probes.qda_fit``, retried with ``reg_param=1e-3`` when a class
    covariance is not full rank, as the JAX package's ``qda_rand_cv`` does
    (collapsed latent dims make it singular); any other ``ValueError``,
    and a retry that fails again, propagate."""
    try:
        return probes.qda_fit(z_train, y_train)
    except ValueError as e:
        if "full rank" not in str(e):
            raise
        return probes.qda_fit(z_train, y_train, reg_param=1e-3)


@rand_cv
def qda_rand_cv(z_train, y_train, z_test, y_test):
    return _accuracy(y_test, probes.qda_predict(qda_fit_retry(z_train, y_train), z_test))


@rand_cv
def lda_rand_cv(z_train, y_train, z_test, y_test):
    return _accuracy(y_test, probes.lda_predict(probes.lda_fit(z_train, y_train), z_test))


@rand_cv
def mlp_rand_cv(z_train, y_train, z_test, y_test):
    """R^2 of the MLP probe, trained 200 steps from ``probes.probe_init``
    (seed 0) in every fold."""
    predict = probes.train_mlp_probe(z_train, y_train, 200, device=z_train.device)
    return probes.r2_score(y_test, predict(z_test))


def mmd_estimate(X, Y, h=None, device=None) -> float:
    """Unbiased MMD with a squared-exponential kernel and the median
    heuristic for ``h`` (reference metrics.py:332-374; Gretton et al.
    2012), in float64 on ``device``."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev).double()
    Y = torch.as_tensor(Y, device=dev).double()
    xd, yd = torch.pdist(X), torch.pdist(Y)
    xyd = torch.cdist(X, Y).reshape(-1)
    if h is None:
        # np.median: the middle value, or the mean of the two middle values
        # of an even count (torch.quantile refuses more than 2^24 values)
        v = torch.sort(torch.cat((xd, yd, xyd))).values
        mid = len(v) // 2
        h = float(v[mid] if len(v) % 2 else (v[mid - 1] + v[mid]) / 2) ** 2
    kxx = torch.exp(-(xd**2) / h).mean()
    kyy = torch.exp(-(yd**2) / h).mean()
    kxy = torch.exp(-(xyd**2) / h).mean()
    return float(kxx + kyy - 2 * kxy)


def shannon_entropy(x, device=None) -> float:
    """Entropy (nats) of the empirical distribution of the labels ``x``."""
    counts = torch.unique(torch.as_tensor(x, device=resolve_device(device)), return_counts=True)[1]
    hist = counts.double() / counts.sum()
    return float((hist * torch.log(1 / hist)).sum())


def hungarian_match(x1, x2, device=None) -> np.ndarray:
    """Map x1's categorical labels onto x2's by the Hungarian assignment of
    their contingency table (reference metrics.py:388-412); the table is
    counted on ``device``, the assignment solved on the host by scipy."""
    from scipy.optimize import linear_sum_assignment

    dev = resolve_device(device)
    x1 = np.asarray(x1)
    k1, i1 = torch.unique(torch.as_tensor(x1, device=dev), return_inverse=True)
    k2, i2 = torch.unique(torch.as_tensor(np.asarray(x2), device=dev), return_inverse=True)
    cost = torch.zeros(len(k1) * len(k2), dtype=torch.int64, device=dev)
    cost.index_add_(0, i1 * len(k2) + i2, torch.ones_like(i1))
    row_ind, col_ind = linear_sum_assignment(cost.reshape(len(k1), len(k2)).cpu().numpy(), maximize=True)
    row_k = k1.cpu().numpy()[row_ind]
    col_v = k2.cpu().numpy()[col_ind]
    idx = np.searchsorted(row_k, x1)
    idx[idx == len(row_k)] = 0
    mask = row_k[idx] == x1
    return np.where(mask, col_v[idx], x1)


# ---------------------------------------------------------------------------
# Cached per-epoch offline harness (reference metrics.py:23-216)
# ---------------------------------------------------------------------------


def epoch_metric(func):
    """Decorator: iterate saved epochs, compute a metric per epoch, cache the
    result dict to a pickle next to the run (reference epoch_metric). The
    data and the latents are made on ``device``."""

    @functools.wraps(func)
    def wrapper(
        path: str,
        method: str,
        dataset_label: str,
        save_load: bool = True,
        disentangle_keys: Sequence[str] = ("avg_speed_3d", "heading"),
        start_epoch: int = 100,
        device=None,
        **kwargs,
    ):
        from scrubvae_torch import factory
        from scrubvae_torch.params import read

        config = read.config(str(Path(path) / "model_config.yaml"), make_dirs=False)
        config["model"]["load_model"] = config["out_path"]

        pickle_path = Path(config["out_path"]) / f"{method}_{dataset_label}.p"
        if pickle_path.is_file() and save_load:
            with open(pickle_path, "rb") as f:
                metrics = pickle.load(f)
            epochs_to_test = [
                e
                for e in factory.all_saved_epochs(path)
                if (e not in metrics["epochs"]) and (e > start_epoch)
            ]
            metrics["epochs"] = np.concatenate([metrics["epochs"], epochs_to_test]).astype(int)
        else:
            metrics = {"epochs": [e for e in factory.all_saved_epochs(path) if e > start_epoch]}
            epochs_to_test = metrics["epochs"]

        if len(epochs_to_test) > 0:
            data_keys = ["x6d", "root"] + list(disentangle_keys)
            dataset = factory.mouse_data(
                config["data"],
                train_val_test=dataset_label,
                data_keys=data_keys,
                window=config["model"].get("window"),
                device=device,
            )
            metrics = func(
                config=config,
                dataset=dataset,
                epochs_to_test=epochs_to_test,
                metrics=metrics,
                dataset_label=dataset_label,
                disentangle_keys=disentangle_keys,
                method=method,
                device=device,
                **kwargs,
            )

        if save_load:
            with open(pickle_path, "wb") as f:
                pickle.dump(metrics, f)
        return metrics

    return wrapper


@epoch_metric
def epoch_regression(
    config,
    dataset,
    epochs_to_test,
    metrics,
    method,
    dataset_label,
    disentangle_keys=("avg_speed_3d", "heading"),
    device=None,
):
    """Per-epoch decodability sweep (reference metrics.py:150-216)."""
    from scrubvae_torch.evals.latents import latents as get_latents

    if len(metrics.keys()) == 1:
        if ("log_class" in method) or ("qda" in method):
            metrics.update({k: {"Accuracy": []} for k in disentangle_keys})
        else:
            metrics.update({k: {"R2": []} for k in disentangle_keys})

    window = config["model"].get("window") or 51
    class_window = decodability_class_window(config["data"].get("dataset"), window)
    full = dataset.batch(torch.arange(len(dataset), device=dataset.device))
    for epoch in epochs_to_test:
        z = get_latents(config, epoch=epoch, dataset=dataset, label=dataset_label, device=device)
        for key in disentangle_keys:
            y = full[key]
            if method == "linear_rand_cv":
                metrics[key]["R2"].append(linear_rand_cv(z, y, window, 5, device=device))
            elif method == "mlp_rand_cv":
                metrics[key]["R2"].append(mlp_rand_cv(z, y, window, 5, device=device))
            elif method == "log_class_rand_cv":
                metrics[key]["Accuracy"].append(log_class_rand_cv(z, y.long(), class_window, 5, device=device))
            elif method == "qda_rand_cv":
                metrics[key]["Accuracy"].append(qda_rand_cv(z, y.long(), class_window, 5, device=device))
    return metrics
