"""The embedding probe (counterpart of `coma_unet_tpu/analysis/embeddings.py`):
run volumes through a trained model, take the bottleneck encoder features
(512 x 8^3 a volume in the flagship at 128^3), and probe how much
amyloid-beta status they encode with PLS regression and recursive feature
elimination.

The JAX package calls scikit-learn for the probe; the card's machine has
none, so the probe here is numpy and scipy, step for step what the
scikit-learn estimators it names compute on these inputs (`train_test_split`,
`PLSRegression` with NIPALS, `RFE` over `LinearRegression`, `r2_score`):
the same dtypes, the same reductions in the same order, the same LAPACK
driver. The row filter, the feature subsample and the RFE size guard are
the JAX package's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy import linalg

from coma_unet_tpu_torch.models.registry import (apply_model, device_args,
                                                 eval_mode, has_attention_maps)

_FLOAT_DTYPES = (np.float64, np.float32, np.float16)
_LSTSQ_COND = 1e-6  # LinearRegression's default `tol`, its lstsq cutoff


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def extract_bottleneck_encodings(model: torch.nn.Module, loader
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(X [N, F] float32, the bottleneck features of each volume flattened;
    abeta [N]) over `loader`'s batches (dicts of arrays or tensors, moved
    to the model's device), the model in eval mode as the JAX package's
    `train=False` (batch norm on its running statistics, which stay as
    they are; no dropout) and in its earlier mode after. A model whose
    output carries no encoder features (the baselines) raises ValueError
    before any forward."""
    if not has_attention_maps(model):
        raise ValueError(f"{type(model).__name__} returns no encoder features "
                         f"to probe")
    feats, abetas = [], []
    with eval_mode(model), torch.inference_mode():
        for batch in loader:
            outs = apply_model(model, *device_args(model, batch),
                               with_projections=False)
            enc = outs.encoder[-1].float().cpu().numpy()
            feats.append(enc.reshape(enc.shape[0], -1))
            abetas.append(_numpy(batch["abeta"]).reshape(-1))
    return np.concatenate(feats), np.concatenate(abetas)


# ---------------------------------------------------------------------------
# the probe's estimators
# ---------------------------------------------------------------------------


def train_test_split(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) row indices: ceil(n / 4) test rows first in
    `RandomState(seed)`'s permutation, the rest train."""
    n_test = math.ceil(0.25 * n)
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def pls_fit(x: np.ndarray, y: np.ndarray, n_components: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(coef [1, p], x_mean [p], y_mean [1]) of the PLS regression of one
    target by NIPALS in float64, X and y centred and scaled (std with ddof
    1, a zero std taken as 1); it predicts (X - x_mean) @ coef.T + y_mean.
    With one target the power method converges in one iteration; a
    component whose y residual is constant (every value under float64's
    eps after the columns under 10 eps are zeroed) ends the fit there."""
    xk = np.array(x, dtype=np.float64)
    yk = np.array(y, dtype=np.float64).reshape(-1, 1)
    p = xk.shape[1]
    x_mean = xk.mean(axis=0)
    xk -= x_mean
    y_mean = yk.mean(axis=0)
    yk -= y_mean
    x_std = xk.std(axis=0, ddof=1)
    x_std[x_std == 0.0] = 1.0
    xk /= x_std
    y_std = yk.std(axis=0, ddof=1)
    y_std[y_std == 0.0] = 1.0
    yk /= y_std

    x_weights_ = np.zeros((p, n_components))
    x_loadings_ = np.zeros((p, n_components))
    y_loadings_ = np.zeros((1, n_components))
    eps = np.finfo(np.float64).eps
    for k in range(n_components):
        yk[:, np.all(np.abs(yk) < 10 * eps, axis=0)] = 0.0
        y_score = yk.T[0]
        if not np.any(np.abs(y_score) > eps):
            break  # the y residual is constant
        x_weights = np.dot(xk.T, y_score) / np.dot(y_score, y_score)
        x_weights /= np.sqrt(np.dot(x_weights, x_weights)) + eps
        # the sign that makes x_weights' largest entry positive
        x_weights *= np.sign(x_weights[np.argmax(np.abs(x_weights))])
        x_scores = np.dot(xk, x_weights)
        x_loadings = np.dot(x_scores, xk) / np.dot(x_scores, x_scores)
        xk -= np.outer(x_scores, x_loadings)
        y_loadings = np.dot(x_scores, yk) / np.dot(x_scores, x_scores)
        yk -= np.outer(x_scores, y_loadings)
        x_weights_[:, k] = x_weights
        x_loadings_[:, k] = x_loadings
        y_loadings_[:, k] = y_loadings

    x_rotations = np.dot(x_weights_, linalg.pinv(
        np.dot(x_loadings_.T, x_weights_), check_finite=False))
    coef = np.dot(x_rotations, y_loadings_.T)
    return (coef * y_std).T / x_std, x_mean, y_mean


def linear_fit(x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(coef [p], intercept) of ordinary least squares with an intercept,
    in x's float dtype (float32 stays float32): X and y centred by their
    means, `scipy.linalg.lstsq` (LAPACK gelsd) with singular values under
    1e-6 of the largest cut."""
    x = np.array(x, dtype=x.dtype if x.dtype in (np.float64, np.float32)
                 else np.float64)
    y = np.array(y, dtype=x.dtype)
    x_offset = np.average(x, axis=0).astype(x.dtype, copy=False)
    x -= x_offset
    y_offset = np.asarray(np.average(y, axis=0))
    y -= y_offset
    coef = linalg.lstsq(x, y, cond=_LSTSQ_COND)[0]
    coef = coef.astype(x_offset.dtype, copy=False)
    return coef, y_offset - x_offset @ coef


def rfe_support(x: np.ndarray, y: np.ndarray, n_select: int) -> np.ndarray:
    """Recursive feature elimination over least squares, one feature a
    refit: the feature with the smallest coef^2 goes (the first in index
    order among ties); the boolean mask of the `n_select` kept."""
    n_features = x.shape[1]
    support = np.ones(n_features, dtype=bool)
    while np.sum(support) > n_select:
        features = np.arange(n_features)[support]
        coef, _ = linear_fit(x[:, features], y)
        ranks = np.argsort(coef ** 2, kind="stable")
        support[features[ranks][:1]] = False
    return support


def r2_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """The coefficient of determination, computed in the wider float dtype
    of the two; NaN under 2 samples; with a constant y_true 1.0 for an
    exact prediction, else 0.0."""
    dtype = np.result_type(*[a.dtype for a in (y_true, y_pred)
                             if a.dtype.kind == "f"] or [np.float64])
    y_true = np.asarray(y_true, dtype=dtype).reshape(-1, 1)
    y_pred = np.asarray(y_pred, dtype=dtype).reshape(-1, 1)
    if y_pred.shape[0] < 2:
        return float("nan")
    numerator = np.sum(1.0 * (y_true - y_pred) ** 2, axis=0)
    denominator = np.sum(
        1.0 * (y_true - np.average(y_true, axis=0)) ** 2, axis=0)
    if numerator[0] == 0:
        return 1.0
    if denominator[0] == 0:
        return 0.0
    return float(1 - numerator[0] / denominator[0])


def probe_abeta_from_embeddings(x: np.ndarray, abeta: np.ndarray,
                                n_components: int = 2,
                                n_features: Optional[int] = None,
                                seed: int = 0) -> Dict[str, float]:
    """{"r2", "rfe_r2"}: PLS regression of abeta on the bottleneck features
    (rows with a NaN or negative abeta left out; NaN for both under 4
    rows) and least squares on the max(2, F // 4) features RFE keeps (NaN
    above 4,096 features), both scored on a quarter of the rows held out.
    `n_features` subsamples the features first (`default_rng(seed)`)."""
    x, abeta = np.asarray(x), np.asarray(abeta)
    keep = ~np.isnan(abeta) & (abeta >= 0)
    x, abeta = x[keep], abeta[keep]
    if x.shape[0] < 4:
        return {"r2": float("nan"), "rfe_r2": float("nan")}
    rng = np.random.default_rng(seed)
    if n_features is not None and x.shape[1] > n_features:
        cols = rng.choice(x.shape[1], size=n_features, replace=False)
        x = x[:, cols]
    train, test = train_test_split(x.shape[0], seed)
    xtr, xte = x.take(train, axis=0), x.take(test, axis=0)
    ytr, yte = abeta.take(train, axis=0), abeta.take(test, axis=0)
    coef, x_mean, y_mean = pls_fit(xtr, ytr, min(n_components, xtr.shape[0] - 1))
    # X centred in its own float dtype (float64 for any other), as sklearn's
    # `predict` does
    xc = np.array(xte, dtype=xte.dtype if xte.dtype in _FLOAT_DTYPES
                  else np.float64)
    xc -= x_mean
    r2 = r2_score(yte, (xc @ coef.T + y_mean).ravel())

    rfe_r2 = float("nan")
    if x.shape[1] <= 4096:  # RFE refits F - F // 4 times
        support = rfe_support(xtr, ytr, max(2, x.shape[1] // 4))
        coef, intercept = linear_fit(xtr[:, np.arange(x.shape[1])[support]], ytr)
        rfe_r2 = r2_score(yte, xte[:, support] @ coef + intercept)
    return {"r2": float(r2), "rfe_r2": float(rfe_r2)}


def pca(x: np.ndarray, n_components: int, center: bool = True):
    """(components [k, F], projected [N, k], explained_variance [k]) by an
    SVD in float64, centred unless `center` is False."""
    x = np.asarray(x, np.float64)
    if center:
        x = x - x.mean(axis=0, keepdims=True)
    u, s, vt = np.linalg.svd(x, full_matrices=False)
    k = min(n_components, vt.shape[0])
    comps = vt[:k]
    proj = x @ comps.T
    ev = (s[:k] ** 2) / max(x.shape[0] - 1, 1)
    return comps, proj, ev
