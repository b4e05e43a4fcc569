"""Host-side preprocessing (port of cmfrec_tpu/solvers/preprocess.py).

The global mean follows the reference's calc_mean_and_center (upstream
cmfrec src/common.c:3423), accumulated in float64.  The bucketed engine's
starting biases come from :func:`initialize_biases` on the host; the
dense-masked engine computes its own on the device
(dense_masked._device_bias_init).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def weighted_global_mean(
    vals: np.ndarray, wgt: Optional[np.ndarray] = None
) -> float:
    if wgt is None:
        return float(np.mean(vals, dtype=np.float64))
    sw = float(np.sum(wgt, dtype=np.float64))
    return float(np.sum(vals * wgt, dtype=np.float64) / max(sw, 1e-300))


def initialize_biases(
    rows: np.ndarray,
    cols: np.ndarray,
    vals_centered: np.ndarray,
    m: int,
    n: int,
    lam_user: float,
    lam_item: float,
    wgt: Optional[np.ndarray] = None,
    user_bias: bool = True,
    item_bias: bool = True,
    scale_lam: bool = False,
    nonneg: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Alternating closed-form bias init, in float64.

    With both biases on: the reference's iterated two-sided init
    (initialize_biases_twosided, upstream cmfrec src/common.c:4410):
    5 alternating full re-solves (15 under ``nonneg``), items first --
    biasB[j] = sum_obs(x - biasA) / (cnt + lam*(scale? cnt : 1)), then the
    symmetric user pass, each half-pass clipped at 0 under ``nonneg``.
    With a single bias on: one shrunken-mean pass
    (initialize_biases_onesided, src/common.c:4130), clipped likewise."""
    biasA = np.zeros(m, np.float64)
    biasB = np.zeros(n, np.float64)
    v = vals_centered.astype(np.float64)
    w = None if wgt is None else wgt.astype(np.float64)

    if w is None:
        c_item = np.bincount(cols, minlength=n).astype(np.float64)
        c_user = np.bincount(rows, minlength=m).astype(np.float64)
    else:
        c_item = np.bincount(cols, weights=w, minlength=n)
        c_user = np.bincount(rows, weights=w, minlength=m)
    den_item = c_item + lam_item * (np.maximum(c_item, 1.0) if scale_lam else 1.0)
    den_user = c_user + lam_user * (np.maximum(c_user, 1.0) if scale_lam else 1.0)

    niter = 1
    if user_bias and item_bias:
        niter = 15 if nonneg else 5
    for _ in range(niter):
        if item_bias:
            resid = v - biasA[rows]
            s = np.bincount(cols, weights=resid if w is None else resid * w,
                            minlength=n)
            biasB = np.divide(s, den_item, out=np.zeros_like(s),
                              where=den_item > 0)
            if nonneg:
                biasB = np.maximum(biasB, 0.0)
        if user_bias:
            resid = v - biasB[cols]
            s = np.bincount(rows, weights=resid if w is None else resid * w,
                            minlength=m)
            biasA = np.divide(s, den_user, out=np.zeros_like(s),
                              where=den_user > 0)
            if nonneg:
                biasA = np.maximum(biasA, 0.0)

    return biasA, biasB


def center_columns(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_cols: int,
    na_as_zero: bool,
    n_rows: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Column-mean centering of sparse side information (center_U /
    center_I; upstream cmfrec src/common.c:4911 center_by_cols).  Under
    NA-as-zero the mean divides by the full row count (missing entries count
    as zeros).  Returns the centered values and the f64 column means."""
    s = np.bincount(cols, weights=vals.astype(np.float64), minlength=n_cols)
    if na_as_zero:
        c = np.full(n_cols, float(n_rows))
    else:
        c = np.bincount(cols, minlength=n_cols).astype(np.float64)
    means = np.divide(s, c, out=np.zeros_like(s), where=c > 0)
    return vals - means[cols].astype(vals.dtype), means
