"""Prediction and top-N ranking (port of cmfrec_tpu/ops/predict.py).

The reference scores candidates with a gemv then partial-argsorts on the
host (upstream cmfrec src/common.c:5066 predict_multiple, :5127 topN).
Here scoring is one matrix-vector product and ``torch.topk`` on the model's
device; masks carry the include/exclude lists.  Plain torch: the JAX package
runs no hand-written kernel on this path either.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def predict_pairs(A, B, rows, cols, biasA=None, biasB=None,
                  glob_mean: float = 0.0):
    """Batched <a_row, b_col> + biases + mean at arbitrary (row, col) pairs
    (the reference's predict_multiple, upstream cmfrec src/common.c:5066)."""
    p = torch.einsum("nk,nk->n", A[rows], B[cols])
    if biasA is not None:
        p = p + biasA[rows]
    if biasB is not None:
        p = p + biasB[cols]
    return p + glob_mean


def score_items(a_vec, B, biasB=None, glob_mean: float = 0.0,
                a_bias: float = 0.0):
    s = B @ a_vec
    if biasB is not None:
        s = s + biasB
    return s + (glob_mean + a_bias)


def topn(a_vec, B, n_top: int = 10, biasB=None, glob_mean: float = 0.0,
         a_bias: float = 0.0, include: Optional[np.ndarray] = None,
         exclude: Optional[np.ndarray] = None):
    """Rank all items for one user-factor vector; returns numpy (indices,
    scores), best first (include/exclude lists as in
    upstream cmfrec src/common.c:5240-5345)."""
    scores = score_items(a_vec, B, biasB, glob_mean, a_bias)
    n = B.shape[0]
    allow = None
    if include is not None:
        allow = torch.zeros(n, dtype=torch.bool, device=B.device)
        allow[torch.as_tensor(include, device=B.device)] = True
        n_top = min(n_top, len(include))
    elif exclude is not None:
        allow = torch.ones(n, dtype=torch.bool, device=B.device)
        allow[torch.as_tensor(exclude, device=B.device)] = False
    if allow is not None:
        scores = torch.where(allow, scores, -torch.inf)
    vals, idx = torch.topk(scores, min(n_top, n))
    return idx.cpu().numpy(), vals.cpu().numpy()
