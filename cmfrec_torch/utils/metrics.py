"""Evaluation metrics of the benchmark protocols (a copy of
cmfrec_tpu/utils/metrics.py, which imports no JAX either).

The reference leaves ranking metrics to the external `recometrics`
library (upstream cmfrec README.md:372-374); its benchmark notebooks use
RMSE (explicit, ML10M) and P@10 / MAP@10 (implicit, LastFM-360K,
upstream cmfrec benchmark/README.md).  These are the same definitions; the
ranking metrics call the model's ``topN``, which scores on its device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def rmse(pred: np.ndarray, truth: np.ndarray,
         weights: Optional[np.ndarray] = None) -> float:
    pred = np.asarray(pred, np.float64)
    truth = np.asarray(truth, np.float64)
    d2 = (pred - truth) ** 2
    if weights is None:
        return float(np.sqrt(d2.mean()))
    w = np.asarray(weights, np.float64)
    return float(np.sqrt((w * d2).sum() / w.sum()))


def _ranked_hits(model, user, test_items, train_items, k):
    exclude = None if train_items is None or not len(train_items) \
        else np.asarray(train_items)
    top = np.asarray(model.topN(user, n=k, exclude=exclude))
    return np.isin(top, np.asarray(test_items)), top


def precision_at_k(model, test_user_items: dict, k: int = 10,
                   train_user_items: Optional[dict] = None) -> float:
    """Mean P@k over test users: |top-k ∩ heldout| / k, excluding each
    user's training items from the candidate pool (the LastFM protocol)."""
    ps = []
    for u, items in test_user_items.items():
        if len(items) == 0:
            continue
        tr = train_user_items.get(u) if train_user_items else None
        hits, _ = _ranked_hits(model, u, items, tr, k)
        ps.append(hits.sum() / k)
    return float(np.mean(ps)) if ps else 0.0


def map_at_k(model, test_user_items: dict, k: int = 10,
             train_user_items: Optional[dict] = None) -> float:
    """Mean average precision at k (truncated AP per user, averaged)."""
    aps = []
    for u, items in test_user_items.items():
        if len(items) == 0:
            continue
        tr = train_user_items.get(u) if train_user_items else None
        hits, _ = _ranked_hits(model, u, items, tr, k)
        if not hits.any():
            aps.append(0.0)
            continue
        prec = np.cumsum(hits) / (np.arange(hits.size) + 1)
        aps.append(float((prec * hits).sum() / min(len(items), k)))
    return float(np.mean(aps)) if aps else 0.0
