"""MostPopular — the intercepts-only baseline (port of
cmfrec_tpu/models/most_popular.py; reference: upstream
cmfrec/__init__.py:8302, fit math src/common.c:5371,5703).

Explicit: biases by the shrunken-mean closed forms (alternating with user
biases when asked).  Implicit: biasB[j] = alpha S_j / (alpha S_j + (m -
cnt_j) + lam) with S_j the sum of (x + 1) over j's observations
(src/common.c:5804-5809), the k = 0 WRMF solution.  The fit's sums run on
the model's ``device`` in float64, as cmfrec_tpu's NumPy does; ``predict``
and ``topN`` score there too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..solvers import preprocess, warm
from .base import _BaseModel

F64 = torch.float64


def _bincount(idx, minlength, weights=None):
    """np.bincount on the device, float64."""
    if weights is None:
        weights = torch.ones(idx.shape[0], dtype=F64, device=idx.device)
    return torch.zeros(minlength, dtype=F64, device=idx.device).index_add_(
        0, idx, weights)


def _divide(s, den):
    """s / den where den > 0, else 0."""
    return torch.where(den > 0, s / torch.where(den > 0, den, 1.0), 0.0)


class MostPopular(_BaseModel):
    def __init__(self, implicit=False, center=True, user_bias=False,
                 lambda_=1e1, alpha=1.0, NA_as_zero=False, scale_lam=False,
                 scale_bias_const=False, apply_log_transf=False,
                 use_float=False, produce_dicts=False, nthreads=-1,
                 n_jobs=None, device="cuda"):
        self.implicit = implicit
        self.center = center
        self.user_bias = user_bias
        self.lambda_ = lambda_
        self.alpha = alpha
        self.NA_as_zero = NA_as_zero
        self.scale_lam = scale_lam
        self.scale_bias_const = scale_bias_const
        self.apply_log_transf = apply_log_transf
        self.use_float = use_float
        self.produce_dicts = produce_dicts
        self.nthreads = nthreads
        self.n_jobs = n_jobs
        self.device = device
        self.k = 0
        self.k_user = 0
        self.k_item = 0
        self.is_fitted_ = False
        if implicit and scale_lam:
            raise ValueError("'scale_lam' not supported for implicit-feedback.")
        if (not implicit) and apply_log_transf:
            raise ValueError(
                "Option 'apply_log_transf' only available for 'implicit=True'."
            )

    def fit(self, X, W=None):
        self._reset()
        self.dtype_ = resolve_dtype(self.use_float)
        rows, cols, vals, wgt, m, n = self._ingest_X(X, W)
        dev = resolve_device(self.device)
        lam = np.atleast_1d(np.asarray(self.lambda_, np.float64))
        lam_user = float(lam[0])
        lam_item = float(lam[1] if lam.size == 6 else lam[0])
        r = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
        c = torch.as_tensor(np.asarray(cols, np.int64), device=dev)

        def up(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)

        if self.implicit:
            v = up(vals)
            if self.apply_log_transf:
                v = torch.log(v)
            cnt = _bincount(c, n)
            S = _bincount(c, n, v + 1.0)
            a = self.alpha
            self.item_bias_ = ((a * S) / (a * S + (m - cnt) + lam_item)
                               ).cpu().numpy()
            self.user_bias_ = None
            self.glob_mean_ = 0.0
        else:
            biasA, biasB, glob_mean = self._explicit_biases(
                r, c, up(vals), None if wgt is None else up(wgt), m, n,
                lam_user, lam_item, vals, wgt)
            self.item_bias_ = biasB.cpu().numpy()
            self.user_bias_ = (biasA.cpu().numpy()
                               if self.user_bias and biasA is not None
                               else None)
            self.glob_mean_ = float(glob_mean)

        self.A_ = np.zeros((m, 0), self.dtype_)
        self.B_ = np.zeros((n, 0), self.dtype_)
        self.is_fitted_ = True
        return self

    def _explicit_biases(self, r, c, v, w, m, n, lam_user, lam_item,
                         vals_np, wgt_np):
        """(biasA or None, biasB, glob_mean): cmfrec_tpu's four branches
        (NA_as_zero; alternating user and item biases; item biases only),
        float64 on the device."""
        glob_mean = (preprocess.weighted_global_mean(vals_np, wgt_np)
                     if self.center else 0.0)
        if self.NA_as_zero and self.center:
            # the mean over all m*n cells (unobserved = 0), as the
            # factorization drivers take it (common.c:3513)
            wsum = (float(len(vals_np)) if wgt_np is None
                    else float(np.sum(wgt_np)))
            glob_mean *= wsum / (wsum + float(m) * float(n)
                                 - float(len(vals_np)))
        vals_c = v - glob_mean
        scale_lam = self.scale_lam
        # per-entity observation counts or weight sums
        cA = _bincount(r, m, w)
        cB = _bincount(c, n, w)
        if scale_lam and self.scale_bias_const:
            # constant scaling: lam times the mean count (or weight sum);
            # per-entity scaling then turns off (common.c:5896-5925)
            lam_user *= float(torch.mean(cA))
            lam_item *= float(torch.mean(cB))
            scale_lam = False
        wv = vals_c if w is None else vals_c * w
        if self.NA_as_zero:
            # every unobserved cell takes part as a zero of unit weight
            # (initialize_biases_twosided NA_as_zero, common.c:4447)
            cntA = _bincount(r, m)
            cntB = _bincount(c, n)
            wsA = cA + (float(n) - cntA)
            wsB = cB + (float(m) - cntB)
            dB = wsB + lam_item * (wsB if scale_lam else 1.0)
            dA = wsA + lam_user * (wsA if scale_lam else 1.0)
            sB0 = _bincount(c, n, wv) - glob_mean * (float(m) - cntB)
            sA0 = _bincount(r, m, wv) - glob_mean * (float(n) - cntA)
            biasA = torch.zeros(m, dtype=F64, device=r.device)
            biasB = torch.zeros(n, dtype=F64, device=r.device)
            for _ in range(6 if self.user_bias else 1):
                # TB_j = sum_i w_ij biasA_i over all i (w = 1 on the zeros)
                TB = biasA.sum()
                if w is not None:
                    TB = TB + _bincount(c, n, (w - 1.0) * biasA[r])
                biasB = (sB0 - TB) / dB
                if not self.user_bias:
                    break
                TA = biasB.sum()
                if w is not None:
                    TA = TA + _bincount(r, m, (w - 1.0) * biasB[c])
                biasA = (sA0 - TA) / dA
            return (biasA if self.user_bias else None), biasB, glob_mean
        if self.user_bias:
            # fit_most_popular_internal: biases start at zero and run six
            # alternating passes, items first (common.c:5928-5932)
            biasA = torch.zeros(m, dtype=F64, device=r.device)
            denB = cB + lam_item * (cB if scale_lam else 1.0)
            denA = cA + lam_user * (cA if scale_lam else 1.0)
            for _ in range(6):
                resB = vals_c - biasA[r]
                biasB = _divide(_bincount(c, n, resB if w is None
                                          else resB * w), denB)
                resA = vals_c - biasB[c]
                biasA = _divide(_bincount(r, m, resA if w is None
                                          else resA * w), denA)
            return biasA, biasB, glob_mean
        # one shrunken-mean pass for the item biases
        # (initialize_biases_onesided, common.c:4130)
        den = cB + lam_item * (torch.clamp(cB, min=1.0) if scale_lam else 1.0)
        return None, _divide(_bincount(c, n, wv), den), glob_mean

    def _bias_dev(self, name):
        """A fitted bias vector, float64 on the device."""
        return warm._dev(self, name, getattr(self, name), dtype=np.float64)

    def predict(self, user, item):
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")
        i, scalar = self._map_ids(item, self.item_mapping_, "item")
        dev = resolve_device(self.device)
        i = torch.as_tensor(np.atleast_1d(i), device=dev)
        p = self._bias_dev("item_bias_")[i] + self.glob_mean_
        if self.user_bias_ is not None:
            u, _ = self._map_ids(user, self.user_mapping_, "user")
            p = p + self._bias_dev("user_bias_")[
                torch.as_tensor(np.atleast_1d(u), device=dev)]
        p = p.cpu().numpy()
        return float(p[0]) if scalar else p

    def topN(self, user=None, n=10, include=None, exclude=None,
             output_score=False):
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")
        dev = resolve_device(self.device)
        scores = self._bias_dev("item_bias_") + self.glob_mean_
        if include is not None:
            inc, _ = self._map_ids(include, self.item_mapping_, "item")
            mask = torch.zeros(scores.shape[0], dtype=torch.bool, device=dev)
            mask[torch.as_tensor(np.atleast_1d(inc), device=dev)] = True
            scores = torch.where(mask, scores, -torch.inf)
        elif exclude is not None:
            exc, _ = self._map_ids(exclude, self.item_mapping_, "item")
            scores = scores.clone()
            scores[torch.as_tensor(np.atleast_1d(exc), device=dev)] = -torch.inf
        vals, idx = torch.topk(scores, min(n, scores.shape[0]))
        idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
        items = self._unmap_items(idx)
        return (items, vals) if output_score else items
