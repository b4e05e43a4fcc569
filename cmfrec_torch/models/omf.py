"""Offsets models (OMF_explicit, OMF_implicit) and ContentBased (port of
cmfrec_tpu/models/omf.py).

API as cmfrec_tpu's (and the reference's, upstream cmfrec/__init__.py:6039
OMF_explicit, :7122 OMF_implicit, :7689 ContentBased), plus ``device``.
Predictions use the combined matrices Am/Bm; cold factors are the
attribute projection (Am_new = w_user (u C + C_bias)), warm factors add a
ridge offset against Bm (src/offsets.c:538,578;
solvers/warm.py::offsets_warm_batch, in the model's dtype).  The
attribute projections and the scoring run in the model's dtype on the
model's ``device``, from copies of the fitted arrays uploaded once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype, set_handle_interrupt
from ..solvers import offsets as offsets_solver
from ..solvers import warm
from ..solvers.drivers import implicit_values
from ..utils import profiling
from .base import _BaseModel


def _top_of(scores, n, output_score):
    """The n best of a device score vector as numpy (indices, scores)."""
    vals, idx = torch.topk(scores, min(n, scores.shape[0]))
    idx, vals = idx.cpu().numpy(), vals.cpu().numpy()
    return (idx, vals) if output_score else idx


class _OMFBase(_BaseModel):
    @property
    def _xA(self):
        return self.Am_

    @property
    def _xB(self):
        return self.Bm_

    def _device_x_factors(self):
        return self._on_device("Am_"), self._on_device("Bm_")

    def _device_xB(self):
        return self._on_device("Bm_")

    def _store(self, res):
        with profiling.span("cmfrec.finish"):
            self.A_ = res.get("A")
            self.B_ = res.get("B")
            self.C_ = res.get("C")
            self.D_ = res.get("D")
            self.C_bias_ = res.get("C_bias")
            self.D_bias_ = res.get("D_bias")
            self.Am_ = res["Am"] if "Am" in res else None
            self.Bm_ = res.get("Bm")
            self.user_bias_ = res.get("biasA")
            self.item_bias_ = res.get("biasB")
            self.glob_mean_ = res.get("glob_mean", 0.0)
            self.U_colmeans_ = res.get("U_colmeans")
            self.I_colmeans_ = res.get("I_colmeans")
            self.niter_ = res.get("niter")
            self.is_fitted_ = True
            self._build_dicts()
            if self.Bm_ is not None:
                self.force_precompute_for_predictions()

    def force_precompute_for_predictions(self):
        """The Bm-space caches of the warm solves (precompute_offsets_both,
        upstream cmfrec src/offsets.c:870)."""
        self._precomputed = warm.build_precomputed_offsets(self)
        return self

    def _attr_mat(self, M, colmeans, C, C_bias, w):
        """Attribute rows [R, p] (NaN = missing) -> w (M C + C_bias) [R, kCD]
        on the device (``C``, ``C_bias``, ``colmeans``: attribute names)."""
        dev = resolve_device(self.device)
        M = np.asarray(M, np.float64)
        if M.ndim == 1:
            M = M[None, :]
        Md = torch.as_tensor(M, dtype=self._torch_dtype, device=dev)
        if getattr(self, colmeans) is not None:
            Md = Md - self._on_device(colmeans)[None, :]
        out = w * (torch.nan_to_num(Md, nan=0.0) @ self._on_device(C))
        if getattr(self, C_bias) is not None:
            out = out + w * self._on_device(C_bias)[None, :]
        return out

    def _user_attrs(self, U):
        return self._attr_mat(U, "U_colmeans_", "C_", "C_bias_",
                              getattr(self, "w_user", 1.0))

    def _item_attrs(self, I):
        return self._attr_mat(I, "I_colmeans_", "D_", "D_bias_",
                              getattr(self, "w_item", 1.0))

    def _widen(self, uc, width):
        """Projection rows [R, k_sec + k] -> [R, width], zeros beyond."""
        out = uc.new_zeros(uc.shape[0], width)
        out[:, :getattr(self, "k_sec", 0) + self.k] = uc
        return out

    @staticmethod
    def _dense_attr(U, U_col, U_val, p):
        """One attribute row as dense [p]; from U_col/U_val the missing
        entries are 0 (as cmfrec_tpu builds it)."""
        if U is None and U_col is None:
            raise ValueError("Must pass side info")
        if U is None:
            u = np.zeros(p)
            u[np.asarray(U_col, np.int64)] = np.asarray(U_val, np.float64)
            return u
        return np.asarray(U, np.float64).ravel()

    def _cold_dev(self, U=None, U_col=None, U_val=None):
        self._check_fitted()
        u = self._dense_attr(U, U_col, U_val, np.asarray(self.C_).shape[0])
        return self._widen(self._user_attrs(u), np.asarray(self.Am_).shape[1])

    def factors_cold(self, U=None, U_col=None, U_val=None):
        """The Am row of a new user from attributes only (upstream cmfrec
        src/offsets.c:538): a zero free offset."""
        return self._cold_dev(U, U_col, U_val)[0].cpu().numpy()

    def _score(self, i, a, bias=0.0):
        """Bm[i] . a (one row a, or one a item) + mean + item bias, on the
        device."""
        dev = resolve_device(self.device)
        it = torch.as_tensor(i, device=dev)
        B = self._on_device("Bm_")[it]
        p = (B @ a if a.ndim == 1 else torch.sum(a * B, dim=1))
        p = p + self.glob_mean_ + bias
        if self.item_bias_ is not None:
            p = p + self._on_device("item_bias_")[it]
        return p.cpu().numpy()

    def predict_cold(self, items, U=None, U_col=None, U_val=None):
        return self._score(self._item_rows(items),
                           self._cold_dev(U, U_col, U_val)[0])

    def topN_cold(self, n=10, U=None, U_col=None, U_val=None,
                  include=None, exclude=None, output_score=False):
        return self._topN_vec(self._cold_dev(U, U_col, U_val)[0], 0.0, n,
                              include, exclude, output_score)

    def _cold_multiple_dev(self, U):
        return self._widen(self._user_attrs(U), np.asarray(self.Am_).shape[1])

    def factors_cold_multiple(self, U=None):
        """Am rows of many new users from attributes (upstream
        cmfrec/__init__.py:5944, factors_cold batched)."""
        return self._cold_multiple_dev(U).cpu().numpy()

    def item_factors_cold(self, I=None, I_col=None, I_val=None):
        """The Bm row of a new item from its attributes (the D-side dual;
        upstream cmfrec/__init__.py:5965)."""
        self._check_fitted()
        if self.D_ is None:
            raise ValueError("Model was fit without item side info")
        i_vec = (I if I is not None else
                 self._dense_attr(None, I_col, I_val,
                                  np.asarray(self.D_).shape[0]))
        bm = self._widen(self._item_attrs(i_vec), np.asarray(self.Bm_).shape[1])
        return bm[0].cpu().numpy()

    def predict_cold_multiple(self, item, U=None):
        """(new user attributes, existing item) pairs (upstream
        cmfrec/__init__.py:5994)."""
        return self._score(self._item_rows(item), self._cold_multiple_dev(U))

    def _new_items_dev(self, I):
        return self._widen(self._item_attrs(I), np.asarray(self.Bm_).shape[1])

    def predict_new(self, user, I=None):
        """(existing user, new item attributes) pairs (upstream
        cmfrec/__init__.py:6013)."""
        B_new = self._new_items_dev(I)
        u, _ = self._map_ids(user, self.user_mapping_, "user")
        ut = torch.as_tensor(np.atleast_1d(u), device=B_new.device)
        p = torch.sum(self._on_device("Am_")[ut] * B_new, dim=1)
        p = p + self.glob_mean_
        if self.user_bias_ is not None:
            p = p + self._on_device("user_bias_")[ut]
        return p.cpu().numpy()

    def topN_new(self, user, I=None, n=10, output_score=False):
        """Rank new items (attributes I) for an existing user (upstream
        cmfrec/__init__.py:5862)."""
        B_new = self._new_items_dev(I)
        u, _ = self._map_ids(user, self.user_mapping_, "user")
        scores = B_new @ self._on_device("Am_")[int(u)] + self.glob_mean_
        if self.user_bias_ is not None:
            scores = scores + float(np.asarray(self.user_bias_)[int(u)])
        return _top_of(scores, n, output_score)

    def _pack_dense_rows(self, X, W=None):
        """Dense [R, n] X with NaN = missing -> padded idx/val/weight."""
        X = np.asarray(X, np.float64)
        rows, cols = np.nonzero(np.isfinite(X))
        vals = X[rows, cols]
        wgt = None if W is None else np.asarray(W, np.float64)[rows, cols]
        return warm.pack_padded_rows(rows, cols, vals, wgt, X.shape[0])

    def _warm_base_multiple(self, R, U=None):
        """Attribute-projection base rows of a warm batch (zeros without
        U), on the host."""
        if U is not None and self.C_ is not None:
            return self.factors_cold_multiple(U=U)
        return np.zeros((R, np.asarray(self.Bm_).shape[1]))

    def _warm_offset(self, base, cols, vals, wgt=None, implicit=False,
                     alpha=1.0, return_bias=False, exact=None):
        """One row's warm factors through the batched solver
        (offsets_factors_warm, upstream cmfrec src/offsets.c:578)."""
        cols = np.atleast_1d(np.asarray(cols, np.int64))
        vals = np.atleast_1d(np.asarray(vals, np.float64))
        idx = cols[None, :] if cols.size else np.zeros((1, 1), np.int64)
        vv = vals[None, :] if cols.size else np.zeros((1, 1))
        ww = None
        if wgt is not None and cols.size:
            ww = np.atleast_1d(np.asarray(wgt, np.float64))[None, :]
        counts = np.array([cols.size], np.int64)
        b = None if base is None else np.asarray(base, np.float64)[None, :]
        res = warm.offsets_warm_batch(self, idx, vv, counts, wgt=ww, base=b,
                                      implicit=implicit, alpha=alpha,
                                      return_bias=return_bias, exact=exact)
        if return_bias and not implicit:
            a, bias = res
            return a[0], float(bias[0])
        return res[0]

    def _warm_base(self, U, U_col, U_val):
        if (U is not None or U_col is not None) and self.C_ is not None:
            return self.factors_cold(U=U, U_col=U_col, U_val=U_val)
        return np.zeros(np.asarray(self.Bm_).shape[1])



class OMF_explicit(_OMFBase):
    """Explicit-feedback offsets model (reference: upstream
    cmfrec/__init__.py:6039)."""

    def __init__(self, k=50, lambda_=1e1, method="lbfgs", use_cg=True,
                 user_bias=True, item_bias=True, center=True, k_sec=0,
                 k_main=0, add_intercepts=True, w_user=1.0, w_item=1.0,
                 maxiter=10000, niter=10, parallelize="separate",
                 corr_pairs=7, max_cg_steps=3, precondition_cg=False,
                 finalize_chol=True, NA_as_zero=False, use_float=False,
                 random_state=1, verbose=False, print_every=100,
                 produce_dicts=False, handle_interrupt=True,
                 nthreads=-1, n_jobs=None, exact=False, device="cuda"):
        self.k = k
        self.lambda_ = lambda_
        self.method = method
        self.use_cg = use_cg
        self.user_bias = user_bias
        self.item_bias = item_bias
        self.center = center
        self.k_sec = k_sec
        self.k_main = k_main
        self.add_intercepts = add_intercepts
        self.w_user = w_user
        self.w_item = w_item
        self.maxiter = maxiter
        self.niter = niter
        self.parallelize = parallelize
        self.corr_pairs = corr_pairs
        self.max_cg_steps = max_cg_steps
        self.precondition_cg = precondition_cg
        self.finalize_chol = finalize_chol
        self.NA_as_zero = NA_as_zero
        self.use_float = use_float
        self.random_state = random_state
        self.verbose = verbose
        self.print_every = print_every
        self.produce_dicts = produce_dicts
        self.handle_interrupt = handle_interrupt
        self.nthreads = nthreads
        self.n_jobs = n_jobs
        self.exact = exact
        self.device = device
        self.is_fitted_ = False
        self._validate_offsets_params()

    def _validate_offsets_params(self):
        """_take_params_offsets (upstream cmfrec/__init__.py:313-340)."""
        if self.method not in ("als", "lbfgs"):
            raise ValueError("'method' must be one of 'als' or 'lbfgs'")
        if int(self.k_sec) < 0 or int(self.k_main) < 0:
            raise ValueError("'k_sec'/'k_main' must be non-negative")
        if self.method == "als":
            if self.k_sec > 0 or self.k_main > 0:
                raise ValueError(
                    "'k_sec' and 'k_main' not supported with method='als'."
                )
            if np.atleast_1d(np.asarray(self.lambda_)).size > 1:
                raise ValueError(
                    "Different regularization for each parameter is not "
                    "supported with method='als'."
                )
            if self.w_user != 1.0 or self.w_item != 1.0:
                raise ValueError(
                    "'w_user' and 'w_item' are not supported with "
                    "method='als'."
                )

    @profiling.recorded_fit
    def fit(self, X, U=None, I=None, W=None, mesh=None):
        self._validate_offsets_params()
        set_handle_interrupt(bool(self.handle_interrupt))
        self._reset()
        self.dtype_ = resolve_dtype(self.use_float)
        rows, cols, vals, wgt, m, n = self._ingest_X(X, W)
        side_U = self._ingest_side(U, self.user_mapping_, m, "U")
        side_I = self._ingest_side(I, self.item_mapping_, n, "I")
        if self.method == "lbfgs" or self.exact or self.k_sec or self.k_main:
            res = offsets_solver.fit_offsets_explicit_lbfgs(
                rows, cols, vals, m, n, side_U=side_U, side_I=side_I,
                k=self.k, k_sec=self.k_sec, k_main=self.k_main,
                lambda_=self.lambda_, w_user=self.w_user, w_item=self.w_item,
                user_bias=self.user_bias, item_bias=self.item_bias,
                center=self.center, add_intercepts=self.add_intercepts,
                maxiter=self.maxiter, corr_pairs=self.corr_pairs,
                weights=wgt, dtype=self.dtype_, seed=self.random_state,
                verbose=self.verbose, print_every=self.print_every,
                mesh=mesh, device=self.device,
            )
        else:
            res = offsets_solver.fit_offsets_als(
                rows, cols, vals, m, n, side_U=side_U, side_I=side_I,
                implicit=False, k=self.k, lambda_=self.lambda_,
                user_bias=self.user_bias, item_bias=self.item_bias,
                center=self.center, add_intercepts=self.add_intercepts,
                niter=self.niter, use_cg=self.use_cg,
                max_cg_steps=self.max_cg_steps,
                finalize_chol=self.finalize_chol, NA_as_zero=self.NA_as_zero,
                weights=wgt, dtype=self.dtype_, seed=self.random_state,
                verbose=self.verbose, mesh=mesh, device=self.device,
            )
        self._store(res)
        self.fit_stats_ = {key: res.get(key) for key in
                           ("n_evals", "host_syncs", "values")}
        return self

    def factors_warm(self, X=None, X_col=None, X_val=None, W=None,
                     U=None, U_col=None, U_val=None, return_bias=False,
                     return_raw_A=False, exact=None):
        self._check_fitted()
        if X is not None:
            X = np.asarray(X, np.float64).ravel()
            cols = np.nonzero(~np.isnan(X))[0]
            vals = X[cols]
            if W is not None:
                W = np.asarray(W, np.float64).ravel()
                if W.shape[0] == X.shape[0]:
                    W = W[cols]
        else:
            cols = self._item_rows(np.asarray(X_col))
            vals = np.asarray(X_val, np.float64).ravel()
        base = self._warm_base(U, U_col, U_val)
        bias = None
        if return_bias:
            a, bias = self._warm_offset(base, cols, vals, wgt=W,
                                        return_bias=True, exact=exact)
        else:
            a = self._warm_offset(base, cols, vals, wgt=W, exact=exact)
        if return_raw_A:
            # A := Am - w_user U C over the shared coordinates
            # (upstream cmfrec src/offsets.c:732-741,845-847)
            a = (np.asarray(a) - np.asarray(base))[int(self.k_sec):]
        return (a, bias) if return_bias else a

    def predict_warm(self, items, X=None, X_col=None, X_val=None, W=None,
                     U=None, U_col=None, U_val=None):
        a = self.factors_warm(X=X, X_col=X_col, X_val=X_val, W=W, U=U,
                              U_col=U_col, U_val=U_val)
        return self._score(self._item_rows(items), self._to_device(a))

    def topN_warm(self, n=10, X=None, X_col=None, X_val=None, W=None,
                  U=None, U_col=None, U_val=None, include=None,
                  exclude=None, output_score=False):
        a = self.factors_warm(X=X, X_col=X_col, X_val=X_val, W=W, U=U,
                              U_col=U_col, U_val=U_val)
        return self._topN_vec(self._to_device(a), 0.0, n, include, exclude,
                              output_score)

    def factors_warm_multiple(self, X, W=None, U=None):
        """Warm factors of many new users at once: one batched Cholesky
        solve on the device (the reference's loop, upstream
        cmfrec/__init__.py:6771, as one call)."""
        self._check_fitted()
        idx, vv, ww, counts = self._pack_dense_rows(X, W)
        base = self._warm_base_multiple(idx.shape[0], U=U)
        return warm.offsets_warm_batch(self, idx, vv, counts, wgt=ww,
                                       base=base)

    def predict_warm_multiple(self, X, item, W=None, U=None):
        """(new user row i, item[i]) for many users (upstream
        cmfrec/__init__.py:6771)."""
        a = self.factors_warm_multiple(X, W=W, U=U)
        return self._score(self._item_rows(item), self._to_device(a))

    def transform(self, X=None, y=None, U=None, W=None,
                  replace_existing=False):
        """Fill the missing entries of new rows of X (sklearn style;
        upstream cmfrec/__init__.py:7063).  Rows with no observed entries
        fall back to the attribute projection, or zeros."""
        X = np.asarray(X, np.float64)
        a = self._to_device(self.factors_warm_multiple(X, W=W, U=U))
        pred = a @ self._on_device("Bm_").T + self.glob_mean_
        if self.item_bias_ is not None:
            pred = pred + self._on_device("item_bias_")[None, :]
        pred = pred.cpu().numpy().astype(np.float64)
        if replace_existing:
            return pred
        out = X.copy()
        nanmask = np.isnan(out)
        out[nanmask] = pred[nanmask]
        return out


class OMF_implicit(_OMFBase):
    """Implicit-feedback offsets model (reference: upstream
    cmfrec/__init__.py:7122)."""

    def __init__(self, k=50, lambda_=1e0, alpha=1.0, use_cg=True,
                 add_intercepts=True, niter=10, apply_log_transf=False,
                 use_float=False, max_cg_steps=3, precondition_cg=False,
                 finalize_chol=False, random_state=1, verbose=False,
                 produce_dicts=False, handle_interrupt=True,
                 nthreads=-1, n_jobs=None, device="cuda"):
        self.k = k
        self.lambda_ = lambda_
        self.alpha = alpha
        self.use_cg = use_cg
        self.add_intercepts = add_intercepts
        self.niter = niter
        self.apply_log_transf = apply_log_transf
        self.use_float = use_float
        self.max_cg_steps = max_cg_steps
        self.precondition_cg = precondition_cg
        self.finalize_chol = finalize_chol
        self.random_state = random_state
        self.verbose = verbose
        self.produce_dicts = produce_dicts
        self.handle_interrupt = handle_interrupt
        self.nthreads = nthreads
        self.n_jobs = n_jobs
        self.device = device
        self.w_user = 1.0
        self.w_item = 1.0
        self.k_sec = 0
        self.k_main = 0
        self.is_fitted_ = False

    @profiling.recorded_fit
    def fit(self, X, U=None, I=None, mesh=None):
        set_handle_interrupt(bool(self.handle_interrupt))
        self._reset()
        self.dtype_ = resolve_dtype(self.use_float)
        rows, cols, vals, _, m, n = self._ingest_X(X)
        side_U = self._ingest_side(U, self.user_mapping_, m, "U")
        side_I = self._ingest_side(I, self.item_mapping_, n, "I")
        res = offsets_solver.fit_offsets_als(
            rows, cols, vals, m, n, side_U=side_U, side_I=side_I,
            implicit=True, k=self.k, lambda_=self.lambda_, alpha=self.alpha,
            apply_log_transf=self.apply_log_transf,
            add_intercepts=self.add_intercepts, niter=self.niter,
            use_cg=self.use_cg, max_cg_steps=self.max_cg_steps,
            finalize_chol=self.finalize_chol, dtype=self.dtype_,
            seed=self.random_state, verbose=self.verbose, mesh=mesh,
            device=self.device,
        )
        self._store(res)
        self.w_main_multiplier_ = res.get("w_main_multiplier", 1.0)
        return self

    def factors_warm(self, X_col, X_val, U=None, U_col=None, U_val=None,
                     return_raw_A=False):
        self._check_fitted()
        cols = self._item_rows(np.asarray(X_col))
        # values <= 0 under apply_log_transf raise (ROADMAP F4)
        vals = implicit_values(np.asarray(X_val, np.float64).ravel(),
                               self.apply_log_transf)
        base = self._warm_base(U, U_col, U_val)
        a = self._warm_offset(base, cols, vals, implicit=True,
                              alpha=self.alpha)
        if return_raw_A:
            a = np.asarray(a) - np.asarray(base)
        return a

    def predict_warm(self, items, X_col, X_val):
        a = self._to_device(self.factors_warm(X_col, X_val))
        i = torch.as_tensor(self._item_rows(items), device=a.device)
        return (self._on_device("Bm_")[i] @ a).cpu().numpy()

    def topN_warm(self, n=10, X_col=None, X_val=None, U=None, U_col=None,
                  U_val=None, include=None, exclude=None, output_score=False):
        a = self.factors_warm(X_col, X_val, U=U, U_col=U_col, U_val=U_val)
        return self._topN_vec(self._to_device(a), 0.0, n, include, exclude,
                              output_score)

    def factors_warm_multiple(self, X, U=None):
        """WRMF warm factors of many new users at once (X sparse [R, n]):
        one batched confidence-weighted solve on the device."""
        import scipy.sparse as sp

        self._check_fitted()
        Xc = sp.coo_matrix(X)
        vals = implicit_values(Xc.data, self.apply_log_transf)
        idx, vv, _, counts = warm.pack_padded_rows(Xc.row, Xc.col, vals,
                                                   None, Xc.shape[0])
        base = self._warm_base_multiple(idx.shape[0], U=U)
        return warm.offsets_warm_batch(self, idx, vv, counts, base=base,
                                       implicit=True, alpha=float(self.alpha))

    def predict_warm_multiple(self, X, item, U=None):
        """(new user row i, item[i]) for many users (upstream
        cmfrec/__init__.py:7646); X is sparse [R, n]."""
        a = self._to_device(self.factors_warm_multiple(X, U=U))
        i = torch.as_tensor(self._item_rows(item), device=a.device)
        return torch.sum(a * self._on_device("Bm_")[i], dim=1).cpu().numpy()


class ContentBased(_OMFBase):
    """The attribute-only model: Am = U C + Cb, Bm = I D + Db (reference:
    upstream cmfrec/__init__.py:7689, src/offsets.c:3283).  Needs both U
    and I."""

    def __init__(self, k=20, lambda_=1e2, user_bias=False, item_bias=False,
                 add_intercepts=True, maxiter=3000, corr_pairs=3,
                 parallelize="separate", verbose=False, print_every=100,
                 random_state=1, use_float=True, produce_dicts=False,
                 handle_interrupt=True, start_with_ALS=True,
                 nthreads=-1, n_jobs=None, device="cuda"):
        self.k = k
        self.lambda_ = lambda_
        self.user_bias = user_bias
        self.item_bias = item_bias
        self.add_intercepts = add_intercepts
        self.maxiter = maxiter
        self.corr_pairs = corr_pairs
        self.parallelize = parallelize
        self.verbose = verbose
        self.print_every = print_every
        self.random_state = random_state
        self.use_float = use_float
        self.produce_dicts = produce_dicts
        self.handle_interrupt = handle_interrupt
        self.start_with_ALS = start_with_ALS
        self.nthreads = nthreads
        self.n_jobs = n_jobs
        self.device = device
        self.w_user = 1.0
        self.w_item = 1.0
        self.k_main = 0
        self.is_fitted_ = False

    @property
    def k_sec(self):
        return self.k

    @profiling.recorded_fit
    def fit(self, X, U, I, W=None, mesh=None):
        if U is None or I is None:
            raise ValueError("ContentBased requires both U and I")
        set_handle_interrupt(bool(self.handle_interrupt))
        self._reset()
        self.dtype_ = resolve_dtype(self.use_float)
        rows, cols, vals, wgt, m, n = self._ingest_X(X, W)
        side_U = self._ingest_side(U, self.user_mapping_, m, "U")
        side_I = self._ingest_side(I, self.item_mapping_, n, "I")
        init = None
        if self.start_with_ALS:
            als = offsets_solver.fit_offsets_als(
                rows, cols, vals, m, n, side_U=side_U, side_I=side_I,
                implicit=False, k=self.k, lambda_=self.lambda_,
                user_bias=self.user_bias, item_bias=self.item_bias,
                center=True, add_intercepts=self.add_intercepts,
                niter=5, weights=wgt, dtype=self.dtype_,
                seed=self.random_state, verbose=False, mesh=mesh,
                device=self.device,
            )
            init = {"C": als["C"], "D": als["D"]}
            if als.get("C_bias") is not None:
                init["C_bias"] = als["C_bias"]
            if als.get("D_bias") is not None:
                init["D_bias"] = als["D_bias"]
        res = offsets_solver.fit_offsets_explicit_lbfgs(
            rows, cols, vals, m, n, side_U=side_U, side_I=side_I,
            k=0, k_sec=self.k, k_main=0, lambda_=self.lambda_,
            user_bias=self.user_bias, item_bias=self.item_bias,
            center=True, add_intercepts=self.add_intercepts,
            maxiter=self.maxiter, corr_pairs=self.corr_pairs,
            weights=wgt, dtype=self.dtype_, seed=self.random_state,
            verbose=self.verbose, print_every=self.print_every,
            init_params=init, mesh=mesh, device=self.device,
        )
        self._store(res)
        self.fit_stats_ = {key: res.get(key) for key in
                           ("n_evals", "host_syncs", "values")}
        return self

    def _attrs_to_factors(self, M, colmeans, C, C_bias):
        return self._attr_mat(M, colmeans, C, C_bias, 1.0)

    def predict_new(self, U, I):
        """Predictions for wholly new (user, item) pairs from their
        attributes (upstream cmfrec/__init__.py:8073)."""
        self._check_fitted()
        am = self._attrs_to_factors(U, "U_colmeans_", "C_", "C_bias_")
        bm = self._attrs_to_factors(I, "I_colmeans_", "D_", "D_bias_")
        return (torch.sum(am * bm, dim=1) + self.glob_mean_).cpu().numpy()

    def factors_multiple(self, U=None):
        return self._attrs_to_factors(U, "U_colmeans_", "C_",
                                      "C_bias_").cpu().numpy()

    def topN_new(self, n=10, U=None, U_col=None, U_val=None, I=None,
                 include=None, exclude=None, output_score=False):
        """Rank new items (attributes I) for a new user (attributes U)."""
        a = self._cold_dev(U, U_col, U_val)[0]
        if I is not None:
            bm = self._attrs_to_factors(I, "I_colmeans_", "D_", "D_bias_")
            return _top_of(bm @ a + self.glob_mean_, n, output_score)
        return self._topN_vec(a, 0.0, n, include, exclude, output_score)
