"""CMF — the flagship explicit model (port of cmfrec_tpu/models/cmf.py).

API-compatible with cmfrec_tpu's ``CMF`` (and the reference's class of the
same name, upstream cmfrec/__init__.py:2446): the same constructor
hyperparameters plus ``device``, the same fitted attributes, and
fit/predict/topN/save/load and the warm and cold serving surface
(factors_warm/cold, *_multiple, transform, predict_new, topN_*; the solves
are in solvers/warm.py).  ``CMF_implicit`` (upstream
cmfrec/__init__.py:4358) likewise.  Without side info ``CMF`` fits on the
dense-masked engine unless the data needs the bucketed one, and
``CMF_implicit`` on the bucketed one (``drivers.fit_implicit_als(...,
engine="dense")`` runs a plain implicit fit on the dense-masked engine).
With side info (``U=``, ``I=``), k splits or implicit features both run
the collective fits of solvers/collective.py: fully dense side info on the
dense-masked engine, the rest (sparse or partial side info, side-info-only
entities, k splits, ``w_main``, the ``NA_as_zero*`` options, weighted
implicit features) on the bucketed collective route.  ``method="lbfgs"``
fits the joint objective by L-BFGS (solvers/lbfgs.py), binary side info
(``U_bin``, ``I_bin``) included, and serves new rows with binary side info
through one L-BFGS over the rows (warm.factors_bin_batch).  ``nonneg``,
``nonneg_C``, ``nonneg_D`` and ``l1_lambda`` fit and serve by coordinate
descent on every ALS route (``method="lbfgs"`` rejects them, as cmfrec_tpu).
``fit(..., mesh=)`` with a 1-D ``torch.distributed`` DeviceMesh
(parallel/mesh.py) fits data-parallel on every route, each rank solving
its rows and every rank returning the whole model; serving after such a
fit is the ordinary serving on each rank's model.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..config import resolve_device, resolve_dtype, set_handle_interrupt
from ..solvers import collective, drivers, lbfgs, warm
from ..utils import profiling
from .base import _BaseModel

def _route_grouped(rows, m_new, min_rows=256, max_waste=3.0):
    """Serving-batch routing: the degree-grouped warm path when padding
    every row to the batch's largest degree would waste more than
    ``max_waste`` times the entry count (power-law request batches).
    Small or uniform batches keep the plain padded path and its
    full-observation caches."""
    if m_new < min_rows:
        return False
    counts = np.bincount(rows, minlength=m_new)
    waste = m_new * int(counts.max(initial=0)) / max(rows.size, 1)
    return waste > max_waste


def _top_of(scores, n, output_score):
    n = min(n, scores.shape[0])
    idx = np.argpartition(-scores, n - 1)[:n]
    idx = idx[np.argsort(-scores[idx])]
    return (idx, scores[idx]) if output_score else idx


def _check_lambda(lambda_, name="lambda_"):
    arr = np.atleast_1d(np.asarray(lambda_, np.float64))
    if arr.size not in (1, 6):
        raise ValueError(f"'{name}' must be a scalar or an array of size 6")
    if np.any(arr < 0):
        raise ValueError(f"'{name}' must be non-negative")


def _validate_cmf_params(self, implicit=False):
    """Unsupported-combination checks matching the reference's _take_params
    (upstream cmfrec/__init__.py:63-262)."""
    if getattr(self, "method", "als") not in ("als", "lbfgs"):
        raise ValueError("'method' must be one of 'als' or 'lbfgs'")
    if int(self.k) <= 0 and not (self.k_user and self.k_item):
        raise ValueError("'k' must be a positive integer")
    for nm in ("k_user", "k_item", "k_main"):
        if int(getattr(self, nm)) < 0:
            raise ValueError(f"'{nm}' must be non-negative")
    _check_lambda(self.lambda_)
    _check_lambda(self.l1_lambda, "l1_lambda")
    if int(self.niter) < 0:
        raise ValueError("'niter' must be non-negative")
    if getattr(self, "method", "als") == "lbfgs":
        if (getattr(self, "NA_as_zero", False) or self.NA_as_zero_user
                or self.NA_as_zero_item):
            raise ValueError(
                "Option 'NA_as_zero' not supported with method='lbfgs'.")
        if getattr(self, "add_implicit_features", False):
            raise ValueError(
                "Option 'add_implicit_features' not supported with "
                "method='lbfgs'.")
        if self.nonneg or self.nonneg_C or self.nonneg_D:
            raise ValueError(
                "non-negativity constraints not supported with "
                "method='lbfgs'.")
        if getattr(self, "scale_lam", False) or getattr(
                self, "scale_lam_sideinfo", False):
            raise ValueError("'scale_lam' not supported with method='lbfgs'.")
        if np.any(np.atleast_1d(np.asarray(self.l1_lambda,
                                           np.float64)) != 0.0):
            raise ValueError(
                "L1 regularization not supported with method='lbfgs'.")
    elif int(self.max_cg_steps) <= 0:
        raise ValueError("'max_cg_steps' must be a positive integer")
    if implicit and float(self.alpha) <= 0:
        raise ValueError("'alpha' must be positive")
    if getattr(self, "center", False) and self.nonneg:
        warnings.warn(
            "Warning: will fit a model with centering and non-negativity "
            "constraints."
        )


_host = profiling.to_host


class CMF(_BaseModel):
    """Collective matrix factorization with explicit feedback.

    Model: X ~ A B^T (+ biases + mean).  ``device`` ("cuda" by default)
    is where the fit and the predict/topN scoring run.
    """

    _supports_extra_side_rows = True  # m_u > m via the collective fits

    _unknown_pred_mean = True  # unknown ids -> mean+biases (reference note)

    def __init__(self, k=40, lambda_=1e1, method="als", use_cg=True,
                 user_bias=True, item_bias=True, center=True,
                 add_implicit_features=False,
                 scale_lam=False, scale_lam_sideinfo=False,
                 scale_bias_const=False,
                 k_user=0, k_item=0, k_main=0,
                 w_main=1.0, w_user=1.0, w_item=1.0, w_implicit=0.5,
                 l1_lambda=0.0, center_U=True, center_I=True,
                 maxiter=800, niter=10, parallelize="separate", corr_pairs=4,
                 max_cg_steps=3, precondition_cg=False, finalize_chol=True,
                 NA_as_zero=False, NA_as_zero_user=False, NA_as_zero_item=False,
                 nonneg=False, nonneg_C=False, nonneg_D=False, max_cd_steps=100,
                 precompute_for_predictions=True, include_all_X=True,
                 use_float=True,
                 random_state=1, verbose=False, print_every=10,
                 handle_interrupt=True, produce_dicts=False,
                 nthreads=-1, n_jobs=None,
                 checkpoint_path=None, checkpoint_every=0, device="cuda"):
        self.k = k
        self.lambda_ = lambda_
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.method = method
        self.use_cg = use_cg
        self.user_bias = user_bias
        self.item_bias = item_bias
        self.center = center
        self.add_implicit_features = add_implicit_features
        self.scale_lam = scale_lam
        # the reference's Python class couples the flags: scale_lam
        # implies scale_lam_sideinfo (upstream cmfrec/__init__.py:208)
        self.scale_lam_sideinfo = bool(scale_lam_sideinfo) or bool(scale_lam)
        self.scale_bias_const = scale_bias_const
        self.k_user = k_user
        self.k_item = k_item
        self.k_main = k_main
        self.w_main = w_main
        self.w_user = w_user
        self.w_item = w_item
        self.w_implicit = w_implicit
        self.l1_lambda = l1_lambda
        self.center_U = center_U
        self.center_I = center_I
        self.maxiter = maxiter
        self.niter = niter
        self.parallelize = parallelize
        self.corr_pairs = corr_pairs
        self.max_cg_steps = max_cg_steps
        self.precondition_cg = precondition_cg
        self.finalize_chol = finalize_chol
        self.NA_as_zero = NA_as_zero
        self.NA_as_zero_user = NA_as_zero_user
        self.NA_as_zero_item = NA_as_zero_item
        self.nonneg = nonneg
        self.nonneg_C = nonneg_C
        self.nonneg_D = nonneg_D
        self.max_cd_steps = max_cd_steps
        self.precompute_for_predictions = precompute_for_predictions
        self.include_all_X = include_all_X
        self.use_float = use_float
        self.random_state = random_state
        self.verbose = verbose
        self.print_every = print_every
        self.handle_interrupt = handle_interrupt
        self.produce_dicts = produce_dicts
        self.nthreads = nthreads
        self.n_jobs = n_jobs
        self.device = device
        self.is_fitted_ = False
        _validate_cmf_params(self)

    @profiling.recorded_fit
    def fit(self, X, U=None, I=None, U_bin=None, I_bin=None, W=None,
            mesh=None):
        """Fit to explicit-feedback data (reference:
        upstream cmfrec/__init__.py:3066).  ``method="lbfgs"`` fits the
        joint objective by L-BFGS (solvers/lbfgs.py), the only fit that
        takes binary side info (``U_bin``, ``I_bin``).  ``mesh``: a 1-D
        DeviceMesh (parallel/mesh.py:make_mesh, called on every rank with
        the same arguments) fits data-parallel."""
        _validate_cmf_params(self)  # set_params may have changed options
        set_handle_interrupt(bool(self.handle_interrupt))
        self._reset()
        self.dtype_ = resolve_dtype(self.use_float)
        rows, cols, vals, wgt, m, n = self._ingest_X(X, W)
        if self.scale_lam and self.scale_bias_const:
            # the constant bias-penalty scaling = mean observation weight
            # per row/column (common.c:3787 wsum/m)
            wsum = (float(len(vals)) if wgt is None
                    else float(np.sum(wgt)))
            self.scaling_biasA_ = wsum / max(m, 1)
            self.scaling_biasB_ = wsum / max(n, 1)
        if (U_bin is not None or I_bin is not None) and self.method != "lbfgs":
            raise ValueError("Binary side info requires method='lbfgs'")
        if self.method == "lbfgs":
            return self._fit_lbfgs(rows, cols, vals, wgt, m, n, U, I, U_bin,
                                   I_bin, mesh)

        common = dict(
            mesh=mesh, k=self.k, lambda_=self.lambda_,
            l1_lambda=self.l1_lambda, niter=self.niter, use_cg=self.use_cg,
            max_cg_steps=self.max_cg_steps,
            precondition_cg=self.precondition_cg,
            finalize_chol=self.finalize_chol,
            user_bias=self.user_bias, item_bias=self.item_bias,
            center=self.center, scale_lam=self.scale_lam,
            scale_bias_const=self.scale_bias_const,
            NA_as_zero=self.NA_as_zero, nonneg=self.nonneg,
            max_cd_steps=self.max_cd_steps,
            weights=wgt, dtype=self.dtype_, seed=self.random_state,
            verbose=self.verbose,
            checkpoint_path=self.checkpoint_path,
            checkpoint_every=self.checkpoint_every,
            device=self.device,
        )
        if (U is None and I is None and not self.add_implicit_features
                and not (self.k_user or self.k_item or self.k_main)):
            res = drivers.fit_explicit_als(rows, cols, vals, m, n, **common)
        else:
            res = collective.fit_collective_explicit_als(
                rows, cols, vals, m, n,
                side_U=self._ingest_side(U, self.user_mapping_, m, "U"),
                side_I=self._ingest_side(I, self.item_mapping_, n, "I"),
                k_user=self.k_user, k_item=self.k_item, k_main=self.k_main,
                w_main=self.w_main, w_user=self.w_user, w_item=self.w_item,
                w_implicit=self.w_implicit,
                add_implicit_features=self.add_implicit_features,
                center_U=self.center_U, center_I=self.center_I,
                scale_lam_sideinfo=self.scale_lam_sideinfo,
                NA_as_zero_user=self.NA_as_zero_user,
                NA_as_zero_item=self.NA_as_zero_item,
                nonneg_C=self.nonneg_C, nonneg_D=self.nonneg_D, **common)
            self._store_side(res)
            # the bucketed route's side-count-inclusive values
            # (upstream cmfrec src/collective.c:8070)
            for attr, key in (("scaling_biasA_", "scaling_biasA"),
                              ("scaling_biasB_", "scaling_biasB")):
                if res.get(key) is not None:
                    setattr(self, attr, float(res[key]))

        with profiling.span("cmfrec.finish"):
            self.A_ = _host(res["A"])
            self.B_ = _host(res["B"])
            self.user_bias_ = _host(res["biasA"])
            self.item_bias_ = _host(res["biasB"])
            self.glob_mean_ = res["glob_mean"]
            self.is_fitted_ = True
            self.niter_ = self.niter
            self._build_dicts()
            if self.precompute_for_predictions:
                self.force_precompute_for_predictions()
        return self

    def _fit_lbfgs(self, rows, cols, vals, wgt, m, n, U, I, U_bin, I_bin,
                   mesh):
        res = lbfgs.fit_collective_explicit_lbfgs(
            rows, cols, vals, m, n,
            side_U=self._ingest_side(U, self.user_mapping_, m, "U"),
            side_I=self._ingest_side(I, self.item_mapping_, n, "I"),
            side_Ub=self._ingest_side(U_bin, self.user_mapping_, m, "U"),
            side_Ib=self._ingest_side(I_bin, self.item_mapping_, n, "I"),
            k=self.k, k_user=self.k_user, k_item=self.k_item,
            k_main=self.k_main, lambda_=self.lambda_,
            w_main=self.w_main, w_user=self.w_user, w_item=self.w_item,
            user_bias=self.user_bias, item_bias=self.item_bias,
            center=self.center, center_U=self.center_U,
            center_I=self.center_I, maxiter=self.maxiter,
            corr_pairs=self.corr_pairs, weights=wgt, dtype=self.dtype_,
            seed=self.random_state, verbose=self.verbose,
            print_every=self.print_every, mesh=mesh, device=self.device)
        for attr in ("A", "B", "C", "D", "Cb", "Db"):
            setattr(self, attr + "_", res[attr])
        self.user_bias_ = res["biasA"]
        self.item_bias_ = res["biasB"]
        self.glob_mean_ = res["glob_mean"]
        self.U_colmeans_ = res["U_colmeans"]
        self.I_colmeans_ = res["I_colmeans"]
        self.nfev_ = res["nfev"]
        self.niter_ = res["niter"]
        self.fit_stats_ = {key: res[key] for key in
                           ("n_evals", "host_syncs", "linesearch_steps",
                            "values")}
        self.is_fitted_ = True
        with profiling.span("cmfrec.finish"):
            self._build_dicts()
            if self.precompute_for_predictions:
                self.force_precompute_for_predictions()
        return self

    # ------------------------------------------------------------------ #
    # warm / cold factors                                                 #
    # ------------------------------------------------------------------ #

    def _bin_rows(self, idx, vals, wgt, lengths, U, U_bin, cold=False):
        """New rows with binary side info: factors_bin_batch's L-BFGS
        (no closed form; upstream cmfrec src/collective.c:1146)."""
        return warm.factors_bin_batch(
            self, idx, vals, wgt, lengths,
            U=None if U is None else np.asarray(U, np.float64),
            U_bin=np.asarray(U_bin, np.float64).reshape(
                np.asarray(lengths).shape[0], -1),
            cold=cold, return_bias=not cold)

    def _bin_warm_row(self, X, X_col, X_val, W, U, U_bin, U_col, U_val):
        cols, vals, wgt = self._new_row_X(X, X_col, X_val, W)
        a, bias = self._bin_rows(cols[None, :], vals[None, :],
                                 None if wgt is None else wgt[None, :],
                                 np.array([len(cols)], np.int64),
                                 self._new_row_U(U, U_col, U_val), U_bin)
        return a[0], float(bias[0])

    def _bin_cold_rows(self, U, U_bin, R):
        return self._bin_rows(np.zeros((R, 0), np.int64), np.zeros((R, 0)),
                              None, np.zeros(R, np.int64), U, U_bin,
                              cold=True)

    def _warm_row(self, X, X_col, X_val, W, U, U_col, U_val):
        """One new user's [1, w + 2] result on the device."""
        cols, vals, wgt = self._new_row_X(X, X_col, X_val, W)
        return warm.factors_explicit_batch(
            self, cols[None, :], vals[None, :],
            None if wgt is None else wgt[None, :],
            np.array([len(cols)], np.int64),
            U=self._new_row_U(U, U_col, U_val), return_device=True)

    def factors_warm(self, X=None, X_col=None, X_val=None, W=None,
                     U=None, U_bin=None, U_col=None, U_val=None,
                     return_bias=False):
        """Latent factors of a new user from their interactions (reference:
        upstream cmfrec/__init__.py:3568).  With binary side info there is
        no closed form: the reference's per-row L-BFGS."""
        self._check_fitted()
        if U_bin is not None:
            a, bias = self._bin_warm_row(X, X_col, X_val, W, U, U_bin, U_col,
                                         U_val)
            return (a, bias) if return_bias else a
        a, bias = warm.download(self._warm_row(X, X_col, X_val, W, U, U_col,
                                               U_val))
        return (a[0], float(bias[0])) if return_bias else a[0]

    def _cold_rows(self, U, R):
        """R new users' [R, w + 2] result from side info alone."""
        return warm.factors_explicit_batch(
            self, np.zeros((R, 0), np.int64), np.zeros((R, 0)), None,
            np.zeros(R, np.int64), U=U, return_device=True)

    def factors_cold(self, U=None, U_bin=None, U_col=None, U_val=None):
        """Factors from side info only (reference:
        upstream cmfrec/__init__.py:3398).  With binary side info: the
        per-row L-BFGS with the k_main coordinates held at zero
        (upstream cmfrec src/collective.c:3412)."""
        self._check_fitted()
        if self.C_ is None and getattr(self, "Cb_", None) is None:
            raise ValueError("Model was fit without user side info")
        if U_bin is not None:
            return self._bin_cold_rows(self._new_row_U(U, U_col, U_val),
                                       U_bin, 1)[0]
        return warm.download(self._cold_rows(
            self._new_row_U(U, U_col, U_val), 1))[0][0]

    def _new_row_X(self, X, X_col, X_val, W):
        if X is not None:
            X = np.asarray(X, np.float64).ravel()
            cols = np.nonzero(~np.isnan(X))[0]
            vals = X[cols]
            wgt = None if W is None else np.asarray(W, np.float64).ravel()[cols]
        else:
            cols, _ = self._map_ids(np.asarray(X_col), self.item_mapping_,
                                    "item")
            cols = np.atleast_1d(cols)
            vals = np.asarray(X_val, np.float64).ravel()
            wgt = None if W is None else np.asarray(W, np.float64).ravel()
        return cols.astype(np.int64), vals, wgt

    def _score_items(self, i, a, bias=0.0):
        """Predictions for items ``i`` from factor rows ``a`` (one row, or
        one a item), on the host as cmfrec_tpu does."""
        B = np.asarray(self._xB)[i]
        a = np.asarray(a)[..., self.k_user:]
        p = (B @ a if a.ndim == 1 else np.sum(a * B, axis=1))
        p = p + self.glob_mean_ + bias
        if self.item_bias_ is not None:
            p = p + np.asarray(self.item_bias_)[i]
        return p

    def predict_warm(self, items, X=None, X_col=None, X_val=None, W=None,
                     U=None, U_bin=None, U_col=None, U_val=None):
        a, bias = self.factors_warm(X=X, X_col=X_col, X_val=X_val, W=W, U=U,
                                    U_bin=U_bin, U_col=U_col, U_val=U_val,
                                    return_bias=True)
        return self._score_items(self._item_rows(items), a, bias)

    def topN_warm(self, n=10, X=None, X_col=None, X_val=None, W=None,
                  U=None, U_bin=None, U_col=None, U_val=None,
                  include=None, exclude=None, output_score=False):
        self._check_fitted()
        if U_bin is not None:
            a, bias = self._bin_warm_row(X, X_col, X_val, W, U, U_bin, U_col,
                                         U_val)
            return self._topN_vec(self._to_device(a[self.k_user:]), bias, n,
                                  include, exclude, output_score)
        out = self._warm_row(X, X_col, X_val, W, U, U_col, U_val)
        return self._topN_row(out, n, include, exclude, output_score)

    def topN_cold(self, n=10, U=None, U_bin=None, U_col=None, U_val=None,
                  include=None, exclude=None, output_score=False):
        self._check_fitted()
        if U_bin is not None:
            a = self.factors_cold(U=U, U_bin=U_bin, U_col=U_col, U_val=U_val)
            return self._topN_vec(self._to_device(a[self.k_user:]), 0.0, n,
                                  include, exclude, output_score)
        if self.C_ is None:
            raise ValueError("Model was fit without user side info")
        # a cold user is ranked without a bias, as cmfrec_tpu does
        return self._topN_row(
            self._cold_rows(self._new_row_U(U, U_col, U_val), 1), n, include,
            exclude, output_score, with_bias=False)

    def predict_cold(self, items, U=None, U_bin=None, U_col=None, U_val=None):
        a = self.factors_cold(U=U, U_bin=U_bin, U_col=U_col, U_val=U_val)
        return self._score_items(self._item_rows(items), a)

    def predict_cold_multiple(self, item, U=None, U_bin=None):
        """Predict for many (new user, existing item) pairs (reference:
        upstream cmfrec/__init__.py:3291)."""
        self._check_fitted()
        if U_bin is not None:
            a = self._bin_cold_rows(U, U_bin, np.asarray(U_bin).shape[0])
            return self._score_items(self._item_rows(item), a)
        U = np.asarray(U, np.float64)
        a, _ = warm.download(self._cold_rows(U, U.shape[0]))
        return self._score_items(self._item_rows(item), a)

    def _new_items(self, I):
        """Factors (and biases) of new items from their side info, through
        the swapped model: (b [R, w], bias [R])."""
        I = np.asarray(I, np.float64)
        if I.ndim == 1:
            I = I[None, :]
        sw = self.swap_users_and_items(precompute=False)
        return warm.download(sw._cold_rows(I, I.shape[0]))

    def item_factors_cold(self, I=None, I_bin=None, I_col=None, I_val=None):
        """Factors of a new item from its side info (reference: upstream
        cmfrec/__init__.py:3434): factors_cold of the swapped model,
        solved against D."""
        self._check_fitted()
        if self.D_ is None and getattr(self, "Db_", None) is None:
            raise ValueError("Model was fit without item side info")
        return self.swap_users_and_items(precompute=False).factors_cold(
            U=I, U_bin=I_bin, U_col=I_col, U_val=I_val)

    def predict_new(self, user, I=None, I_bin=None):
        """Predict for (existing user, new item given side info) pairs
        (reference: upstream cmfrec/__init__.py:3472).  ``I_bin`` is
        accepted and, as in cmfrec_tpu, not used."""
        self._check_fitted()
        b, _ = self._new_items(I)
        u, _ = self._map_ids(user, self.user_mapping_, "user")
        u = np.atleast_1d(u)
        p = np.sum(np.asarray(self._xA)[u] * b[:, self.k_item:], axis=1)
        p = p + self.glob_mean_
        if self.user_bias_ is not None:
            p = p + np.asarray(self.user_bias_)[u]
        return p

    def topN_new(self, user, I=None, I_bin=None, n=10, output_score=False):
        """Rank a pool of new items (given their side info) for an existing
        user (reference: upstream cmfrec/__init__.py:3511).  ``I_bin`` is
        accepted and, as in cmfrec_tpu, not used."""
        self._check_fitted()
        b, _ = self._new_items(I)
        u, _ = self._map_ids(user, self.user_mapping_, "user")
        scores = b[:, self.k_item:] @ np.asarray(self._xA)[int(u)]
        scores = scores + self.glob_mean_
        if self.user_bias_ is not None:
            scores = scores + float(self.user_bias_[int(u)])
        return _top_of(scores, n, output_score)

    def factors_multiple(self, X=None, U=None, U_bin=None, W=None,
                         return_bias=False):
        """Warm factors of many new users at once (reference: upstream
        cmfrec/__init__.py:3706): power-law batches through the
        degree-grouped route (``_route_grouped``), the others padded to
        their largest degree; one download either way.  With binary side
        info: factors_bin_batch's L-BFGS over all the rows."""
        self._check_fitted()
        U = None if U is None else np.asarray(U, np.float64)
        if U_bin is not None:
            a, bias = self._bin_rows(*self._pack_new_rows(X, W, U), U, U_bin)
            return (a, bias) if return_bias else a
        if X is not None:
            rows, cols, vals, wgt, m_new, _ = self._ingest_X_new(X, W)
            if _route_grouped(rows, m_new):
                a, bias = warm.factors_explicit_grouped(
                    self, rows, cols, vals, wgt, m_new, U=U)
                return (a, bias) if return_bias else a
            idx, vv, ww, counts = warm.pack_padded_rows(rows, cols, vals,
                                                        wgt, m_new)
        else:
            idx, vv, ww, counts = self._pack_new_rows(X, W, U)
        a, bias = warm.factors_explicit_batch(self, idx, vv, ww, counts, U=U)
        return (a, bias) if return_bias else a

    def _pack_new_rows(self, X, W, U):
        """New users' interactions -> padded [R, L] idx / value / weight."""
        if X is None:
            m_new = np.asarray(U).shape[0] if U is not None else 0
            return (np.zeros((m_new, 0), np.int64), np.zeros((m_new, 0)),
                    None, np.zeros(m_new, np.int64))
        rows, cols, vals, wgt, m_new, _ = self._ingest_X_new(X, W)
        return warm.pack_padded_rows(rows, cols, vals, wgt, m_new)

    def predict_warm_multiple(self, X, item, W=None, U=None, U_bin=None):
        """Predict (new user row i, item[i]) for many new users at once
        (reference: upstream cmfrec/__init__.py:3654)."""
        a, bias = self.factors_multiple(X=X, U=U, U_bin=U_bin, W=W,
                                        return_bias=True)
        i = self._item_rows(item)
        if i.shape[0] != a.shape[0]:
            raise ValueError("item must have one entry per row of X")
        return self._score_items(i, a, bias)

    def transform(self, X=None, y=None, U=None, U_bin=None, W=None,
                  replace_existing=False):
        """Fill the missing entries of new rows of X with predictions
        (sklearn style; reference: upstream cmfrec/__init__.py:4027)."""
        X = np.asarray(X, np.float64)
        a, bias = self.factors_multiple(X=X, U=U, U_bin=U_bin, W=W,
                                        return_bias=True)
        pred = a[:, self.k_user:] @ np.asarray(self._xB).T + self.glob_mean_
        pred = pred + bias[:, None]
        if self.item_bias_ is not None:
            pred = pred + np.asarray(self.item_bias_)[None, :]
        if replace_existing:
            return pred
        out = X.copy()
        nan = np.isnan(out)
        out[nan] = pred[nan]
        return out

    def force_precompute_for_predictions(self):
        """Build the prediction caches (warm.build_precomputed)."""
        self._precomputed = warm.build_precomputed(self)
        return self

    @staticmethod
    def from_model_matrices(A, B, glob_mean=0.0, precompute=True,
                            user_bias=None, item_bias=None,
                            lambda_=1e1, scale_lam=False, l1_lambda=0.0,
                            nonneg=False, NA_as_zero=False,
                            scaling_biasA=None, scaling_biasB=None,
                            use_float=True, nthreads=-1, n_jobs=None,
                            device="cuda"):
        """A CMF that serves from existing factor matrices (reference:
        upstream cmfrec/__init__.py:4186).  The arrays are kept in the
        model's dtype (float64 with ``use_float=False``), as cmfrec_tpu
        keeps them."""
        A = np.asarray(A)
        B = np.asarray(B)
        if A.shape[1] != B.shape[1]:
            raise ValueError("A and B must have the same number of columns")
        model = CMF(k=A.shape[1], lambda_=lambda_, scale_lam=scale_lam,
                    l1_lambda=l1_lambda, nonneg=nonneg, NA_as_zero=NA_as_zero,
                    user_bias=user_bias is not None,
                    item_bias=item_bias is not None, use_float=use_float,
                    device=device)
        _adopt(model, A, B, glob_mean)
        model.user_bias_ = None if user_bias is None else np.asarray(
            user_bias, model.dtype_)
        model.item_bias_ = None if item_bias is None else np.asarray(
            item_bias, model.dtype_)
        if scaling_biasA is not None:
            model.scale_bias_const = True
            model.scaling_biasA_ = float(scaling_biasA)
        if scaling_biasB is not None:
            model.scale_bias_const = True
            model.scaling_biasB_ = float(scaling_biasB)
        if precompute:
            model.force_precompute_for_predictions()
        return model


def _adopt(model, A, B, glob_mean):
    """A fresh model takes A and B, in the dtype its ``use_float`` names,
    as its fitted factors."""
    model._reset()
    model.dtype_ = resolve_dtype(model.use_float)
    model.A_ = np.asarray(A, model.dtype_)
    model.B_ = np.asarray(B, model.dtype_)
    model.glob_mean_ = float(glob_mean)
    model._m_orig, model._n_orig = model.A_.shape[0], model.B_.shape[0]
    model.is_fitted_ = True


class CMF_implicit(_BaseModel):
    """Implicit-feedback WRMF/iALS (reference: upstream
    cmfrec/__init__.py:4358).  ``device`` ("cuda" by default) is where the
    fit and the predict/topN scoring run."""

    _supports_extra_side_rows = True  # m_u > m via the collective fits

    def __init__(self, k=50, lambda_=1e0, alpha=1.0, use_cg=True,
                 k_user=0, k_item=0, k_main=0,
                 w_main=1.0, w_user=1.0, w_item=1.0,
                 l1_lambda=0.0, center_U=True, center_I=True,
                 niter=10, max_cg_steps=3, precondition_cg=False,
                 finalize_chol=False,
                 NA_as_zero_user=False, NA_as_zero_item=False,
                 nonneg=False, nonneg_C=False, nonneg_D=False,
                 max_cd_steps=100,
                 apply_log_transf=False, downweight=False,
                 precompute_for_predictions=True,
                 use_float=True, random_state=1, verbose=False,
                 print_every=10, handle_interrupt=True, produce_dicts=False,
                 nthreads=-1, n_jobs=None,
                 checkpoint_path=None, checkpoint_every=0, device="cuda"):
        self.k = k
        self.lambda_ = lambda_
        self.alpha = alpha
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.use_cg = use_cg
        self.k_user = k_user
        self.k_item = k_item
        self.k_main = k_main
        self.w_main = w_main
        self.w_user = w_user
        self.w_item = w_item
        self.l1_lambda = l1_lambda
        self.center_U = center_U
        self.center_I = center_I
        self.niter = niter
        self.max_cg_steps = max_cg_steps
        self.precondition_cg = precondition_cg
        self.finalize_chol = finalize_chol
        self.NA_as_zero_user = NA_as_zero_user
        self.NA_as_zero_item = NA_as_zero_item
        self.nonneg = nonneg
        self.nonneg_C = nonneg_C
        self.nonneg_D = nonneg_D
        self.max_cd_steps = max_cd_steps
        self.apply_log_transf = apply_log_transf
        self.downweight = downweight
        self.precompute_for_predictions = precompute_for_predictions
        self.use_float = use_float
        self.random_state = random_state
        self.verbose = verbose
        self.print_every = print_every
        self.handle_interrupt = handle_interrupt
        self.produce_dicts = produce_dicts
        self.nthreads = nthreads
        self.n_jobs = n_jobs
        self.device = device
        self.is_fitted_ = False
        _validate_cmf_params(self, implicit=True)

    @profiling.recorded_fit
    def fit(self, X, U=None, I=None, mesh=None):
        """Fit to implicit-feedback data (reference:
        upstream cmfrec/__init__.py:4816): without side info on the
        bucketed engine; with side info on the collective routes (dense
        side info on the dense-masked engine, the rest bucketed)."""
        _validate_cmf_params(self, implicit=True)
        set_handle_interrupt(bool(self.handle_interrupt))
        self._reset()
        self.dtype_ = resolve_dtype(self.use_float)
        rows, cols, vals, _, m, n = self._ingest_X(X)
        common = dict(
            mesh=mesh, k=self.k, lambda_=self.lambda_,
            l1_lambda=self.l1_lambda, niter=self.niter, use_cg=self.use_cg,
            max_cg_steps=self.max_cg_steps,
            precondition_cg=self.precondition_cg,
            finalize_chol=self.finalize_chol,
            alpha=self.alpha, apply_log_transf=self.apply_log_transf,
            adjust_weight=self.downweight, nonneg=self.nonneg,
            max_cd_steps=self.max_cd_steps,
            dtype=self.dtype_, seed=self.random_state, verbose=self.verbose,
            checkpoint_path=self.checkpoint_path,
            checkpoint_every=self.checkpoint_every,
            device=self.device,
        )
        if (U is None and I is None
                and not (self.k_user or self.k_item or self.k_main)):
            res = drivers.fit_implicit_als(rows, cols, vals, m, n, **common)
        else:
            res = collective.fit_collective_implicit_als(
                rows, cols, vals, m, n,
                side_U=self._ingest_side(U, self.user_mapping_, m, "U"),
                side_I=self._ingest_side(I, self.item_mapping_, n, "I"),
                k_user=self.k_user, k_item=self.k_item, k_main=self.k_main,
                w_main=self.w_main, w_user=self.w_user, w_item=self.w_item,
                center_U=self.center_U, center_I=self.center_I,
                NA_as_zero_user=self.NA_as_zero_user,
                NA_as_zero_item=self.NA_as_zero_item,
                nonneg_C=self.nonneg_C, nonneg_D=self.nonneg_D, **common)
            self._store_side(res)
        with profiling.span("cmfrec.finish"):
            self.A_ = _host(res["A"])
            self.B_ = _host(res["B"])
            self.user_bias_ = None
            self.item_bias_ = None
            self.glob_mean_ = 0.0
            self.w_main_multiplier_ = res["w_main_multiplier"]
            self.is_fitted_ = True
            self.niter_ = self.niter
            self._build_dicts()
            if self.precompute_for_predictions:
                self.force_precompute_for_predictions()
        return self

    # ------------------------------------------------------------------ #
    # warm / cold factors                                                 #
    # ------------------------------------------------------------------ #

    force_precompute_for_predictions = CMF.force_precompute_for_predictions

    def _warm_row(self, X_col, X_val, U, U_col, U_val):
        cols, _ = self._map_ids(np.asarray(X_col), self.item_mapping_, "item")
        cols = np.atleast_1d(cols).astype(np.int64)
        # apply_log_transf raises on values <= 0, as the fit does
        vals = drivers.implicit_values(np.ravel(X_val),
                                       self.apply_log_transf)
        return warm.factors_implicit_batch(
            self, cols[None, :], vals[None, :],
            np.array([len(cols)], np.int64),
            U=self._new_row_U(U, U_col, U_val), return_device=True)

    def factors_warm(self, X_col=None, X_val=None, U=None, U_col=None,
                     U_val=None):
        """WRMF factors of a new user (reference: upstream
        cmfrec/__init__.py:5231)."""
        self._check_fitted()
        return warm.download(self._warm_row(X_col, X_val, U, U_col,
                                            U_val))[0][0]

    def _cold_rows(self, U):
        if self.C_ is None:
            raise ValueError("Model was fit without user side info")
        U = np.asarray(U, np.float64)
        R = U.shape[0]
        return warm.factors_implicit_batch(
            self, np.zeros((R, 1), np.int64), np.zeros((R, 1)),
            np.zeros(R, np.int64), U=U, return_device=True)

    def factors_cold(self, U=None, U_col=None, U_val=None):
        self._check_fitted()
        return warm.download(self._cold_rows(
            self._new_row_U(U, U_col, U_val)))[0][0]

    def topN_warm(self, n=10, X_col=None, X_val=None, U=None, U_col=None,
                  U_val=None, include=None, exclude=None, output_score=False):
        self._check_fitted()
        return self._topN_row(self._warm_row(X_col, X_val, U, U_col, U_val),
                              n, include, exclude, output_score)

    def topN_cold(self, n=10, U=None, U_col=None, U_val=None,
                  include=None, exclude=None, output_score=False):
        self._check_fitted()
        return self._topN_row(
            self._cold_rows(self._new_row_U(U, U_col, U_val)), n, include,
            exclude, output_score)

    def _score_items(self, i, a):
        B = np.asarray(self._xB)[i]
        a = np.asarray(a)[..., self.k_user:]
        return B @ a if a.ndim == 1 else np.sum(a * B, axis=1)

    def predict_warm(self, items, X_col, X_val, U=None, U_col=None,
                     U_val=None):
        a = self.factors_warm(X_col=X_col, X_val=X_val, U=U, U_col=U_col,
                              U_val=U_val)
        return self._score_items(self._item_rows(items), a)

    def predict_cold(self, items, U=None, U_col=None, U_val=None):
        a = self.factors_cold(U=U, U_col=U_col, U_val=U_val)
        return self._score_items(self._item_rows(items), a)

    def factors_multiple(self, X=None, U=None):
        """WRMF warm factors of many new users at once (reference: upstream
        cmfrec/__init__.py:5107); one download."""
        self._check_fitted()
        if X is None:
            return warm.download(self._cold_rows(U))[0]
        U = None if U is None else np.asarray(U, np.float64)
        rows, cols, vals, _, m_new, _ = self._ingest_X_new(X, None)
        vals = drivers.implicit_values(vals, self.apply_log_transf)
        if _route_grouped(rows, m_new):
            return warm.factors_implicit_grouped(self, rows, cols, vals,
                                                 m_new, U=U)
        idx, vv, _, counts = warm.pack_padded_rows(rows, cols, vals, None,
                                                   m_new)
        return warm.factors_implicit_batch(self, idx, vv, counts, U=U)

    def predict_warm_multiple(self, X, item, U=None):
        """Predict (new user row i, item[i]) pairs (reference: upstream
        cmfrec/__init__.py:5306)."""
        a = self.factors_multiple(X=X, U=U)
        i = self._item_rows(item)
        if i.shape[0] != a.shape[0]:
            raise ValueError("item must have one entry per row of X")
        return self._score_items(i, a)

    def predict_cold_multiple(self, item, U=None):
        """Predict for many (new user given side info, existing item)
        pairs (reference: upstream cmfrec/__init__.py:5221)."""
        self._check_fitted()
        a = warm.download(self._cold_rows(U))[0]
        return self._score_items(self._item_rows(item), a)

    def item_factors_cold(self, I=None, I_col=None, I_val=None):
        """Factors of a new item from its side info: factors_cold of the
        swapped model (reference: upstream cmfrec/__init__.py:5061)."""
        self._check_fitted()
        if self.D_ is None:
            raise ValueError("Model was fit without item side info")
        return self.swap_users_and_items(precompute=False).factors_cold(
            U=I, U_col=I_col, U_val=I_val)

    def _new_items(self, I):
        I = np.asarray(I, np.float64)
        if I.ndim == 1:
            I = I[None, :]
        sw = self.swap_users_and_items(precompute=False)
        return warm.download(sw._cold_rows(I))[0]

    def predict_new(self, user, I=None):
        """Predict for (existing user, new item given side info) pairs
        (reference: upstream cmfrec/__init__.py:5402)."""
        self._check_fitted()
        b = self._new_items(I)
        u, _ = self._map_ids(user, self.user_mapping_, "user")
        u = np.atleast_1d(u)
        return np.sum(np.asarray(self._xA)[u] * b[:, self.k_item:], axis=1)

    def topN_new(self, user, I=None, n=10, output_score=False):
        """Rank a pool of new items (given side info) for an existing user
        (reference: upstream cmfrec/__init__.py:5465)."""
        self._check_fitted()
        b = self._new_items(I)
        u, _ = self._map_ids(user, self.user_mapping_, "user")
        scores = b[:, self.k_item:] @ np.asarray(self._xA)[int(u)]
        return _top_of(scores, n, output_score)

    @staticmethod
    def from_model_matrices(A, B, precompute=True, lambda_=1e0,
                            l1_lambda=0.0, nonneg=False,
                            apply_log_transf=False, alpha=1.0,
                            use_float=True, nthreads=-1, n_jobs=None,
                            device="cuda"):
        """A CMF_implicit that serves from existing factor matrices; the
        arrays are kept in the model's dtype, as cmfrec_tpu keeps them."""
        A = np.asarray(A)
        B = np.asarray(B)
        if A.shape[1] != B.shape[1]:
            raise ValueError("A and B must have the same number of columns")
        model = CMF_implicit(k=A.shape[1], lambda_=lambda_,
                             l1_lambda=l1_lambda, nonneg=nonneg,
                             apply_log_transf=apply_log_transf, alpha=alpha,
                             use_float=use_float, device=device)
        _adopt(model, A, B, 0.0)
        model.w_main_multiplier_ = 1.0
        if precompute:
            model.force_precompute_for_predictions()
        return model
