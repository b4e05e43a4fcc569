"""CMF — the flagship explicit model (port of cmfrec_tpu/models/cmf.py).

API-compatible with cmfrec_tpu's ``CMF`` (and the reference's class of the
same name, upstream cmfrec/__init__.py:2446): the same constructor
hyperparameters plus ``device``, the same fitted attributes, and
fit/predict/topN/save/load.  ``CMF_implicit`` (upstream
cmfrec/__init__.py:4358) likewise.  Without side info ``CMF`` fits on the
dense-masked engine unless the data needs the bucketed one, and
``CMF_implicit`` on the bucketed one (``drivers.fit_implicit_als(...,
engine="dense")`` runs a plain implicit fit on the dense-masked engine).
With dense side info (``U=``, ``I=``) or implicit features both run the
collective fits of solvers/collective.py on the dense-masked engine.  The
other fit branches raise ``ValueError`` naming the ROADMAP slice that
brings them.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..config import resolve_dtype, set_handle_interrupt
from ..solvers import collective, drivers
from .base import _BaseModel


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
    if (getattr(self, "method", "als") == "als"
            and int(self.max_cg_steps) <= 0):
        raise ValueError("'max_cg_steps' must be a positive integer")
    if implicit and float(self.alpha) <= 0:
        raise ValueError("'alpha' must be positive")
    if getattr(self, "center", False) and self.nonneg:
        warnings.warn(
            "Warning: will fit a model with centering and non-negativity "
            "constraints."
        )


def _host(t):
    return None if t is None else t.cpu().numpy()


class CMF(_BaseModel):
    """Collective matrix factorization with explicit feedback.

    Model: X ~ A B^T (+ biases + mean).  ``device`` ("cuda" by default)
    is where the fit and the predict/topN scoring run.
    """

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
        # stored for API parity; its precompute (warm.build_precomputed)
        # arrives with the warm-serving slice
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

    def fit(self, X, U=None, I=None, U_bin=None, I_bin=None, W=None,
            mesh=None):
        """Fit to explicit-feedback data (reference:
        upstream cmfrec/__init__.py:3066).  ``mesh`` (multi-device fitting)
        must be None until ROADMAP slice 7."""
        _validate_cmf_params(self)  # set_params may have changed options
        if self.method == "lbfgs" or U_bin is not None or I_bin is not None:
            raise drivers._unsupported("method='lbfgs' and binary side info",
                                       "slice 6")
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
                nonneg_C=self.nonneg_C, nonneg_D=self.nonneg_D,
                max_cd_steps=self.max_cd_steps, **common)
            self._store_side(res)

        self.A_ = _host(res["A"])
        self.B_ = _host(res["B"])
        self.user_bias_ = _host(res["biasA"])
        self.item_bias_ = _host(res["biasB"])
        self.glob_mean_ = res["glob_mean"]
        self.is_fitted_ = True
        self.niter_ = self.niter
        self._build_dicts()
        return self


class CMF_implicit(_BaseModel):
    """Implicit-feedback WRMF/iALS (reference: upstream
    cmfrec/__init__.py:4358).  ``device`` ("cuda" by default) is where the
    fit and the predict/topN scoring run."""

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
        # stored for API parity; its precompute arrives with the
        # warm-serving slice
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

    def fit(self, X, U=None, I=None, mesh=None):
        """Fit to implicit-feedback data (reference:
        upstream cmfrec/__init__.py:4816): without side info on the
        bucketed engine; with dense side info on the dense-masked engine."""
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
                nonneg_C=self.nonneg_C, nonneg_D=self.nonneg_D,
                max_cd_steps=self.max_cd_steps, **common)
            self._store_side(res)
        self.A_ = _host(res["A"])
        self.B_ = _host(res["B"])
        self.user_bias_ = None
        self.item_bias_ = None
        self.glob_mean_ = 0.0
        self.w_main_multiplier_ = res["w_main_multiplier"]
        self.is_fitted_ = True
        self.niter_ = self.niter
        self._build_dicts()
        return self
