"""Collective matrix factorization ALS drivers, the dense route (port of the
dense-engine half of cmfrec_tpu/solvers/collective.py).

The joint model (upstream cmfrec src/collective.c:78-355), with k_user =
k_item = k_main = 0:

    X[m,n]  ~  A B^T (+ biases + mean)
    U[m,p]  ~  A C^T                              (weight w_user)
    I[n,q]  ~  B D^T                              (weight w_item)
    Xones   ~  A Bi^T,  Xones^T ~ B Ai^T          (weight w_implicit)

These fits run on the dense-masked engine (solvers/dense_masked.py, kernels
K1/K2), on a card as on the CPU: fully dense side info contributes a shared
Gram (C^T C) and a dense rhs (U @ C), and C/D/Ai/Bi are whole-matrix
closed-form solves.  Every configuration the JAX package sends to its
bucketed collective engine raises a ``ValueError`` naming the ROADMAP item
that brings it (SLICE_BUCKETED).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import resolve_device, resolve_dtype
from . import drivers, preprocess
from .dense_masked import (
    fit_collective_dense_masked,
    fit_collective_implicit_dense_masked,
    padded_dims,
)

SLICE_BUCKETED = "slice 4 item 11, the bucketed half of solvers/collective.py"


@dataclass
class PreparedSide:
    p: int  # number of features (columns of U)
    n_ent: int  # number of entities (rows of U); may exceed the X dimension
    colmeans: Optional[np.ndarray]  # f64 [p] when centered
    # centered f32 [n_ent, p] when fully observed; None for sparse side info
    # (sparse, NaNs or fewer rows than X), which only the bucketed route takes
    dense: Optional[np.ndarray]


def prepare_side(side, center: bool, dtype=np.float32
                 ) -> Optional[PreparedSide]:
    """Normalize an ingested side-info matrix (see _BaseModel._ingest_side):
    a fully observed one is column-centered (means over its rows, kept as
    colmeans).  The port has the dense branch only: a sparse one keeps its
    shape and no data, for the driver to reject."""
    if side is None:
        return None
    _, _, _, n_ent, p, is_dense, dense = side
    if not is_dense:
        return PreparedSide(p=p, n_ent=n_ent, colmeans=None, dense=None)
    dense = np.asarray(dense, np.float64)
    colmeans = None
    if center:
        colmeans = dense.mean(axis=0)
        dense = dense - colmeans[None, :]
    return PreparedSide(p=p, n_ent=n_ent, colmeans=colmeans,
                        dense=dense.astype(dtype))


def _sparsify_short_dense_side(side, xdim):
    """A dense side matrix with fewer rows than the main dimension
    (m_u < m) is re-expressed as sparse triplets over its rows: the dense
    routes assume every main row has a side row (shared CtC Gram +
    whole-matrix solves), but entities beyond n_ent must get no side
    contribution at all (the reference solves them X-only)."""
    if side is None:
        return side
    rows, cols, vals, n_ent, p, is_dense, dense = side
    if not is_dense or n_ent >= xdim:
        return side
    dense = np.asarray(dense, np.float64)
    rr, cc = np.nonzero(~np.isnan(dense))
    return (rr, cc, dense[rr, cc], n_ent, p, False, None)


def _init_dense_ok(init):
    """Whether a warm restart may ride the dense engine.  The engine seeds
    A/B/biasA/biasB and solves C/D/Ai/Bi from them before first use
    (upstream cmfrec src/collective.c:8345/8396/8479/8520); a warm start
    that carries C/D/Ai/Bi goes to the bucketed route, as in the JAX
    package."""
    if init is None:
        return True
    return all(init.get(key) is None for key in ("C", "D", "Ai", "Bi"))


def _reject_bucketed(U, I, m, n, *, k_user, k_item, k_main, w_main,
                     NA_as_zero, add_implicit_features, weights, init,
                     dense_bytes, dev):
    """Raise for a configuration that the JAX package fits on its bucketed
    collective engine, which the port does not have yet."""
    def no(what):
        return drivers._unsupported(what, SLICE_BUCKETED)

    for side, name, dim in ((U, "U", m), (I, "I", n)):
        if side is None:
            continue
        if side.n_ent > dim:
            raise no(f"side information with more rows than X ({name}= has "
                     f"{side.n_ent}, X {dim}: side-info-only entities)")
        if side.dense is None:
            raise no(f"side information with missing entries ({name}= "
                     "sparse, with NaNs, or with fewer rows than X)")
    if k_user or k_item or k_main:
        raise no("k_user/k_item/k_main")
    if w_main != 1.0:
        raise no("w_main != 1 in an explicit collective fit")
    if NA_as_zero:
        raise no("NA_as_zero, NA_as_zero_user or NA_as_zero_item in a "
                 "collective fit")
    if add_implicit_features and weights is not None:
        raise no("add_implicit_features with weights")
    if not _init_dense_ok(init):
        raise no("a warm start (init=) that carries C, D, Ai or Bi")
    budget = drivers._dense_budget(dev)
    if budget is not None and dense_bytes > budget:
        raise no(f"a collective fit whose dense form ({dense_bytes} B) "
                 f"exceeds the card's budget ({budget} B)")


def fit_collective_explicit_als(
    rows, cols, vals, m, n, *,
    side_U=None, side_I=None,
    k=40, k_user=0, k_item=0, k_main=0,
    lambda_=10.0, l1_lambda=0.0,
    w_main=1.0, w_user=1.0, w_item=1.0, w_implicit=0.5,
    add_implicit_features=False,
    niter=10, use_cg=True, max_cg_steps=3, precondition_cg=False,
    finalize_chol=True,
    user_bias=True, item_bias=True, center=True,
    center_U=True, center_I=True,
    scale_lam=False, scale_lam_sideinfo=False, scale_bias_const=False,
    NA_as_zero=False, NA_as_zero_user=False, NA_as_zero_item=False,
    nonneg=False, nonneg_C=False, nonneg_D=False, max_cd_steps=100,
    weights=None, dtype=np.float32, seed=1, verbose=False,
    mesh=None, init=None, checkpoint_path=None, checkpoint_every=0,
    shard_opposing_rows=False, device="cuda",
) -> dict:
    """Collective explicit ALS on the dense-masked engine.  side_U/side_I
    are _BaseModel._ingest_side tuples.  Returns A, B, biasA/biasB, C, D,
    Ai, Bi (None where absent) as f32 tensors on ``device``, plus
    U_colmeans/I_colmeans, glob_mean and k.  As on the JAX package's dense
    route, the fit writes no mid-fit checkpoints (checkpoint_path and
    checkpoint_every are accepted and unused)."""
    lam6, l16 = drivers._resolve_lambdas(lambda_, l1_lambda)
    dtype = resolve_dtype(dtype)
    dev = resolve_device(device)
    drivers._reject_common(mesh, shard_opposing_rows,
                           nonneg or nonneg_C or nonneg_D, l16, use_cg,
                           precondition_cg, dtype)
    scale_lam = scale_lam or scale_lam_sideinfo
    U = prepare_side(_sparsify_short_dense_side(side_U, m), center_U, dtype)
    I = prepare_side(_sparsify_short_dense_side(side_I, n), center_I, dtype)
    Kp = padded_dims(m, n, k)[2]
    drivers.check_kernel_k(k, Kp, "dense", dev)
    _reject_bucketed(
        U, I, m, n, k_user=k_user, k_item=k_item, k_main=k_main,
        w_main=w_main,
        NA_as_zero=NA_as_zero or NA_as_zero_user or NA_as_zero_item,
        add_implicit_features=add_implicit_features, weights=weights,
        init=init, dense_bytes=drivers.dense_bytes(m, n, k,
                                                   weights is not None),
        dev=dev)

    glob_mean = (preprocess.weighted_global_mean(vals, weights) if center
                 else 0.0)
    res = fit_collective_dense_masked(
        rows, cols, vals, m, n,
        U_dense=None if U is None else U.dense,
        I_dense=None if I is None else I.dense,
        weights=weights, k=k, lam6=lam6, w_user=w_user, w_item=w_item,
        niter=niter, max_cg_steps=max_cg_steps, finalize_chol=finalize_chol,
        finalize_steps=drivers.FINALIZE_STEPS, user_bias=user_bias,
        item_bias=item_bias, glob_mean=glob_mean, scale_lam=scale_lam,
        scale_lam_sideinfo=scale_lam_sideinfo,
        scale_bias_const=scale_bias_const, seed=seed, verbose=verbose,
        device=dev, init=init, add_implicit_features=add_implicit_features,
        w_implicit=w_implicit, exact=not use_cg)
    res["U_colmeans"] = None if U is None else U.colmeans
    res["I_colmeans"] = None if I is None else I.colmeans
    return res


def fit_collective_implicit_als(
    rows, cols, vals, m, n, *,
    side_U=None, side_I=None,
    k=50, k_user=0, k_item=0, k_main=0,
    lambda_=1.0, l1_lambda=0.0,
    w_main=1.0, w_user=1.0, w_item=1.0,
    alpha=1.0, apply_log_transf=False, adjust_weight=False,
    niter=10, use_cg=True, max_cg_steps=3, precondition_cg=False,
    finalize_chol=False,
    center_U=True, center_I=True,
    NA_as_zero_user=False, NA_as_zero_item=False,
    nonneg=False, nonneg_C=False, nonneg_D=False, max_cd_steps=100,
    dtype=np.float32, seed=1, verbose=False,
    mesh=None, init=None, checkpoint_path=None, checkpoint_every=0,
    shard_opposing_rows=False, device="cuda",
) -> dict:
    """WRMF with side info (upstream cmfrec src/collective.c:9375) on the
    dense-masked engine.  The main part's weight is w_main times the
    adjust_weight multiplier nnz/(m*n) (src/collective.c:9776-9782).
    Returns A, B, C, D (or None) as f32 tensors on ``device``, plus
    U_colmeans/I_colmeans, w_main_multiplier and alpha; no mid-fit
    checkpoints, as on the JAX package's dense route."""
    lam6, l16 = drivers._resolve_lambdas(lambda_, l1_lambda)
    dtype = resolve_dtype(dtype)
    dev = resolve_device(device)
    drivers._reject_common(mesh, shard_opposing_rows,
                           nonneg or nonneg_C or nonneg_D, l16, use_cg,
                           precondition_cg, dtype)
    vals = drivers.implicit_values(vals, apply_log_transf)
    w_mult = len(vals) / (float(m) * float(n)) if adjust_weight else 1.0
    U = prepare_side(_sparsify_short_dense_side(side_U, m), center_U, dtype)
    I = prepare_side(_sparsify_short_dense_side(side_I, n), center_I, dtype)
    Kp = padded_dims(m, n, k, bias_col=False)[2]
    drivers.check_kernel_k(k, Kp, "dense", dev)
    _reject_bucketed(
        U, I, m, n, k_user=k_user, k_item=k_item, k_main=k_main,
        w_main=1.0, NA_as_zero=NA_as_zero_user or NA_as_zero_item,
        add_implicit_features=False, weights=None, init=init,
        dense_bytes=drivers.dense_bytes(m, n, k, False, implicit=True),
        dev=dev)

    res = fit_collective_implicit_dense_masked(
        rows, cols, vals, m, n,
        U_dense=None if U is None else U.dense,
        I_dense=None if I is None else I.dense,
        k=k, lam6=lam6, w_user=w_user, w_item=w_item, niter=niter,
        max_cg_steps=max_cg_steps, finalize_steps=drivers.FINALIZE_STEPS,
        finalize_chol=finalize_chol, alpha=alpha,
        w_main_multiplier=w_main * w_mult, seed=seed, verbose=verbose,
        device=dev, init=init, exact=not use_cg)
    res["U_colmeans"] = None if U is None else U.colmeans
    res["I_colmeans"] = None if I is None else I.colmeans
    return res
