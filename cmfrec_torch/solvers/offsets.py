"""Offsets-model (OMF) and content-based fits (port of
cmfrec_tpu/solvers/offsets.py).

Model (upstream cmfrec src/offsets.c:140-175, "Cold-start recommendations
in Collective Matrix Factorization", Cortes 2018):

    Am = [ w_user*(U C + Cb)[:, :k_sec],
           A[:, :k] + w_user*(U C + Cb)[:, k_sec:],
           A[:, k:] ]                       # columns [k_sec | k | k_main]
    Bm = likewise from B, I, D
    min ||M . (X - Am Bm^T - biases - mu)||^2 + lam * ||params||^2

Two fits, as in the reference:
  * the exact joint optimization by L-BFGS (fit_offsets_explicit_lbfgs,
    src/offsets.c:1150): solvers/lbfgs_core.py with autograd gradients, in
    plain torch on the fit's device;
  * the ALS approximation (fit_offsets_als, src/offsets.c:1773): Am/Bm by
    the port's ALS drivers on the fit's device (K1/K2 on the dense-masked
    engine, K3 on the bucketed one), then the attribute regression
    C = argmin ||Am - U C|| and A = Am - w_user U C on the host, in f64.
    Only k (no k_sec/k_main) in this mode.

The pure content-based model (Am = U C + Cb, k_sec = k, no free part)
reuses the same machinery (src/offsets.c:3283).  The attributes are dense
design matrices built on the host (``densify_side``), as in cmfrec_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from . import preprocess
from .drivers import (
    _resolve_lambdas,
    _unsupported,
    fit_explicit_als,
    fit_implicit_als,
)
from .lbfgs import SLICE_MESH, SparseObs, _torch_dtype, run_lbfgs


def densify_side(side, center: bool):
    """OMF treats attributes as dense design matrices; NaNs (and sparse
    holes) become zeros after column centering."""
    if side is None:
        return None, None
    rows, cols, vals, n_ent, p, is_dense, dense = side
    if not is_dense:
        M = np.zeros((n_ent, p))
        if rows is not None:
            M[rows, cols] = vals
        dense = M
    else:
        dense = np.asarray(dense, np.float64).copy()
    colmeans = None
    if center:
        colmeans = np.nanmean(dense, axis=0)
        dense = dense - colmeans[None, :]
    dense = np.nan_to_num(dense, nan=0.0)
    return dense, colmeans


def construct_Am(A, UC, k_sec, k, k_main, w):
    """(upstream cmfrec src/offsets.c:458); torch tensors or numpy arrays."""
    parts = []
    if k_sec:
        parts.append(w * UC[:, :k_sec])
    if k:
        base = A[:, :k]
        if UC is not None:
            base = base + w * UC[:, k_sec:]
        parts.append(base)
    if k_main:
        parts.append(A[:, k:])
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=1)
    return np.concatenate(parts, axis=1)


class OffsetsProblem:
    """The objective of one offsets L-BFGS fit on a device: ``loss(p)``
    over the parameter dict (A, B, C, D, C_bias, D_bias, biasA, biasB,
    whichever the model has) and ``sides(p)`` -> (Am, Bm)."""

    def __init__(self, rows, cols, vals, m, n, *, side_U=None, side_I=None,
                 k=50, k_sec=0, k_main=0, lambda_=10.0, w_user=1.0,
                 w_item=1.0, user_bias=True, item_bias=True, center=True,
                 add_intercepts=True, weights=None, dtype=np.float32,
                 device="cuda"):
        self.tdt = _torch_dtype(dtype)
        self.dev = resolve_device(device)
        self.m, self.n = int(m), int(n)
        self.k, self.k_sec, self.k_main = k, k_sec, k_main
        self.w_user, self.w_item = w_user, w_item
        self.user_bias, self.item_bias = user_bias, item_bias
        self.add_intercepts = add_intercepts
        lam6, _ = _resolve_lambdas(lambda_, 0.0)
        self.lam_map = {"biasA": lam6[0], "biasB": lam6[1], "A": lam6[2],
                        "B": lam6[3], "C": lam6[4], "D": lam6[5],
                        "C_bias": lam6[4], "D_bias": lam6[5]}
        U, self.U_colmeans = densify_side(side_U, center=True)
        I, self.I_colmeans = densify_side(side_I, center=True)
        if U is None and k_sec > 0:
            raise ValueError("k_sec requires side info")
        self.glob_mean = (preprocess.weighted_global_mean(vals, weights)
                          if center else 0.0)
        self.obs = SparseObs(rows, cols,
                             np.asarray(vals, np.float64) - self.glob_mean,
                             weights, m, n, self.tdt, self.dev)
        self.U = None if U is None else self._up(U)
        self.I = None if I is None else self._up(I)

    def _up(self, a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               device=self.dev).to(self.tdt)

    def init_params(self, seed=1, init_params=None):
        """Seeded N(0, 1/(k_sec + k + k_main)) matrices (torch's generator,
        not jax.random's) and zero intercepts and biases, then whatever
        ``init_params`` carries."""
        kAB = self.k + self.k_main
        kCD = self.k_sec + self.k
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(int(seed))
        s = 1.0 / np.sqrt(max(self.k_sec + self.k + self.k_main, 1))

        def normal(*shape):
            return s * torch.randn(shape, generator=gen, device=self.dev,
                                   dtype=self.tdt)

        def zeros(size):
            return torch.zeros(size, dtype=self.tdt, device=self.dev)

        params = {}
        if kAB:
            params["A"] = normal(self.m, kAB)
            params["B"] = normal(self.n, kAB)
        if self.U is not None:
            params["C"] = normal(self.U.shape[1], kCD)
            if self.add_intercepts:
                params["C_bias"] = zeros(kCD)
        if self.I is not None:
            params["D"] = normal(self.I.shape[1], kCD)
            if self.add_intercepts:
                params["D_bias"] = zeros(kCD)
        if self.user_bias:
            params["biasA"] = zeros(self.m)
        if self.item_bias:
            params["biasB"] = zeros(self.n)
        for key, v in (init_params or {}).items():
            params[key] = self._up(v)
        return params

    def sides(self, p):
        kAB = self.k + self.k_main
        UC = None
        if self.U is not None:
            UC = self.U @ p["C"]
            if "C_bias" in p:
                UC = UC + p["C_bias"][None, :]
        ID = None
        if self.I is not None:
            ID = self.I @ p["D"]
            if "D_bias" in p:
                ID = ID + p["D_bias"][None, :]
        Am = construct_Am(p.get("A", torch.zeros(self.m, kAB, dtype=self.tdt,
                                                 device=self.dev)),
                          UC, self.k_sec, self.k, self.k_main, self.w_user)
        Bm = construct_Am(p.get("B", torch.zeros(self.n, kAB, dtype=self.tdt,
                                                 device=self.dev)),
                          ID, self.k_sec, self.k, self.k_main, self.w_item)
        return Am, Bm

    def loss(self, p):
        Am, Bm = self.sides(p)
        f = self.obs.term(Am, Bm, p.get("biasA"), p.get("biasB"))
        for name in sorted(p):
            mat = p[name]
            f = f + 0.5 * self.lam_map[name] * torch.sum(mat * mat)
        return f


def fit_offsets_explicit_lbfgs(
    rows, cols, vals, m, n, *,
    side_U=None, side_I=None,
    k=50, k_sec=0, k_main=0,
    lambda_=10.0, w_user=1.0, w_item=1.0,
    user_bias=True, item_bias=True, center=True, add_intercepts=True,
    maxiter=10000, corr_pairs=7,
    weights=None, dtype=np.float32, seed=1, verbose=False, print_every=100,
    init_params=None, tol=1e-8,
    mesh=None,
    device="cuda",
) -> dict:
    """The exact offsets fit.  Returns numpy arrays (A, B, C, D, C_bias,
    D_bias, Am, Bm, biasA, biasB; None where absent), glob_mean, the
    attribute column means, cmfrec_tpu's niter, and the measured n_evals,
    host_syncs and per-iteration values."""
    if mesh is not None:
        raise _unsupported("multi-device fitting (mesh=)", SLICE_MESH)
    prob = OffsetsProblem(
        rows, cols, vals, m, n, side_U=side_U, side_I=side_I, k=k,
        k_sec=k_sec, k_main=k_main, lambda_=lambda_, w_user=w_user,
        w_item=w_item, user_bias=user_bias, item_bias=item_bias,
        center=center, add_intercepts=add_intercepts, weights=weights,
        dtype=dtype, device=device)
    params, stats = run_lbfgs(prob.loss, prob.init_params(seed, init_params),
                              maxiter=maxiter, corr_pairs=corr_pairs, tol=tol,
                              verbose=verbose, print_every=print_every,
                              label="offsets-lbfgs")
    stats.pop("nfev")
    with torch.no_grad():
        Am, Bm = prob.sides(params)
    out = {name: v.cpu().numpy() for name, v in params.items()}
    return {
        "A": out.get("A"), "B": out.get("B"), "C": out.get("C"),
        "D": out.get("D"), "C_bias": out.get("C_bias"),
        "D_bias": out.get("D_bias"),
        "Am": Am.cpu().numpy(), "Bm": Bm.cpu().numpy(),
        "biasA": out.get("biasA"), "biasB": out.get("biasB"),
        "glob_mean": float(prob.glob_mean),
        "U_colmeans": prob.U_colmeans, "I_colmeans": prob.I_colmeans,
        "k": k, "k_sec": k_sec, "k_main": k_main, **stats,
    }


def _regress_side(U, Am, add_intercepts, ridge=1e-10):
    """C = argmin ||Am - U C|| (upstream cmfrec src/offsets.c:184-199), f64
    on the host."""
    X = U
    if add_intercepts:
        X = np.concatenate([U, np.ones((U.shape[0], 1))], axis=1)
    G = X.T @ X + ridge * np.eye(X.shape[1])
    Cfull = np.linalg.solve(G, X.T @ Am)
    if add_intercepts:
        return Cfull[:-1], Cfull[-1]
    return Cfull, None


def _host(t):
    return None if t is None else t.cpu().numpy()


def fit_offsets_als(
    rows, cols, vals, m, n, *,
    side_U=None, side_I=None, implicit=False,
    k=50, lambda_=10.0, alpha=1.0, apply_log_transf=False,
    user_bias=True, item_bias=True, center=True, add_intercepts=True,
    niter=10, use_cg=True, max_cg_steps=3, finalize_chol=True,
    NA_as_zero=False, weights=None, dtype=np.float32, seed=1, verbose=False,
    init=None,  # warm restart for the inner Am/Bm ALS (reset_values=False)
    mesh=None,
    device="cuda",
) -> dict:
    """ALS approximation: the port's ALS fit for Am/Bm on ``device``, then
    the attribute regression (upstream cmfrec src/offsets.c:1773).  The
    ALS drivers take float32 only (ROADMAP slice 1 item 1)."""
    U, U_colmeans = densify_side(side_U, center=True)
    I, I_colmeans = densify_side(side_I, center=True)
    common = dict(k=k, lambda_=lambda_, niter=niter, use_cg=use_cg,
                  max_cg_steps=max_cg_steps, finalize_chol=finalize_chol,
                  dtype=dtype, seed=seed, verbose=verbose, init=init,
                  mesh=mesh, device=device)
    if implicit:
        res = fit_implicit_als(rows, cols, vals, m, n, alpha=alpha,
                               apply_log_transf=apply_log_transf, **common)
    else:
        res = fit_explicit_als(rows, cols, vals, m, n, user_bias=user_bias,
                               item_bias=item_bias, center=center,
                               NA_as_zero=NA_as_zero, weights=weights,
                               **common)
    Am, Bm = _host(res["A"]), _host(res["B"])
    out = {
        "Am": Am, "Bm": Bm,
        "biasA": _host(res.get("biasA")), "biasB": _host(res.get("biasB")),
        "glob_mean": res.get("glob_mean", 0.0),
        "U_colmeans": U_colmeans, "I_colmeans": I_colmeans,
        "k": k, "k_sec": 0, "k_main": 0,
        "w_main_multiplier": res.get("w_main_multiplier", 1.0),
        "alpha": alpha,
    }
    if U is not None:
        C, C_bias = _regress_side(U, Am, add_intercepts)
        out["C"], out["C_bias"] = C, C_bias
        out["A"] = Am - U @ C - (C_bias if C_bias is not None else 0.0)
    else:
        out["C"] = out["C_bias"] = None
        out["A"] = Am
    if I is not None:
        D, D_bias = _regress_side(I, Bm, add_intercepts)
        out["D"], out["D_bias"] = D, D_bias
        out["B"] = Bm - I @ D - (D_bias if D_bias is not None else 0.0)
    else:
        out["D"] = out["D_bias"] = None
        out["B"] = Bm
    return out
