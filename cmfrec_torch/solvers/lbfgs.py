"""Joint-objective L-BFGS fit (port of cmfrec_tpu/solvers/lbfgs.py).

The reference packs [biasA|biasB|A|B|C|Cb|D|Db] into one flat vector and
runs liblbfgs (upstream cmfrec src/collective.c:6636); cmfrec_tpu keeps
the parameters a pytree and runs optax.lbfgs.  Here they are a dict of
tensors, the optimizer is solvers/lbfgs_core.py (optax's algorithm, leaf
by leaf in sorted key order) and the gradients come from
``torch.autograd`` on the same objective:

    f = w_main/2 ||W . (X - A_x B_x^T - bA - bB - mu)||^2_obs
      + w_user/2 ||U - A_u C^T||^2_obs + w_item/2 ||I - B_i D^T||^2_obs
      + w_user/2 ||U_bin - sigmoid(A_u Cb^T)||^2_obs     (binary side info:
        squared error through a sigmoid, src/collective.c:805)
      + sum_M lam_M/2 ||M||^2

This is the only fit that takes binary side information.  The objective is
plain torch on the fit's device (cmfrec_tpu's is XLA, not Pallas); float64
(``use_float=False``) runs on either device.  Its squared-error terms over
sparse observations (X, and side info given as COO) go through
``SparseObs``: the predictions as a sampled product on the observations'
CSR pattern and the gradient as two sparse-dense products, with no
[nnz, k] intermediate and no atomic scatter (``_term_sparse`` is the same
term by gathers, as cmfrec_tpu writes it).  Multi-device fitting
(``mesh=``) comes with ROADMAP slice 7.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, should_handle_interrupt
from . import preprocess
from .drivers import _resolve_lambdas, _unsupported
from .lbfgs_core import FlatParams, Lbfgs

SLICE_MESH = "slice 7"


def _torch_dtype(dtype):
    return torch.float64 if np.dtype(dtype) == np.float64 else torch.float32


def _rowdot(a, rows, b, cols):
    """sum_k a[rows, k] * b[cols, k] for every observation."""
    return (a.index_select(0, rows) * b.index_select(0, cols)).sum(1)


def _term_sparse(Amat, Bmat, rows, cols, vals, wgt=None, bias_a=None,
                 bias_b=None, mu=0.0):
    pred = _rowdot(Amat, rows, Bmat, cols) + mu
    if bias_a is not None:
        pred = pred + bias_a.index_select(0, rows)
    if bias_b is not None:
        pred = pred + bias_b.index_select(0, cols)
    r = vals - pred
    if wgt is not None:
        return 0.5 * torch.sum(wgt * r * r)
    return 0.5 * torch.sum(r * r)


class _SparseSquares(torch.autograd.Function):
    """0.5 sum w (x - a_u . b_i)^2 over a SparseObs's observations, with a
    closed-form backward: g = -w r, dA = G B and dB = G^T A for the CSR
    matrix G of the g values."""

    @staticmethod
    def forward(ctx, A, B, obs):
        pred = torch.sparse.sampled_addmm(obs.pattern, A, B.T.contiguous(),
                                          beta=0.0).values()
        r = obs.vals - pred
        wr = r if obs.wgt is None else obs.wgt * r
        ctx.obs = obs
        ctx.save_for_backward(A, B, wr)
        return 0.5 * torch.sum(wr * r)

    @staticmethod
    def backward(ctx, grad):
        A, B, wr = ctx.saved_tensors
        obs = ctx.obs
        g = -grad * wr
        gA = torch.sparse.mm(obs.csr(obs.crow_r, obs.col_r, g, obs.shape),
                             B)
        gB = torch.sparse.mm(obs.csr(obs.crow_c, obs.row_c, g[obs.perm_c],
                                     obs.shape[::-1]), A)
        return gA, gB, None


class SparseObs:
    """The observations of one squared-error term (rows, cols, vals and
    optional weights) on a device, sorted by row and held as their CSR
    pattern by rows and by columns.  ``term(A, B, bias_a, bias_b)`` is
    ``_term_sparse`` of them: 0.5 sum w (x - a_u . b_i - bias_a_u -
    bias_b_i)^2, the biases as two extra columns of A and B."""

    def __init__(self, rows, cols, vals, wgt, m, n, dtype, dev):
        def up(a, dt=torch.int64):
            return torch.as_tensor(np.asarray(a), device=dev).to(dt)

        def crow(ids, size):
            return torch.cat([ids.new_zeros(1), torch.cumsum(
                torch.bincount(ids, minlength=size), 0)])

        r, c = up(rows), up(cols)
        order = torch.argsort(r * n + c)  # by rows, then columns
        r, c = r[order], c[order]
        self.shape = (int(m), int(n))
        self.vals = up(vals, torch.float64)[order].to(dtype)
        self.wgt = (None if wgt is None else
                    up(wgt, torch.float64)[order].to(dtype))
        self.perm_c = torch.argsort(c, stable=True)
        self.crow_r, self.col_r = crow(r, m), c
        self.crow_c, self.row_c = crow(c, n), r[self.perm_c]
        self.pattern = self.csr(self.crow_r, self.col_r,
                                torch.ones(r.numel(), dtype=dtype,
                                           device=dev), self.shape)

    @staticmethod
    def csr(crow, col, values, shape):
        return torch.sparse_csr_tensor(crow, col, values, shape,
                                       check_invariants=False)

    def term(self, A, B, bias_a=None, bias_b=None):
        def col(x, size):
            return (x[:, None] if x is not None else
                    A.new_zeros(size, 1)), A.new_ones(size, 1)

        za, oa = col(bias_a, A.shape[0])
        zb, ob = col(bias_b, B.shape[0])
        return _SparseSquares.apply(torch.cat([A, za, oa], 1),
                                    torch.cat([B, ob, zb], 1), self)


def _term_dense(Amat, Bmat, M):
    r = M - Amat @ Bmat.T
    return 0.5 * torch.sum(r * r)


def _term_bin(Amat, Cb, rows, cols, vals, wgt=None):
    r = vals - torch.sigmoid(_rowdot(Amat, rows, Cb, cols))
    if wgt is not None:
        return 0.5 * torch.sum(wgt * r * r)
    return 0.5 * torch.sum(r * r)


def _side_coo(side, center, dtype):
    """Ingested side tuple -> (kind, rows, cols, vals (centered), p,
    colmeans) on the host; dense side info as kind "dense" in vals."""
    if side is None:
        return None
    rows, cols, vals, n_ent, p, is_dense, dense = side
    if is_dense:
        dense = np.asarray(dense, np.float64)
        colmeans = dense.mean(axis=0) if center else None
        if center:
            dense = dense - colmeans[None, :]
        return ("dense", None, None, dense.astype(dtype), p, colmeans)
    vals = np.asarray(vals, np.float64)
    colmeans = None
    if center:
        vals, colmeans = preprocess.center_columns(rows, cols, vals, p, False,
                                                   n_ent)
    return ("coo", np.asarray(rows, np.int64), np.asarray(cols, np.int64),
            vals.astype(dtype), p, colmeans)


def value_and_grad_of(loss_fn, layout):
    """(value, grad) of ``loss_fn`` (of a dict of tensors) at a flat vector
    laid out by ``layout`` (a FlatParams), by autograd."""

    def value_and_grad(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            f = loss_fn(layout.views(x))
            grad, = torch.autograd.grad(f, x)
        return f.detach(), grad

    return value_and_grad


def run_lbfgs(loss_fn, params, *, maxiter, corr_pairs, tol, verbose=False,
              print_every=10, label="lbfgs"):
    """cmfrec_tpu's iteration loop around optax.lbfgs: chunks of up to 25
    iterations, and after each chunk a stop when its value trace is not
    finite or its last two changes are within ``tol * max(|f|, 1)``
    (cmfrec_tpu/solvers/lbfgs.py:293-328; up to a chunk less one iteration
    may run past ``tol``).  Returns (params, stats): ``niter`` as
    cmfrec_tpu counts it (iterations + 1), ``nfev`` its count
    (iterations), and the measured ``n_evals``, ``host_syncs``,
    ``linesearch_steps`` and per-iteration ``values``."""
    layout = FlatParams(params)
    x = layout.flatten(params)
    core = Lbfgs(value_and_grad_of(loss_fn, layout), x, corr_pairs)
    chunk = max(1, min(25, int(maxiter)))
    it = 0
    nfev = 0
    prev = np.inf
    trace = []
    try:
        while it < int(maxiter):
            vs = []
            for _ in range(chunk):
                x, value = core.step(x)
                vs.append(value)
            vs = np.asarray(vs, np.float64)
            trace.extend(vs.tolist())
            if verbose:
                for j in range(0, chunk, max(1, print_every)):
                    print(f"{label} iter {it + j}: f={vs[j]:.6f}")
            it += chunk
            nfev += chunk
            if not np.isfinite(vs[-1]):
                break
            deltas = np.abs(np.diff(np.concatenate([[prev], vs])))
            if (deltas[-2:] <= tol * np.maximum(np.abs(vs[-1]), 1.0)).all():
                break
            prev = vs[-1]
    except KeyboardInterrupt:
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")
    return layout.views(x), dict(niter=it + 1, nfev=nfev, n_evals=core.n_evals,
                        host_syncs=core.host_syncs,
                        linesearch_steps=core.linesearch_steps, values=trace)


class CollectiveProblem:
    """The joint objective of one collective L-BFGS fit on a device: the
    centered data, the side terms, the regularization map, and
    ``loss(params)`` / ``value_and_grad(params)`` over the parameter dict
    (A, B, and whichever of biasA, biasB, C, D, Cb, Db the model has)."""

    def __init__(self, rows, cols, vals, m, n, *, side_U=None, side_I=None,
                 side_Ub=None, side_Ib=None, k=40, k_user=0, k_item=0,
                 k_main=0, lambda_=10.0, w_main=1.0, w_user=1.0, w_item=1.0,
                 user_bias=True, item_bias=True, center=True, center_U=True,
                 center_I=True, weights=None, dtype=np.float32,
                 device="cuda"):
        self.dtype = np.dtype(dtype)
        self.tdt = _torch_dtype(dtype)
        self.dev = resolve_device(device)
        self.m, self.n = int(m), int(n)
        self.k, self.k_user, self.k_item, self.k_main = k, k_user, k_item, k_main
        self.w_main, self.w_user, self.w_item = w_main, w_user, w_item
        self.user_bias, self.item_bias = user_bias, item_bias
        lam6, _ = _resolve_lambdas(lambda_, 0.0)
        self.lam_map = {"biasA": lam6[0], "biasB": lam6[1], "A": lam6[2],
                        "B": lam6[3], "C": lam6[4], "D": lam6[5],
                        "Cb": lam6[4], "Db": lam6[5]}

        self.glob_mean = (preprocess.weighted_global_mean(vals, weights)
                          if center else 0.0)
        self.obs = SparseObs(rows, cols,
                             np.asarray(vals, np.float64) - self.glob_mean,
                             weights, m, n, self.tdt, self.dev)

        self.sides = {}
        self.colmeans = {}
        for name, side, cen in (("U", side_U, center_U),
                                ("I", side_I, center_I),
                                ("Ub", side_Ub, False), ("Ib", side_Ib, False)):
            S = _side_coo(side, cen, self.dtype)
            if S is None:
                continue
            kind, r_s, c_s, v_s, p, colmeans = S
            self.colmeans[name] = colmeans
            if kind == "dense":
                self.sides[name] = ("dense", p, self._up(v_s))
            elif name in ("U", "I"):
                n_ent = (self.m, self.n)[name == "I"]
                self.sides[name] = ("coo", p, SparseObs(
                    r_s, c_s, v_s, None, n_ent, p, self.tdt, self.dev))
            else:
                self.sides[name] = (
                    "coo", p, torch.as_tensor(r_s, device=self.dev),
                    torch.as_tensor(c_s, device=self.dev), self._up(v_s))

    def _up(self, a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               device=self.dev).to(self.tdt)

    def init_params(self, seed=1, init=None):
        """Seeded N(0, 1/k) factors and zero biases (torch's generator, not
        jax.random's), then whatever ``init`` carries."""
        ka = self.k_user + self.k + self.k_main
        kb = self.k_item + self.k + self.k_main
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(int(seed))
        scale = float(1.0 / np.sqrt(max(self.k, 1)))

        def normal(*shape):
            return scale * torch.randn(shape, generator=gen, device=self.dev,
                                       dtype=self.tdt)

        params = {"A": normal(self.m, ka), "B": normal(self.n, kb)}
        if self.user_bias:
            params["biasA"] = torch.zeros(self.m, dtype=self.tdt,
                                          device=self.dev)
        if self.item_bias:
            params["biasB"] = torch.zeros(self.n, dtype=self.tdt,
                                          device=self.dev)
        for name, pname, width in (("U", "C", self.k_user + self.k),
                                   ("I", "D", self.k_item + self.k),
                                   ("Ub", "Cb", self.k_user + self.k),
                                   ("Ib", "Db", self.k_item + self.k)):
            if name in self.sides:
                params[pname] = normal(self.sides[name][1], width)
        if init is not None:
            for name in ("A", "B", "C", "D", "Cb", "Db", "biasA", "biasB"):
                if init.get(name) is not None and name in params:
                    params[name] = self._up(init[name])
        return params

    def _side_term(self, name, Amat, Cmat, w, binary):
        side = self.sides[name]
        if side[0] == "dense":
            M = side[2]
            if binary:
                rr = M - torch.sigmoid(Amat @ Cmat.T)
                return w * 0.5 * torch.sum(rr * rr)
            return w * _term_dense(Amat, Cmat, M)
        if binary:
            _, _, r_s, c_s, v_s = side
            return w * _term_bin(Amat, Cmat, r_s, c_s, v_s)
        return w * side[2].term(Amat, Cmat)

    def loss(self, p):
        A, B = p["A"], p["B"]
        ku, ki, k = self.k_user, self.k_item, self.k
        f = self.w_main * self.obs.term(A[:, ku:], B[:, ki:], p.get("biasA"),
                                        p.get("biasB"))
        if "C" in p:
            f = f + self._side_term("U", A[:, :ku + k], p["C"], self.w_user,
                                    False)
        if "D" in p:
            f = f + self._side_term("I", B[:, :ki + k], p["D"], self.w_item,
                                    False)
        if "Cb" in p:
            f = f + self._side_term("Ub", A[:, :ku + k], p["Cb"], self.w_user,
                                    True)
        if "Db" in p:
            f = f + self._side_term("Ib", B[:, :ki + k], p["Db"], self.w_item,
                                    True)
        for name in sorted(p):
            mat = p[name]
            f = f + 0.5 * self.lam_map[name] * torch.sum(mat * mat)
        return f

    def value_and_grad(self, params):
        """(value, dict of gradients) at a dict of parameters."""
        layout = FlatParams(params)
        value, grad = value_and_grad_of(self.loss, layout)(
            layout.flatten(params))
        return value, layout.views(grad)


def fit_collective_explicit_lbfgs(
    rows, cols, vals, m, n, *,
    side_U=None, side_I=None, side_Ub=None, side_Ib=None,
    k=40, k_user=0, k_item=0, k_main=0,
    lambda_=10.0,
    w_main=1.0, w_user=1.0, w_item=1.0,
    user_bias=True, item_bias=True, center=True,
    center_U=True, center_I=True,
    maxiter=800, corr_pairs=4,
    weights=None, dtype=np.float32, seed=1,
    verbose=False, print_every=10,
    tol=1e-7,
    init=None,  # warm restart: dict with any of A/B/C/D/Cb/Db/biasA/biasB
    mesh=None,
    device="cuda",
) -> dict:
    """The collective explicit fit by L-BFGS on the joint objective.
    Returns numpy arrays (A, B, C, D, Cb, Db, biasA, biasB; None where
    absent), glob_mean, the side-info column means, cmfrec_tpu's niter and
    nfev, and the measured n_evals, host_syncs and per-iteration values."""
    if mesh is not None:
        raise _unsupported("multi-device fitting (mesh=)", SLICE_MESH)
    prob = CollectiveProblem(
        rows, cols, vals, m, n, side_U=side_U, side_I=side_I,
        side_Ub=side_Ub, side_Ib=side_Ib, k=k, k_user=k_user, k_item=k_item,
        k_main=k_main, lambda_=lambda_, w_main=w_main, w_user=w_user,
        w_item=w_item, user_bias=user_bias, item_bias=item_bias,
        center=center, center_U=center_U, center_I=center_I, weights=weights,
        dtype=dtype, device=device)
    params, stats = run_lbfgs(prob.loss, prob.init_params(seed, init),
                              maxiter=maxiter, corr_pairs=corr_pairs, tol=tol,
                              verbose=verbose, print_every=print_every)
    out = {name: v.cpu().numpy() for name, v in params.items()}
    return {
        "A": out["A"], "B": out["B"], "C": out.get("C"), "D": out.get("D"),
        "Cb": out.get("Cb"), "Db": out.get("Db"),
        "biasA": out.get("biasA"), "biasB": out.get("biasB"),
        "glob_mean": float(prob.glob_mean),
        "U_colmeans": prob.colmeans.get("U"),
        "I_colmeans": prob.colmeans.get("I"),
        "k": k, **stats,
    }
