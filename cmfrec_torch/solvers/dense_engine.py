"""The plain dense engine of the float64 and Jacobi-PCG explicit fits
(port of cmfrec_tpu/solvers/dense_engine.py).

For data whose dense [m, n] form fits the card, every half-step solves the
per-row ridge systems of all rows at once by truncated CG whose operator
and right-hand side are whole-matrix masked products:

    rhs    = ((X - bias_opp) . W) @ Be                       [R, K]
    Gv(P)  = ((P @ Be^T) . W) @ Be + lam . P                 [R, K]

These are the systems of the bucketed engine (ops/rowsolve.py) and of the
reference's per-row solves (upstream cmfrec src/common.c:1098); only the
schedule differs.  The B half-step contracts the same arrays the other way,
so no transposed copy is held.

The engine runs in the fit's dtype (float32 or float64) with plain torch
matrix products; the kernels K1/K2 of the dense-masked engine take neither
float64 nor a preconditioner, as the JAX package's Pallas engine does not.
Float32 products are true f32 (``config.resolve_device`` turns TF32 off).
The [rows, S] temporaries of ``big(Q) * W`` are formed CHUNK_BYTES at a
time, so the engine holds X and W plus a bounded amount beside them
(:func:`estimate_dense_bytes`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.rowsolve import cg_iterations
from ..utils import profiling

# bytes of one [rows, S] temporary of a masked product
CHUNK_BYTES = 256 << 20


def dense_from_coo(rows, cols, vals, m, n, weights=None, *, dtype, device):
    """(X, W) on ``device``, scattered there from the COO triplets: X [m, n]
    of ``dtype`` holds the (centered) values with 0 at missing entries, W
    the weights in ``dtype``, or without weights a 0/1 int8 mask.  Duplicate
    (row, col) pairs keep one entry (ROADMAP F5)."""
    dev = torch.device(device)
    flat = profiling.upload(np.asarray(rows, np.int64) * n
                            + np.asarray(cols, np.int64), dev)
    X = torch.zeros(m * n, dtype=dtype, device=dev)
    X[flat] = profiling.upload(np.asarray(vals), dev).to(dtype)
    if weights is None:
        W = torch.zeros(m * n, dtype=torch.int8, device=dev)
        W[flat] = 1
    else:
        W = torch.zeros(m * n, dtype=dtype, device=dev)
        W[flat] = profiling.upload(np.asarray(weights), dev).to(dtype)
    return X.view(m, n), W.view(m, n)


def estimate_dense_bytes(m, n, nnz, k, itemsize, weighted):
    """Device bytes a fit on this engine holds at most: X and W, two chunk
    temporaries, the COO upload of the scatter, and the factors with the CG
    state of a half-step (a dozen [max(m, n), k + 1] arrays)."""
    w_size = itemsize if weighted else 1
    coo = nnz * (8 + itemsize + (itemsize if weighted else 0))
    state = 16 * (m + n) * (k + 1) * itemsize
    return m * n * (itemsize + w_size) + 2 * CHUNK_BYTES + coo + state


def _chunks(rows, cols, itemsize):
    """Row slices of a [rows, cols] array whose temporaries take at most
    CHUNK_BYTES each."""
    step = max(1, CHUNK_BYTES // max(cols * itemsize, 1))
    return [slice(i, min(i + step, rows)) for i in range(0, rows, step)]


def _masked_products(Q, W, Be, rows_axis):
    """small(big(Q) * W): ((Q Be^T) . W) Be over X's rows (rows_axis 0), or
    ((Be Q^T) . W)^T Be over its columns (rows_axis 1), chunk by chunk of
    X's rows."""
    m, n = W.shape
    if rows_axis == 0:
        out = torch.empty_like(Q)
        for sl in _chunks(m, n, Q.element_size()):
            out[sl] = (Q[sl] @ Be.T).mul_(W[sl]) @ Be
        return out
    out = torch.zeros_like(Q)
    for sl in _chunks(m, n, Q.element_size()):
        out += (Be[sl] @ Q.T).mul_(W[sl]).T @ Be[sl]
    return out


def _masked_rhs(X, W, Be, opp_bias, rows_axis):
    """small((X - opp_bias) . W): the rhs of every row at once."""
    m, n = X.shape
    K = Be.shape[1]
    if rows_axis == 0:
        out = torch.empty(m, K, dtype=Be.dtype, device=Be.device)
        for sl in _chunks(m, n, Be.element_size()):
            V = X[sl] if opp_bias is None else X[sl] - opp_bias[None, :]
            out[sl] = (V * W[sl]) @ Be
        return out
    out = torch.zeros(n, K, dtype=Be.dtype, device=Be.device)
    for sl in _chunks(m, n, Be.element_size()):
        V = X[sl] if opp_bias is None else X[sl] - opp_bias[sl, None]
        out += (V * W[sl]).T @ Be[sl]
    return out


def weight_sums(W, axis, dtype):
    """W summed along ``axis`` (1: each of X's rows, 0: each column) in
    ``dtype``, chunk by chunk of rows: no [m, n] cast of W is formed."""
    m, n = W.shape
    itemsize = torch.finfo(dtype).bits // 8
    if axis == 1:
        return torch.cat([W[sl].to(dtype).sum(dim=1)
                          for sl in _chunks(m, n, itemsize)])
    out = torch.zeros(n, dtype=dtype, device=W.device)
    for sl in _chunks(m, n, itemsize):
        out += W[sl].to(dtype).sum(dim=0)
    return out


def _weighted_squares(W, Be, rows_axis):
    """sum_s W[r, s] Be[s, k]^2: the Gram diagonal of the observed entries."""
    m, n = W.shape
    Be2 = Be * Be
    if rows_axis == 0:
        out = torch.empty(m, Be.shape[1], dtype=Be.dtype, device=Be.device)
        for sl in _chunks(m, n, Be.element_size()):
            out[sl] = W[sl].to(Be.dtype) @ Be2
        return out
    out = torch.zeros(n, Be.shape[1], dtype=Be.dtype, device=Be.device)
    for sl in _chunks(m, n, Be.element_size()):
        out += W[sl].to(Be.dtype).T @ Be2[sl]
    return out


def dense_cg_update(
    P: torch.Tensor,  # [R, K] warm start (R = m for the A side, n for B)
    X: torch.Tensor,  # [m, n] zero-filled centered values
    W: torch.Tensor,  # [m, n] weights or 0/1 mask (0 = missing)
    Be: torch.Tensor,  # [S, K] extended opposing matrix (bias column incl.)
    opp_bias: Optional[torch.Tensor],  # [S] opposing bias, or None
    lam_vec: torch.Tensor,  # [K]
    lam_mult: Optional[torch.Tensor],  # [R] (scale_lam) or None
    lam_const_vec: Optional[torch.Tensor],  # [K] unscaled extra diagonal
    n_steps: int,
    rows_axis: int,  # 0: X's rows (A update); 1: its columns (B update)
    jacobi: bool = False,  # precondition_cg: Jacobi-preconditioned CG
) -> torch.Tensor:
    """Batched truncated CG over every row of one side at once
    (rowsolve.cg_iterations: the two-tolerance stop without a
    preconditioner; under ``jacobi`` every row runs all ``n_steps``, as the
    reference's factors_explicit_pcg, src/common.c:1198).  Rows with no
    observations solve to zero (the reference's zero_out)."""
    lam_row = (lam_vec[None, :] if lam_mult is None
               else lam_vec[None, :] * lam_mult.clamp(min=1.0)[:, None])
    if lam_const_vec is not None:
        lam_row = lam_row + lam_const_vec[None, :]

    def matvec(Q):
        return _masked_products(Q, W, Be, rows_axis) + Q * lam_row

    inv_diag = None
    if jacobi:
        # the reference's preconditioner (common.c:1234): the diagonal of
        # the observed entries' Gram plus the row's lambda
        diag = _weighted_squares(W, Be, rows_axis) + lam_row
        inv_diag = torch.where(diag > 0,
                               1.0 / torch.where(diag > 0, diag, 1.0), 1.0)
    rhs = _masked_rhs(X, W, Be, opp_bias, rows_axis)
    a = cg_iterations(matvec, rhs, P, n_steps, inv_diag)
    live = weight_sums(W, 1 - rows_axis, P.dtype) > 0
    return torch.where(live[:, None], a, 0.0)
