"""Dense-masked ALS on the fused masked-Gram kernels.

Port of cmfrec_tpu/solvers/dense_pallas.py: the explicit fit
(fit_explicit_dense_pallas), the collective explicit fit with dense side
information and implicit features (fit_collective_dense_pallas), the
implicit WRMF fit (fit_implicit_dense_pallas) and the collective implicit
fit (fit_collective_implicit_dense_pallas).  The data are held as padded
dense [m, n] arrays in both orientations; every half-step solves the per-row
ridge systems of upstream cmfrec src/common.c:2742 optimizeA (explicit) or
:3305 optimizeA_implicit for all rows at once by truncated CG whose operator
and right-hand side are the kernels of ops/masked_matmul.py.

The engine is float32 without a preconditioner, as the JAX package's
Pallas engine: every entry point raises on ``dtype=float64`` or a Jacobi
PCG fit (``precondition_cg``), which take the plain engines
(solvers/dense_engine.py, the bucketed engine's plain solves).

Numerics: explicit X stays uncentered in bf16 (half-point rating grids are
exact), with the global mean and opposing bias folded into the f32 ``mb``
vector of the rhs kernel.  Factors are f32 and rounded to bf16 only at the
kernels' inputs.  The final ``finalize_chol`` iteration runs more CG steps
with f32 operands, landing on the f32 fixed point as the reference's final
Cholesky does (upstream cmfrec src/collective.c:8336-8340).  Exact mode
(use_cg=False) runs every half-step's CG in f32 to the per-row freeze.

The port runs eagerly: one Python loop step per iteration, no dispatch
batching.  Dropped TPU workarounds: chunked uploads, the x64 trace guards,
pad_dim's TPU block sizes (the kernels' own 64-wide tile is used) and the
int32 flat index.

Under a mesh (``mesh=``, parallel/mesh.py; the JAX engine's shard_map,
cmfrec_tpu/solvers/dense_pallas.py:170-348) each rank holds its share of
the dense form's rows in both orientations (:class:`_Rows`: equal shares
of whole TILEs, the padded row count rounded up to the world's), and the
factor matrices whole.  A half-step runs K1 and K2 on the rank's rows
against the whole opposing matrix, then one all-gather makes the solved
side whole; the bias start sums the ranks' column sums, and exact mode's
all-frozen exit is taken when every rank's rows are frozen.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import should_handle_interrupt
from ..ops.masked_matmul import (TILE, masked_gram_matvec,
                                 masked_gram_matvec_rows, masked_rhs,
                                 row_chunks, row_lists, takes_rows)
from ..parallel.mesh import (any_rank, gather_rows, padded_share, reduce_sum,
                             world_rank)
from ..utils import profiling


def _round_up(x, mult):
    return -(-x // mult) * mult


def _require_f32_plain_cg(dtype, precondition_cg):
    """The entry points' guard: K1/K2 take float32 and plain CG only."""
    if np.dtype(dtype) != np.float32 or precondition_cg:
        raise ValueError(
            "the dense-masked engine (kernels K1/K2) takes float32 without "
            f"precondition_cg, got dtype {np.dtype(dtype)} and "
            f"precondition_cg={bool(precondition_cg)}")


def padded_dims(m: int, n: int, k: int, bias_col: bool = True
                ) -> tuple[int, int, int]:
    """(m_pad, n_pad, Kp): the dense form's padded sizes.  The explicit
    engines carry a bias coordinate (Kp covers k + 1); the implicit ones
    have none (Kp covers k)."""
    return (max(_round_up(m, TILE), TILE), max(_round_up(n, TILE), TILE),
            max(_round_up(k + int(bias_col), TILE), TILE))


class _Split(NamedTuple):
    """One side's rows of the dense form over a mesh: ``pad`` rows without
    one, ``total`` = world x ``share`` >= pad, and this rank's ``share``
    rows from ``start`` (share = total = pad without a mesh)."""

    pad: int
    total: int
    share: int
    start: int

    @property
    def sl(self) -> slice:
        return slice(self.start, self.start + self.share)


def _split(n_pad: int, mesh) -> _Split:
    world, rank = world_rank(mesh)
    share = padded_share(n_pad, mesh, TILE)
    return _Split(n_pad, world * share, share, rank * share)


class _Rows(NamedTuple):
    """A dense fit's row sharding: each side's _Split, the mesh (None:
    every rank holds everything) and each side's liveness whole (the
    opposing side of a half-step)."""

    a: _Split
    b: _Split
    mesh: object
    live_A: torch.Tensor  # [a.total] bool
    live_B: torch.Tensor  # [b.total] bool

    def gather(self, t):
        return gather_rows(t, self.mesh)


def _whole_mask(live, mesh):
    """A bool row mask made whole over the mesh."""
    return gather_rows(live.to(torch.uint8), mesh).bool()


def _rank_entries(key, s: _Split, *ts):
    """The COO entries whose ``key`` lies in this rank's rows of ``s``, the
    key made local (all of them where one rank holds every row)."""
    if s.share == s.total:
        return (key,) + ts
    keep = (key >= s.start) & (key < s.start + s.share)
    return (key[keep] - s.start,) + tuple(
        None if t is None else t[keep] for t in ts)


def _both_orientations(rows, cols, values, fill, m_pad, n_pad, mesh):
    """``fill(r, c, values, R, S)``: [R, S] tensors of this rank's rows of
    the dense form, then of its transpose; ``values`` are per-entry
    tensors (or None), cut with the entries.  Also the f32 row counts of
    the last forward tensor (the mask or weights) and this rank's share of
    its column counts, summed over the ranks: taken before the transpose,
    so that their temporaries do not meet it.  Where one rank holds every
    row the transpose is the forward form's (so a duplicate pair keeps the
    same entry in both); across ranks each orientation is scattered from
    its own entries."""
    sa, sb = _split(m_pad, mesh), _split(n_pad, mesh)
    r, c, *v = _rank_entries(rows, sa, cols, *values)
    fwd = fill(r, c, v, sa.share, sb.total)
    W = fwd[-1]
    cnt_A = W.sum(dim=1, dtype=torch.float32)
    cnt_B = reduce_sum(W.sum(dim=0, dtype=torch.float32), mesh)[sb.sl]
    if sa.share == sa.total:
        bwd = [t.t().contiguous() for t in fwd]
    else:
        c2, r2, *v2 = _rank_entries(cols, sb, rows, *values)
        bwd = fill(c2, r2, v2, sb.share, sa.total)
    return fwd, bwd, cnt_A, cnt_B


def _scatter(r, c, R, S, fills):
    """Dense [R, S] tensors of (dtype, values) at the entries (r, c)."""
    flat = r * S + c  # int64: no 2**31 limit on R * S
    out = []
    for dtype, v in fills:
        t = torch.zeros(R * S, dtype=dtype, device=r.device)
        t[flat] = v
        out.append(t.view(R, S))
    return out


def _setup(rows, cols, vals, wvals, m_pad, n_pad, mesh=None):
    """Scatter COO -> padded dense bf16 X and int8 mask (or f32 weights) W,
    both orientations, plus f32 row/column counts: this rank's rows of
    each orientation under a mesh ([m_pad, n_pad] and its transpose
    without one).  Duplicate (row, col) pairs keep one entry, as on the TPU
    engine."""
    def fill(r, c, v, R, S):
        x, w = v
        return _scatter(r, c, R, S, [
            (torch.bfloat16, x.to(torch.bfloat16)),
            (torch.float32, w) if w is not None else (torch.int8, 1)])

    (X, W), (XT, WT), cnt_A, cnt_B = _both_orientations(
        rows, cols, (vals, wvals), fill, m_pad, n_pad, mesh)
    return X, W, XT, WT, cnt_A, cnt_B


def _setup_implicit(rows, cols, av, m_pad, n_pad, mesh=None):
    """Scatter the confidence terms of WRMF, both orientations: Wx =
    bf16(alpha*x) (the Gram coefficients), Xp = bf16(1 + Wx) (the rhs
    coefficients; two roundings, as on the TPU) and the int8 mask M, plus
    f32 row/column counts (this rank's rows under a mesh)."""
    def fill(r, c, v, R, S):
        avb = v[0].to(torch.bfloat16)
        return _scatter(r, c, R, S, [(torch.bfloat16, avb),
                                     (torch.bfloat16, 1.0 + avb),
                                     (torch.int8, 1)])

    (Wx, Xp, M), (WxT, XpT, MT), cnt_A, cnt_B = _both_orientations(
        rows, cols, (av,), fill, m_pad, n_pad, mesh)
    return Wx, Xp, M, WxT, XpT, MT, cnt_A, cnt_B


def _cg(P, rhs, matvec, n_steps, dyn_stop=False, mesh=None):
    """Truncated CG with per-row early freeze (masked step size).

    Two-tolerance stopping matching the reference
    (upstream cmfrec src/common.c:1147,1181): rows whose initial residual is
    <= 1e-12 are skipped; a live row stops once its post-step residual falls
    <= 1e-8.  Frozen rows are exact no-ops (alpha = 0).

    dyn_stop=True (exact mode) adds the relative freeze floor
    max(1e-8, (1e-6*|rhs_r|)^2) -- the absolute target is unreachable in f32
    for rows with a large rhs -- and leaves the loop once every row is
    frozen, which gives the fixed-step result without its wasted matvecs.
    That exit reads ``live.any()`` on the host: one device sync per step
    (counted by profiling.synced), and under ``mesh`` one all-reduce, so
    that every rank leaves together."""
    r = rhs - matvec(P)
    rs = torch.sum(r * r, dim=-1)
    live = rs > 1e-12
    if dyn_stop:
        tol = torch.clamp(1e-12 * torch.sum(rhs * rhs, dim=-1), min=1e-8)
    else:
        tol = 1e-8
    a, p = P, r
    for _ in range(n_steps):
        if dyn_stop:
            profiling.synced(1)
            if not any_rank(live.any(), mesh):
                break
        Ap = matvec(p)
        denom = torch.sum(p * Ap, dim=-1)
        alpha = torch.where(live, rs / torch.where(denom == 0, 1.0, denom), 0.0)
        a = a + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rs_new = torch.sum(r * r, dim=-1)
        live = live & (rs_new > tol)
        beta = torch.where(live, rs_new / torch.where(rs == 0, 1.0, rs), 0.0)
        p = torch.where(live[:, None], r + beta[:, None] * p, p)
        rs = torch.where(live, rs_new, rs)
    return a


class _RowLists:
    """The row lists of an explicit fit's W and WT for K1 with f32 operands
    (ops/masked_matmul.py: row_lists, masked_gram_matvec_rows), where the
    density rule (takes_rows) chooses them: W's ``entries`` (the fit's
    rating count, which bounds the dense form's entries) over the padded
    dense form.  Built at the first f32 half-step, after the bias start
    (whose f32 temporaries set the fit's peak memory), and freed with the
    fit."""

    def __init__(self, W, WT, entries, m_pad, n_pad, Kp):
        self.W, self.WT, self.entries = W, WT, int(entries)
        self.use = takes_rows(self.entries, m_pad, n_pad, Kp)
        self.lists = None

    def of(self, W):
        """W's (or WT's) lists, or None where the dense kernel runs."""
        if not self.use:
            return None
        if self.lists is None:
            self.lists = {id(t): row_lists(t, self.entries)
                          for t in (self.W, self.WT)}
        return self.lists[id(W)]


def _half_step(P, X, W, Be, mb, lam_row, live, *, n_steps, compute_dtype,
               dyn_stop=False, G0=None, R0=None, mesh=None, lists=None):
    """One side's update: solve (Be^T diag(W_r) Be + G0 + lam_r) a_r =
    rhs_r + R0_r for all rows r at once by fused-kernel CG.  G0/R0 carry the
    collective model's side-info and implicit-features terms.  P, X, W,
    lam_row, live and R0 are this rank's rows under ``mesh``, Be whole.
    With f32 operands K1 walks W's row lists where ``lists`` (a _RowLists)
    takes them."""
    Bek = Be.to(compute_dtype)
    rhs = masked_rhs(X, W, mb, Bek)
    if R0 is not None:
        rhs = rhs + R0
    rows = (lists.of(W) if lists is not None
            and compute_dtype == torch.float32 else None)

    def matvec(v):
        if rows is None:
            mv = masked_gram_matvec(v.to(compute_dtype), Bek, W)
        else:
            mv = masked_gram_matvec_rows(v, Bek, rows)
        if G0 is not None:
            mv = mv + v @ G0.T
        return mv + v * lam_row

    a = _cg(P, rhs, matvec, n_steps, dyn_stop=dyn_stop, mesh=mesh)
    return torch.where(live[:, None], a, 0.0)


def _chol_rows(G, rhs):
    """Solve G x_r = rhs_r for every row r of rhs [R, K] with one Cholesky
    factor of the shared SPD matrix G [K, K]."""
    L = torch.linalg.cholesky(G)
    y = torch.linalg.solve_triangular(L, rhs.T, upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True).T


def _mask_matmul(Mask, F, op_dtype):
    """Mask @ F for an int8 0/1 (or any) [R, S] Mask and F [S, k], in f32,
    by row chunks (CUDA has no int8 matmul, and the whole mask in f32 would
    take 4 B an entry).  F is rounded to ``op_dtype`` first: the products of
    bf16-rounded operands are exact in f32, as the TPU's bf16 x bf16 -> f32
    product gives them."""
    Fm = F.to(op_dtype).float()
    out = torch.empty(Mask.shape[0], F.shape[1], dtype=torch.float32,
                      device=Mask.device)
    for sl in row_chunks(*Mask.shape):
        out[sl] = Mask[sl].float() @ Fm
    return out


def _half_step_na0(X, Be, mb, live_opp, lam_diag):
    """NA-as-zero (unweighted) half-step: every column participates with
    value 0 at missing entries, so the Gram is shared across rows and the
    update is one closed-form solve (the reference's optimizeA case 3,
    upstream cmfrec src/common.c:3118):
        (Be_live^T Be_live + diag(lam)) a_r = (X @ Be)_r - mb @ Be_live
    """
    Bl = torch.where(live_opp[:, None], Be, 0.0)
    G = Bl.T @ Bl + torch.diag(lam_diag)
    rhs = _mask_matmul(X, Bl, torch.float32)
    rhs -= (mb @ Bl)[None, :]
    return _chol_rows(G, rhs)


def _solve_side_factor(Ak, Ud, w_side, lam, k):
    """(w A_k^T A_k + lam I) C^T = w A_k^T U: the whole-matrix C (or D)
    update for fully dense side information (the reference's optimizeA
    case-1 fast path, upstream cmfrec src/common.c:2787).  Returns C [p, k]."""
    G = w_side * (Ak.T @ Ak) + lam * torch.eye(k, device=Ak.device)
    return _chol_rows(G, (w_side * (Ak.T @ Ud)).T)


def _shared_na0_solve(Fk, Mask, lam_diag, op_dtype):
    """Implicit-features half-step (Ai or Bi): Xones is the full binary
    matrix (zeros at missing entries), so every row of the solved side
    shares one system matrix and the whole update is a single Cholesky:

        (Fk^T Fk + diag(lam)) out_r = (Mask @ Fk)_r

    The reference hard-codes this closed form even in CG fits (upstream
    cmfrec src/collective.c:8479,8520)."""
    G = Fk.T @ Fk + torch.diag(lam_diag)
    return _chol_rows(G, _xones_matmul(Mask, Fk, op_dtype))


def _xones_matmul(Mask, F, op_dtype):
    """An implicit-features product Mask @ F (Xones is the fit's mask),
    counted: one ``impfeat.products``, and the bytes of the mask as held
    (R x S of the dense int8 form) as ``impfeat.mask_bytes``."""
    profiling.count("impfeat.products")
    profiling.count("impfeat.mask_bytes", Mask.numel() * Mask.element_size())
    return _mask_matmul(Mask, F, op_dtype)


def _side_terms(n_rows, Kp, k, parts):
    """G0 [Kp, Kp] and R0 [n_rows, Kp] of a collective half-step from
    ``parts``, a list of (w, F [*, k], rhs [n_rows, k]) adding w F^T F to
    G0's leading block and w rhs to R0's leading columns, in order; (None,
    None) when there are none."""
    if not parts:
        return None, None
    dev = parts[0][1].device
    G0 = torch.zeros(Kp, Kp, dtype=torch.float32, device=dev)
    R0 = torch.zeros(n_rows, Kp, dtype=torch.float32, device=dev)
    for w, F, rhs in parts:
        G0[:k, :k] += w * (F.T @ F)
        R0[:, :k] += w * rhs
    return G0, R0


def _iteration(A, B, X, W, XT, WT, lam_row_A, lam_row_B, live_A, live_B, mu,
               *, k, user_bias, item_bias, n_steps, compute, rows, na0=False,
               dyn_stop=False, G0B=None, R0B=None, G0A=None, R0A=None,
               lists=None):
    """One full ALS iteration: B half-step then A half-step (the reference's
    in-iteration order, upstream cmfrec src/collective.c:8614 "Updating B"
    before :8802 "Updating A").  G0*/R0* are a collective fit's side terms
    of each half-step.  A and B are whole; X, W, the lambdas, the live
    masks and R0* hold this rank's rows (``rows``, a _Rows); ``lists`` the
    f32 K1's row lists of W and WT (a _RowLists)."""
    cdt = torch.bfloat16 if compute == "bf16" else torch.float32
    # bias-column trick (upstream cmfrec src/common.c:561-565): the opposing
    # side's bias coordinate is a column of ones (or zeros without a bias),
    # and its bias values fold into the rhs offset mb
    Ae = A.clone()
    Ae[:, k] = 1.0 if item_bias else 0.0
    mbB = torch.full((A.shape[0],), mu, dtype=torch.float32, device=A.device)
    if user_bias:
        mbB = mbB + A[:, k]
    if na0:
        # lam_row_* is the shared [Kp] diagonal in this mode
        B = torch.where(live_B[:, None],
                        _half_step_na0(XT, Ae, mbB, rows.live_A, lam_row_B),
                        0.0)
    else:
        B = _half_step(B[rows.b.sl], XT, WT, Ae, mbB, lam_row_B, live_B,
                       n_steps=n_steps, compute_dtype=cdt, dyn_stop=dyn_stop,
                       G0=G0B, R0=R0B, mesh=rows.mesh, lists=lists)
    B = rows.gather(B)
    Be = B.clone()
    Be[:, k] = 1.0 if user_bias else 0.0
    mbA = torch.full((B.shape[0],), mu, dtype=torch.float32, device=B.device)
    if item_bias:
        mbA = mbA + B[:, k]
    if na0:
        A = torch.where(live_A[:, None],
                        _half_step_na0(X, Be, mbA, rows.live_B, lam_row_A),
                        0.0)
    else:
        A = _half_step(A[rows.a.sl], X, W, Be, mbA, lam_row_A, live_A,
                       n_steps=n_steps, compute_dtype=cdt, dyn_stop=dyn_stop,
                       G0=G0A, R0=R0A, mesh=rows.mesh, lists=lists)
    return rows.gather(A), B


def _init_factors(gen, live, bias0, s: _Split, Kp, coord, seed_bias):
    """Random factors scaled by 1/sqrt(k) over the whole padded rows
    (``s.pad`` of them drawn, whatever the mesh; zeros below them to
    ``s.total``), zero past coordinate ``coord`` and on dead rows (``live``,
    whole), with the bias coordinate (if Kp holds one) seeded from bias0 (or
    zero)."""
    scale = float(1.0 / np.sqrt(max(coord, 1)))
    M = scale * torch.randn((s.pad, Kp), generator=gen, dtype=torch.float32,
                            device=live.device)
    if s.total > s.pad:
        M = torch.cat([M, M.new_zeros(s.total - s.pad, Kp)])
    coord_pad = torch.arange(Kp, device=live.device) > coord
    M = torch.where(coord_pad[None, :] | ~live[:, None], 0.0, M)
    if coord < Kp:
        M[:, coord] = bias0 if seed_bias else 0.0
    return M


def _apply_init(A, B, init, m, n, k, user_bias=False, item_bias=False):
    """Warm restart (the reference's reset_values=False, upstream cmfrec
    src/cmfrec.h:1858): continue from the given factors and biases."""
    if init is None:
        return

    def given(key):
        return profiling.upload(init[key], A.device, torch.float32)

    if init.get("A") is not None:
        A[:m, :k] = given("A")
    if init.get("B") is not None:
        B[:n, :k] = given("B")
    if user_bias and init.get("biasA") is not None:
        A[:m, k] = given("biasA")
    if item_bias and init.get("biasB") is not None:
        B[:n, k] = given("biasB")


def _device_bias_init(X, W, cnt_A, cnt_B, mu, lam_user, lam_item, scale_lam,
                      user_bias, item_bias, mesh=None):
    """Iterated alternating closed-form bias init from the dense forms (the
    reference's initialize_biases_twosided, upstream cmfrec src/common.c:4410):
    5 alternating full re-solves when both biases are on (items first), one
    pass otherwise.  Row chunks bound the f32 temporaries.  Under ``mesh``
    X, W and cnt_A are this rank's rows and cnt_B its share of the columns:
    the column sums are the ranks' partial sums added up (rank 0's
    starting from the base), and the biases come back whole."""
    m_sh, n_tot = X.shape
    chunks = list(row_chunks(m_sh, n_tot))
    first = world_rank(mesh)[1] == 0

    def wf(sl):
        return W[sl].float()

    sB0 = torch.zeros(n_tot, dtype=torch.float32, device=X.device)
    sA0 = torch.empty(m_sh, dtype=torch.float32, device=X.device)
    for sl in chunks:
        xw = X[sl].float() * wf(sl)
        sB0 += xw.sum(dim=0)
        sA0[sl] = xw.sum(dim=1)
    sB0 = reduce_sum(sB0, mesh)
    cnt_B = gather_rows(cnt_B, mesh)
    sB0 -= mu * cnt_B
    sA0 -= mu * cnt_A
    denomB = cnt_B + lam_item * (torch.clamp(cnt_B, min=1.0) if scale_lam else 1.0)
    denomA = cnt_A + lam_user * (torch.clamp(cnt_A, min=1.0) if scale_lam else 1.0)
    biasA = torch.zeros(m_sh, dtype=torch.float32, device=X.device)
    biasB = torch.zeros(n_tot, dtype=torch.float32, device=X.device)
    for _ in range(5 if (user_bias and item_bias) else 1):
        if item_bias:
            sB = sB0.clone() if first else torch.zeros_like(sB0)
            for sl in chunks:
                sB -= biasA[sl] @ wf(sl)
            sB = reduce_sum(sB, mesh)
            biasB = torch.where(denomB > 0,
                                sB / torch.where(denomB > 0, denomB, 1.0), 0.0)
        if user_bias:
            sA = torch.empty_like(sA0)
            for sl in chunks:
                sA[sl] = sA0[sl] - wf(sl) @ biasB
            biasA = torch.where(denomA > 0,
                                sA / torch.where(denomA > 0, denomA, 1.0), 0.0)
    return gather_rows(biasA, mesh), biasB


def _lam_rows(lam_f, lam_bias, has_bias, cnt, count_avg, *, k, Kp, scale_lam,
              scale_bias_const):
    """The per-row ridge diagonal of an explicit half-step: lam_f on the k
    factor coordinates, lam_bias (or 1 without a bias) on coordinate k, 1 on
    padding; times max(cnt, 1) under scale_lam, with the bias coordinate
    held at lam_bias * count_avg under scale_bias_const
    (upstream cmfrec src/common.c:717-722)."""
    v = np.ones(Kp, np.float32)
    v[:k] = lam_f
    v[k] = lam_bias if has_bias else 1.0
    vec = profiling.upload(v, cnt.device)
    if not scale_lam:
        return vec[None, :]
    lam_row = vec[None, :] * torch.clamp(cnt, min=1.0)[:, None]
    if scale_bias_const and has_bias:
        lam_row[:, k] = lam_bias * count_avg
    return lam_row


def _exact_cap(k_sys):
    """Step cap for exact mode: twice the Krylov bound (CG on an SPD system
    of dimension d terminates in d steps in exact arithmetic; f32 rounding
    delays that, so allow 2d + 4).  The per-row freeze and the all-frozen
    exit mean typical data pays far fewer steps."""
    return 2 * k_sys + 4


def _schedule(exact, k_sys, max_cg_steps, finalize_steps, polish):
    """(bulk, polish) keyword sets of the iteration step.  Exact mode: every
    iteration f32 to the per-row freeze under the Krylov cap, no polish.
    Else bf16 bulk iterations of max_cg_steps CG steps, and with ``polish``
    a last f32 iteration of finalize_steps."""
    if exact:
        return dict(n_steps=_exact_cap(k_sys), compute="f32",
                    dyn_stop=True), None
    return (dict(n_steps=max_cg_steps, compute="bf16", dyn_stop=False),
            dict(n_steps=finalize_steps, compute="f32", dyn_stop=False)
            if polish else None)


def _run_fit(step, niter, bulk, polish, *, verbose, dev, save=None):
    """niter calls of ``step(**kw)``: the bulk keywords, and with a polish
    its keywords in the last call.  ``save(it)`` follows each bulk
    iteration (checkpoints); Ctrl-C returns the partial fit when the model
    asks for that (handle_interrupt)."""
    n_bulk = niter - 1 if polish is not None else niter
    try:
        for it in range(1, niter + 1):
            final = it > n_bulk
            kw = polish if final else bulk
            t0 = time.time()
            with profiling.span("cmfrec.engine.iter", it=it,
                                compute=kw["compute"]):
                step(**kw)
            if verbose:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                print(f"iter {it}/{niter} [masked-{kw['compute']}"
                      f"{'*' if final else ''}] {time.time() - t0:.3f}s")
            if save is not None and not final:
                save(it)
    except KeyboardInterrupt:
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")


def _upload(a, dtype, dev):
    return profiling.upload(np.asarray(a, dtype), dev)


def _host_state(state):
    return {key: profiling.to_host(v) for key, v in state.items()}


def _live_share(s: _Split, n_real, cnt, live_all):
    """This rank's live rows: every real row (``live_all``), or those that a
    rating reaches."""
    if live_all:
        return torch.arange(s.start, s.start + s.share,
                            device=cnt.device) < n_real
    return cnt > 0


def _dense_explicit_setup(rows, cols, vals_raw, weights, m, n, k, *, lam6,
                          user_bias, item_bias, glob_mean, scale_lam, seed,
                          dev, init, live_all_A=False, live_all_B=False,
                          mesh=None):
    """Shared set-up of the explicit engines: the dense forms, liveness,
    bias init and the (warm-started) factors.  Returns (X, W, XT, WT, cnt_A,
    cnt_B, live_A, live_B, A, B, rows): this rank's rows of the dense
    forms, counts and liveness, the whole factors, and the _Rows."""
    m_pad, n_pad, Kp = padded_dims(m, n, k)
    with profiling.span("cmfrec.engine.setup"):
        X, W, XT, WT, cnt_A, cnt_B = _setup(
            _upload(rows, np.int64, dev), _upload(cols, np.int64, dev),
            _upload(vals_raw, np.float32, dev),
            None if weights is None else _upload(weights, np.float32, dev),
            m_pad, n_pad, mesh)
        sa, sb = _split(m_pad, mesh), _split(n_pad, mesh)
        # rows that no rating reaches are dead (zero), unless the fit gives
        # every real row a system of its own (NA-as-zero, side info)
        live_A = _live_share(sa, m, cnt_A, live_all_A)
        live_B = _live_share(sb, n, cnt_B, live_all_B)
    mu = float(np.float32(glob_mean))
    if user_bias or item_bias:
        with profiling.span("cmfrec.engine.bias_init"):
            bA, bB = _device_bias_init(X, W, cnt_A, cnt_B, mu,
                                       float(lam6[0]), float(lam6[1]),
                                       scale_lam, user_bias, item_bias, mesh)
    else:
        bA = torch.zeros(sa.total, device=dev)
        bB = torch.zeros(sb.total, device=dev)
    rws = _Rows(sa, sb, mesh, _whole_mask(live_A, mesh),
                _whole_mask(live_B, mesh))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    A = _init_factors(gen, rws.live_A, bA, sa, Kp, k, user_bias)
    B = _init_factors(gen, rws.live_B, bB, sb, Kp, k, item_bias)
    _apply_init(A, B, init, m, n, k, user_bias, item_bias)
    return X, W, XT, WT, cnt_A, cnt_B, live_A, live_B, A, B, rws


@profiling.engine
def fit_explicit_dense_masked(
    rows, cols, vals_raw, m, n, *, weights,
    k, lam6, niter, max_cg_steps, finalize_chol, finalize_steps,
    user_bias, item_bias, glob_mean, scale_lam, scale_bias_const,
    seed, verbose, device, init=None, na_as_zero=False, ckpt=None,
    exact=False, dtype=np.float32, precondition_cg=False, mesh=None,
) -> dict:
    """Fit explicit ALS on the dense-masked engine.  Returns A [m,k], B [n,k],
    biasA/biasB (or None), glob_mean and k; tensors stay on ``device``.
    Under ``mesh`` each rank holds its rows of the dense form and every rank
    returns the whole model."""
    _require_f32_plain_cg(dtype, precondition_cg)
    Kp = padded_dims(m, n, k)[2]
    weighted = weights is not None
    dev = torch.device(device)
    (X, W, XT, WT, cnt_A, cnt_B, live_A, live_B, A, B,
     rws) = _dense_explicit_setup(
        rows, cols, vals_raw, weights, m, n, k, lam6=lam6,
        user_bias=user_bias, item_bias=item_bias, glob_mean=glob_mean,
        scale_lam=scale_lam, seed=seed, dev=dev, init=init,
        # every real row/column participates (missing entries are zeros)
        live_all_A=na_as_zero, live_all_B=na_as_zero, mesh=mesh)

    count_avg_A = count_avg_B = 1.0
    if scale_lam:
        tot = float(np.sum(weights)) if weighted else float(len(rows))
        count_avg_A = tot / max(m, 1)
        count_avg_B = tot / max(n, 1)
    if na_as_zero:
        # shared [Kp] diagonal: under NA-as-zero every row sees the full
        # column count, so the scaled lambda is row-independent
        def lam_diag_for(lam_f, lam_bias, has_bias, n_opp, count_avg):
            v = np.ones(Kp, np.float32)
            v[:k] = lam_f * (n_opp if scale_lam else 1.0)
            if has_bias:
                v[k] = lam_bias * (
                    count_avg if (scale_lam and scale_bias_const)
                    else (n_opp if scale_lam else 1.0))
            return profiling.upload(v, dev)

        lam_row_A = lam_diag_for(lam6[2], lam6[0], user_bias, n, count_avg_A)
        lam_row_B = lam_diag_for(lam6[3], lam6[1], item_bias, m, count_avg_B)
    else:
        lam_kw = dict(k=k, Kp=Kp, scale_lam=scale_lam,
                      scale_bias_const=scale_bias_const)
        lam_row_A = _lam_rows(lam6[2], lam6[0], user_bias, cnt_A, count_avg_A,
                              **lam_kw)
        lam_row_B = _lam_rows(lam6[3], lam6[1], item_bias, cnt_B, count_avg_B,
                              **lam_kw)

    mu = float(np.float32(glob_mean))
    args = (X, W, XT, WT, lam_row_A, lam_row_B, live_A, live_B, mu)
    lists = _RowLists(W, WT, len(rows), rws.a.pad, rws.b.pad, Kp)
    st = {"A": A, "B": B}

    def step(**kw):
        st["A"], st["B"] = _iteration(st["A"], st["B"], *args, k=k,
                                      user_bias=user_bias,
                                      item_bias=item_bias, na0=na_as_zero,
                                      rows=rws, lists=lists, **kw)

    def _state():
        # checkpoint layout == return layout (1:1 with init=)
        A, B = st["A"], st["B"]
        return {
            "A": A[:m, :k],
            "B": B[:n, :k],
            "biasA": A[:m, k] if user_bias else None,
            "biasB": B[:n, k] if item_bias else None,
        }

    # Exact mode (use_cg=False in fit_explicit_als): every half-step's CG runs in
    # f32 to the per-row freeze under the Krylov step cap with the
    # all-frozen exit -- the per-row systems solved to the f32 fixed point.
    # NA-as-zero solves are exact closed forms: no exact mode, no polish.
    bulk, polish = _schedule(exact and not na_as_zero, k + 1, max_cg_steps,
                             finalize_steps, finalize_chol and not na_as_zero)
    _run_fit(step, niter, bulk, polish, verbose=verbose, dev=dev,
             save=None if ckpt is None else
             lambda it: ckpt.maybe_save(it, lambda: _host_state(_state())))

    out = _state()
    out.update({"glob_mean": float(glob_mean), "k": k})
    return out


# ----------------------------------------------------------------------- #
# collective explicit                                                      #
# ----------------------------------------------------------------------- #


def _upload_side(S, rows_pad, dev):
    """A dense side matrix [rows, p] as f32 on the device, zero-padded to
    rows_pad rows (None stays None)."""
    if S is None:
        return None
    S = np.asarray(S, np.float32)
    return _upload(np.pad(S, ((0, rows_pad - S.shape[0]), (0, 0))),
                   np.float32, dev)


def _rows_of(S, s: _Split):
    """This rank's rows of a whole side matrix (None stays None)."""
    return None if S is None else S[s.sl]


def _collective_iteration(A, B, X, W, XT, WT, Ud, Id, lam_row_A, lam_row_B,
                          live_A, live_B, mu, lamC, lamD, w_user, w_item,
                          lam_ai, lam_bi, w_imp, *, k, user_bias, item_bias,
                          n_steps, compute, dyn_stop, rows, lists=None,
                          it=None):
    """One collective iteration in the reference's order: C, D, Bi, Ai, then
    B, then A (upstream cmfrec src/collective.c:8345,8396,8479,8520,8614,
    8802).  C/D/Bi/Ai are solved from the pre-update A/B.  Returns A, B, C,
    D, Ai, Bi (None where the fit has no such part), all whole: Ud and Id
    are whole, C and D solved alike on every rank; Ai and Bi are solved on
    each rank's rows of the masks and gathered.  The Xones work is the span
    ``cmfrec.engine.impfeat`` (attrs ``it``, the iteration, and
    ``compute``)."""
    Kp = A.shape[1]
    # the implicit-features products take bf16-rounded factors in the bf16
    # iterations on a card, as on the TPU; the CPU multiplies f32 factors,
    # as the JAX package does off the TPU
    mdt = (torch.bfloat16 if compute == "bf16" and A.device.type == "cuda"
           else torch.float32)
    C = None if Ud is None else _solve_side_factor(A[:, :k], Ud, w_user,
                                                   lamC, k)
    D = None if Id is None else _solve_side_factor(B[:, :k], Id, w_item,
                                                   lamD, k)
    Ai = Bi = None
    if lam_ai is not None:
        # Xones ~ A Bi^T and Xones^T ~ B Ai^T, both from the pre-update A/B
        with profiling.span("cmfrec.engine.impfeat", it=it, compute=compute):
            Bi = rows.gather(_shared_na0_solve(A[:, :k], WT, lam_bi, mdt))
            Ai = rows.gather(_shared_na0_solve(B[:, :k], W, lam_ai, mdt))
            rhs_B = _xones_matmul(WT, Ai, mdt)
            rhs_A = _xones_matmul(W, Bi, mdt)
    parts_B, parts_A = [], []
    if D is not None:
        parts_B.append((w_item, D, _rows_of(Id, rows.b) @ D))
    if C is not None:
        parts_A.append((w_user, C, _rows_of(Ud, rows.a) @ C))
    if Ai is not None:
        parts_B.append((w_imp, Ai, rhs_B))
        parts_A.append((w_imp, Bi, rhs_A))
    G0B, R0B = _side_terms(rows.b.share, Kp, k, parts_B)
    G0A, R0A = _side_terms(rows.a.share, Kp, k, parts_A)
    A, B = _iteration(A, B, X, W, XT, WT, lam_row_A, lam_row_B, live_A,
                      live_B, mu, k=k, user_bias=user_bias,
                      item_bias=item_bias, n_steps=n_steps, compute=compute,
                      dyn_stop=dyn_stop, G0B=G0B, R0B=R0B, G0A=G0A, R0A=R0A,
                      rows=rows, lists=lists)
    return A, B, C, D, Ai, Bi


@profiling.engine
def fit_collective_dense_masked(
    rows, cols, vals_raw, m, n, *, U_dense, I_dense, weights,
    k, lam6, w_user, w_item, niter, max_cg_steps, finalize_chol,
    finalize_steps, user_bias, item_bias, glob_mean, scale_lam,
    scale_lam_sideinfo=False, scale_bias_const=False, seed=1, verbose=False,
    device="cpu", init=None, add_implicit_features=False, w_implicit=0.5,
    exact=False, dtype=np.float32, precondition_cg=False, mesh=None,
) -> dict:
    """Collective explicit ALS with fully dense side info (U_dense [m, p],
    I_dense [n, q], centered) and/or implicit features on the dense-masked
    engine (k_user = k_item = k_main = 0; unweighted with implicit
    features).  exact=True (use_cg=False) runs every A/B half-step's CG to
    the per-row freeze under the Krylov cap; the C/D/Ai/Bi half-steps are
    closed forms already.  Returns A, B, biasA/biasB (or None), C [p, k], D
    [q, k], Ai [m, k], Bi [n, k] (or None), glob_mean and k; the returned
    C/D/Ai/Bi are those solved at the last iteration's start, and with
    niter=0 those of the starting factors.  Under ``mesh`` the dense side
    matrices are whole on every rank, X and W a rank's rows."""
    _require_f32_plain_cg(dtype, precondition_cg)
    Kp = padded_dims(m, n, k)[2]
    dev = torch.device(device)
    has_impl = bool(add_implicit_features)
    # with dense side info (or implicit features, whose Xones part gives
    # every row a full-rank system) every real row participates
    (X, W, XT, WT, cnt_A, cnt_B, live_A, live_B, A, B,
     rws) = _dense_explicit_setup(
        rows, cols, vals_raw, weights, m, n, k, lam6=lam6,
        user_bias=user_bias, item_bias=item_bias, glob_mean=glob_mean,
        scale_lam=scale_lam, seed=seed, dev=dev, init=init,
        live_all_A=U_dense is not None or has_impl,
        live_all_B=I_dense is not None or has_impl, mesh=mesh)
    Ud = _upload_side(U_dense, rws.a.total, dev)
    Id = _upload_side(I_dense, rws.b.total, dev)

    count_avg_A = count_avg_B = 1.0
    if scale_lam:
        tot = float(np.sum(weights)) if weights is not None else float(len(rows))
        count_avg_A = tot / max(m, 1)
        count_avg_B = tot / max(n, 1)
    # dense side info adds p (resp. q) observations a row under
    # scale_lam_sideinfo (upstream cmfrec src/common.c:689-724)
    if scale_lam_sideinfo and Ud is not None:
        cnt_A = cnt_A + float(Ud.shape[1])
    if scale_lam_sideinfo and Id is not None:
        cnt_B = cnt_B + float(Id.shape[1])
    lam_kw = dict(k=k, Kp=Kp, scale_lam=scale_lam,
                  scale_bias_const=scale_bias_const)
    lam_row_A = _lam_rows(lam6[2], lam6[0], user_bias, cnt_A, count_avg_A,
                          **lam_kw)
    lam_row_B = _lam_rows(lam6[3], lam6[1], item_bias, cnt_B, count_avg_B,
                          **lam_kw)

    def f32(x):
        return float(np.float32(x))

    lam_ai = lam_bi = None
    if has_impl:
        # The Xones half-steps: under scale_lam their multiplier is the
        # full opposing length (shared across rows), and lambda is divided
        # by w_implicit so the unweighted shared-Gram solve lands on the
        # reference's weighted system (upstream cmfrec
        # src/collective.c:8479,8520)
        lam_ai = torch.full((k,), f32(lam6[2] / w_implicit
                                      * (float(n) if scale_lam else 1.0)),
                            device=dev)
        lam_bi = torch.full((k,), f32(lam6[3] / w_implicit
                                      * (float(m) if scale_lam else 1.0)),
                            device=dev)
    args = (X, W, XT, WT, Ud, Id, lam_row_A, lam_row_B, live_A, live_B,
            f32(glob_mean), f32(lam6[4]), f32(lam6[5]), f32(w_user),
            f32(w_item), lam_ai, lam_bi, f32(w_implicit))
    lists = _RowLists(W, WT, len(rows), rws.a.pad, rws.b.pad, Kp)
    st = {"A": A, "B": B, "C": None, "D": None, "Ai": None, "Bi": None,
          "it": 0}

    def step(**kw):
        st["it"] += 1
        out = _collective_iteration(st["A"], st["B"], *args, k=k,
                                    user_bias=user_bias, item_bias=item_bias,
                                    rows=rws, lists=lists, it=st["it"], **kw)
        st.update(zip(("A", "B", "C", "D", "Ai", "Bi"), out))

    bulk, polish = _schedule(exact, k + 1, max_cg_steps, finalize_steps,
                             finalize_chol)
    _run_fit(step, niter, bulk, polish, verbose=verbose, dev=dev)

    A, B = st["A"], st["B"]
    if niter == 0:
        # no iteration ran: the side factors of the starting A/B
        if Ud is not None:
            st["C"] = _solve_side_factor(A[:, :k], Ud, f32(w_user),
                                         f32(lam6[4]), k)
        if Id is not None:
            st["D"] = _solve_side_factor(B[:, :k], Id, f32(w_item),
                                         f32(lam6[5]), k)
        if has_impl:
            st["Bi"] = rws.gather(_shared_na0_solve(A[:, :k], WT, lam_bi,
                                                    torch.float32))
            st["Ai"] = rws.gather(_shared_na0_solve(B[:, :k], W, lam_ai,
                                                    torch.float32))
    return {
        "A": A[:m, :k],
        "B": B[:n, :k],
        "biasA": A[:m, k] if user_bias else None,
        "biasB": B[:n, k] if item_bias else None,
        "C": st["C"], "D": st["D"],
        "Ai": None if st["Ai"] is None else st["Ai"][:m],
        "Bi": None if st["Bi"] is None else st["Bi"][:n],
        "glob_mean": float(glob_mean),
        "k": k,
    }


# ----------------------------------------------------------------------- #
# implicit (WRMF) and collective implicit                                  #
# ----------------------------------------------------------------------- #


def _half_step_implicit(P, Wx, Xp, M, Be, live, live_opp, lam_vec, w_mult, *,
                        n_steps, compute_dtype, dyn_stop=False, side=None,
                        mesh=None):
    """WRMF half-step: (w (B^T B + sum_obs alpha*x b b^T) + lam) a =
    w sum_obs (1 + alpha*x) b (upstream cmfrec src/common.c:1914), B the
    live opposing rows.  ``side`` = (w_side, C, S) adds the collective
    fit's dense side-info terms w_side C^T C and w_side S @ C
    (optimizeA_collective_implicit, upstream cmfrec src/collective.c:5971);
    a collective fit (side given, or the empty tuple) scales the Gram base
    by w before adding them, as the TPU engine does.  P, Wx, Xp, M, live
    and S are this rank's rows under ``mesh``; Be and live_opp whole."""
    Bl = torch.where(live_opp[:, None], Be, 0.0)
    Bek = Bl.to(compute_dtype)
    G0 = Bl.T @ Bl
    R0 = None
    if side is not None:
        G0 = G0 * w_mult
        if side:
            w_side, C, S = side
            k = C.shape[1]
            Gs = torch.zeros_like(G0)
            Gs[:k, :k] = C.T @ C
            G0 = G0 + w_side * Gs
            R0 = torch.zeros_like(P)
            R0[:, :k] = w_side * (S @ C)
    zero_mb = torch.zeros(Bl.shape[0], dtype=torch.float32, device=Bl.device)
    rhs = w_mult * masked_rhs(Xp, M, zero_mb, Bek)
    if R0 is not None:
        rhs = rhs + R0

    def matvec(v):
        mv = masked_gram_matvec(v.to(compute_dtype), Bek, Wx)
        if side is not None:
            return w_mult * mv + v @ G0.T + v * lam_vec[None, :]
        return w_mult * (mv + v @ G0.T) + v * lam_vec[None, :]

    a = _cg(P, rhs, matvec, n_steps, dyn_stop=dyn_stop, mesh=mesh)
    return torch.where(live[:, None], a, 0.0)


def _implicit_iteration(A, B, Wx, Xp, M, WxT, XpT, MT, lam_vec_A, lam_vec_B,
                        live_A, live_B, w_mult, *, k, n_steps, compute,
                        dyn_stop, rows, side=None):
    """One WRMF iteration, B half-step then A (upstream cmfrec
    src/collective.c:9927 "Optimize B" before :9981 "Optimize A").  ``side``
    (a collective fit's dict of Ud, Id, w_user, w_item, lamC, lamD) first
    solves C and D from the pre-update A and B.  Returns A, B, C, D, whole
    (``rows``, a _Rows, says this rank's rows)."""
    cdt = torch.bfloat16 if compute == "bf16" else torch.float32
    C = D = None
    side_B = side_A = None
    if side is not None:
        if side["Ud"] is not None:
            C = _solve_side_factor(A[:, :k], side["Ud"], side["w_user"],
                                   side["lamC"], k)
        if side["Id"] is not None:
            D = _solve_side_factor(B[:, :k], side["Id"], side["w_item"],
                                   side["lamD"], k)
        side_B = () if D is None else (side["w_item"], D,
                                       _rows_of(side["Id"], rows.b))
        side_A = () if C is None else (side["w_user"], C,
                                       _rows_of(side["Ud"], rows.a))
    kw = dict(n_steps=n_steps, compute_dtype=cdt, dyn_stop=dyn_stop,
              mesh=rows.mesh)
    B = rows.gather(_half_step_implicit(
        B[rows.b.sl], WxT, XpT, MT, A, live_B, rows.live_A, lam_vec_B,
        w_mult, side=side_B, **kw))
    A = rows.gather(_half_step_implicit(
        A[rows.a.sl], Wx, Xp, M, B, live_A, rows.live_B, lam_vec_A, w_mult,
        side=side_A, **kw))
    return A, B, C, D


def _fit_implicit(rows, cols, vals, m, n, *, k, lam6, niter, max_cg_steps,
                  finalize_steps, finalize_chol, alpha, w_main_multiplier,
                  seed, verbose, device, init, ckpt, exact, side, mesh=None):
    """The WRMF engine of fit_implicit_dense_masked (side None) and
    fit_collective_implicit_dense_masked (side the dense side matrices and
    their weights and lambdas)."""
    m_pad, n_pad, Kp = padded_dims(m, n, k, bias_col=False)
    dev = torch.device(device)
    # alpha * x formed in f64 on the host, as the TPU engine's upload does
    av = (float(alpha) * np.asarray(vals, np.float64)).astype(np.float32)
    with profiling.span("cmfrec.engine.setup"):
        Wx, Xp, M, WxT, XpT, MT, cnt_A, cnt_B = _setup_implicit(
            _upload(rows, np.int64, dev), _upload(cols, np.int64, dev),
            _upload(av, np.float32, dev), m_pad, n_pad, mesh)
        sa, sb = _split(m_pad, mesh), _split(n_pad, mesh)
        sd = None
        if side is not None:
            sd = dict(Ud=_upload_side(side["U"], sa.total, dev),
                      Id=_upload_side(side["I"], sb.total, dev),
                      w_user=float(np.float32(side["w_user"])),
                      w_item=float(np.float32(side["w_item"])),
                      lamC=float(np.float32(lam6[4])),
                      lamD=float(np.float32(lam6[5])))
        # dense side info gives every real row a system of its own
        live_A = _live_share(sa, m, cnt_A,
                             sd is not None and sd["Ud"] is not None)
        live_B = _live_share(sb, n, cnt_B,
                             sd is not None and sd["Id"] is not None)
    rws = _Rows(sa, sb, mesh, _whole_mask(live_A, mesh),
                _whole_mask(live_B, mesh))

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    A = _init_factors(gen, rws.live_A, 0.0, sa, Kp, k, False)
    B = _init_factors(gen, rws.live_B, 0.0, sb, Kp, k, False)
    _apply_init(A, B, init, m, n, k)

    def lam_vec_for(lam_f):
        v = np.ones(Kp, np.float32)
        v[:k] = lam_f
        return profiling.upload(v, dev)

    args = (Wx, Xp, M, WxT, XpT, MT, lam_vec_for(lam6[2]),
            lam_vec_for(lam6[3]), live_A, live_B,
            float(np.float32(w_main_multiplier)))
    st = {"A": A, "B": B, "C": None, "D": None}

    def step(**kw):
        out = _implicit_iteration(st["A"], st["B"], *args, k=k, side=sd,
                                  rows=rws, **kw)
        st.update(zip(("A", "B", "C", "D"), out))

    def _state():
        # checkpoint layout == return layout (1:1 with init=)
        return {"A": st["A"][:m, :k], "B": st["B"][:n, :k]}

    bulk, polish = _schedule(exact, k, max_cg_steps, finalize_steps,
                             finalize_chol)
    _run_fit(step, niter, bulk, polish, verbose=verbose, dev=dev,
             save=None if ckpt is None else
             lambda it: ckpt.maybe_save(it, lambda: _host_state(_state())))

    out = _state()
    if sd is not None:
        if niter == 0:
            # no iteration ran: the side factors of the starting A/B
            if sd["Ud"] is not None:
                st["C"] = _solve_side_factor(A[:, :k], sd["Ud"], sd["w_user"],
                                             sd["lamC"], k)
            if sd["Id"] is not None:
                st["D"] = _solve_side_factor(B[:, :k], sd["Id"], sd["w_item"],
                                             sd["lamD"], k)
        out.update({"C": st["C"], "D": st["D"]})
    out.update({"biasA": None, "biasB": None, "glob_mean": 0.0, "k": k,
                "w_main_multiplier": float(w_main_multiplier),
                "alpha": alpha})
    return out


@profiling.engine
def fit_implicit_dense_masked(
    rows, cols, vals, m, n, *, k, lam6, niter, max_cg_steps, finalize_steps,
    finalize_chol, alpha, w_main_multiplier, seed, verbose, device,
    init=None, ckpt=None, exact=False, dtype=np.float32,
    precondition_cg=False, mesh=None,
) -> dict:
    """WRMF on the dense-masked engine (the dense confidence form); the same
    systems as the bucketed implicit engine.  K1 runs on W = bf16(alpha*x),
    K2 on X = bf16(1 + alpha*x) with the int8 mask.  exact=True (use_cg=False)
    runs each half-step's CG to the per-row freeze under the Krylov cap.
    Returns A [m, k], B [n, k] on ``device``, w_main_multiplier and alpha."""
    _require_f32_plain_cg(dtype, precondition_cg)
    return _fit_implicit(
        rows, cols, vals, m, n, k=k, lam6=lam6, niter=niter,
        max_cg_steps=max_cg_steps, finalize_steps=finalize_steps,
        finalize_chol=finalize_chol, alpha=alpha,
        w_main_multiplier=w_main_multiplier, seed=seed, verbose=verbose,
        device=device, init=init, ckpt=ckpt, exact=exact, side=None,
        mesh=mesh)


@profiling.engine
def fit_collective_implicit_dense_masked(
    rows, cols, vals, m, n, *, U_dense, I_dense, k, lam6, w_user, w_item,
    niter, max_cg_steps, finalize_steps, finalize_chol, alpha,
    w_main_multiplier, seed, verbose, device, init=None, exact=False,
    dtype=np.float32, precondition_cg=False, mesh=None,
) -> dict:
    """Collective WRMF with fully dense side info on the dense-masked engine
    (k_user = k_item = k_main = 0): C and D are solved whole-matrix at each
    iteration's start, then B, then A.  Returns what
    fit_implicit_dense_masked does plus C [p, k] and D [q, k] (or None), the
    last iteration's (with niter=0, those of the starting factors)."""
    _require_f32_plain_cg(dtype, precondition_cg)
    return _fit_implicit(
        rows, cols, vals, m, n, k=k, lam6=lam6, niter=niter,
        max_cg_steps=max_cg_steps, finalize_steps=finalize_steps,
        finalize_chol=finalize_chol, alpha=alpha,
        w_main_multiplier=w_main_multiplier, seed=seed, verbose=verbose,
        device=device, init=init, ckpt=None, exact=exact,
        side=dict(U=U_dense, I=I_dense, w_user=w_user, w_item=w_item),
        mesh=mesh)
