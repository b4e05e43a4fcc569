"""Collective matrix factorization ALS drivers
(port of cmfrec_tpu/solvers/collective.py).

The joint model (upstream cmfrec src/collective.c:78-355):

    X[m,n]  ~  A[:, k_user:] . B[:, k_item:]^T   (+ biases + mean)
    U[m,p]  ~  A[:, :k_user+k] . C^T             (weight w_user)
    I[n,q]  ~  B[:, :k_item+k] . D^T             (weight w_item)
    Xones   ~  A[:, k_user:] . Bi^T,  Xones^T ~ B[:, k_item:] . Ai^T
                                                  (weight w_implicit)

Two routes, chosen as the JAX package chooses them (:func:`_dense_route`):

- the dense-masked engine (solvers/dense_masked.py, kernels K1/K2) for
  fully dense side information with no k splits, w_main = 1, no
  NA-as-zero option, unweighted implicit features, no warm C/D/Ai/Bi, no
  nonneg, nonneg_C, nonneg_D or l1_lambda, and a
  dense form within the card's budget: fully dense side info contributes
  a shared Gram (C^T C) and a dense rhs (U @ C), and C/D/Ai/Bi are
  whole-matrix closed-form solves;
- the bucketed engine (solvers/als.py, kernel K3) for everything else.  A
  row's system is assembled from sparse parts sharing one coordinate space
  (the reference's extended Be = [[0, Bs, Bm], [Cu, Cs, 0]],
  src/collective.c:179-214): the X part on coordinates [k_user:], a sparse
  side-info part on [:k_user+k], the implicit-features part on [k_user:],
  the bias on the last coordinate; dense side info adds a shared Gram and
  per-bucket rhs bases instead of a part.  Side-info-only entities (side
  matrices with more rows than X) get rows with no X part.  The update
  order per iteration is the reference's (src/collective.c:8334-8860):
  C, D, Bi, Ai, B, A.

Under ``nonneg``, ``nonneg_C``, ``nonneg_D`` or ``l1_lambda`` the
half-steps they constrain solve by coordinate descent (solvers/als.py; the
CD kernel on a card), the dense C/D update with one G shared by every side
column; ``nonneg`` turns CG off, as in the JAX package.

A float64 fit, or one with Jacobi PCG (``precondition_cg``), never takes
the dense-masked route: it runs the bucketed route's plain-torch solves in
the fit's dtype, as the JAX package's routes send it to its XLA code
(cmfrec_tpu/solvers/collective.py:382-416, :1088-1114).

``mesh=`` (parallel/mesh.py) fits data-parallel on both routes, as the JAX
package's ``_mesh_place_collective`` (cmfrec_tpu/solvers/collective.py:
64-88): each rank holds its rows of the X buckets, of the side-info
feature buckets, of the aligned parts, the dense side slices and the mean
slices; C, D, the dense side matrices and the permutations are whole on
every rank.

``shard_opposing_rows=True`` (the big-axis ring, parallel/ring.py;
cmfrec_tpu/solvers/collective.py:64-131, 714-930, 1253-1420) takes the
bucketed route and keeps A, B, Ai, Bi, and C and D of sparse side
information, row-sharded for the whole fit: each rank holds the rows it
solves, in ring order (parallel/ring.py:RingSide), and every slot that
indexes one of them (the X buckets, the side-info feature buckets, the
aligned parts) is rewritten into that order once a fit.  The real-row and
X-row masks and the dense side matrices' rows follow the same order; the
Gram and cross terms over a sharded matrix (the NA-as-zero bases, the
implicit B^T B, the dense C/D solves' A1^T A1 and A1^T U) are partial sums
added over the ranks.  C and D of dense side information stay whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import time

import numpy as np
import torch

from ..config import (resolve_device, resolve_dtype, should_handle_interrupt,
                      torch_dtype)
from ..data.device_fill import (build_bucketed_pair_share,
                                build_bucketed_rows_share)
from ..data.shards import BucketedRows
from ..parallel.mesh import gather_blocks, row_share, world_rank
from ..parallel.ring import RingSide, row_sum
from ..utils import profiling
from ..utils.checkpoint import FitCheckpointer
from ..utils.profiling import profiled_fit
from ..ops import coord_descent
from . import drivers, preprocess
from .als import (
    PartData,
    SidePlan,
    blocks_to_orig,
    gram_matrix,
    init_blocks,
    update_side,
)
from .dense_masked import (
    _round_up,
    fit_collective_dense_masked,
    fit_collective_implicit_dense_masked,
)


# --------------------------------------------------------------------- #
# side-info preparation                                                  #
# --------------------------------------------------------------------- #


@dataclass
class PreparedSide:
    p: int  # number of features (columns of U)
    n_ent: int  # number of entities (rows of U); may exceed the X dimension
    na0: bool  # NA_as_zero_user / NA_as_zero_item
    colmeans: Optional[np.ndarray]  # f64 [p] when centered
    dense: Optional[np.ndarray]  # centered [n_ent, p] in the fit's dtype
    # when fully observed
    coo: Optional[tuple]  # (rows, cols, vals) otherwise: centered unless na0


def prepare_side(side, center: bool, na0: bool = False, dtype=np.float32
                 ) -> Optional[PreparedSide]:
    """Normalize an ingested side-info matrix (see _BaseModel._ingest_side):
    a fully observed one is column-centered (means over its rows, kept as
    colmeans); a sparse one keeps its triplets, centered over the observed
    entries, or under NA-as-zero raw, with means over all n_ent rows that
    the fit subtracts through the part's opp_bias."""
    if side is None:
        return None
    rows, cols, vals, n_ent, p, is_dense, dense = side
    colmeans = None
    if is_dense:
        dense = np.asarray(dense, np.float64)
        if center:
            colmeans = dense.mean(axis=0)
            dense = dense - colmeans[None, :]
        return PreparedSide(p=p, n_ent=n_ent, na0=na0, colmeans=colmeans,
                            dense=dense.astype(dtype), coo=None)
    vals = np.asarray(vals, np.float64)
    centered = vals
    if center:
        centered, colmeans = preprocess.center_columns(
            rows, cols, vals, p, na_as_zero=na0, n_rows=n_ent)
    return PreparedSide(p=p, n_ent=n_ent, na0=na0, colmeans=colmeans,
                        dense=None,
                        coo=(rows, cols, vals if na0 else centered))


def _sparsify_short_dense_side(side, xdim):
    """A dense side matrix with fewer rows than the main dimension
    (m_u < m) is re-expressed as sparse triplets over its rows: the dense
    paths assume every main row has a side row (shared CtC Gram +
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


def build_aligned_parts(bucketed: BucketedRows, rows_s, cols_s, vals_s,
                        n_ent: int, dev, dtype=np.float32, mesh=None):
    """Pad a second sparse matrix's rows in the exact row order of an
    existing bucketing (so the X part and the side part of one row system
    sit in the same batch slot): per bucket (idx [R, L] int32, val [R, L]
    of ``dtype``, length [R] int32) on ``dev``, L the bucket's longest side
    row rounded up to 8.  The sort and scatter run on the host.  Under
    ``mesh`` only this rank's share of each bucket's rows
    (parallel/mesh.py:row_share) is built and uploaded, L still the whole
    bucket's."""
    rows_s = np.asarray(rows_s, np.int64)
    order = np.argsort(rows_s, kind="stable")
    sc = np.asarray(cols_s, np.int64)[order]
    sv = np.asarray(vals_s, np.float64)[order]
    counts = np.bincount(rows_s, minlength=max(n_ent, bucketed.n_rows))
    indptr = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])

    out = []
    for b in bucketed.buckets:
        ids = bucketed.row_of[b.start:b.start + b.n_rows]  # -1 on padding
        ns = np.where(ids >= 0, counts[np.maximum(ids, 0)], 0)
        L = _round_up(max(int(ns.max()), 1), 8)
        sl = row_share(b.n_rows, mesh)
        ids, ns = ids[sl], ns[sl]
        R = sl.stop - sl.start
        idx = np.zeros((R, L), np.int32)
        val = np.zeros((R, L), dtype)
        total = int(ns.sum())
        if total:
            starts = np.where(ids >= 0, indptr[np.maximum(ids, 0)], 0)
            seg_off = np.repeat(np.cumsum(ns) - ns, ns)
            within = np.arange(total, dtype=np.int64) - seg_off
            src = np.repeat(starts, ns) + within
            dest_r = np.repeat(np.arange(R, dtype=np.int64), ns)
            idx[dest_r, within] = sc[src]
            val[dest_r, within] = sv[src]
        out.append(tuple(profiling.upload(a, dev)
                         for a in (idx, val, ns.astype(np.int32))))
    return out


def _bucket_dense_slices(bucketed: BucketedRows, M: np.ndarray, dev,
                         mesh=None):
    """Per-bucket dense row slices of M in its dtype (rows beyond M ->
    zeros): under ``mesh`` this rank's share of each bucket's rows."""
    out = []
    for b in bucketed.buckets:
        share = row_share(b.n_rows, mesh)
        ids = bucketed.row_of[b.start + share.start:b.start + share.stop]
        sl = np.zeros((ids.size, M.shape[1]), M.dtype)
        ok = (ids >= 0) & (ids < M.shape[0])
        sl[ok] = M[ids[ok]]
        out.append(profiling.upload(sl, dev))
    return out


def _pad_cols(M: torch.Tensor, k_pad: int, offset: int) -> torch.Tensor:
    """M's columns at [offset : offset + width] of a k_pad-wide matrix."""
    out = torch.zeros(M.shape[0], k_pad, dtype=M.dtype, device=M.device)
    out[:, offset:offset + M.shape[1]] = M
    return out


def _dense_rhs(U_slice, Ce, w):
    """w * U_bucket @ Ce: per-row rhs base from fully dense side info."""
    return w * (U_slice @ Ce)


def _dense_full_solve(A1, U, lam_vec, w, nonneg, l1_vec, max_cd_steps,
                      lam_scale=1.0, ring=None):
    """Whole-matrix update of C (or D) from fully dense side info:
    (w A1^T A1 + diag(lam)) C^T = w A1^T U, by one Cholesky (the
    reference's optimizeA case-1 fast path, upstream cmfrec
    src/common.c:2787).  ``lam_scale``: the scale_lam multiplier, the
    number of side-info rows (case 1 uses lam * n).  Under ``nonneg`` or an
    ``l1_vec`` (scaled by ``lam_scale`` too) every side column is solved by
    coordinate descent against the one G, passed with row stride 0.  Under
    the big-axis ``ring`` (the rows' RingSide and the mesh) A1 and U are
    this rank's rows of them (ring order) and A1^T A1 and the cross term
    are added over the ranks (parallel/ring.py:row_sum)."""
    side, mesh = ring or (None, None)
    G = w * row_sum(gram_matrix, side, mesh, A1) + torch.diag(
        lam_vec * lam_scale)
    if nonneg or l1_vec is not None:
        rhs = w * row_sum(lambda a, u: u.T @ a, side, mesh, A1, U)  # [p, K]
        l1 = torch.zeros_like(lam_vec) if l1_vec is None else l1_vec
        return coord_descent.solve_cd(
            G.expand(rhs.shape[0], *G.shape), rhs.contiguous(),
            (l1 * lam_scale).contiguous(), nonneg=nonneg,
            max_steps=max_cd_steps)
    rhs = w * row_sum(lambda a, u: a.T @ u, side, mesh, A1, U)  # [K, p]
    return torch.cholesky_solve(rhs, torch.linalg.cholesky(G)).T


def _init_dense_ok(init):
    """Whether a warm restart may ride the dense engine.  The engine seeds
    A/B/biasA/biasB and solves C/D/Ai/Bi from them before first use
    (upstream cmfrec src/collective.c:8345/8396/8479/8520); a warm start
    that carries C/D/Ai/Bi goes to the bucketed route, as in the JAX
    package."""
    if init is None:
        return True
    return all(init.get(key) is None for key in ("C", "D", "Ai", "Bi"))


def _dense_route(U, I, m, n, *, k_user, k_item, k_main, w_main, na0,
                 add_implicit_features, weights, init, dense_bytes, dev,
                 cd=False, mesh=None):
    """Whether a collective fit takes the dense-masked engine: where the
    JAX package's ``use_dense_pallas`` would (cmfrec_tpu/solvers/
    collective.py:382-414, :1088-1113), with the card's budget
    (drivers._dense_budget; none on the CPU) in place of the TPU's, against
    a rank's share of the dense form under ``mesh``.  ``cd``: nonneg,
    nonneg_C, nonneg_D or an l1_lambda, which it never takes."""
    if not (k_user == 0 and k_item == 0 and k_main == 0 and w_main == 1.0
            and not na0 and not cd and _init_dense_ok(init)
            and not (add_implicit_features and weights is not None)):
        return False
    for side, dim in ((U, m), (I, n)):
        if side is not None and (side.dense is None or side.n_ent != dim):
            return False
    budget = drivers._mesh_budget(dev, mesh)
    return budget is None or dense_bytes // world_rank(mesh)[0] <= budget


def _side_layout(S: Optional[PreparedSide], main: BucketedRows, dev, dtype,
                 mesh):
    """The bucketed route's structures of one side matrix, in the fit's
    ``dtype``: (the feature bucketing's plan, (its share, the parts aligned
    to the main bucketing ``main`` (a plan), the dense slices, and under
    NA-as-zero with centering the column means of the feature buckets'
    rows)), all of this rank's rows under ``mesh`` (whose row block pads
    the feature buckets), built from them alone."""
    if S is None:
        return None, (None, None, None, None)
    if S.dense is not None:
        return None, (None, None,
                      _bucket_dense_slices(main, S.dense, dev, mesh), None)
    r_s, c_s, v_s = S.coo
    feat_plan, feat_b = build_bucketed_rows_share(
        c_s, r_s, v_s, S.p, S.n_ent, device=dev, dtype=dtype, mesh=mesh)
    aligned = build_aligned_parts(main, r_s, c_s, v_s, S.n_ent, dev, dtype,
                                  mesh)
    mean_slices = None
    if S.na0 and S.colmeans is not None:
        mean_slices = []
        for b in feat_b.buckets:
            ids = feat_b.row_of[b.start:b.start + b.n_rows]
            ms = np.zeros(b.n_rows, dtype)
            ok = ids >= 0
            ms[ok] = S.colmeans[ids[ok]]
            mean_slices.append(profiling.upload(ms, dev))
    return feat_plan, (feat_b, aligned, None, mean_slices)


def _side_init(S, featb, kx, kx_pad, gen, init_M, dev, tdt, side=None,
               share=None):
    """C (or D) at the start of a bucketed fit, of torch dtype ``tdt``: for
    dense side info a [p, kx_pad] matrix of N(0, 0.01^2), else bucket
    blocks over the features; ``init_M`` ([p, kx]) overrides.  Returns
    (blocks, orig).  Under the big-axis ring (``side``, the features'
    RingSide) the blocks are this rank's, laid out as ``share`` (its share
    of the feature bucketing), and orig is None."""
    if S.dense is not None:
        M = 0.01 * torch.randn(S.p, kx_pad, generator=gen, dtype=tdt,
                               device=dev)
        M[:, kx:] = 0.0
        if init_M is not None:
            M[:, :kx] = profiling.upload(init_M, dev, tdt)
        return None, M
    blocks = init_blocks(gen, featb, kx, kx_pad, tdt, side)
    if init_M is not None:
        drivers._seed_factor_blocks(blocks, featb if side is None else share,
                                    init_M, kx)
    if side is not None:
        return blocks, None
    return blocks, blocks_to_orig(blocks, profiling.upload(featb.perm, dev))


def _xdim_mask(limit, total, dev, tdt):
    """1 on the first ``limit`` of ``total`` rows: the shared Gram and rhs
    bases of the opposing side sum over the X (or side) rows only.  With
    side-info-only entities the factor matrices carry live rows beyond X's
    dimension, which the reference's opposing row counts exclude (its
    optimizeA calls pass m/n, upstream cmfrec src/collective.c:8461/9924)."""
    return profiling.upload(np.arange(total) < limit, dev, tdt)


def _side_factor_update(S, featb, blocks, A1, lam_vec, w_side, method,
                        mean_slices, *, n_steps, scale_lam, precondition,
                        l1_vec, nonneg, max_cd_steps, mesh=None,
                        ring_mesh=None, ring_side=None):
    """Update C (or D): rows = side-info features, opposing = A[:, :k_off+k].
    Under scale_lam (or scale_lam_sideinfo) the lambda scales with each
    feature's observed count too (upstream cmfrec src/collective.c:8373).
    Under ``ring_mesh`` A1 and the blocks are this rank's, A1's rows in the
    order of ``ring_side``."""
    plan = SidePlan(featb, "na0" if S.na0 else "explicit", S.n_ent)
    G0 = r0_blocks = None
    if S.na0:
        G0 = w_side * row_sum(gram_matrix, ring_side, ring_mesh, A1)
        if mean_slices is not None:
            colsum = row_sum(lambda a: a.sum(dim=0), ring_side, ring_mesh,
                             A1)
            r0_blocks = [-w_side * ms[:, None] * colsum[None, :]
                         for ms in mean_slices]
    return update_side(plan, blocks, A1, None, lam_vec, w=w_side, G0=G0,
                       r0_blocks=r0_blocks, l1_vec=l1_vec, method=method,
                       n_steps=n_steps, nonneg=nonneg,
                       max_cd_steps=max_cd_steps, scale_lam=scale_lam,
                       precondition=precondition, mesh=mesh,
                       ring_mesh=ring_mesh)


def _side_parts(S, aligned, Ce, w_side, n_buckets, scale_flag, dev,
                ring=None, ring_mesh=None):
    """A sparse side matrix's parts of the A (or B) systems, one list per
    bucket, and its shared bases under NA-as-zero: (extra, G0, r0_vec).
    Under ``ring_mesh`` Ce is this rank's shard of C in the order of
    ``ring`` (the features' RingSide) and the bases are added over the
    ranks."""
    extra = [[] for _ in range(n_buckets)]
    G0 = r0_vec = cm = None
    if S.na0:
        G0 = w_side * row_sum(gram_matrix, ring, ring_mesh, Ce)
        if S.colmeans is not None:
            cm = (profiling.upload(S.colmeans, dev, Ce.dtype)
                  if ring is None else
                  ring.values(S.colmeans).to(Ce.dtype))
        r0_vec = w_side * row_sum(
            lambda c, b: drivers._na0_rhs_base(c, b, 0.0), ring, ring_mesh,
            Ce, cm)
    for bi, (idx_s, val_s, len_s) in enumerate(aligned):
        pd = PartData(idx=idx_s, val=val_s, length=len_s, wgt=None, opp=Ce,
                      opp_bias=cm, w=w_side, alpha=None,
                      mu=0.0 if S.na0 else None)
        extra[bi].append((pd, "na0" if S.na0 else "explicit", S.p,
                          scale_flag))
    return extra, G0, r0_vec


def _add(a, b):
    return b if a is None else (a if b is None else a + b)


def _update_C(S, featb, blocks, A_orig, kc, kc_pad, lam_vec, w_side,
              method, mean_slices, perm_S, xmask, lam_scale, ring=None,
              main_ring=None, dense=None, **kw):
    """One C (or D) half-step from A_orig (or B_orig); returns (blocks,
    orig).  Under the big-axis ring (``kw["ring_mesh"]``) A_orig is this
    rank's shard of A (in the order of ``main_ring``), ``dense`` the dense
    side matrix's rows in its order and ``ring`` the features' RingSide:
    sparse side info returns this rank's blocks and shard of C, dense side
    info the whole C."""
    A1 = _pad_cols(A_orig[:, :kc], kc_pad, 0)
    ring_mesh = kw.get("ring_mesh")
    if S.dense is not None:
        A1u = A1
        if ring_mesh is None:
            A1u = A1[:S.n_ent] if S.n_ent < A1.shape[0] else A1
            dense = profiling.upload(S.dense, A1.device)
        return None, _dense_full_solve(
            A1u, dense, lam_vec, w_side, kw["nonneg"], kw["l1_vec"],
            kw["max_cd_steps"], lam_scale,
            None if ring_mesh is None else (main_ring, ring_mesh))
    if xmask is not None and not S.na0:
        # under NA-as-zero the rows beyond the side matrix are genuine
        # all-zero side rows (kept)
        A1 = A1 * xmask[:, None]
    blocks = _side_factor_update(S, featb, blocks, A1, lam_vec, w_side,
                                 method, mean_slices, ring_side=main_ring,
                                 **kw)
    return blocks, (blocks_to_orig(blocks, perm_S) if ring is None
                    else ring.shard(blocks))


class _Sides(NamedTuple):
    """The side-info structures both bucketed bodies build around their
    main bucketings: each side matrix's layout (_side_layout; this rank's
    rows of it under a mesh) and start (_side_init), the row permutations,
    the X-row masks, and the slot maps of the several-part CG buckets
    (filled on the first CG half-step, kept for the fit)."""

    U_lay: tuple  # (feature bucketing, aligned parts, dense slices, means)
    I_lay: tuple
    C0: tuple  # (blocks, orig) of C at the start; (None, None) without U
    D0: tuple
    perm_A: torch.Tensor
    perm_B: torch.Tensor
    perm_U: Optional[torch.Tensor]
    perm_I: Optional[torch.Tensor]
    xmask_A: torch.Tensor
    xmask_B: torch.Tensor
    xmask_AU: Optional[torch.Tensor]
    xmask_BI: Optional[torch.Tensor]
    stacks_A: list
    stacks_B: list
    # under the big-axis ring: the RingSides (A, B, U's features, I's
    # features; None for dense side info) and the dense side matrices'
    # rows of this rank in A's (B's) ring order
    ring: Optional[tuple] = None
    U_dense: Optional[torch.Tensor] = None
    I_dense: Optional[torch.Tensor] = None


def _sides(U, I, RB, CB, m, n, m_eff, n_eff, widths, seed, init, dev,
           dtype, mesh=None, ring=None):
    """The _Sides of a bucketed fit in the fit's ``dtype``; ``widths`` is
    (kc, kc_pad, kd, kd_pad).  C and D start from their own generator
    (seed + 1).  RB and CB are the main bucketings' plans; under ``mesh``
    each rank builds only its rows of the side layouts.  Under ``ring``
    (the big-axis ring: A's and B's RingSides) every slot that indexes a
    sharded matrix is rewritten into its ring order, C and D of sparse
    side info start as this rank's blocks, and the masks are this rank's
    rows in ring order."""
    kc, kc_pad, kd, kd_pad = widths
    tdt = torch_dtype(dtype)
    plan_U, U_lay = _side_layout(U, RB, dev, dtype, mesh)
    plan_I, I_lay = _side_layout(I, CB, dev, dtype, mesh)
    gen2 = torch.Generator(device=dev)
    gen2.manual_seed(int(seed) + 1)

    def perm(featb):
        return None if featb is None else profiling.upload(featb.perm, dev)

    rings = (None,) * 4
    if ring:
        rings = tuple(ring) + tuple(
            None if plan is None else RingSide(plan, mesh, dev, tdt)
            for plan in (plan_U, plan_I))
    C0 = D0 = (None, None)
    if U is not None:
        C0 = _side_init(U, plan_U, kc, kc_pad, gen2, init.get("C"), dev,
                        tdt, rings[2], U_lay[0])
    if I is not None:
        D0 = _side_init(I, plan_I, kd, kd_pad, gen2, init.get("D"), dev,
                        tdt, rings[3], I_lay[0])
    if not ring:
        return _Sides(
            U_lay, I_lay, C0, D0, perm(RB), perm(CB), perm(U_lay[0]),
            perm(I_lay[0]), _xdim_mask(m, m_eff, dev, tdt),
            _xdim_mask(n, n_eff, dev, tdt),
            None if U is None or U.n_ent >= m_eff
            else _xdim_mask(U.n_ent, m_eff, dev, tdt),
            None if I is None or I.n_ent >= n_eff
            else _xdim_mask(I.n_ent, n_eff, dev, tdt),
            [None] * len(RB.buckets), [None] * len(CB.buckets))

    rA, rB, rU, rI = rings
    dense = []
    for lay, main_ring, feat_ring in ((U_lay, rA, rU), (I_lay, rB, rI)):
        featb, aligned, slices, _ = lay
        if featb is not None:  # the feature buckets' slots index A (B)
            main_ring.remap_slots(featb)
        if aligned is not None:  # the aligned parts' slots index C (D)
            for i, (idx, *rest) in enumerate(aligned):
                aligned[i] = (feat_ring.remap(idx), *rest)
        dense.append(None if slices is None else torch.cat(slices, 0))
    return _Sides(
        U_lay, I_lay, C0, D0, perm(RB), perm(CB), perm(U_lay[0]),
        perm(I_lay[0]), rA.rows_below(m), rB.rows_below(n),
        None if U is None or U.n_ent >= m_eff else rA.rows_below(U.n_ent),
        None if I is None or I.n_ent >= n_eff else rB.rows_below(I.n_ent),
        [None] * len(RB.buckets), [None] * len(CB.buckets), rings, *dense)


def _update_sides(sd, U, I, C, D, A_orig, B_orig, widths, lam_vec_C,
                  lam_vec_D, w_user, w_item, method, *, n_steps, scale_lam,
                  precondition, cd, mesh=None):
    """The C and D half-steps of one iteration; C and D are (blocks, orig)
    pairs, returned updated.  ``cd``: (nonneg_C, nonneg_D, l1_vec_C,
    l1_vec_D, max_cd_steps).  Under the ring (``sd.ring``) A_orig and
    B_orig are this rank's shards."""
    kc, kc_pad, kd, kd_pad = widths
    nonneg_C, nonneg_D, l1_vec_C, l1_vec_D, max_cd_steps = cd
    kw = dict(n_steps=n_steps, scale_lam=scale_lam,
              precondition=precondition, max_cd_steps=max_cd_steps)
    kw.update({"mesh": mesh} if sd.ring is None else {"ring_mesh": mesh})
    rA, rB, rU, rI = (None,) * 4 if sd.ring is None else sd.ring
    if U is not None:
        C = _update_C(U, sd.U_lay[0], C[0], A_orig, kc, kc_pad, lam_vec_C,
                      w_user, method, sd.U_lay[3], sd.perm_U, sd.xmask_AU,
                      float(U.n_ent) if scale_lam else 1.0, ring=rU,
                      main_ring=rA, dense=sd.U_dense, nonneg=nonneg_C,
                      l1_vec=l1_vec_C, **kw)
    if I is not None:
        D = _update_C(I, sd.I_lay[0], D[0], B_orig, kd, kd_pad, lam_vec_D,
                      w_item, method, sd.I_lay[3], sd.perm_I, sd.xmask_BI,
                      float(I.n_ent) if scale_lam else 1.0, ring=rI,
                      main_ring=rB, dense=sd.I_dense, nonneg=nonneg_D,
                      l1_vec=l1_vec_D, **kw)
    return C, D


def _opposing(F_orig, k_from, k_to, width, k_pad, ones_col, xmask,
              ones=1.0):
    """The extended opposing matrix of a main half-step: F's shared
    coordinates moved to [k_to : k_to + width], ``ones`` on the bias column
    ``ones_col`` (or none; under the ring the real-row mask, so padding
    rows stay zero), rows outside ``xmask`` zeroed (or kept)."""
    opp = torch.zeros(F_orig.shape[0], k_pad, dtype=F_orig.dtype,
                      device=F_orig.device)
    opp[:, k_to:k_to + width] = F_orig[:, k_from:k_from + width]
    if ones_col is not None:
        opp[:, ones_col] = ones
    return opp if xmask is None else opp * xmask[:, None]


# --------------------------------------------------------------------- #
# explicit collective fit                                                #
# --------------------------------------------------------------------- #


@profiled_fit
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
    """Collective explicit ALS.  side_U/side_I are _BaseModel._ingest_side
    tuples.  Returns A, B, biasA/biasB, C, D, Ai, Bi (None where absent) as
    tensors of the fit's dtype on ``device``, plus U_colmeans/I_colmeans,
    glob_mean and k;
    the bucketed route also scaling_biasA/B (None unless scale_bias_const)
    and writes mid-fit checkpoints.  The dense route, as the JAX package's,
    writes none (checkpoint_path and checkpoint_every are unused there)."""
    lam6, l16 = drivers._resolve_lambdas(lambda_, l1_lambda)
    dtype = resolve_dtype(dtype)
    dev = resolve_device(device)
    drivers._reject_common(mesh, shard_opposing_rows, dev, use_cg)
    if nonneg:
        use_cg = False
    U = prepare_side(_sparsify_short_dense_side(side_U, m), center_U,
                     NA_as_zero_user, dtype)
    I = prepare_side(_sparsify_short_dense_side(side_I, n), center_I,
                     NA_as_zero_item, dtype)
    plain = drivers.plain_route(dtype, use_cg, precondition_cg)
    # the ring is the bucketed route's
    dense = not plain and not shard_opposing_rows and _dense_route(
        U, I, m, n, k_user=k_user, k_item=k_item, k_main=k_main,
        w_main=w_main,
        na0=NA_as_zero or NA_as_zero_user or NA_as_zero_item,
        add_implicit_features=add_implicit_features, weights=weights,
        init=init, dense_bytes=drivers.dense_bytes(m, n, k,
                                                   weights is not None),
        dev=dev, cd=bool(nonneg or nonneg_C or nonneg_D or np.any(l16 > 0)),
        mesh=mesh)
    if not dense:
        return _fit_collective_explicit_bucketed(
            rows, cols, vals, m, n, U=U, I=I, k=k, k_user=k_user,
            k_item=k_item, k_main=k_main, lam6=lam6, w_main=w_main,
            w_user=w_user, w_item=w_item, w_implicit=w_implicit,
            add_implicit_features=add_implicit_features, niter=niter,
            use_cg=use_cg, max_cg_steps=max_cg_steps,
            finalize_chol=finalize_chol, user_bias=user_bias,
            item_bias=item_bias, center=center, scale_lam=scale_lam,
            scale_lam_sideinfo=scale_lam_sideinfo,
            scale_bias_const=scale_bias_const, NA_as_zero=NA_as_zero,
            weights=weights, seed=seed, verbose=verbose, device=dev,
            init=init, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, dtype=dtype,
            precondition_cg=precondition_cg, l16=l16, nonneg=nonneg,
            nonneg_C=nonneg_C, nonneg_D=nonneg_D, max_cd_steps=max_cd_steps,
            mesh=mesh, ring=shard_opposing_rows)

    glob_mean = (preprocess.weighted_global_mean(vals, weights) if center
                 else 0.0)
    res = fit_collective_dense_masked(
        rows, cols, vals, m, n,
        U_dense=None if U is None else U.dense,
        I_dense=None if I is None else I.dense,
        weights=weights, k=k, lam6=lam6, w_user=w_user, w_item=w_item,
        niter=niter, max_cg_steps=max_cg_steps, finalize_chol=finalize_chol,
        finalize_steps=drivers.FINALIZE_STEPS, user_bias=user_bias,
        item_bias=item_bias, glob_mean=glob_mean,
        scale_lam=scale_lam or scale_lam_sideinfo,
        scale_lam_sideinfo=scale_lam_sideinfo,
        scale_bias_const=scale_bias_const, seed=seed, verbose=verbose,
        device=dev, init=init, add_implicit_features=add_implicit_features,
        w_implicit=w_implicit, exact=not use_cg, dtype=dtype,
        precondition_cg=use_cg and precondition_cg, mesh=mesh)
    res["U_colmeans"] = None if U is None else U.colmeans
    res["I_colmeans"] = None if I is None else I.colmeans
    return res


@profiling.engine
def _fit_collective_explicit_bucketed(
    rows, cols, vals, m, n, *, U, I, k, k_user, k_item, k_main, lam6,
    w_main, w_user, w_item, w_implicit, add_implicit_features, niter,
    use_cg, max_cg_steps, finalize_chol, user_bias, item_bias, center,
    scale_lam, scale_lam_sideinfo, scale_bias_const, NA_as_zero, weights,
    seed, verbose, device, init, checkpoint_path, checkpoint_every,
    dtype=np.float32, precondition_cg=False, l16=(0.0,) * 6, nonneg=False,
    nonneg_C=False, nonneg_D=False, max_cd_steps=100, mesh=None, ring=False,
) -> dict:
    """The bucketed route of fit_collective_explicit_als
    (cmfrec_tpu/solvers/collective.py:440-1019), in the fit's ``dtype``.
    ``U``/``I`` are PreparedSide (prepare_side) or None, ``lam6`` the six
    lambdas (drivers._resolve_lambdas).  Under ``mesh`` the whole layouts
    plan and seed the start and each rank solves its share of them; under
    ``ring`` each rank keeps only its rows of the factor matrices."""
    dev = torch.device(device)
    tdt = torch_dtype(dtype)
    ckpt = FitCheckpointer(checkpoint_path, checkpoint_every, niter, mesh)
    scale_lam = scale_lam or scale_lam_sideinfo
    m_eff = max(m, U.n_ent if U else 0)
    n_eff = max(n, I.n_ent if I else 0)

    glob_mean = (preprocess.weighted_global_mean(vals, weights) if center
                 else 0.0)
    if NA_as_zero and center:
        # the mean over all m*n cells (unobserved = 0, weight 1), as in
        # drivers.fit_explicit_als
        wsum = (float(len(vals)) if weights is None
                else float(np.sum(weights)))
        glob_mean *= wsum / (wsum + float(m) * float(n) - float(len(vals)))
    if nonneg:
        # centred like any other, the mean clamped at 0 (common.c:3599)
        glob_mean = max(glob_mean, 0.0)
    vals_c = (np.asarray(vals, np.float64) - glob_mean).astype(dtype)

    biasA0 = biasB0 = None
    if user_bias or item_bias:
        biasA0, biasB0 = preprocess.initialize_biases(
            rows, cols, vals_c, m_eff, n_eff, lam_user=lam6[0],
            lam_item=lam6[1], wgt=weights, user_bias=user_bias,
            item_bias=item_bias, scale_lam=scale_lam, nonneg=nonneg)
    with profiling.span("cmfrec.engine.layout"):
        (RB, CB), shares = build_bucketed_pair_share(
            rows, cols, vals_c, m, n, weights, device=dev, mesh=mesh,
            m_eff=m_eff, n_eff=n_eff, dtype=dtype)

    ka, kb = k_user + k + k_main, k_item + k + k_main  # A/B widths, no bias
    ka_pad, kb_pad = _round_up(ka + 1, 8), _round_up(kb + 1, 8)
    kc, kd = k_user + k, k_item + k
    kc_pad, kd_pad = _round_up(kc, 8), _round_up(kd, 8)
    ki_w = k + k_main  # implicit-features width
    ki_pad = _round_up(ki_w, 8)
    init = init or {}

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    rA, rB = ((RingSide(RB, mesh, dev, tdt), RingSide(CB, mesh, dev, tdt))
              if ring else (None, None))
    lay_A, lay_B = shares if ring else (RB, CB)  # the blocks' layouts
    A_blocks = init_blocks(gen, RB, ka, ka_pad, tdt, rA)
    B_blocks = init_blocks(gen, CB, kb, kb_pad, tdt, rB)
    if user_bias:
        drivers._set_bias_coord(A_blocks, lay_A, biasA0, ka)
    if item_bias:
        drivers._set_bias_coord(B_blocks, lay_B, biasB0, kb)
    for key, blocks, bk, kx, has_bias in (
            ("A", A_blocks, lay_A, ka, user_bias),
            ("B", B_blocks, lay_B, kb, item_bias)):
        if init.get(key) is not None:
            drivers._seed_factor_blocks(blocks, bk, init[key], kx)
        if has_bias and init.get("bias" + key) is not None:
            drivers._set_bias_coord(blocks, bk, init["bias" + key], kx)

    widths = (kc, kc_pad, kd, kd_pad)
    sd = _sides(U, I, RB, CB, m, n, m_eff, n_eff, widths, seed, init, dev,
                dtype, mesh, ring and (rA, rB))
    (C_blocks, C_orig), (D_blocks, D_orig) = sd.C0, sd.D0
    Ai_blocks = Bi_blocks = None
    if add_implicit_features:
        Bi_blocks = init_blocks(gen, CB, ki_w, ki_pad, tdt, rB)
        Ai_blocks = init_blocks(gen, RB, ki_w, ki_pad, tdt, rA)
        if init.get("Bi") is not None:
            drivers._seed_factor_blocks(Bi_blocks, lay_B, init["Bi"], ki_w)
        if init.get("Ai") is not None:
            drivers._seed_factor_blocks(Ai_blocks, lay_A, init["Ai"], ki_w)
    if ring:
        rB.remap_slots(shares[0])  # A's slots index B's rows
        rA.remap_slots(shares[1])

    def mk(*a):
        return drivers._make_lam_vec(*a, dev, tdt)

    lam_vec_A = mk(ka, ka_pad, lam6[2], lam6[0], user_bias)
    lam_vec_B = mk(kb, kb_pad, lam6[3], lam6[1], item_bias)
    lam_vec_C = mk(kc, kc_pad, lam6[4], 0.0, False)
    lam_vec_D = mk(kd, kd_pad, lam6[5], 0.0, False)
    lam_vec_Bi = mk(ki_w, ki_pad, lam6[3] / w_implicit, 0.0, False)
    lam_vec_Ai = mk(ki_w, ki_pad, lam6[2] / w_implicit, 0.0, False)

    def mk1(*a):
        return drivers._make_l1_vec(*a, dev, tdt)

    l1_vec_A = mk1(ka, ka_pad, l16[2], l16[0], user_bias)
    l1_vec_B = mk1(kb, kb_pad, l16[3], l16[1], item_bias)
    cd_sides = (nonneg_C, nonneg_D, mk1(kc, kc_pad, l16[4], 0.0, False),
                mk1(kd, kd_pad, l16[5], 0.0, False), max_cd_steps)

    # scale_bias_const: the bias coordinate's penalty scales with the
    # average observation count instead of the per-row count
    # (upstream cmfrec src/common.c:717-722); the mean runs over the X
    # dimension (src/collective.c:8114) and, under scale_lam_sideinfo,
    # counts the side entries (src/collective.c:8070)
    lam_const_A = lam_const_B = None
    scaling_biasA = scaling_biasB = None
    if scale_lam and scale_bias_const:
        wsum_total = (float(np.sum(weights)) if weights is not None
                      else float(len(vals)))

        def side_wsum(S, lim):
            if S is None or not scale_lam_sideinfo:
                return 0.0
            if S.na0:
                return float(S.p) * lim
            if S.dense is not None:
                return float(min(S.n_ent, lim)) * S.p
            return float(np.count_nonzero(np.asarray(S.coo[0]) < lim))

        if user_bias:
            scaling_biasA = (wsum_total + side_wsum(U, m)) / max(m, 1)
            lam_const_A = torch.zeros(ka_pad, dtype=tdt, device=dev)
            lam_const_A[ka] = lam6[0] * scaling_biasA
            lam_vec_A[ka] = 0.0
        if item_bias:
            scaling_biasB = (wsum_total + side_wsum(I, n)) / max(n, 1)
            lam_const_B = torch.zeros(kb_pad, dtype=tdt, device=dev)
            lam_const_B[kb] = lam6[1] * scaling_biasB
            lam_vec_B[kb] = 0.0

    mode = "na0" if NA_as_zero else "explicit"
    RB, CB = shares  # each rank solves its share of the buckets
    plan_A, plan_B = SidePlan(RB, mode, n), SidePlan(CB, mode, m)
    perm_A, perm_B, xmask_A, xmask_B = (sd.perm_A, sd.perm_B, sd.xmask_A,
                                        sd.xmask_B)
    ring_mesh = mesh if ring else None
    upd = {"ring_mesh": mesh} if ring else {"mesh": mesh}
    rA, rB, rU, rI = sd.ring if ring else (None,) * 4

    def factor_update(blocks, plan, opp, opp_bias, lam_vec, method, S, S_al,
                      S_ds, C_mat, kx, w_side, Xones_opp, k_off, lam_const,
                      stacks, l1_vec, S_ring, opp_ring):
        """One A- or B-style update with optional side-info and implicit
        features parts; under the ring the opposing rows are in the order
        of ``opp_ring``, the side info's in ``S_ring``'s."""
        K = lam_vec.shape[0]
        G0 = r0_vec = r0_blocks = extra = None
        n_buckets = len(plan.bucketed.buckets)
        if plan.mode == "na0":
            G0 = w_main * row_sum(gram_matrix, opp_ring, ring_mesh, opp)
            r0_vec = w_main * row_sum(
                lambda o, b: drivers._na0_rhs_base(o, b, glob_mean),
                opp_ring, ring_mesh, opp, opp_bias)
        lam_mult_add = 0.0
        if S is not None:
            Ce = _pad_cols(C_mat[:, :kx], K, 0)
            if S.dense is not None:
                G0 = _add(G0, w_side * gram_matrix(Ce))
                r0_blocks = [_dense_rhs(sl, Ce, w_side) for sl in S_ds]
                if scale_lam_sideinfo:
                    # dense side info adds p observations per row to the
                    # lambda multiplier (src/common.c:689-724)
                    lam_mult_add = float(S.p)
            else:
                extra, Gs, rv = _side_parts(S, S_al, Ce, w_side, n_buckets,
                                            scale_lam_sideinfo, dev, S_ring,
                                            ring_mesh)
                G0, r0_vec = _add(G0, Gs), _add(r0_vec, rv)
        if add_implicit_features:
            # Xones ~ A[:, k_off:] . Bi^T
            Bi_e = _pad_cols(Xones_opp[:, :ki_w], K, k_off)
            G0 = _add(G0, w_implicit * row_sum(gram_matrix, opp_ring,
                                               ring_mesh, Bi_e))
            extra = extra or [[] for _ in range(n_buckets)]
            for bi, b in enumerate(plan.bucketed.buckets):
                pd = PartData(idx=b.idx, val=torch.ones_like(b.val),
                              length=b.length, wgt=None, opp=Bi_e,
                              opp_bias=None, w=w_implicit, alpha=None,
                              mu=0.0)
                extra[bi].append((pd, "na0", plan.n_total, False))
        return update_side(
            plan, blocks, opp, opp_bias, lam_vec, w=w_main,
            mu=glob_mean if plan.mode == "na0" else None, G0=G0,
            r0_vec=r0_vec, r0_blocks=r0_blocks, extra_parts=extra,
            lam_const_vec=lam_const, l1_vec=l1_vec, method=method,
            n_steps=max_cg_steps, nonneg=nonneg, max_cd_steps=max_cd_steps,
            scale_lam=scale_lam, lam_mult_add=lam_mult_add,
            precondition=precondition_cg, stacks=stacks, **upd)

    def iteration(method, st):
        A_blocks, B_blocks, C_blocks, D_blocks, C_orig, D_orig, Ai_blocks, \
            Bi_blocks = st
        A_orig = _orig(A_blocks, perm_A, rA)
        B_orig = _orig(B_blocks, perm_B, rB)
        Ai_orig = Bi_orig = None
        (C_blocks, C_orig), (D_blocks, D_orig) = _update_sides(
            sd, U, I, (C_blocks, C_orig), (D_blocks, D_orig), A_orig, B_orig,
            widths, lam_vec_C, lam_vec_D, w_user, w_item, method,
            n_steps=max_cg_steps, scale_lam=scale_lam,
            precondition=precondition_cg, cd=cd_sides, mesh=mesh)
        if add_implicit_features:
            # always closed form: the reference hard-codes use_cg=false for
            # these half-steps (src/collective.c:8479/8520)
            A_x = _pad_cols(A_orig[:, k_user:k_user + ki_w], ki_pad, 0)
            A_x = A_x * xmask_A[:, None]  # Gram over the X rows only
            Bi_blocks = update_side(
                SidePlan(CB, "na0", m), Bi_blocks, A_x, None, lam_vec_Bi,
                G0=row_sum(gram_matrix, rA, ring_mesh, A_x), ones_val=True,
                method="chol", nonneg=nonneg, max_cd_steps=max_cd_steps,
                scale_lam=scale_lam, **upd)
            Bi_orig = _orig(Bi_blocks, perm_B, rB)
            B_x = _pad_cols(B_orig[:, k_item:k_item + ki_w], ki_pad, 0)
            B_x = B_x * xmask_B[:, None]
            Ai_blocks = update_side(
                SidePlan(RB, "na0", n), Ai_blocks, B_x, None, lam_vec_Ai,
                G0=row_sum(gram_matrix, rB, ring_mesh, B_x), ones_val=True,
                method="chol", nonneg=nonneg, max_cd_steps=max_cd_steps,
                scale_lam=scale_lam, **upd)
            Ai_orig = _orig(Ai_blocks, perm_A, rA)

        # B (items; opposing A, D, Ai).  The shared bases sum the X rows
        # only, except under NA_as_zero, where side-only entities are
        # genuine all-zero X rows
        opp = _opposing(A_orig, k_user, k_item, k + k_main, kb_pad,
                        kb if item_bias else None,
                        None if NA_as_zero else xmask_A,
                        1.0 if rA is None else rA.mask)
        B_blocks = factor_update(
            B_blocks, plan_B, opp, A_orig[:, ka] if user_bias else None,
            lam_vec_B, method, I, sd.I_lay[1], sd.I_lay[2], D_orig, kd,
            w_item, None if Ai_orig is None else Ai_orig * xmask_A[:, None],
            k_item, lam_const_B, sd.stacks_B, l1_vec_B, rI, rA)
        B_orig = _orig(B_blocks, perm_B, rB)

        # A (users; opposing B, C, Bi)
        opp = _opposing(B_orig, k_item, k_user, k + k_main, ka_pad,
                        ka if user_bias else None,
                        None if NA_as_zero else xmask_B,
                        1.0 if rB is None else rB.mask)
        A_blocks = factor_update(
            A_blocks, plan_A, opp, B_orig[:, kb] if item_bias else None,
            lam_vec_A, method, U, sd.U_lay[1], sd.U_lay[2], C_orig, kc,
            w_user, None if Bi_orig is None else Bi_orig * xmask_B[:, None],
            k_user, lam_const_A, sd.stacks_A, l1_vec_A, rU, rB)
        return (A_blocks, B_blocks, C_blocks, D_blocks, C_orig, D_orig,
                Ai_blocks, Bi_blocks)

    def state_dict(st):
        Ab, Bb, Cb, Db, Co, Do, Aib, Bib = st
        Ao, Bo, Co, Do, Aio, Bio = _whole(
            ring_mesh, (Ab, perm_A), (Bb, perm_B), (Cb, sd.perm_U, Co),
            (Db, sd.perm_I, Do), (Aib, perm_A), (Bib, perm_B))
        return {
            "A": Ao[:, :ka], "B": Bo[:, :kb],
            "biasA": Ao[:, ka] if user_bias else None,
            "biasB": Bo[:, kb] if item_bias else None,
            "C": None if Co is None else Co[:, :kc],
            "D": None if Do is None else Do[:, :kd],
            "Ai": None if Aio is None else Aio[:, :ki_w],
            "Bi": None if Bio is None else Bio[:, :ki_w],
        }

    st = (A_blocks, B_blocks, C_blocks, D_blocks, C_orig, D_orig,
          Ai_blocks, Bi_blocks)
    st = _run(iteration, st, state_dict, niter, use_cg, finalize_chol,
              verbose, dev, ckpt)
    # the return layout is the checkpoint layout (1:1 with init=)
    out = state_dict(st)
    out.update({
        "U_colmeans": None if U is None else U.colmeans,
        "I_colmeans": None if I is None else I.colmeans,
        "scaling_biasA": scaling_biasA, "scaling_biasB": scaling_biasB,
        "glob_mean": float(glob_mean), "k": k,
    })
    return out


def _orig(blocks, perm, ring):
    """A factor matrix as a half-step reads it: whole in original order, or
    under the ring (``ring`` its side's RingSide) this rank's shard."""
    return blocks_to_orig(blocks, perm) if ring is None else ring.shard(blocks)


def _whole(ring_mesh, *mats):
    """Each of ``mats`` whole in original order: ``(blocks, perm)``, or
    ``(blocks, perm, orig)`` for C or D (``orig`` whole already where the
    side info is dense, or C is replicated without a ring).  Under
    ``ring_mesh`` the blocks are this rank's and are gathered, one
    all-gather each."""
    out = []
    for blocks, perm, *orig in mats:
        if blocks is None:
            out.append(orig[0] if orig else None)
        elif orig and ring_mesh is None:
            out.append(orig[0])
        else:
            out.append(blocks_to_orig(gather_blocks(blocks, ring_mesh), perm))
    return out


def _run(iteration, st, state_dict, niter, use_cg, finalize_chol, verbose,
         dev, ckpt):
    """The iterations of a bucketed collective fit: CG until the last one
    under finalize_chol, Cholesky otherwise; mid-fit checkpoints; on
    KeyboardInterrupt the partial state (the reference's handle_interrupt,
    upstream cmfrec src/helpers.c:1493)."""
    try:
        for it in range(niter):
            method = ("cg" if use_cg and not (finalize_chol
                                              and it == niter - 1)
                      else "chol")
            t0 = time.time()
            with profiling.span("cmfrec.engine.iter", it=it + 1,
                                method=method):
                st = iteration(method, st)
            if verbose:
                drivers._fence(dev)
                print(f"iter {it + 1}/{niter} [{method}] "
                      f"{time.time() - t0:.3f}s")
            ckpt.maybe_save(it + 1, lambda: drivers._host(state_dict(st)))
    except KeyboardInterrupt:
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")
    return st


# --------------------------------------------------------------------- #
# implicit collective fit                                                #
# --------------------------------------------------------------------- #


@profiled_fit
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
    """WRMF with side info (upstream cmfrec src/collective.c:9375).  The
    main part's weight is w_main times the adjust_weight multiplier
    nnz/(m*n) (src/collective.c:9776-9782).  Returns A, B, C, D (or None)
    as tensors of the fit's dtype on ``device``, plus U_colmeans/I_colmeans,
    w_main_multiplier and alpha; the bucketed route writes mid-fit
    checkpoints, the dense one none (as the JAX package's)."""
    lam6, l16 = drivers._resolve_lambdas(lambda_, l1_lambda)
    dtype = resolve_dtype(dtype)
    dev = resolve_device(device)
    drivers._reject_common(mesh, shard_opposing_rows, dev, use_cg)
    if nonneg:
        use_cg = False
    vals = drivers.implicit_values(vals, apply_log_transf)
    w_mult = len(vals) / (float(m) * float(n)) if adjust_weight else 1.0
    U = prepare_side(_sparsify_short_dense_side(side_U, m), center_U,
                     NA_as_zero_user, dtype)
    I = prepare_side(_sparsify_short_dense_side(side_I, n), center_I,
                     NA_as_zero_item, dtype)
    plain = drivers.plain_route(dtype, use_cg, precondition_cg)
    dense = not plain and not shard_opposing_rows and _dense_route(
        U, I, m, n, k_user=k_user, k_item=k_item, k_main=k_main,
        w_main=1.0, na0=NA_as_zero_user or NA_as_zero_item,
        add_implicit_features=False, weights=None, init=init,
        dense_bytes=drivers.dense_bytes(m, n, k, False, implicit=True),
        dev=dev, cd=bool(nonneg or nonneg_C or nonneg_D or np.any(l16 > 0)),
        mesh=mesh)
    if not dense:
        return _fit_collective_implicit_bucketed(
            rows, cols, vals, m, n, U=U, I=I, k=k, k_user=k_user,
            k_item=k_item, k_main=k_main, lam6=lam6, w_x=w_main * w_mult,
            w_mult=w_mult, w_user=w_user, w_item=w_item, alpha=alpha,
            niter=niter, use_cg=use_cg, max_cg_steps=max_cg_steps,
            finalize_chol=finalize_chol, seed=seed, verbose=verbose,
            device=dev, init=init, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, dtype=dtype,
            precondition_cg=precondition_cg, l16=l16, nonneg=nonneg,
            nonneg_C=nonneg_C, nonneg_D=nonneg_D, max_cd_steps=max_cd_steps,
            mesh=mesh, ring=shard_opposing_rows)

    res = fit_collective_implicit_dense_masked(
        rows, cols, vals, m, n,
        U_dense=None if U is None else U.dense,
        I_dense=None if I is None else I.dense,
        k=k, lam6=lam6, w_user=w_user, w_item=w_item, niter=niter,
        max_cg_steps=max_cg_steps, finalize_steps=drivers.FINALIZE_STEPS,
        finalize_chol=finalize_chol, alpha=alpha,
        w_main_multiplier=w_main * w_mult, seed=seed, verbose=verbose,
        device=dev, init=init, exact=not use_cg, dtype=dtype,
        precondition_cg=use_cg and precondition_cg, mesh=mesh)
    res["U_colmeans"] = None if U is None else U.colmeans
    res["I_colmeans"] = None if I is None else I.colmeans
    return res


@profiling.engine
def _fit_collective_implicit_bucketed(
    rows, cols, vals, m, n, *, U, I, k, k_user, k_item, k_main, lam6, w_x,
    w_mult, w_user, w_item, alpha, niter, use_cg, max_cg_steps,
    finalize_chol, seed, verbose, device, init, checkpoint_path,
    checkpoint_every, dtype=np.float32, precondition_cg=False,
    l16=(0.0,) * 6, nonneg=False, nonneg_C=False, nonneg_D=False,
    max_cd_steps=100, mesh=None, ring=False,
) -> dict:
    """The bucketed route of fit_collective_implicit_als
    (cmfrec_tpu/solvers/collective.py:1134-1500), in the fit's ``dtype``.
    ``vals`` are the implicit values (log-transformed where asked), ``w_x``
    the main part's weight w_main * w_mult.  Under ``mesh`` each rank
    solves its share of the buckets; under ``ring`` each rank keeps only
    its rows of the factor matrices."""
    dev = torch.device(device)
    tdt = torch_dtype(dtype)
    ckpt = FitCheckpointer(checkpoint_path, checkpoint_every, niter, mesh)
    m_eff = max(m, U.n_ent if U else 0)
    n_eff = max(n, I.n_ent if I else 0)
    with profiling.span("cmfrec.engine.layout"):
        (RB, CB), shares = build_bucketed_pair_share(
            rows, cols, np.asarray(vals).astype(dtype), m, n, device=dev,
            mesh=mesh, m_eff=m_eff, n_eff=n_eff, dtype=dtype)
    ka, kb = k_user + k + k_main, k_item + k + k_main
    ka_pad, kb_pad = _round_up(ka, 8), _round_up(kb, 8)
    kc, kd = k_user + k, k_item + k
    kc_pad, kd_pad = _round_up(kc, 8), _round_up(kd, 8)
    init = init or {}

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    rA, rB = ((RingSide(RB, mesh, dev, tdt), RingSide(CB, mesh, dev, tdt))
              if ring else (None, None))
    lay_A, lay_B = shares if ring else (RB, CB)  # the blocks' layouts
    A_blocks = init_blocks(gen, RB, ka, ka_pad, tdt, rA)
    B_blocks = init_blocks(gen, CB, kb, kb_pad, tdt, rB)
    if init.get("A") is not None:
        drivers._seed_factor_blocks(A_blocks, lay_A, init["A"], ka)
    if init.get("B") is not None:
        drivers._seed_factor_blocks(B_blocks, lay_B, init["B"], kb)

    widths = (kc, kc_pad, kd, kd_pad)
    sd = _sides(U, I, RB, CB, m, n, m_eff, n_eff, widths, seed, init, dev,
                dtype, mesh, ring and (rA, rB))
    (C_blocks, C_orig), (D_blocks, D_orig) = sd.C0, sd.D0
    if ring:
        rB.remap_slots(shares[0])  # A's slots index B's rows
        rA.remap_slots(shares[1])
    RB, CB = shares  # each rank solves its share of the buckets
    ring_mesh = mesh if ring else None
    upd = {"ring_mesh": mesh} if ring else {"mesh": mesh}
    rA, rB, rU, rI = sd.ring if ring else (None,) * 4

    def mk(*a):
        return drivers._make_lam_vec(*a, 0.0, False, dev, tdt)

    lam_vec_A = mk(ka, ka_pad, lam6[2])
    lam_vec_B = mk(kb, kb_pad, lam6[3])
    lam_vec_C = mk(kc, kc_pad, lam6[4])
    lam_vec_D = mk(kd, kd_pad, lam6[5])

    def mk1(*a):
        return drivers._make_l1_vec(*a, 0.0, False, dev, tdt)

    l1_vec_A, l1_vec_B = mk1(ka, ka_pad, l16[2]), mk1(kb, kb_pad, l16[3])
    cd_sides = (nonneg_C, nonneg_D, mk1(kc, kc_pad, l16[4]),
                mk1(kd, kd_pad, l16[5]), max_cd_steps)
    plan_A, plan_B = SidePlan(RB, "implicit", n), SidePlan(CB, "implicit", m)
    perm_A, perm_B = sd.perm_A, sd.perm_B

    def factor_update(blocks, plan, opp, lam_vec, method, S, S_al, S_ds,
                      C_mat, kx, w_side, stacks, l1_vec, S_ring, opp_ring):
        K = lam_vec.shape[0]
        G0 = w_x * row_sum(gram_matrix, opp_ring, ring_mesh, opp)
        r0_vec = r0_blocks = extra = None
        if S is not None:
            Ce = _pad_cols(C_mat[:, :kx], K, 0)
            if S.dense is not None:
                G0 = G0 + w_side * gram_matrix(Ce)
                r0_blocks = [_dense_rhs(sl, Ce, w_side) for sl in S_ds]
            else:
                extra, Gs, r0_vec = _side_parts(
                    S, S_al, Ce, w_side, len(plan.bucketed.buckets), False,
                    dev, S_ring, ring_mesh)
                G0 = _add(G0, Gs)
        return update_side(
            plan, blocks, opp, None, lam_vec, w=w_x, alpha=alpha, G0=G0,
            r0_vec=r0_vec, r0_blocks=r0_blocks, extra_parts=extra,
            l1_vec=l1_vec, method=method, n_steps=max_cg_steps,
            nonneg=nonneg, max_cd_steps=max_cd_steps,
            precondition=precondition_cg, stacks=stacks, **upd)

    def iteration(method, st):
        A_blocks, B_blocks, C_blocks, D_blocks, C_orig, D_orig = st
        A_orig = _orig(A_blocks, perm_A, rA)
        B_orig = _orig(B_blocks, perm_B, rB)
        (C_blocks, C_orig), (D_blocks, D_orig) = _update_sides(
            sd, U, I, (C_blocks, C_orig), (D_blocks, D_orig), A_orig, B_orig,
            widths, lam_vec_C, lam_vec_D, w_user, w_item, method,
            n_steps=max_cg_steps, scale_lam=False,
            precondition=precondition_cg, cd=cd_sides, mesh=mesh)
        # the shared Gram sums the X rows only
        opp = _opposing(A_orig, k_user, k_item, k + k_main, kb_pad, None,
                        sd.xmask_A)
        B_blocks = factor_update(B_blocks, plan_B, opp, lam_vec_B, method, I,
                                 sd.I_lay[1], sd.I_lay[2], D_orig, kd, w_item,
                                 sd.stacks_B, l1_vec_B, rI, rA)
        B_orig = _orig(B_blocks, perm_B, rB)
        opp = _opposing(B_orig, k_item, k_user, k + k_main, ka_pad, None,
                        sd.xmask_B)
        A_blocks = factor_update(A_blocks, plan_A, opp, lam_vec_A, method, U,
                                 sd.U_lay[1], sd.U_lay[2], C_orig, kc, w_user,
                                 sd.stacks_A, l1_vec_A, rU, rB)
        return A_blocks, B_blocks, C_blocks, D_blocks, C_orig, D_orig

    def state_dict(st):
        Ab, Bb, Cb, Db, Co, Do = st
        Ao, Bo, Co, Do = _whole(ring_mesh, (Ab, perm_A), (Bb, perm_B),
                                (Cb, sd.perm_U, Co), (Db, sd.perm_I, Do))
        return {
            "A": Ao[:, :ka], "B": Bo[:, :kb],
            "C": None if Co is None else Co[:, :kc],
            "D": None if Do is None else Do[:, :kd],
        }

    st = (A_blocks, B_blocks, C_blocks, D_blocks, C_orig, D_orig)
    st = _run(iteration, st, state_dict, niter, use_cg, finalize_chol,
              verbose, dev, ckpt)
    out = state_dict(st)
    out.update({
        "U_colmeans": None if U is None else U.colmeans,
        "I_colmeans": None if I is None else I.colmeans,
        "glob_mean": 0.0, "w_main_multiplier": w_mult, "alpha": alpha,
        "k": k,
    })
    return out
