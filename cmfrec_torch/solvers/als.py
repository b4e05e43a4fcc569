"""Batched ALS half-iterations of the bucketed engine
(port of cmfrec_tpu/solvers/als.py).

One half-iteration solves every row of one factor matrix given the other
(the reference's optimizeA / optimizeA_implicit, upstream cmfrec
src/common.c:2742,3305).  Each degree bucket of rows is one batched solve:
coefficient prep -> batched Cholesky, truncated CG through the fused
bucket-CG op (ops/sparse_cg.py: kernel K3 on a card, its twin on the CPU),
or, under ``nonneg`` or an l1 penalty, coordinate descent on the assembled
systems (ops/coord_descent.py: the CD kernel on a card, rowsolve.solve_cd on
the CPU).

A row system may have several sparse parts (the X part, a sparse side-info
part, the implicit-features part of the collective fits) beside a shared
Gram base G0 and rhs bases.  CG over several parts runs the bucket-CG op
once a bucket over the parts' opposing matrices stacked, through a slot
map built once per fit (:func:`stack_slots`); rowsolve.solve_cg over the
separate parts is its reference.

The blocks, the coefficients and the solves run in the fit's dtype.  The
bucket-CG op takes float32 without a preconditioner only, as the JAX
package's fused CG (its ``can_fuse_cg``): float64 and Jacobi PCG
(``precondition_cg``) buckets run rowsolve.solve_cg in plain torch, and so
do buckets whose K is past what K3's shared memory holds on the card
(:func:`takes_k3`).

Under a mesh (parallel/mesh.py) the layout a half-step gets is this
rank's share of every bucket's rows, built from its entries alone
(data/device_fill.py:build_bucketed_pair_share): the rank solves its rows
of each bucket against the whole opposing matrix and one all-gather makes
the blocks whole again.  Under the big-axis ring
(``ring_mesh``, parallel/ring.py) the rank's blocks stay its own and the
opposing matrices are its shards of them: each part of
RING_MIN_ROWS x D rows or more is assembled by rotating the shards, a
smaller one is gathered whole; Cholesky and coordinate descent only, as
in the JAX package.  The shared-Gram solves keep their one Cholesky under
the ring (their rhs rotates the shards too), where the JAX package
factors each row's copy of the one G: the same systems, and at a world of
one the meshless fit's bits.

Not ported from the JAX package: ``defer_solve`` and the cross-bucket
Cholesky concatenation (a TPU compile-time measure: here each bucket
factors its own systems) and the K = 128 lane padding of the CG operands.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..data.shards import ROW_BLOCK, BucketedRows, plan_layout
from ..ops import _cuda, coord_descent, rowsolve, sparse_cg
from ..ops.rowsolve import SparsePart, length_mask
from ..parallel.mesh import gather_blocks, local_blocks
from ..parallel.ring import opposing_operand, ring_take, shard_slots
from ..utils import profiling


class PartData(NamedTuple):
    """Tensors of one sparse part for one bucket."""

    idx: torch.Tensor  # [R, L] int32
    val: torch.Tensor  # [R, L]
    length: torch.Tensor  # [R] int32
    wgt: Optional[torch.Tensor]  # [R, L] or None
    opp: torch.Tensor  # [S, K] extended opposing matrix (bf16 under mxu_bf16)
    opp_bias: Optional[torch.Tensor]  # [S] or None
    w: float  # part weight (w_main)
    alpha: Optional[float]  # implicit confidence slope
    mu: Optional[float]  # global mean (NA-as-zero centering)
    ring: object = None  # the mesh when opp is this rank's shard of a
    # row-sharded matrix and idx are ring-order ids (parallel/ring.py)


def _coefficients(p: PartData, mode: str) -> SparsePart:
    """Map raw (val, wgt) to the unified (cw, cv) Gram/rhs coefficients.

    explicit:  cw = w*wgt, cv = w*wgt*(val - opp_bias)
               (upstream cmfrec src/common.c:546 factors_closed_form)
    implicit:  cw = w*alpha*val, cv = w*(1 + alpha*val)
               (src/common.c:2063 factors_implicit_chol)
    na0:       NA-as-zero explicit: cw = w*(wgt-1), cv = w*(wgt*(val - ob)
               + mu + ob); the caller puts w * opp^T opp into G0 and
               w * opp^T (-mu - opp_bias) into the rhs base
               (src/common.c:3118 optimizeA case 3, the bias_BtX trick of
               src/collective.c:303-312)
    """
    msk = length_mask(p.length, p.idx.shape[1]).to(p.val.dtype)
    slots = (None if p.ring is None else
             shard_slots(p.idx, p.length, p.opp.shape[0], p.ring))
    ob = None
    if p.opp_bias is not None:
        ob = (p.opp_bias[p.idx] if slots is None
              else ring_take(p.opp_bias, slots))
    if mode == "explicit":
        vadj = p.val if ob is None else p.val - ob
        cw = p.w * msk if p.wgt is None else p.w * p.wgt * msk
        cv = cw * vadj
    elif mode == "implicit":
        av = p.alpha * p.val
        cw = p.w * av * msk
        cv = p.w * (1.0 + av) * msk
    elif mode == "na0":
        cw = (torch.zeros_like(p.val) if p.wgt is None
              else p.w * (p.wgt - 1.0) * msk)
        ob = torch.zeros_like(p.val) if ob is None else ob
        mu = 0.0 if p.mu is None else p.mu
        wgt = 1.0 if p.wgt is None else p.wgt
        cv = p.w * (wgt * (p.val - ob) + mu + ob) * msk
    else:
        raise ValueError(mode)
    return SparsePart(p.opp, p.idx, cw.contiguous(), cv.contiguous(), slots)


def _lam_multiplier(p: PartData, mode: str, n_total: int) -> torch.Tensor:
    """Per-row lambda multiplier for scale_lam (upstream cmfrec
    src/common.c:689-724): observation count, weight sum, or the full
    column count under NA-as-zero."""
    R, L = p.idx.shape
    if mode == "na0":
        if p.wgt is None:
            return torch.full((R,), float(n_total), dtype=p.val.dtype,
                              device=p.val.device)
        # weighted NA-as-zero: wsum over observed + 1 per missing entry
        # (src/common.c:708-710)
        msk = length_mask(p.length, L).to(p.val.dtype)
        wsum = torch.sum(p.wgt * msk, dim=1)
        return wsum + (float(n_total) - p.length.to(p.val.dtype))
    if p.wgt is None:
        return p.length.to(p.val.dtype)
    msk = length_mask(p.length, L).to(p.val.dtype)
    return torch.sum(p.wgt * msk, dim=1)


# cmfrec_tpu/solvers/als.py:219-224
RING_CG_MESSAGE = ("ring-sharded opposing factors support Cholesky/CD "
                   "solves only (truncated CG would cost one ring per "
                   "matvec); pass use_cg=False")


class SlotStack(NamedTuple):
    """The slots of a bucket's sparse parts laid out as one part of the
    stacked opposing matrix (each part's matrix below the previous one's):
    a row's real slots of part 1, then of part 2, ..., then padding."""

    idx: torch.Tensor  # [R, Ls] int32 rows of the stacked matrix
    src: torch.Tensor  # [R, Ls] int64 columns of the parts' coefficients
    # side by side; padding slots point at one zero column past them
    length: torch.Tensor  # [R] int32 real slots a row (the parts' sum)


def stack_slots(parts: tuple) -> SlotStack:
    """The slot map of ``parts`` (PartData of one bucket), built once per
    fit and bucket on the parts' device.  Its width is the longest row's
    slot count rounded up to 8."""
    R = parts[0].idx.shape[0]
    dev = parts[0].idx.device
    lens = [p.length.long() for p in parts]
    total = sum(lens)
    width = -(-max(int(total.max()), 1) // 8) * 8
    idx = torch.zeros(R, width, dtype=torch.int32, device=dev)
    src = torch.full((R, width), sum(p.idx.shape[1] for p in parts),
                     dtype=torch.int64, device=dev)
    before = torch.zeros(R, dtype=torch.int64, device=dev)
    col0 = row0 = 0
    for p, ln in zip(parts, lens):
        L = p.idx.shape[1]
        r, sl = torch.nonzero(length_mask(ln, L), as_tuple=True)
        pos = before[r] + sl
        idx[r, pos] = p.idx[r, sl] + row0
        src[r, pos] = col0 + sl
        before = before + ln
        col0 += L
        row0 += p.opp.shape[0]
    return SlotStack(idx, src, total.to(torch.int32))


def stacked_part(sparse_parts: list, mat: torch.Tensor,
                 st: SlotStack) -> SparsePart:
    """The parts' coefficients moved into the slot map: one gather each for
    cw and cv.  ``mat`` is the parts' matrices stacked in order."""
    z = torch.zeros(st.idx.shape[0], 1, dtype=sparse_parts[0].cw.dtype,
                    device=st.idx.device)
    cw = torch.cat([sp.cw for sp in sparse_parts] + [z], 1).gather(1, st.src)
    cv = torch.cat([sp.cv for sp in sparse_parts] + [z], 1).gather(1, st.src)
    return SparsePart(mat, st.idx, cw, cv)


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def takes_k3(dtype, precondition: bool, K: int, device) -> bool:
    """Whether a CG bucket of width K on `device` runs the bucket-CG op
    (kernel K3 on a card): f32 without Jacobi preconditioning, the JAX
    package's ``can_fuse_cg`` gate, and on a card only where a row's CG
    vectors fit its opt-in shared memory (``sparse_cg.k_fits``: K <= 3,624
    on an H100).  Otherwise rowsolve.solve_cg runs it, the route the JAX
    package takes past its gate; the twin on the CPU takes any K."""
    if dtype != torch.float32 or precondition:
        return False
    return not _on_card(device) or sparse_cg.k_fits(
        K, _cuda.optin_smem(device))


def solve_bucket(
    parts: tuple,  # of PartData
    a_prev: torch.Tensor,  # [R, K] warm start
    G0: Optional[torch.Tensor],  # [K, K]
    r0: Optional[torch.Tensor],  # [R, K] per-row rhs base
    r0_vec: Optional[torch.Tensor],  # [K] shared rhs base
    lam_vec: torch.Tensor,  # [K] (per-row-scaled under scale_lam)
    lam_const_vec: Optional[torch.Tensor],  # [K] additional unscaled diagonal
    l1_vec: Optional[torch.Tensor] = None,  # [K] l1 penalties
    *,
    modes: tuple,  # one mode string per part
    method: str,  # "chol" | "cg"
    n_steps: int,
    nonneg: bool = False,
    max_cd_steps: int = 100,
    scale_lam: bool,
    n_totals: tuple,  # per part: total column count (na0 scaling)
    scale_parts: tuple = (),  # per part: counts toward the lam multiplier
    lam_mult_add: float = 0.0,  # added to the multiplier (the observation
    # count of dense side info, upstream cmfrec src/common.c:689-724)
    mxu_bf16: bool = False,
    precondition: bool = False,  # Jacobi PCG (precondition_cg)
    stacked: Optional[tuple] = None,  # (stacked matrix, SlotStack) of CG
    # over several parts, built here when not given
) -> torch.Tensor:
    sparse_parts = [_coefficients(p, m) for p, m in zip(parts, modes)]
    R, K = a_prev.shape
    if r0_vec is not None:
        base = r0_vec[None, :].expand(R, K)
        r0 = base if r0 is None else r0 + base
    if not scale_parts:
        scale_parts = (True,) * len(parts)

    lam_mult = None
    if scale_lam:
        lam_mult = sum(_lam_multiplier(p, m, nt)
                       for p, m, nt, sc in zip(parts, modes, n_totals,
                                               scale_parts) if sc)
        # empty (or padding) rows would make the system singular; they are
        # zeroed below anyway (the reference's zero_out, common.c:676-681)
        lam_mult = torch.clamp(lam_mult + lam_mult_add, min=1.0)

    # Rows with no observations solve to exactly zero -- unless an
    # NA-as-zero part or a rhs base makes every row live.
    live = None
    if r0 is None and "na0" not in modes:
        for p in parts:
            lv = p.length > 0
            live = lv if live is None else (live | lv)

    def finish(a):
        return a if live is None else torch.where(live[:, None], a, 0.0)

    use_cd = nonneg or l1_vec is not None
    if (any(p.ring is not None for p in parts)
            and not (method == "chol" or use_cd)):
        raise ValueError(RING_CG_MESSAGE)
    if method == "chol" and not use_cd and all(
            m == "na0" and p.wgt is None for p, m in zip(parts, modes)):
        # Shared-Gram fast path: every per-row Gram correction vanishes
        # (cw == 0) and the scale_lam multiplier is row-constant, so all
        # rows share one [K, K] system (unweighted NA-as-zero).
        mult = 1.0
        if scale_lam:
            mult = max(float(sum(nt for nt, sc in zip(n_totals, scale_parts)
                                 if sc)) + lam_mult_add, 1.0)
        G = torch.diag(lam_vec * mult)
        if G0 is not None:
            G = G + G0
        if lam_const_vec is not None:
            G = G + torch.diag(lam_const_vec)
        rhs = sum(rowsolve.part_rhs(p, mxu_bf16) for p in sparse_parts)
        if r0 is not None:
            rhs = rhs + r0
        return rowsolve.solve_shared_chol(G, rhs)

    if method == "chol" or use_cd:
        G, rhs = rowsolve.assemble_system(
            sparse_parts, lam_vec, lam_mult=lam_mult, G0=G0, r0=r0,
            mxu_bf16=mxu_bf16)
        if lam_const_vec is not None:
            G = G + torch.diag(lam_const_vec)[None, :, :]
        if not use_cd:
            return finish(rowsolve.solve_chol(G, rhs))
        l1 = torch.zeros_like(lam_vec) if l1_vec is None else l1_vec
        if lam_mult is not None:
            # l1 scales with the same per-row multiplier as the L2 penalty
            # (upstream cmfrec src/common.c:717-722)
            l1 = l1[None, :] * lam_mult[:, None]
        return finish(coord_descent.solve_cd(
            G, rhs.contiguous(), l1.contiguous(), nonneg=nonneg,
            max_steps=max_cd_steps))

    # CG path
    G0_eff = G0
    if lam_const_vec is not None:
        G0_eff = torch.diag(lam_const_vec) if G0 is None else (
            G0 + torch.diag(lam_const_vec))
    if not takes_k3(a_prev.dtype, precondition, K, a_prev.device):
        return finish(rowsolve.solve_cg(
            sparse_parts, lam_vec, a_prev, n_steps, lam_mult=lam_mult,
            G0=G0_eff, r0=r0, jacobi=precondition, mxu_bf16=mxu_bf16))
    if len(parts) != 1:
        if stacked is None:
            stacked = (torch.cat([p.opp for p in parts]), stack_slots(parts))
        sp = stacked_part(sparse_parts, *stacked)
        length = stacked[1].length
    else:
        sp, length = sparse_parts[0], parts[0].length
    if lam_mult is not None:
        lam_row = (lam_vec[None, :] * lam_mult[:, None]).contiguous()
        gfix = (torch.zeros(K, K, dtype=lam_vec.dtype, device=lam_vec.device)
                if G0_eff is None else G0_eff.contiguous())
    else:
        lam_row = None
        gfix = torch.diag(lam_vec)
        if G0_eff is not None:
            gfix = G0_eff + gfix
    r0 = None if r0 is None else r0.contiguous()
    mat = sp.mat.to(torch.bfloat16) if mxu_bf16 else sp.mat
    return finish(sparse_cg.bucket_cg(
        mat, sp.idx, sp.cw, sp.cv, gfix, lam_row, r0, a_prev.contiguous(),
        n_steps=n_steps, length=length))


class SidePlan(NamedTuple):
    """Everything needed to run one half-iteration for one factor side."""

    bucketed: BucketedRows  # sparse data, rows = this side
    mode: str  # part mode of the X part
    n_total: int  # column count of this orientation


def update_side(
    plan: SidePlan,
    blocks: list,  # current per-bucket factor blocks (warm starts)
    opp: torch.Tensor,  # [S, K] extended opposing matrix
    opp_bias: Optional[torch.Tensor],
    lam_vec: torch.Tensor,
    *,
    w: float = 1.0,
    alpha: Optional[float] = None,
    mu: Optional[float] = None,
    G0: Optional[torch.Tensor] = None,
    r0_vec: Optional[torch.Tensor] = None,  # [K] shared rhs base
    r0_blocks: Optional[list] = None,  # per-bucket [R, K] rhs bases
    extra_parts: Optional[list] = None,  # per bucket: list of
    #   (PartData, mode, n_total, counts_toward_scale_lam)
    ones_val: bool = False,  # values 1.0 (Xones, the implicit features)
    lam_const_vec: Optional[torch.Tensor] = None,
    l1_vec: Optional[torch.Tensor] = None,
    method: str = "chol",
    n_steps: int = 3,
    nonneg: bool = False,
    max_cd_steps: int = 100,
    scale_lam: bool = False,
    lam_mult_add: float = 0.0,
    mxu_bf16: bool = False,
    precondition: bool = False,  # Jacobi PCG (precondition_cg)
    stacks: Optional[list] = None,  # per-bucket SlotStack cache (None
    # entries are filled on first use) for CG over several parts
    mesh=None,  # a 1-D DeviceMesh: plan.bucketed is this rank's share
    ring_mesh=None,  # the big-axis ring's mesh: plan.bucketed, blocks and
    # the opposing matrices are this rank's (parallel/ring.py)
) -> list:
    """Solve all buckets of one side; returns the new block list.  Under
    ``mxu_bf16`` the opposing matrix is rounded to bf16 once per side.  A
    CG bucket with several parts that takes the bucket-CG op
    (:func:`takes_k3`) runs it once over the parts' matrices stacked (built
    once per call) and the bucket's slot map.  Under ``nonneg`` or an
    ``l1_vec`` every bucket is solved by coordinate descent, whatever
    ``method`` says, as in the JAX package.  Under ``mesh`` the plan's
    buckets, ``r0_blocks`` and ``extra_parts`` hold this rank's rows
    (data/device_fill.py:build_bucketed_pair_share) and ``blocks`` are
    whole: the rank solves its rows and the returned blocks are whole
    again (one all-gather).  Under ``ring_mesh`` the blocks, ``opp``,
    ``opp_bias`` and the extra parts' matrices and biases are this rank's
    shards in ring order, and the returned blocks this rank's, with no
    gather (parallel/ring.py)."""
    if ring_mesh is None:
        blocks = local_blocks(blocks, plan.bucketed, mesh)
        ring, operand = None, None
    else:
        seen = {}

        def operand(mat, bias):
            """(matrix, bias, ring) of a part: each distinct shard resolved
            (kept, or gathered whole) once a half-step."""
            key = (id(mat), id(bias))
            if key not in seen:
                seen[key] = opposing_operand(mat, bias, ring_mesh)
            return seen[key]

        opp, opp_bias, ring = operand(opp, opp_bias)
    use_cd = nonneg or l1_vec is not None
    mat = opp.to(torch.bfloat16) if mxu_bf16 else opp
    mat_cat = None
    out = []
    for bi, (b, blk) in enumerate(zip(plan.bucketed.buckets, blocks)):
        part = PartData(idx=b.idx, length=b.length, opp=mat,
                        val=torch.ones_like(b.val) if ones_val else b.val,
                        # the Xones solves are unweighted even in a weighted
                        # fit (upstream cmfrec src/collective.c:8458-8530)
                        wgt=None if ones_val else b.wgt,
                        opp_bias=opp_bias, w=w, alpha=alpha, mu=mu,
                        ring=ring)
        parts, modes = (part,), (plan.mode,)
        n_totals, scale_parts = (plan.n_total,), (True,)
        for pd, pmode, pn, psc in ([] if extra_parts is None
                                   else extra_parts[bi]):
            if operand is not None:
                pmat, pbias, pring = operand(pd.opp, pd.opp_bias)
                pd = pd._replace(opp=pmat, opp_bias=pbias, ring=pring)
            parts, modes = parts + (pd,), modes + (pmode,)
            n_totals, scale_parts = n_totals + (pn,), scale_parts + (psc,)
        stacked = None
        if (method == "cg" and not use_cd and len(parts) > 1
                and takes_k3(blk.dtype, precondition, blk.shape[1],
                             blk.device)):
            if mat_cat is None:
                mat_cat = torch.cat([p.opp for p in parts])
                if mxu_bf16:
                    mat_cat = mat_cat.to(torch.bfloat16)
            if stacks is None:
                stacks = [None] * len(blocks)
            if stacks[bi] is None:
                stacks[bi] = stack_slots(parts)
            stacked = (mat_cat, stacks[bi])
        out.append(solve_bucket(
            parts, blk, G0, None if r0_blocks is None else r0_blocks[bi],
            r0_vec, lam_vec, lam_const_vec, l1_vec, modes=modes,
            method=method, n_steps=n_steps, nonneg=nonneg,
            max_cd_steps=max_cd_steps, scale_lam=scale_lam, n_totals=n_totals,
            scale_parts=scale_parts, lam_mult_add=lam_mult_add,
            mxu_bf16=mxu_bf16, precondition=precondition, stacked=stacked))
    return out if ring_mesh is not None else gather_blocks(out, mesh)


def blocks_to_orig(blocks: list, perm: torch.Tensor) -> torch.Tensor:
    """Concatenate permuted bucket blocks and re-order to original row ids."""
    return torch.cat(blocks, dim=0)[perm]


def init_blocks(gen: torch.Generator, bucketed: BucketedRows, k_tot: int,
                k_pad: int, dtype=torch.float32, side=None) -> list:
    """Random normal init scaled like the reference's random_parallel
    (upstream cmfrec src/helpers.c:927), zero on coordinates >= k_tot, in
    the fit's ``dtype``.  The draws follow the layout of ROW_BLOCK rows a
    block: a layout padded for a mesh (``row_block`` > ROW_BLOCK) takes the
    same rows' draws, its padding rows zero, so that the start does not
    depend on the mesh size.  Under the big-axis ring (``side``, the
    layout's parallel/ring.py:RingSide) only this rank's blocks are made,
    each draw block's rows of them kept as it is drawn."""
    scale = float(1.0 / np.sqrt(max(k_tot, 1)))
    sizes = [b.n_rows for b in bucketed.buckets]
    perm, row_of = bucketed.perm, bucketed.row_of
    if bucketed.row_block != ROW_BLOCK:
        order = np.argsort(-bucketed.counts, kind="stable").astype(np.int64)
        chunks, perm, row_of, _ = plan_layout(bucketed.counts, order,
                                              bucketed.n_rows)
        sizes = [c[1] for c in chunks]
    shard = (None if side is None else
             torch.zeros(side.chunk, k_pad, dtype=dtype, device=gen.device))
    blocks, pos = [], 0
    for R in sizes:
        blk = scale * torch.randn(R, k_pad, generator=gen, dtype=dtype,
                                  device=gen.device)
        blk[:, k_tot:] = 0.0
        if shard is None:
            blocks.append(blk)
        else:
            side.keep(shard, blk, row_of[pos:pos + R])
        pos += R
    if shard is not None:
        return side.split(shard)
    if bucketed.row_block == ROW_BLOCK:
        return blocks
    orig = blocks_to_orig(blocks, profiling.upload(perm, gen.device))
    ext = torch.cat([orig, orig.new_zeros(1, k_pad)])
    return [ext[profiling.upload(bucketed.row_of[b.start:b.start + b.n_rows],
                                 gen.device)]
            for b in bucketed.buckets]


def gram_matrix(mat: torch.Tensor) -> torch.Tensor:
    """M^T M (the BtB precompute, upstream cmfrec src/collective.c:6276)."""
    return mat.T @ mat
