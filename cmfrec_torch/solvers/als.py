"""Batched ALS half-iterations of the bucketed engine
(port of cmfrec_tpu/solvers/als.py).

One half-iteration solves every row of one factor matrix given the other
(the reference's optimizeA / optimizeA_implicit, upstream cmfrec
src/common.c:2742,3305).  Each degree bucket of rows is one batched solve:
coefficient prep -> batched Cholesky, or truncated CG through the fused
bucket-CG op (ops/sparse_cg.py: kernel K3 on a card, its twin on the CPU).

Not ported from the JAX package: ``defer_solve`` and the cross-bucket
Cholesky concatenation (a TPU compile-time measure: here each bucket
factors its own systems), the K = 128 lane padding of the CG operands, the
coordinate-descent solver (nonneg/L1), the ring-sharded assembly, and the
collective models' extra parts and rhs bases.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..data.shards import BucketedRows
from ..ops import rowsolve, sparse_cg
from ..ops.rowsolve import SparsePart, length_mask


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
    if mode == "explicit":
        vadj = p.val if p.opp_bias is None else p.val - p.opp_bias[p.idx]
        cw = p.w * msk if p.wgt is None else p.w * p.wgt * msk
        cv = cw * vadj
    elif mode == "implicit":
        av = p.alpha * p.val
        cw = p.w * av * msk
        cv = p.w * (1.0 + av) * msk
    elif mode == "na0":
        cw = (torch.zeros_like(p.val) if p.wgt is None
              else p.w * (p.wgt - 1.0) * msk)
        ob = (torch.zeros_like(p.val) if p.opp_bias is None
              else p.opp_bias[p.idx])
        mu = 0.0 if p.mu is None else p.mu
        wgt = 1.0 if p.wgt is None else p.wgt
        cv = p.w * (wgt * (p.val - ob) + mu + ob) * msk
    else:
        raise ValueError(mode)
    return SparsePart(p.opp, p.idx, cw.contiguous(), cv.contiguous())


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


def solve_bucket(
    parts: tuple,  # of PartData
    a_prev: torch.Tensor,  # [R, K] warm start
    G0: Optional[torch.Tensor],  # [K, K]
    r0_vec: Optional[torch.Tensor],  # [K] shared rhs base
    lam_vec: torch.Tensor,  # [K] (per-row-scaled under scale_lam)
    lam_const_vec: Optional[torch.Tensor],  # [K] additional unscaled diagonal
    *,
    modes: tuple,  # one mode string per part
    method: str,  # "chol" | "cg"
    n_steps: int,
    scale_lam: bool,
    n_totals: tuple,  # per part: total column count (na0 scaling)
    mxu_bf16: bool = False,
) -> torch.Tensor:
    sparse_parts = [_coefficients(p, m) for p, m in zip(parts, modes)]
    R, K = a_prev.shape

    lam_mult = None
    if scale_lam:
        lam_mult = sum(_lam_multiplier(p, m, nt)
                       for p, m, nt in zip(parts, modes, n_totals))
        # empty (or padding) rows would make the system singular; they are
        # zeroed below anyway (the reference's zero_out, common.c:676-681)
        lam_mult = torch.clamp(lam_mult, min=1.0)

    # Rows with no observations solve to exactly zero -- unless an
    # NA-as-zero part or a rhs base makes every row live.
    live = None
    if r0_vec is None and "na0" not in modes:
        for p in parts:
            lv = p.length > 0
            live = lv if live is None else (live | lv)

    def finish(a):
        return a if live is None else torch.where(live[:, None], a, 0.0)

    if method == "chol" and all(m == "na0" and p.wgt is None
                                for p, m in zip(parts, modes)):
        # Shared-Gram fast path: every per-row Gram correction vanishes
        # (cw == 0) and the scale_lam multiplier is row-constant, so all
        # rows share one [K, K] system (unweighted NA-as-zero).
        mult = max(float(sum(n_totals)), 1.0) if scale_lam else 1.0
        G = torch.diag(lam_vec * mult)
        if G0 is not None:
            G = G + G0
        if lam_const_vec is not None:
            G = G + torch.diag(lam_const_vec)
        rhs = sum(rowsolve.part_rhs(p, mxu_bf16) for p in sparse_parts)
        if r0_vec is not None:
            rhs = rhs + r0_vec[None, :]
        return rowsolve.solve_shared_chol(G, rhs)

    if method == "chol":
        G, rhs = rowsolve.assemble_system(
            sparse_parts, lam_vec, lam_mult=lam_mult, G0=G0,
            r0=None if r0_vec is None else r0_vec[None, :].expand(R, K),
            mxu_bf16=mxu_bf16)
        if lam_const_vec is not None:
            G = G + torch.diag(lam_const_vec)[None, :, :]
        return finish(rowsolve.solve_chol(G, rhs))

    # CG path
    G0_eff = G0
    if lam_const_vec is not None:
        G0_eff = torch.diag(lam_const_vec) if G0 is None else (
            G0 + torch.diag(lam_const_vec))
    if len(parts) != 1:
        if a_prev.device.type != "cpu":
            raise ValueError("CG over several sparse parts has no kernel "
                             "yet (ROADMAP slice 4, collective bucketed)")
        return finish(rowsolve.solve_cg(
            sparse_parts, lam_vec, a_prev, n_steps=n_steps,
            lam_mult=lam_mult, G0=G0_eff,
            r0=None if r0_vec is None else r0_vec[None, :].expand(R, K),
            mxu_bf16=mxu_bf16))
    sp = sparse_parts[0]
    if lam_mult is not None:
        lam_row = (lam_vec[None, :] * lam_mult[:, None]).contiguous()
        gfix = (torch.zeros(K, K, dtype=torch.float32, device=lam_vec.device)
                if G0_eff is None else G0_eff.contiguous())
    else:
        lam_row = None
        gfix = torch.diag(lam_vec)
        if G0_eff is not None:
            gfix = G0_eff + gfix
    r0 = None if r0_vec is None else r0_vec[None, :].expand(R, K).contiguous()
    mat = sp.mat.to(torch.bfloat16) if mxu_bf16 else sp.mat
    return finish(sparse_cg.bucket_cg(
        mat, sp.idx, sp.cw, sp.cv, gfix, lam_row, r0, a_prev,
        n_steps=n_steps, length=parts[0].length))


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
    lam_const_vec: Optional[torch.Tensor] = None,
    method: str = "chol",
    n_steps: int = 3,
    scale_lam: bool = False,
    mxu_bf16: bool = False,
) -> list:
    """Solve all buckets of one side; returns the new block list.  Under
    ``mxu_bf16`` the opposing matrix is rounded to bf16 once per side."""
    mat = opp.to(torch.bfloat16) if mxu_bf16 else opp
    out = []
    for b, blk in zip(plan.bucketed.buckets, blocks):
        part = PartData(idx=b.idx, val=b.val, length=b.length, wgt=b.wgt,
                        opp=mat, opp_bias=opp_bias, w=w, alpha=alpha, mu=mu)
        out.append(solve_bucket(
            (part,), blk, G0, r0_vec, lam_vec, lam_const_vec,
            modes=(plan.mode,), method=method, n_steps=n_steps,
            scale_lam=scale_lam, n_totals=(plan.n_total,),
            mxu_bf16=mxu_bf16))
    return out


def blocks_to_orig(blocks: list, perm: torch.Tensor) -> torch.Tensor:
    """Concatenate permuted bucket blocks and re-order to original row ids."""
    return torch.cat(blocks, dim=0)[perm]


def init_blocks(gen: torch.Generator, bucketed: BucketedRows, k_tot: int,
                k_pad: int) -> list:
    """Random normal init scaled like the reference's random_parallel
    (upstream cmfrec src/helpers.c:927), zero on coordinates >= k_tot."""
    scale = float(1.0 / np.sqrt(max(k_tot, 1)))
    blocks = []
    for b in bucketed.buckets:
        blk = scale * torch.randn(b.n_rows, k_pad, generator=gen,
                                  dtype=torch.float32, device=gen.device)
        blk[:, k_tot:] = 0.0
        blocks.append(blk)
    return blocks


def gram_matrix(mat: torch.Tensor) -> torch.Tensor:
    """M^T M (the BtB precompute, upstream cmfrec src/collective.c:6276)."""
    return mat.T @ mat
