"""Fused bucket CG of the bucketed engine (port of
cmfrec_tpu/ops/sparse_cg.py::bucket_cg and ::bucket_cg_packed).

For every padded row r of one bucket it runs warm-started truncated CG on

    (gfix + diag(lam_row_r) + sum_l cw[r,l] m_l m_l^T) a_r
        = r0_r + sum_l cv[r,l] m_l,        m_l = mat[idx[r, l]]

from a0_r for ``n_steps`` steps, with the two-tolerance stop of
rowsolve.cg_iterations (skip at 1e-12, freeze at 1e-8).  On a CUDA tensor
the op launches the hand-written kernel K3 (csrc/sparse_cg.cu), which
gathers the opposing rows itself and keeps each row's CG state on chip
across the rhs build and every step; on a CPU tensor it runs its plain
twin :func:`bucket_cg_ref`.  There is no fallback from one to the other.

The kernel serves a bucket in one of three classes, which :func:`k3_plan`
picks from (R, L, K): narrow (a warp a row, 8 rows a block), middle (a
block a row) and wide (a cluster of 2-8 blocks a row, each over a range of
the row's slots), each staging a row's gathered slots in shared memory
where they fit the budget of two blocks an SM.  Past TILED_MAX_K, up to
ROWS_MAX_K, the rows design (:func:`rows_plan`): several rows a block
share each read of gfix, a warp a row (narrow) or a team of 2-4 warps
(middle), or a cluster a row (wide), with the slot sums in registers and
the first slots of a row staged; past ROWS_MAX_K the loop design
(:func:`block_plan`): a block (or cluster) a row, whose warps loop over K.

Operands: mat [S, K] bf16 (CG bulk iterations on a card) or f32; idx
[R, L] int32 with values in [0, S) (not checked: the kernel would read out
of bounds); cw/cv [R, L] f32, zero on padding slots; gfix [K, K] f32
symmetric; lam_row and r0 optional [R, K] f32; a0 [R, K] f32; length
[R] int32, the real slots of each row (slots beyond it must carry
cw = cv = 0: the kernel skips them, which is exact).  K is a multiple of 8,
on a card up to where a row's CG vectors fill the opt-in shared memory
(:func:`check_k`; the twin takes any).  With a bf16 ``mat`` the
rounding points are those of rowsolve._part_matvec: v, t = (m . v) * cw and
cv are rounded to bf16, products are exact and sums f32.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from . import _cuda
from .rowsolve import _part_matvec, _round, _widen, cg_iterations, gather_rows

_MAT_DTYPES = (torch.bfloat16, torch.float32)
# the kernel's register-tiled passes take K up to this; past it the rows
# design up to ROWS_MAX_K, and past that the loop design (a block or
# cluster a row, whose warps loop over K)
TILED_MAX_K = 256
ROWS_MAX_K = 1024
# the rows design's stage budget: two blocks an SM up to this K, one past it
# (the kernels' registers: csrc/sparse_cg.cu bucket_cg_rows_kernel)
ROWS_TWO_BLOCKS_MAX_K = 512
# k3_plan: rows up to this width take a warp each; the shared memory a
# block may take (two blocks an SM); the largest portable cluster
NARROW_L = 128
BLOCK_SMEM = 104 * 1024
MAX_CLUSTER = 8
# gfix is staged in shared memory up to this K (csrc/sparse_cg.cu)
GFIX_SMEM_MAX_K = 96


def _align16(x):
    return -(-x // 16) * 16


def smem_bytes(K, esz, teams, team_warps, stage_slots):
    """Shared memory of one K3 block (the layout of csrc/sparse_cg.cu):
    gfix, each team's CG vectors and partial sums, each team's stage."""
    g = K * K if K <= GFIX_SMEM_MAX_K else 0
    base = _align16((g + teams * ((8 + 2 * team_warps) * K + 32)) * 4)
    return base + teams * _align16(stage_slots * (K * esz + 4))


def rows_smem_bytes(K, esz, rows, warps, stage_slots, cluster=1):
    """Shared memory of one block of the rows design (csrc/sparse_cg.cu:
    rows_base_bytes): the rows' a, r, p; each warp's slot sums; with a
    cluster the partial sums the ranks exchange; the block sums and the
    rows' r.r; each row's stage."""
    base = _align16(((3 * rows + warps + (2 if cluster > 1 else 0)) * K
                     + 2 * warps * rows + 8) * 4)
    return base + rows * _align16(stage_slots * (K * esz + 4))


@lru_cache(maxsize=None)
def k3_plan(R, L, K, esz, sms, optin):
    """K3's launch plan for a bucket of R rows of width L, K coordinates of
    `esz` bytes, on a card of `sms` SMs and `optin` bytes of opt-in shared
    memory a block: :func:`rows_plan`'s past TILED_MAX_K up to ROWS_MAX_K,
    :func:`block_plan`'s otherwise."""
    if TILED_MAX_K < K <= ROWS_MAX_K:
        return rows_plan(R, L, K, esz, sms, optin)
    return block_plan(R, L, K, esz, sms, optin)


def block_plan(R, L, K, esz, sms, optin):
    """The plan of bucket_cg_kernel (a warp, a block or a cluster a row):
    the class, threads a block, whether
    a warp takes a row (8 rows a block), the cluster size (blocks a row),
    the slots a row (or a cluster rank's range) may stage, and the block's
    shared memory.

    narrow (L <= NARROW_L, K <= TILED_MAX_K): a warp a row.  Otherwise a
    block a row, in clusters of 2-8 blocks while the rows alone would not
    give two blocks an SM (and each rank keeps >= 256 slots), or while a
    rank's range would not fit the stage budget (up to 8 blocks an SM's
    worth of the grid).  The stage takes what BLOCK_SMEM leaves; a row whose
    range is longer re-gathers its slots on every pass.  Past TILED_MAX_K
    (the loop design, ``k_loop``: K3's past ROWS_MAX_K) narrow rows take a
    block a row too, and a block keeps 4 warps where 8 would not fit their
    vectors in the opt-in shared memory."""
    slot = K * esz + 4
    if L <= NARROW_L and K <= TILED_MAX_K:
        teams, tw, cluster, per = 8, 1, 1, L
    else:
        teams, cluster = 1, 1
        while (cluster < MAX_CLUSTER and R * cluster < 2 * sms
               and -(-L // (2 * cluster)) >= 256):
            cluster *= 2
        cap = (BLOCK_SMEM - smem_bytes(K, esz, 1, 8, 0)) // slot
        while (cluster < MAX_CLUSTER and -(-L // cluster) > cap
               and R * cluster < 8 * sms):
            cluster *= 2
        per = -(-L // cluster)
        tw = 8 if per >= 512 else 4
        if smem_bytes(K, esz, 1, tw, 0) > optin:
            tw = 4
    cap = max(0, (BLOCK_SMEM - smem_bytes(K, esz, teams, tw, 0))
              // (teams * slot))
    stage = min(per, cap)
    while stage and smem_bytes(K, esz, teams, tw, stage) > BLOCK_SMEM:
        stage -= 1
    cls = "narrow" if teams > 1 else ("wide" if cluster > 1 else "middle")
    return dict(cls=cls, threads=32 * tw * teams, warp_rows=teams > 1,
                cluster=cluster, stage_slots=stage,
                smem=smem_bytes(K, esz, teams, tw, stage),
                k_loop=K > TILED_MAX_K)


def rows_plan(R, L, K, esz, sms, optin):
    """The rows design's plan (TILED_MAX_K < K <= ROWS_MAX_K), with
    ``rows``, the rows a block.  narrow (L <= NARROW_L): a warp a row, 8
    rows a block.  Otherwise a cluster of 2-8 blocks a row (one row a
    block, a team of 4 warps, 8 past 512 slots a rank) while the rows alone
    would not give two blocks an SM and each rank keeps >= 256 slots; else
    middle: a team of 2 warps a row (4 past 512 slots), 8 warps a block,
    with fewer rows a block (and threads) while the row groups would not
    give a block an SM.  The stage, up to the row's (or rank's) slots, takes
    what the rows' vectors leave of BLOCK_SMEM (two blocks an SM) up to
    ROWS_TWO_BLOCKS_MAX_K, of ``optin`` past it: the rows a block come first
    (each read of gfix serves them all), the stage second."""
    slot = K * esz + 4
    budget = BLOCK_SMEM if K <= ROWS_TWO_BLOCKS_MAX_K else optin
    cluster = 1
    if L <= NARROW_L:
        rows, tw = 8, 1
    else:
        while (cluster < MAX_CLUSTER and R * cluster < 2 * sms
               and -(-L // (2 * cluster)) >= 256):
            cluster *= 2
        if cluster > 1:
            rows, tw = 1, (8 if -(-L // cluster) >= 512 else 4)
        else:
            tw = 2 if L <= 512 else 4
            rows = 8 // tw
            while rows > 1 and -(-R // rows) < sms:
                rows //= 2
    warps = rows * tw
    per = -(-L // cluster)
    base = rows_smem_bytes(K, esz, rows, warps, 0, cluster)
    stage = max(0, min(per, (budget - base) // (rows * slot)))
    while stage and rows_smem_bytes(K, esz, rows, warps, stage,
                                    cluster) > budget:
        stage -= 1
    cls = ("wide" if cluster > 1 else "narrow" if tw == 1 else "middle")
    return dict(cls=cls, threads=32 * warps, warp_rows=tw == 1,
                cluster=cluster, stage_slots=stage,
                smem=rows_smem_bytes(K, esz, rows, warps, stage, cluster),
                k_loop=True, rows=rows)


def k_fits(K, optin):
    """Whether one row's CG vectors (a block of 4 warps, nothing staged)
    fit ``optin``, the card's opt-in shared memory a block: the kernel's
    only limit on K (the type of ``mat`` does not enter it)."""
    return smem_bytes(K, 4, 1, 4, 0) <= optin


def check_k(K, esz, optin):
    """Raise where :func:`k_fits` does not hold."""
    if not k_fits(K, optin):
        need = smem_bytes(K, esz, 1, 4, 0)
        raise ValueError(f"bucket_cg: K={K} needs {need} bytes of shared "
                         f"memory a block for a row's CG vectors, above the "
                         f"card's {optin} (the plain twin on the CPU takes "
                         "any K)")


def plan_for(R, L, K, mat_dtype, device):
    """:func:`k3_plan` on `device`'s SM count and opt-in shared memory."""
    device = torch.device(device)
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    esz = 2 if mat_dtype == torch.bfloat16 else 4
    return k3_plan(R, L, K, esz, _cuda.sm_count(index),
                   _cuda.optin_smem(index))


def bucket_cg_ref(mat, idx, cw, cv, gfix, lam_row, r0, a0, *, n_steps):
    """Plain torch twin of :func:`bucket_cg` (it needs no ``length``: the
    padding slots carry zero coefficients)."""
    ms = gather_rows(mat, idx)
    msf = _widen(ms)

    def matvec(v):
        out = _part_matvec(msf, cw, v, ms.dtype) + v @ gfix
        return out if lam_row is None else out + v * lam_row

    rhs = torch.einsum("rlk,rl->rk", msf, _round(cv, ms.dtype))
    if r0 is not None:
        rhs = rhs + r0
    return cg_iterations(matvec, rhs, a0, n_steps)


def _validate(mat, idx, cw, cv, gfix, lam_row, r0, a0, length, n_steps):
    if mat.dtype not in _MAT_DTYPES or mat.dim() != 2:
        raise ValueError("bucket_cg: mat must be a 2-D bfloat16 or float32 "
                         f"tensor, got {mat.dtype}{tuple(mat.shape)}")
    K = mat.shape[1]
    if K % 8 or K <= 0:
        raise ValueError(f"bucket_cg: K={K} must be a positive multiple "
                         "of 8")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError("bucket_cg: idx must be a 2-D int32 tensor, got "
                         f"{idx.dtype}{tuple(idx.shape)}")
    R, L = idx.shape
    if R == 0 or L == 0:
        raise ValueError(f"bucket_cg: empty bucket {(R, L)}")
    want = {"cw": (cw, (R, L)), "cv": (cv, (R, L)), "gfix": (gfix, (K, K)),
            "lam_row": (lam_row, (R, K)), "r0": (r0, (R, K)),
            "a0": (a0, (R, K))}
    for name, (t, shape) in want.items():
        if t is None and name in ("lam_row", "r0"):
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"bucket_cg: {name} must be float32 of shape "
                             f"{shape}, got {t.dtype}{tuple(t.shape)}")
    if length.dtype != torch.int32 or tuple(length.shape) != (R,):
        raise ValueError("bucket_cg: length must be int32 of shape "
                         f"{(R,)}, got {length.dtype}{tuple(length.shape)}")
    if int(n_steps) != n_steps or n_steps < 0:
        raise ValueError(f"bucket_cg: n_steps must be an integer >= 0, "
                         f"got {n_steps!r}")
    tensors = [t for t in (mat, idx, cw, cv, gfix, lam_row, r0, a0, length)
               if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"bucket_cg: tensors on several devices {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bucket_cg: tensors must be contiguous")
    return R, L, K, devices.pop(), tensors


def bucket_cg(mat, idx, cw, cv, gfix, lam_row, r0, a0, *, n_steps, length):
    """Warm-started truncated CG over one bucket; returns [R, K] f32."""
    R, L, K, device, tensors = _validate(mat, idx, cw, cv, gfix, lam_row, r0,
                                         a0, length, n_steps)
    if device.type == "cpu":
        return bucket_cg_ref(mat, idx, cw, cv, gfix, lam_row, r0, a0,
                             n_steps=n_steps)
    if device.type != "cuda":
        raise ValueError(f"bucket_cg: no kernel for device {device}")
    check_k(K, mat.element_size(), _cuda.optin_smem(device))
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("bucket_cg: kernel operands must be 16-byte aligned")
    out = launch(mat, idx, cw, cv, gfix, lam_row, r0, a0, length, n_steps,
                 plan_for(R, L, K, mat.dtype, device))
    bucket_cg.launches += 1
    return out


def launch(mat, idx, cw, cv, gfix, lam_row, r0, a0, length, n_steps, plan,
           kernels=None):
    """One launch of the kernel on validated operands with `plan` (a
    :func:`k3_plan`, :func:`rows_plan` or :func:`block_plan` record), from
    the ops' library, or from `kernels`, a library of
    :func:`_cuda.probe_libs` (scripts/time_k3_wide_torch.py: the result is
    then not K3's).  Counts no launch: :func:`bucket_cg` is the op."""
    R, L = idx.shape
    K = mat.shape[1]
    device = mat.device

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        out = torch.empty(R, K, dtype=torch.float32, device=device)
        so = _cuda.lib() if kernels is None else kernels
        err = so.cmf_bucket_cg(
            mat.data_ptr(), idx.data_ptr(), cw.data_ptr(), cv.data_ptr(),
            gfix.data_ptr(), ptr(lam_row), ptr(r0), a0.data_ptr(),
            length.data_ptr(), out.data_ptr(), R, L, K, int(n_steps),
            int(mat.dtype == torch.float32), plan["threads"],
            int(plan["warp_rows"]), plan["cluster"], plan["stage_slots"],
            plan.get("rows", 0), stream)
    _cuda.check(err, "bucket_cg")
    return out


bucket_cg.launches = 0
