"""Batched per-row ridge solvers of the bucketed engine
(port of cmfrec_tpu/ops/rowsolve.py, plain torch).

Every ALS half-iteration solves, for each row i of a bucket,

    (G0 + sum_l cw[i,l] M[idx[i,l]] M[idx[i,l]]^T + diag(lam_i)) a_i
        = r0_i + sum_l cv[i,l] M[idx[i,l]]

where M is the (extended) opposing factor matrix and (cw, cv) encode the
model variant (explicit, implicit/WRMF, NA-as-zero; see solvers/als.py).
The solvers are batched Cholesky (the reference's tposv_, upstream cmfrec
src/common.c:1045), warm-started truncated CG with the reference's
two-tolerance stop (src/common.c:1098,1147,1181) and cyclic coordinate
descent for non-negative and L1-penalised rows (src/common.c:2131,2228).

bf16 operands (``mxu_bf16``, the CG iterations on a card): the opposing
rows are bf16, every product of two bf16 values is exact in f32 and every
sum is f32; the CG direction, t = (m . v) * cw and cv are rounded to bf16
where they meet the rows, as cmfrec_tpu's ``_part_matvec`` does.  f32
matrix products on a card need ``torch.backends.cuda.matmul.allow_tf32 =
False`` (config.resolve_device sets it): TF32 keeps ~3 decimal digits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# rows whose initial residual r.r is below are skipped, and a live row
# freezes once its residual falls below; both compare in the rows' own
# dtype (a Python float against a tensor), as the JAX package's do
SKIP_TOL = 1e-12
FREEZE_TOL = 1e-8


class SparsePart(NamedTuple):
    """One sparse contribution to a batch of row systems.

    mat: [S, K] extended opposing factor matrix (gather source)
    idx: [R, L] int32 indices into mat (0-padded)
    cw:  [R, L] Gram coefficients (0 on padding)
    cv:  [R, L] rhs coefficients  (0 on padding)
    ring: None, or, where ``mat`` is this rank's shard of a row-sharded
          matrix and ``idx`` are ring-order ids, the slots grouped by the
          shard that holds their rows (parallel/ring.py:ShardSlots)
    """

    mat: torch.Tensor
    idx: torch.Tensor
    cw: torch.Tensor
    cv: torch.Tensor
    ring: object = None


def length_mask(length: torch.Tensor, width: int) -> torch.Tensor:
    """[R] lengths -> [R, width] validity mask."""
    return (torch.arange(width, device=length.device)[None, :]
            < length[:, None])


def gather_rows(mat: torch.Tensor, idx: torch.Tensor,
                mxu_bf16: bool = False) -> torch.Tensor:
    """[S, K], [R, L] -> [R, L, K], in mat's dtype (bf16 with mxu_bf16)."""
    if mxu_bf16:
        mat = mat.to(torch.bfloat16)
    R, L = idx.shape
    return mat.index_select(0, idx.reshape(-1)).view(R, L, mat.shape[1])


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and held in f32 (a no-op unless bf16)."""
    return x.to(dtype).float() if dtype == torch.bfloat16 else x


def _widen(ms: torch.Tensor) -> torch.Tensor:
    """Gathered rows for arithmetic: bf16 values held in f32."""
    return ms.float() if ms.dtype == torch.bfloat16 else ms


def part_rows(part: SparsePart, mxu_bf16: bool = False) -> torch.Tensor:
    """[R, L, K] the opposing rows of a part's slots, in mat's dtype (bf16
    with mxu_bf16): gathered, or under the big-axis ring gathered shard by
    shard as the shards pass (parallel/ring.py:ring_rows)."""
    if part.ring is None:
        return gather_rows(part.mat, part.idx, mxu_bf16)
    from ..parallel.ring import ring_rows

    return ring_rows(part.mat, part.ring, mxu_bf16)


def part_gram(part: SparsePart, mxu_bf16: bool = False,
              ms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[R, K, K] Gram contribution: sum_l cw * m m^T (``ms``: the part's
    rows, part_rows, where already at hand)."""
    ms = part_rows(part, mxu_bf16) if ms is None else ms
    msf = _widen(ms)
    lhs = msf * _round(part.cw, ms.dtype)[..., None]
    return torch.einsum("rlk,rlm->rkm", _round(lhs, ms.dtype), msf)


def part_rhs(part: SparsePart, mxu_bf16: bool = False,
             ms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[R, K] rhs contribution: sum_l cv * m (``ms`` as in part_gram)."""
    ms = part_rows(part, mxu_bf16) if ms is None else ms
    return torch.einsum("rlk,rl->rk", _widen(ms), _round(part.cv, ms.dtype))


def _part_matvec(msf: torch.Tensor, cw: torch.Tensor, v: torch.Tensor,
                 dtype) -> torch.Tensor:
    """[R, L, K] gathered rows (held in f32, of ``dtype`` values), [R, L]
    coefficients, [R, K] vectors -> [R, K]."""
    t = torch.einsum("rlk,rk->rl", msf, _round(v, dtype)) * cw
    return torch.einsum("rl,rlk->rk", _round(t, dtype), msf)


def assemble_system(
    parts: list,
    lam_vec: torch.Tensor,  # [K]
    lam_mult: Optional[torch.Tensor] = None,  # [R] per-row lam scaling
    G0: Optional[torch.Tensor] = None,  # [K, K] shared Gram base
    r0: Optional[torch.Tensor] = None,  # [R, K] per-row rhs base
    mxu_bf16: bool = False,
):
    """The dense batched (G [R, K, K], rhs [R, K]) for Cholesky solving.
    A part with a ``ring`` takes its rows by one ring of its matrix's
    shards (cmfrec_tpu/ops/rowsolve.py:109-135)."""
    R, K = parts[0].idx.shape[0], parts[0].mat.shape[1]
    dev = lam_vec.device
    dt = parts[0].mat.dtype
    if dt == torch.bfloat16:  # bf16 rows accumulate in f32
        dt = torch.float32
    G = torch.zeros(R, K, K, dtype=dt, device=dev)
    rhs = torch.zeros(R, K, dtype=dt, device=dev)
    for p in parts:
        ms = None if p.ring is None else part_rows(p, mxu_bf16)
        G = G + part_gram(p, mxu_bf16, ms)
        rhs = rhs + part_rhs(p, mxu_bf16, ms)
        del ms
    if G0 is not None:
        G = G + G0[None, :, :]
    if r0 is not None:
        rhs = rhs + r0
    lam_row = (lam_vec[None, :] if lam_mult is None
               else lam_vec[None, :] * lam_mult[:, None])
    G = G + torch.diag_embed(lam_row.expand(R, K))
    return G, rhs


def solve_chol(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve via Cholesky: G [R, K, K], rhs [R, K] -> [R, K]."""
    L = torch.linalg.cholesky(G)
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0]


def solve_chol_ex(G: torch.Tensor, rhs: torch.Tensor):
    """``solve_chol`` without its host sync: (x [R, K], info [R] int32).

    ``torch.linalg.cholesky`` checks ``info`` on the host after every call,
    which on a card waits for the device; ``cholesky_ex`` leaves it on the
    device, so a caller solving several batches checks all of them once.
    A row whose ``info`` is not 0 failed (its G is not positive definite)
    and its x is meaningless."""
    L, info = torch.linalg.cholesky_ex(G)
    return torch.cholesky_solve(rhs[..., None], L)[..., 0], info


def solve_shared_chol(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """All rows share ONE [K, K] SPD matrix (NA-as-zero half-steps,
    upstream cmfrec src/common.c:3118 optimizeA case 3): one factorization,
    two triangular solves over the [R, K] rhs."""
    L = torch.linalg.cholesky(G)
    y = torch.linalg.solve_triangular(L, rhs.T, upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True).T


def cg_iterations(matvec, rhs: torch.Tensor, a0: torch.Tensor, n_steps: int,
                  inv_diag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warm-started truncated (P)CG from a0, all rows at once.

    Without a preconditioner: rows whose initial r.r <= SKIP_TOL are
    skipped and a live row freezes once its r.r <= FREEZE_TOL (upstream
    cmfrec src/common.c:1147,1181).  The reference's Jacobi PCG
    (factors_explicit_pcg, src/common.c:1198) has no stopping tests: every
    row runs all steps.  A frozen row's step size is 0, so it is a no-op."""
    r = rhs - matvec(a0)
    z = r if inv_diag is None else r * inv_diag
    rz = torch.sum(r * z, dim=-1)
    live = (torch.ones_like(rz, dtype=torch.bool) if inv_diag is not None
            else rz > SKIP_TOL)
    a, p = a0, z
    for _ in range(n_steps):
        Ap = matvec(p)
        denom = torch.sum(p * Ap, dim=-1)
        alpha = torch.where(live, rz / torch.where(denom == 0, 1.0, denom),
                            0.0)
        a = a + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = r if inv_diag is None else r * inv_diag
        rz_new = torch.sum(r * z, dim=-1)
        if inv_diag is None:
            live = live & (rz_new > FREEZE_TOL)
        beta = torch.where(live, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
        p = torch.where(live[:, None], z + beta[:, None] * p, p)
        rz = torch.where(live, rz_new, rz)
    return a


def solve_cg(
    parts: list,
    lam_vec: torch.Tensor,
    a0: torch.Tensor,  # [R, K] warm start (previous factors)
    n_steps: int,
    lam_mult: Optional[torch.Tensor] = None,
    G0: Optional[torch.Tensor] = None,
    r0: Optional[torch.Tensor] = None,
    jacobi: bool = False,
    mxu_bf16: bool = False,
) -> torch.Tensor:
    """Batched truncated CG, warm-started, matching the reference's
    ``max_cg_steps`` truncation (upstream cmfrec src/common.c:1098); with
    ``jacobi=True`` diagonally-preconditioned PCG (``precondition_cg``,
    src/common.c:1190)."""
    R, K = a0.shape
    lam_row = (lam_vec[None, :] if lam_mult is None
               else lam_vec[None, :] * lam_mult[:, None])
    gathered = []
    for p in parts:
        ms = gather_rows(p.mat, p.idx, mxu_bf16)
        gathered.append((_widen(ms), ms.dtype, p.cw, p.cv))

    def matvec(v):
        out = v * lam_row
        if G0 is not None:
            out = out + v @ G0.T  # G0 @ v per row
        for msf, dt, cw, _ in gathered:
            out = out + _part_matvec(msf, cw, v, dt)
        return out

    rhs = torch.zeros(R, K, dtype=a0.dtype, device=a0.device)
    for msf, dt, _, cv in gathered:
        rhs = rhs + torch.einsum("rlk,rl->rk", msf, _round(cv, dt))
    if r0 is not None:
        rhs = rhs + r0

    inv_diag = None
    if jacobi:
        diag = lam_row.expand(R, K)
        if G0 is not None:
            diag = diag + torch.diagonal(G0)[None, :]
        for msf, _, cw, _ in gathered:
            diag = diag + torch.einsum("rlk,rl->rk", msf * msf, cw)
        inv_diag = torch.where(diag > 0,
                               1.0 / torch.where(diag > 0, diag, 1.0), 1.0)
    return cg_iterations(matvec, rhs, a0, n_steps, inv_diag)


def solve_cd(
    G: torch.Tensor,  # [R, K, K] without l1, with lam on the diagonal
    rhs: torch.Tensor,  # [R, K]
    l1_vec: torch.Tensor,  # [K] or [R, K] l1 penalty a coordinate (may be
    # 0; [R, K] for the per-row scaling of scale_lam, common.c:717-722)
    nonneg: bool,
    max_steps: int,
    a0: Optional[torch.Tensor] = None,
    tol: float = 1e-9,
    return_sweeps: bool = False,
    stop_early: bool = True,
):
    """Batched cyclic coordinate descent: non-negative least squares and/or
    elastic net, as the reference's solve_nonneg / solve_elasticnet
    (upstream cmfrec src/common.c:2131,2228) and cmfrec_tpu's solve_cd.

    Minimizes 0.5 a^T G a - rhs^T a + l1^T |a| (under ``nonneg`` subject to
    a >= 0), in the inputs' dtype.  A row is done once a sweep moves no
    coordinate by more than ``tol``, and is frozen from then on; the loop
    ends once every row is done (``stop_early=False`` runs all
    ``max_steps``, as the JAX package's scan does, to the same bits).
    ``G`` may be a view with row stride 0 (one G shared by every row).
    With ``return_sweeps`` also returns the sweeps each row ran, int32 [R].
    """
    R, K = rhs.shape
    a = (torch.zeros(R, K, dtype=rhs.dtype, device=rhs.device)
         if a0 is None else a0.clone())
    diag = torch.diagonal(G, dim1=-2, dim2=-1)
    safe_diag = torch.where(diag <= 0, 1.0, diag)
    done = torch.zeros(R, dtype=torch.bool, device=rhs.device)
    sweeps = torch.zeros(R, dtype=torch.int32, device=rhs.device)
    for _ in range(max_steps):
        if stop_early and bool(done.all()):
            break
        sweeps += (~done).to(torch.int32)
        max_delta = torch.zeros(R, dtype=rhs.dtype, device=rhs.device)
        for kk in range(K):
            g_k = G[:, kk, :]  # [R, K]
            a_k = a[:, kk].clone()
            l1_k = l1_vec[:, kk] if l1_vec.dim() == 2 else l1_vec[kk]
            # gradient without the coordinate's own term
            num = rhs[:, kk] - torch.sum(g_k * a, dim=-1) + a_k * g_k[:, kk]
            if nonneg:
                new = torch.clamp(num - l1_k, min=0.0) / safe_diag[:, kk]
            else:
                new = (torch.sign(num) * torch.clamp(num.abs() - l1_k,
                                                     min=0.0)
                       / safe_diag[:, kk])
            new = torch.where(done, a_k, new)
            a[:, kk] = new
            max_delta = torch.maximum(max_delta, torch.abs(new - a_k))
        done = done | (max_delta <= tol)
    return (a, sweeps) if return_sweeps else a
