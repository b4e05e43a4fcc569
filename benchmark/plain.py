"""Plain PyTorch pieces of the configurations' references: truncated CG
over per-row ridge systems held as sparse entries, exact per-row solves,
and the rounding of operands that a lower-precision control takes.

Nothing here imports the program.  Every product is written out as
gathers and ``index_add_`` over the entries, in blocks of entries, so
that a reference fits beside the card's other memory at the timed sizes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# blocks of entries: bounds a [block, K] temporary to ~1 GiB in float64,
# and a [GRAM_BLOCK, K, K] one to ~0.5 GiB
BLOCK = 1 << 21
GRAM_BLOCK = 1 << 14

# the CG's two stopping tests of upstream cmfrec (src/common.c:1147,1181):
# rows whose starting r.r is at most SKIP_TOL take no step, and a row
# freezes once its r.r falls to FREEZE_TOL or below
SKIP_TOL = 1e-12
FREEZE_TOL = 1e-8

# TF32 keeps 10 of float32's 23 mantissa bits; float8 e4m3's largest value
TF32_MANTISSA = 10
E4M3_MAX = 448.0


def round_operand(x: torch.Tensor, fmt: Optional[str]) -> torch.Tensor:
    """``x`` as an operand of format ``fmt`` would hold it, back in x's
    dtype: None keeps it; "tf32" rounds the float32 mantissa to nearest
    even; "e4m3" scales the tensor by a power of two that maps
    its largest magnitude under 448 (as a float8 product's per-tensor
    scale does) and rounds to float8_e4m3fn."""
    if fmt is None:
        return x
    if fmt == "e4m3":
        amax = float(x.abs().max()) if x.numel() else 0.0
        if amax == 0.0:
            return x
        scale = 2.0 ** int(torch.floor(torch.log2(
            torch.tensor(E4M3_MAX / amax))).item())
        return ((x.float() * scale).to(torch.float8_e4m3fn).float()
                / scale).to(x.dtype)
    if fmt != "tf32":
        raise ValueError(f"unknown operand format {fmt!r}")
    drop = 23 - TF32_MANTISSA
    bits = x.float().view(torch.int32)
    half = 1 << (drop - 1)
    odd = (bits >> drop) & 1
    bits = ((bits + (half - 1) + odd) >> drop) << drop
    return bits.view(torch.float32).to(x.dtype)


class Precision(NamedTuple):
    """How a reference computes: ``dtype`` of its sums and solves, and the
    operand format of the products in the bulk iterations and in a
    finalize iteration (None: the dtype's own)."""

    dtype: torch.dtype
    bulk: Optional[str]
    final: Optional[str]


PLAIN = Precision(torch.float64, None, None)


class Side(NamedTuple):
    """One half-step's row systems, as entries sorted by the solved row:
    row r solves (sum_e cw_e o_e o_e^T + diag(lam_r)) x = sum_e cv_e o_e,
    o_e the opposing matrix's row ``col_e``."""

    row: torch.Tensor  # [E] int64
    col: torch.Tensor  # [E] int64
    cw: torch.Tensor  # [E]
    cv: torch.Tensor  # [E]
    n_rows: int


def blocks(E: int, size: int = BLOCK):
    for s in range(0, E, size):
        yield slice(s, min(s + size, E))


def rhs(side: Side, opp: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(side.n_rows, opp.shape[1], dtype=opp.dtype,
                      device=opp.device)
    for sl in blocks(side.row.numel()):
        out.index_add_(0, side.row[sl], side.cv[sl, None] * opp[side.col[sl]])
    return out


def matvec(side: Side, opp: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sum_e cw_e (v_r . o_e) o_e for every row r."""
    out = torch.zeros_like(v)
    for sl in blocks(side.row.numel()):
        o = opp[side.col[sl]]
        t = side.cw[sl] * (v[side.row[sl]] * o).sum(1)
        out.index_add_(0, side.row[sl], t[:, None] * o)
    return out


def gram(side: Side, opp: torch.Tensor) -> torch.Tensor:
    """sum_e cw_e o_e o_e^T for every row: [R, K, K]."""
    K = opp.shape[1]
    out = torch.zeros(side.n_rows, K, K, dtype=opp.dtype, device=opp.device)
    for sl in blocks(side.row.numel(), GRAM_BLOCK):
        o = opp[side.col[sl]]
        out.index_add_(0, side.row[sl],
                       side.cw[sl, None, None] * o[:, :, None] * o[:, None, :])
    return out


def cg(side: Side, opp: torch.Tensor, x0: torch.Tensor, lam: torch.Tensor,
       n_steps: int, fmt: Optional[str]):
    """Truncated CG from the warm start x0, every row at once, with
    upstream cmfrec's skip and freeze tests; the products take their
    operands (the opposing matrix and the vector it meets) in ``fmt``."""
    o = round_operand(opp, fmt)

    def A(v):
        return matvec(side, o, round_operand(v, fmt)) + lam * v

    r = rhs(side, o) - A(x0)
    rs = (r * r).sum(1)
    live = rs > SKIP_TOL
    x, p = x0, r
    for _ in range(n_steps):
        Ap = A(p)
        denom = (p * Ap).sum(1)
        alpha = torch.where(live, rs / torch.where(denom == 0, 1.0, denom),
                            0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rs_new = (r * r).sum(1)
        live = live & (rs_new > FREEZE_TOL)
        beta = torch.where(live, rs_new / torch.where(rs == 0, 1.0, rs), 0.0)
        p = torch.where(live[:, None], r + beta[:, None] * p, p)
        rs = torch.where(live, rs_new, rs)
    return x


def exact(side: Side, opp: torch.Tensor, lam: torch.Tensor,
          fmt: Optional[str]) -> torch.Tensor:
    """Every row's system solved by Cholesky (upstream cmfrec's
    finalize_chol iteration), products on operands in ``fmt``."""
    o = round_operand(opp, fmt)
    G = gram(side, o)
    G.diagonal(dim1=1, dim2=2).add_(lam)
    b = rhs(side, o)
    L = torch.linalg.cholesky(G)
    return torch.cholesky_solve(b[:, :, None], L).squeeze(2)


def sort_by(row: torch.Tensor, *others: torch.Tensor):
    """``row`` and ``others`` reordered by ``row`` (stable)."""
    order = torch.argsort(row, stable=True)
    return (row[order],) + tuple(t[order] for t in others)


def control_precision(control: dict) -> Precision:
    """The Precision of a configuration's ``control`` entry."""
    return Precision(getattr(torch, control["dtype"]), control["bulk"],
                     control["final"])
