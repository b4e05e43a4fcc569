"""Plain reference of upstream cmfrec's collective explicit ALS with
implicit features (src/collective.c:7263, ``add_implicit_features=True``,
no side information): user and item biases, centering, scaled lambda,
truncated CG and a final exact iteration, in float64.  The tests hold
cmfrec_torch's fit to it; benchmark/configs/explicit_als_cg_implicit_feat.py
is the benchmark's copy (the same steps on benchmark/plain.py's pieces,
with the operand formats of a control), and the two agree.

The model (src/collective.c:78-355): the centered ratings X ~ A B^T plus
the biases, and jointly, with weight ``w_implicit`` = w, the binary matrix
Xones of which entries were observed, read whole (zeros where nothing was
observed): Xones ~ A Bi^T and Xones^T ~ B Ai^T, Ai [m, k] and Bi [n, k]
auxiliary factors.  Each iteration, in upstream's order
(src/collective.c:8334-8860), all from the iteration's starting A and B:

- Bi (src/collective.c:8479): (A^T A + lam_Bi I) Bi_j = (Xones^T A)_j,
  every item over all m users, one shared Gram;
- Ai (src/collective.c:8520): (B^T B + lam_Ai I) Ai_u = (Xones B)_u;
- B (src/collective.c:8614): each item's ratings system plus w Ai^T Ai on
  its factor block, its rhs plus w (Xones^T Ai)_j;
- A (src/collective.c:8802): the same with w Bi^T Bi and w (Xones Bi)_u.

The Bi and Ai solves are closed forms even in a CG fit (upstream hard-codes
use_cg=false there, src/collective.c:8479,8520).  Every row is live: a row
without ratings still has its Xones part, so its start is drawn and its
system solved (with an rhs of zero).

Departures, and where this follows the JAX package's documented reading
(upstream's C source is not in the repository; the reading is
cmfrec_tpu/solvers/collective.py:1-23 and :859-895, and
cmfrec_tpu/solvers/dense_pallas.py:790-800):

- lam_Bi = lambda m / w and lam_Ai = lambda n / w under scale_lam: the
  NA-as-zero system of a row counts every opposing row, and dividing lambda
  by w puts the unweighted shared Gram on the weighted system;
- under scale_lam a ratings row's lambda counts its ratings alone (not its
  Xones entries), as in the explicit model;
- the bias coordinate takes no Xones term (Ai and Bi have k columns);
- the bias start is the explicit model's (src/common.c:4410);
- each (user, item) pair appears once, so Xones has one entry a rating.

It takes only the random start {A: [m, k], B: [n, k]} from outside; the
mean, the biases' start, Ai and Bi and every iteration it works out from
the ratings.  Every product is gathers and ``index_add_`` over the
observed entries, in blocks of entries; no dense mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK = 1 << 21
GRAM_BLOCK = 1 << 14
# upstream's CG tests (src/common.c:1147,1181): rows whose starting r.r is
# at most SKIP_TOL take no step; a row freezes once r.r <= FREEZE_TOL
SKIP_TOL = 1e-12
FREEZE_TOL = 1e-8


class Side(NamedTuple):
    """One half-step's row systems as entries sorted by the solved row:
    row r solves (sum_e cw_e o_e o_e^T + ...) x = sum_e cv_e o_e + ...,
    o_e the opposing matrix's row ``col_e``."""

    row: torch.Tensor
    col: torch.Tensor
    cw: torch.Tensor
    cv: torch.Tensor
    n_rows: int


def blocks(E: int, size: int = BLOCK):
    for s in range(0, E, size):
        yield slice(s, min(s + size, E))


def rhs(side: Side, opp):
    out = torch.zeros(side.n_rows, opp.shape[1], dtype=opp.dtype,
                      device=opp.device)
    for sl in blocks(side.row.numel()):
        out.index_add_(0, side.row[sl], side.cv[sl, None] * opp[side.col[sl]])
    return out


def matvec(side: Side, opp, v):
    out = torch.zeros_like(v)
    for sl in blocks(side.row.numel()):
        o = opp[side.col[sl]]
        t = side.cw[sl] * (v[side.row[sl]] * o).sum(1)
        out.index_add_(0, side.row[sl], t[:, None] * o)
    return out


def gram(side: Side, opp):
    K = opp.shape[1]
    out = torch.zeros(side.n_rows, K, K, dtype=opp.dtype, device=opp.device)
    for sl in blocks(side.row.numel(), GRAM_BLOCK):
        o = opp[side.col[sl]]
        out.index_add_(0, side.row[sl],
                       side.cw[sl, None, None] * o[:, :, None] * o[:, None, :])
    return out


def sort_by(row, *others):
    order = torch.argsort(row, stable=True)
    return (row[order],) + tuple(t[order] for t in others)


def bias_start(row, col, y, m, n, lam):
    """upstream's initialize_biases_twosided (src/common.c:4410) under
    scale_lam: 5 alternating closed-form passes, items first."""
    dt = y.dtype
    cnt_A = torch.bincount(row, minlength=m).to(dt)
    cnt_B = torch.bincount(col, minlength=n).to(dt)
    den_A = cnt_A + lam * cnt_A.clamp(min=1.0)
    den_B = cnt_B + lam * cnt_B.clamp(min=1.0)
    bA = torch.zeros(m, dtype=dt, device=y.device)
    for _ in range(5):
        sB = torch.zeros(n, dtype=dt, device=y.device).index_add_(
            0, col, y - bA[row])
        bB = sB / den_B
        sA = torch.zeros(m, dtype=dt, device=y.device).index_add_(
            0, row, y - bB[col])
        bA = sA / den_A
    return bA, bB


def xones_solve(side: Side, F, lam):
    """Ai or Bi (src/collective.c:8479,8520): (F^T F + lam I) out_r =
    (Xones @ F)_r, one Cholesky factor for every row."""
    G = F.T @ F
    G.diagonal().add_(lam)
    L = torch.linalg.cholesky(G)
    return torch.cholesky_solve(rhs(side, F).T, L).T


def extra_terms(side_ones: Side, Fi, w, k, K):
    """A half-step's implicit-features terms: G0 = w Fi^T Fi on the factor
    block of every row's system, R0 = w (Xones @ Fi) on its rhs."""
    G0 = torch.zeros(K, K, dtype=Fi.dtype, device=Fi.device)
    G0[:k, :k] = w * (Fi.T @ Fi)
    R0 = torch.zeros(side_ones.n_rows, K, dtype=Fi.dtype, device=Fi.device)
    R0[:, :k] = w * rhs(side_ones, Fi)
    return G0, R0


def cg(side, opp, x0, lam, G0, R0, n_steps):
    """Truncated CG from x0, every row at once, with the skip and freeze
    tests."""
    def A(v):
        return matvec(side, opp, v) + v @ G0 + lam * v

    r = rhs(side, opp) + R0 - A(x0)
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


def exact(side, opp, lam, G0, R0):
    """Every row's system solved by Cholesky (finalize_chol)."""
    G = gram(side, opp) + G0
    G.diagonal(dim1=1, dim2=2).add_(lam)
    b = rhs(side, opp) + R0
    L = torch.linalg.cholesky(G)
    return torch.cholesky_solve(b[:, :, None], L).squeeze(2)


def fit(row, col, val, m, n, args, start):
    """The fitted model {A, B, biasA, biasB, glob_mean} (float64) of
    ``args`` (CMF's arguments) on the ratings (row, col, val) from the
    random factors ``start`` = {A: [m, k], B: [n, k]}."""
    if not (args["user_bias"] and args["item_bias"] and args["center"]
            and args["scale_lam"] and args["use_cg"]
            and args["add_implicit_features"]):
        raise ValueError("this reference covers biases, centering, "
                         "scale_lam, CG and implicit features only")
    dt, dev = torch.float64, row.device
    k, lam = args["k"], float(args["lambda_"])
    w = float(args["w_implicit"])
    K = k + 1
    mu = float(val.double().mean())
    y = val.double() - mu
    bA, bB = bias_start(row, col, y, m, n, lam)
    cnt_A = torch.bincount(row, minlength=m).to(dt)
    cnt_B = torch.bincount(col, minlength=n).to(dt)
    lam_A = (lam * cnt_A.clamp(min=1.0))[:, None]
    lam_B = (lam * cnt_B.clamp(min=1.0))[:, None]
    lam_Ai, lam_Bi = lam * n / w, lam * m / w
    A = torch.cat([torch.as_tensor(start["A"]).to(dev, dt), bA[:, None]], 1)
    B = torch.cat([torch.as_tensor(start["B"]).to(dev, dt), bB[:, None]], 1)
    rA, cA, yA = sort_by(row, col, y)
    cB, rB, yB = sort_by(col, row, y)
    ones_A = torch.ones(m, 1, dtype=dt, device=dev)
    ones_B = torch.ones(n, 1, dtype=dt, device=dev)
    xones_A = Side(rA, cA, torch.ones_like(yA), torch.ones_like(yA), m)
    xones_B = Side(cB, rB, torch.ones_like(yB), torch.ones_like(yB), n)
    niter = args["niter"]
    for it in range(1, niter + 1):
        final = args["finalize_chol"] and it == niter
        Bi = xones_solve(xones_B, A[:, :k], lam_Bi)
        Ai = xones_solve(xones_A, B[:, :k], lam_Ai)
        side = Side(cB, rB, torch.ones_like(yB), yB - A[rB, k], n)
        opp = torch.cat([A[:, :k], ones_A], 1)
        G0, R0 = extra_terms(xones_B, Ai, w, k, K)
        B = (exact(side, opp, lam_B, G0, R0) if final else
             cg(side, opp, B, lam_B, G0, R0, args["max_cg_steps"]))
        side = Side(rA, cA, torch.ones_like(yA), yA - B[cA, k], m)
        opp = torch.cat([B[:, :k], ones_B], 1)
        G0, R0 = extra_terms(xones_A, Bi, w, k, K)
        A = (exact(side, opp, lam_A, G0, R0) if final else
             cg(side, opp, A, lam_A, G0, R0, args["max_cg_steps"]))
    return {"A": A[:, :k], "B": B[:, :k], "biasA": A[:, k],
            "biasB": B[:, k], "glob_mean": mu}
