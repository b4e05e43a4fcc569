"""Plain reference of ``explicit_als_cg_implicit_feat``: upstream cmfrec's
collective explicit ALS with implicit features (src/collective.c:7263,
``add_implicit_features=True``; no side information), with user and item
biases, centering, scaled lambda, truncated CG and a final exact
iteration.

The model (src/collective.c:78-355): the centered ratings X ~ A B^T plus
the biases, and jointly, with weight ``w_implicit`` = w, the binary matrix
Xones of which entries were observed, read whole (zeros where nothing was
observed): Xones ~ A Bi^T and Xones^T ~ B Ai^T, Ai [m, k] and Bi [n, k]
auxiliary factors.  Each iteration, in upstream's order
(src/collective.c:8334-8860), all from the iteration's starting A and B:

- Bi (src/collective.c:8479): every item's row solves the NA-as-zero
  system over all m users, one Gram shared by the rows,
  (A^T A + lam_Bi I) Bi_j = (Xones^T A)_j;
- Ai (src/collective.c:8520): likewise (B^T B + lam_Ai I) Ai_u =
  (Xones B)_u over all n items;
- B (src/collective.c:8614): each item's ratings system plus w Ai^T Ai on
  its factor block, its rhs plus w (Xones^T Ai)_j;
- A (src/collective.c:8802): the same with w Bi^T Bi and w (Xones Bi)_u.

The Bi and Ai solves are closed forms even in a CG fit (upstream hard-codes
use_cg=false there, src/collective.c:8479,8520).  Every row is live: a row
without ratings still has its Xones part, so its start is drawn and its
system solved (rows without ratings get an rhs of zero and move towards
zero).

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
- the data holds each (user, item) pair once, so Xones has one entry a
  rating.

From the program it takes only its random start (the factors of a fit of
the same model with ``niter=0``), which check.start_numbers holds against
the program's documented draw; the mean, the biases' start, Ai and Bi and
every iteration it works out itself from the ratings.  Xones products are
gathers and ``index_add_`` over the observed entries, never a dense mask.

Operand formats (``prec``): the ratings' products (the CG matvec and rhs,
the Gram of the exact iteration) and the Xones products Xones @ F take the
iteration's format, ``prec.bulk`` or ``prec.final``, as the program
rounds their operands (bf16 in the CG iterations on a card, float32 in the
last); the shared Grams F^T F and their product with the CG's vector take
``prec.final`` in every iteration, since the program computes them in
float32 throughout.
"""

from __future__ import annotations

import torch

import plain
import work

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def bias_start(row, col, y, m, n, lam, scale_lam):
    """upstream cmfrec's initialize_biases_twosided (src/common.c:4410):
    5 alternating closed-form passes, items first, on centered ratings."""
    dt = y.dtype
    cnt_A = torch.bincount(row, minlength=m).to(dt)
    cnt_B = torch.bincount(col, minlength=n).to(dt)
    den_A = cnt_A + lam * (cnt_A.clamp(min=1.0) if scale_lam else 1.0)
    den_B = cnt_B + lam * (cnt_B.clamp(min=1.0) if scale_lam else 1.0)
    bA = torch.zeros(m, dtype=dt, device=y.device)
    for _ in range(5):
        sB = torch.zeros(n, dtype=dt, device=y.device).index_add_(
            0, col, y - bA[row])
        bB = sB / den_B
        sA = torch.zeros(m, dtype=dt, device=y.device).index_add_(
            0, row, y - bB[col])
        bA = sA / den_A
    return bA, bB


def xones_times(side: plain.Side, F, fmt):
    """(Xones @ F) over ``side``'s rows: the sum of F's rows at each row's
    observed entries, F's operands in ``fmt``."""
    return plain.rhs(side, plain.round_operand(F, fmt))


def shared_gram(F, fmt):
    o = plain.round_operand(F, fmt)
    return o.T @ o


def xones_solve(side: plain.Side, F, lam, fmt, gram_fmt):
    """The NA-as-zero closed form of Ai or Bi (src/collective.c:8479,8520):
    (F^T F + lam I) out_r = (Xones @ F)_r, one Cholesky factor for all."""
    G = shared_gram(F, gram_fmt)
    G.diagonal().add_(lam)
    L = torch.linalg.cholesky(G)
    return torch.cholesky_solve(xones_times(side, F, fmt).T, L).T


class Extra:
    """A half-step's implicit-features terms: w Fi^T Fi on the factor block
    of every row's system and w (Xones @ Fi) on its rhs."""

    def __init__(self, side_ones, Fi, w, k, K, fmt, gram_fmt):
        self.gram_fmt = gram_fmt
        self.G0 = torch.zeros(K, K, dtype=Fi.dtype, device=Fi.device)
        self.G0[:k, :k] = w * shared_gram(Fi, gram_fmt)
        self.R0 = torch.zeros(side_ones.n_rows, K, dtype=Fi.dtype,
                              device=Fi.device)
        self.R0[:, :k] = w * xones_times(side_ones, Fi, fmt)

    def times(self, v):
        return (plain.round_operand(v, self.gram_fmt)
                @ plain.round_operand(self.G0, self.gram_fmt))


def cg(side, opp, x0, lam, extra: Extra, n_steps, fmt):
    """plain.cg with the implicit-features terms in the operator and the
    rhs: truncated CG from x0 with upstream's skip and freeze tests
    (src/common.c:1147,1181)."""
    o = plain.round_operand(opp, fmt)

    def A(v):
        return (plain.matvec(side, o, plain.round_operand(v, fmt))
                + extra.times(v) + lam * v)

    r = plain.rhs(side, o) + extra.R0 - A(x0)
    rs = (r * r).sum(1)
    live = rs > plain.SKIP_TOL
    x, p = x0, r
    for _ in range(n_steps):
        Ap = A(p)
        denom = (p * Ap).sum(1)
        alpha = torch.where(live, rs / torch.where(denom == 0, 1.0, denom),
                            0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rs_new = (r * r).sum(1)
        live = live & (rs_new > plain.FREEZE_TOL)
        beta = torch.where(live, rs_new / torch.where(rs == 0, 1.0, rs), 0.0)
        p = torch.where(live[:, None], r + beta[:, None] * p, p)
        rs = torch.where(live, rs_new, rs)
    return x


def exact(side, opp, lam, extra: Extra, fmt):
    """plain.exact with the implicit-features terms: every row's system
    solved by Cholesky (finalize_chol's last iteration)."""
    o = plain.round_operand(opp, fmt)
    G = plain.gram(side, o) + extra.G0
    G.diagonal(dim1=1, dim2=2).add_(lam)
    b = plain.rhs(side, o) + extra.R0
    L = torch.linalg.cholesky(G)
    return torch.cholesky_solve(b[:, :, None], L).squeeze(2)


def fit(row, col, val, m, n, args, start, prec=plain.PLAIN):
    """The fitted model {A, B, biasA, biasB, glob_mean} of ``args`` (the
    configuration's model arguments) on the ratings (row, col, val) from
    the random factors ``start`` = {A: [m, k], B: [n, k]}."""
    if not (args["user_bias"] and args["item_bias"] and args["center"]
            and args["scale_lam"] and args["use_cg"]
            and args["add_implicit_features"]):
        raise ValueError("this reference covers the configuration's "
                         "biases, centering, scale_lam, CG and implicit "
                         "features only")
    dt, dev = prec.dtype, row.device
    k, lam = args["k"], float(args["lambda_"])
    w = float(args["w_implicit"])
    K = k + 1
    mu = float(val.double().mean())
    y = (val.double() - mu).to(dt)
    bA, bB = bias_start(row, col, y, m, n, lam, True)
    cnt_A = torch.bincount(row, minlength=m).to(dt)
    cnt_B = torch.bincount(col, minlength=n).to(dt)
    # scale_lam: every coordinate's lambda times the row's rating count
    lam_A = (lam * cnt_A.clamp(min=1.0))[:, None]
    lam_B = (lam * cnt_B.clamp(min=1.0))[:, None]
    # the Xones systems count every opposing row, lambda over w
    lam_Ai, lam_Bi = lam * n / w, lam * m / w
    # every row is live: the start's draws stand on rows without ratings
    A = torch.cat([start["A"].to(dev, dt), bA[:, None]], 1)
    B = torch.cat([start["B"].to(dev, dt), bB[:, None]], 1)
    # entries sorted by user for the A side, by item for the B side
    rA, cA, yA = plain.sort_by(row, col, y)
    cB, rB, yB = plain.sort_by(col, row, y)
    ones_A = torch.ones(m, 1, dtype=dt, device=dev)
    ones_B = torch.ones(n, 1, dtype=dt, device=dev)
    # Xones by user and Xones^T by item: a one at every rating
    xones_A = plain.Side(rA, cA, torch.ones_like(yA), torch.ones_like(yA), m)
    xones_B = plain.Side(cB, rB, torch.ones_like(yB), torch.ones_like(yB), n)
    niter = args["niter"]
    for it in range(1, niter + 1):
        final = args["finalize_chol"] and it == niter
        fmt = prec.final if final else prec.bulk
        # Bi then Ai, from this iteration's starting A and B
        Bi = xones_solve(xones_B, A[:, :k], lam_Bi, fmt, prec.final)
        Ai = xones_solve(xones_A, B[:, :k], lam_Ai, fmt, prec.final)
        # B half-step (src/collective.c:8614 before :8802): the opposing
        # bias coordinate is a column of ones, the user biases move to the
        # values; Ai's terms join each item's system
        side = plain.Side(cB, rB, torch.ones_like(yB), yB - A[rB, k], n)
        opp = torch.cat([A[:, :k], ones_A], 1)
        extra = Extra(xones_B, Ai, w, k, K, fmt, prec.final)
        B = (exact(side, opp, lam_B, extra, fmt) if final else
             cg(side, opp, B, lam_B, extra, args["max_cg_steps"], fmt))
        side = plain.Side(rA, cA, torch.ones_like(yA), yA - B[cA, k], m)
        opp = torch.cat([B[:, :k], ones_B], 1)
        extra = Extra(xones_A, Bi, w, k, K, fmt, prec.final)
        A = (exact(side, opp, lam_A, extra, fmt) if final else
             cg(side, opp, A, lam_A, extra, args["max_cg_steps"], fmt))
    return {"A": A[:, :k], "B": B[:, :k], "biasA": A[:, k],
            "biasB": B[:, k], "glob_mean": mu}


def fit_ops(stats, config):
    """The fit's floating-point operations by operand type (fit_mfu's
    work): the explicit model's (work.explicit_fit_ops), plus each
    iteration's Xones work: four products Xones @ F, 2 k operations an
    observed entry, in the iteration's type; and in the final type
    (float32 in every iteration) the four Grams F^T F (k^2 a row of F:
    A and B for the solves, Ai and Bi for the half-steps), the two
    Cholesky solves (k^3 / 3, and 2 k^2 a solved row), and in each CG
    iteration's 1 + max_cg_steps products with G0 (2 k^2 a solved row a
    side)."""
    args, ops = config["args"], config["operands"]
    nnz, m, n, k = stats["nnz"], stats["m"], stats["n"], args["k"]
    niter, steps = args["niter"], args["max_cg_steps"]
    out = work.explicit_fit_ops(nnz, m, n, k, niter, steps,
                                args["finalize_chol"], ops["bulk"],
                                ops["final"])
    n_bulk = niter - 1 if args["finalize_chol"] else niter
    for fmt, count in ((ops["bulk"], n_bulk), (ops["final"], niter - n_bulk)):
        out[fmt] = out.get(fmt, 0.0) + float(count * 4 * 2 * k * nnz)
    shared = 2 * (m + n) * k * k + 2 * k ** 3 / 3 + 2 * (m + n) * k * k
    g0 = (1 + steps) * 2 * (m + n) * k * k
    out[ops["final"]] = out.get(ops["final"], 0.0) + float(
        niter * shared + n_bulk * g0)
    return out
