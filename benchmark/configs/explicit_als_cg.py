"""Plain reference of ``explicit_als_cg``: upstream cmfrec's explicit ALS
with user and item biases, centering, scaled lambda, truncated CG and a
final exact iteration (src/collective.c:7263 without side information).

From the program it takes only its random start (the factors of a fit of
the same model with ``niter=0``: their draws follow the program's own
layout), which check.start_numbers holds against the program's documented
draw; the global mean, the biases' start and every iteration it works out
itself from the ratings.
"""

from __future__ import annotations

import torch

import plain
import work


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


def fit(row, col, val, m, n, args, start, prec=plain.PLAIN):
    """The fitted model {A, B, biasA, biasB, glob_mean} of ``args`` (the
    configuration's model arguments) on the ratings (row, col, val) from
    the random factors ``start`` = {A: [m, k], B: [n, k]}."""
    if not (args["user_bias"] and args["item_bias"] and args["center"]
            and args["scale_lam"] and args["use_cg"]):
        raise ValueError("this reference covers the configuration's "
                         "biases, centering, scale_lam and CG only")
    dt, dev = prec.dtype, row.device
    k, lam = args["k"], float(args["lambda_"])
    mu = float(val.double().mean())
    y = (val.double() - mu).to(dt)
    bA, bB = bias_start(row, col, y, m, n, lam, True)
    cnt_A = torch.bincount(row, minlength=m).to(dt)
    cnt_B = torch.bincount(col, minlength=n).to(dt)
    # scale_lam: every coordinate's lambda times the row's count
    lam_A = (lam * cnt_A.clamp(min=1.0))[:, None]
    lam_B = (lam * cnt_B.clamp(min=1.0))[:, None]
    live_A, live_B = cnt_A > 0, cnt_B > 0
    A = torch.cat([start["A"].to(dev, dt), bA[:, None]], 1)
    B = torch.cat([start["B"].to(dev, dt), bB[:, None]], 1)
    A[~live_A] = 0.0
    B[~live_B] = 0.0
    # entries sorted by user for the A side, by item for the B side
    rA, cA, yA = plain.sort_by(row, col, y)
    cB, rB, yB = plain.sort_by(col, row, y)
    ones_A = torch.ones(m, 1, dtype=dt, device=dev)
    ones_B = torch.ones(n, 1, dtype=dt, device=dev)
    niter = args["niter"]
    for it in range(1, niter + 1):
        final = args["finalize_chol"] and it == niter
        fmt = prec.final if final else prec.bulk
        # B half-step (src/collective.c:8614 before :8802): the opposing
        # bias coordinate is a column of ones, the user biases move to
        # the values
        side = plain.Side(cB, rB, torch.ones_like(yB), yB - A[rB, k], n)
        opp = torch.cat([A[:, :k], ones_A], 1)
        B = (plain.exact(side, opp, lam_B, fmt) if final else
             plain.cg(side, opp, B, lam_B, args["max_cg_steps"], fmt))
        B[~live_B] = 0.0
        side = plain.Side(rA, cA, torch.ones_like(yA), yA - B[cA, k], m)
        opp = torch.cat([B[:, :k], ones_B], 1)
        A = (plain.exact(side, opp, lam_A, fmt) if final else
             plain.cg(side, opp, A, lam_A, args["max_cg_steps"], fmt))
        A[~live_A] = 0.0
    return {"A": A[:, :k], "B": B[:, :k], "biasA": A[:, k],
            "biasB": B[:, k], "glob_mean": mu}


def fit_ops(stats, config):
    """The fit's floating-point operations by operand type (fit_mfu's
    work), the configuration's ``operands`` naming the types."""
    args, ops = config["args"], config["operands"]
    return work.explicit_fit_ops(stats["nnz"], stats["m"], stats["n"],
                                 args["k"], args["niter"],
                                 args["max_cg_steps"], args["finalize_chol"],
                                 ops["bulk"], ops["final"])
