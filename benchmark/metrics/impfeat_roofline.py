"""impfeat_roofline: % of the implicit-features work's roofline over the
profiled fit: the least time of that work (``least_seconds``) over
impfeat_s, the device seconds of its spans.

The work is counted from the data, not from how the program holds it, so
that any later implementation is read against the same work.  Each
iteration runs four products Xones @ F (Xones the observed entries'
pattern): Xones @ B and Xones @ Bi over the m users, Xones^T @ A and
Xones^T @ Ai over the n items.  A product over R rows against F [S, k]
does 2 k operations an observed entry at the iteration's operand type,
and reads the entries' positions (4 B an entry) and the rows' offsets
((R + 1) x 4 B), F at its operand size, and writes out [R, k] in float32.
Besides, in float32: the two shared Grams (A^T A and B^T B, k^2 an
opposing row; F read, the [k, k] Gram written) and their Cholesky solves
(k^3 / 3, and 2 k^2 a solved row; the rhs read, the solution written).
Each piece is bounded alone (work.bound) and the bounds added."""

import fit_record
import work

BYTES = {"bf16": 2, "f32": 4, "f64": 8}


def least_seconds(stats, config) -> float:
    """The least seconds of a fit's implicit-features work on the card."""
    args, ops = config["args"], config["operands"]
    nnz, m, n, k = stats["nnz"], stats["m"], stats["n"], args["k"]
    niter = args["niter"]
    n_bulk = niter - 1 if args["finalize_chol"] else niter
    total = 0.0
    for it in range(niter):
        fmt = ops["bulk"] if it < n_bulk else ops["final"]
        for R, S in ((m, n), (m, n), (n, m), (n, m)):
            nbytes = (4 * nnz + 4 * (R + 1) + BYTES[fmt] * S * k
                      + 4 * R * k)
            total += work.bound(nbytes, {fmt: 2 * k * nnz})
        for S, R in ((m, n), (n, m)):  # Gram of S rows, R rows solved
            total += work.bound(4 * (S * k + k * k),
                                {"f32": k * k * S})
            total += work.bound(4 * (2 * R * k + k * k),
                                {"f32": k ** 3 / 3 + 2 * k * k * R})
    return total


def read(run):
    rec = fit_record.record(run)
    spans = [] if rec is None else [
        s.device_s for s in rec.named("cmfrec.engine.impfeat")
        if s.device_s is not None]
    seconds = sum(spans)
    if not seconds:
        return None
    return 100.0 * least_seconds(run.stats, run.cell.config) / seconds
