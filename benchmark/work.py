"""The yardstick's arithmetic: the card's published peaks, the least time
a piece of work could take on it, and the work that the kernels and the
whole fit need for a cell's inputs.

The peaks and ``bound`` are copied from chip_smoke.py (HBM_BPS, PEAK_OPS,
bound).  Counts follow the guide's rule for work that depends on the
data: each input byte read once, each output byte written once, and the
operations that these inputs need (the observed entries), not the most
a dense or padded layout could do.  So a kernel that skips work it does
not need can never read above its bound.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM bytes/s; dense bf16 tensor-core, plain
# f32 and f64 tensor-core operations/s.  An operation is costed by its
# operands' type at the fastest unit that keeps their precision: a bf16 x
# bf16 product summed in f32 at the bf16 rate, whatever unit the kernel
# uses.
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "f64": 67e12}

OPERAND = {"torch.bfloat16": "bf16", "torch.float32": "f32",
           "torch.float64": "f64"}


def bound(nbytes: float, ops: dict) -> float:
    """The least seconds the card could take: the larger of the bytes over
    HBM_BPS and the operations, by operand type, over their peaks."""
    t_ops = sum(n / PEAK_OPS[op] for op, n in ops.items())
    return max(nbytes / HBM_BPS, t_ops)


def k1_launch(Q: dict, Be: dict, W: dict, nnz: int, K: int):
    """(bytes, ops) of one launch of K1, masked_gram_matvec(Q, Be, W)
    (ops/masked_matmul.py), out[r] = sum_s W[r, s] (Q[r] . Be[s]) Be[s]:
    Q, Be and W read once as the launch gets them (``shape``,
    ``itemsize``), out [R, Kp] f32 written once; 4 K operations an
    observed entry (the dot and the update of upstream cmfrec's CG
    matvec, src/common.c:1147), K = k + 1 with the bias coordinate."""
    R, Kp = Q["shape"]
    nbytes = (_nbytes(Q) + _nbytes(Be) + _nbytes(W) + R * Kp * 4)
    return nbytes, {OPERAND[Q["dtype"]]: 4 * nnz * K}


def explicit_fit_ops(nnz: int, m: int, n: int, k: int, niter: int,
                     steps: int, finalize: bool, bulk: str,
                     final: str) -> dict:
    """Floating-point operations of upstream cmfrec's explicit ALS-CG
    with biases (src/collective.c:7263), K = k + 1 coordinates, by
    operand type: ``bulk`` for the CG iterations, ``final`` for the
    finalize iteration.  A CG half-step builds its rhs (2 K an entry) and
    runs 1 + ``steps`` matvecs (4 K an entry); the finalize iteration
    (finalize_chol) forms each row's Gram (K (K + 1) an entry, its upper
    triangle), its rhs, and factors and solves it (K^3 / 3 + 2 K^2 a
    row).  Counted once whatever engine runs it; the vector updates of
    CG are left out."""
    K = k + 1
    cg_half = nnz * (2 * K + (1 + steps) * 4 * K)
    n_bulk = niter - 1 if finalize else niter
    ops = {bulk: float(n_bulk * 2 * cg_half)}
    if finalize:
        ops[final] = ops.get(final, 0.0) + float(
            2 * (nnz * (K * (K + 1) + 2 * K))
            + (m + n) * (K ** 3 / 3 + 2 * K * K))
    return ops


def _nbytes(t: dict) -> int:
    count = 1
    for d in t["shape"]:
        count *= d
    return count * t["itemsize"]
