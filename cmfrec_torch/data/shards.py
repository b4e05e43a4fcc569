"""Degree-bucketed padded CSR, the sparse engine's layout
(port of cmfrec_tpu/data/shards.py; NumPy planning, tensors on any device).

The reference keeps a dual CSR+CSC copy of X and dispatches per-row solves
over OpenMP threads (upstream cmfrec src/collective.c:6452,
src/common.c:2922).  Here rows are sorted by nnz (descending) and grouped
into buckets of one padded width L; each bucket's row count R is a multiple
of ``ROW_BLOCK`` and its R*L slab is capped at ``MAX_BLOCK_ELEMS``, so every
bucket is one batched solve.  The boundaries come from a small dynamic
program that minimises the padded slots sum(R*L) with at most 12 buckets
(ML10M/LastFM shapes land at ~1.15-1.3x nnz).

The planner is the JAX package's, constant for constant, so both packages
put the same rows in the same buckets (same boundaries, perm, row_of, R, L);
data/device_fill.py fills the buckets.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

ROW_BLOCK = 8  # bucket row counts are multiples of this
MAX_BLOCK_ELEMS = 1 << 23  # cap on a bucket's R*L slots
MIN_WIDTH = 8  # narrowest bucket width
WIDTH_STEP = 8  # bucket widths are multiples of this
MAX_BUCKETS = 12  # the boundary DP's chunk limit


@dataclass
class Bucket:
    """One statically-shaped batch of padded sparse rows."""

    start: int  # offset of this bucket's first row in the permuted row space
    n_rows: int  # R (includes padding rows at the tail)
    n_real: int  # number of genuine rows (<= n_rows)
    width: int  # L
    idx: Any  # [R, L] int32 column ids, 0-padded
    val: Any  # [R, L] values, 0-padded
    length: Any  # [R] int32 nnz per row (0 for padding rows)
    wgt: Optional[Any] = None  # [R, L] observation weights or None


@dataclass
class BucketedRows:
    """A sparse matrix laid out as degree-sorted padded row buckets.

    ``perm[i]`` gives the position of original row ``i`` in the permuted
    (concatenated-bucket) row space; ``row_of[p]`` maps a permuted position
    back to the original row id (or -1 for padding rows).
    """

    n_rows: int  # real number of rows (m)
    n_cols: int  # number of columns (n)
    n_rows_pad: int  # sum of bucket n_rows
    perm: np.ndarray  # [m] int64: original row -> permuted position
    row_of: np.ndarray  # [n_rows_pad] int64: permuted position -> original row
    counts: np.ndarray  # [m] int64 nnz per original row
    buckets: list[Bucket] = field(default_factory=list)
    row_block: int = ROW_BLOCK  # bucket row counts are multiples of this

    @property
    def nnz(self) -> int:
        return int(self.counts.sum())

    def to(self, device):
        """Move the bucket tensors to ``device`` (in place; returns self)."""
        for b in self.buckets:
            b.idx = b.idx.to(device)
            b.val = b.val.to(device)
            b.length = b.length.to(device)
            if b.wgt is not None:
                b.wgt = b.wgt.to(device)
        return self


def _optimal_boundaries(sorted_counts: np.ndarray):
    """Slot-optimal bucket boundaries.

    Picks <= MAX_BUCKETS contiguous chunks of the degree-sorted rows
    minimising sum(roundup(R, ROW_BLOCK) * roundup(max_count, WIDTH_STEP)),
    the padded slots every solve pays for.  Returns [(start, end, width)].
    """
    n = sorted_counts.size
    if n == 0:
        return []
    sc = np.maximum(sorted_counts, 1)
    # candidate boundaries: starts of distinct-value runs (+ n); the DP is
    # O(K*C^2) so subsample both ends when there are too many (power-law
    # data has thousands of distinct degrees >= 128 in the head)
    _, first_idx = np.unique(-sc, return_index=True)
    cand = np.unique(np.concatenate([first_idx, [n]]))
    if cand.size > 400:
        cin = cand[:-1]
        head = cin[sc[cin] >= 128]
        tail = cin[sc[cin] < 128]
        if head.size > 0:
            head = head[np.linspace(0, head.size - 1,
                                    min(head.size, 200)).astype(int)]
        if tail.size > 0:
            tail = tail[np.linspace(0, tail.size - 1,
                                    min(tail.size, 300)).astype(int)]
        cand = np.unique(np.concatenate([head, tail, [0, n]]))
    C = cand.size
    w_at = np.maximum(
        np.ceil(sc[np.minimum(cand, n - 1)] / WIDTH_STEP) * WIDTH_STEP,
        MIN_WIDTH
    ).astype(np.int64)
    INF = np.int64(1) << 62
    dp = np.full((MAX_BUCKETS + 1, C), INF, np.int64)
    nxt = np.zeros((MAX_BUCKETS + 1, C), np.int32)
    dp[:, C - 1] = 0
    for k in range(1, MAX_BUCKETS + 1):
        for i in range(C - 2, -1, -1):
            R = -(-(cand[i + 1:] - cand[i]) // ROW_BLOCK) * ROW_BLOCK
            cost = R * w_at[i] + dp[k - 1, i + 1:]
            j = int(np.argmin(cost))
            dp[k, i] = cost[j]
            nxt[k, i] = i + 1 + j
    out = []
    i, k = 0, MAX_BUCKETS
    while i < C - 1:
        j = nxt[k, i]
        out.append((int(cand[i]), int(cand[j]), int(w_at[i])))
        i, k = j, k - 1
    return out


def plan_layout(counts: np.ndarray, row_order: np.ndarray, n_rows: int,
                row_block: int = ROW_BLOCK):
    """Bucket layout (no filling): a list of (pos, R, n_real, width, cs)
    chunks, where ``cs`` indexes ``row_order``, plus perm, row_of and
    n_rows_pad.  ``row_block`` (a multiple of ROW_BLOCK that divides over a
    mesh) pads each chunk's R; the boundaries keep ROW_BLOCK in their cost,
    so that bucket membership does not depend on the mesh size, as in the
    JAX package (cmfrec_tpu/data/shards.py:182-186)."""
    boundaries = _optimal_boundaries(counts[row_order])
    chunks = []
    perm = np.zeros(n_rows, dtype=np.int64)
    row_of_parts = []
    pos = 0
    for (bs, be, w) in boundaries:
        max_rows = max(row_block,
                       (MAX_BLOCK_ELEMS // max(w, 1)) // row_block * row_block)
        cs = bs
        while cs < be:
            ce = min(be, cs + max_rows)
            n_real = ce - cs
            R = -(-n_real // row_block) * row_block
            chunks.append((pos, R, n_real, w, cs))
            perm[row_order[cs:ce]] = pos + np.arange(n_real)
            part = np.full(R, -1, dtype=np.int64)
            part[:n_real] = row_order[cs:ce]
            row_of_parts.append(part)
            pos += R
            cs = ce
    row_of = (np.concatenate(row_of_parts) if row_of_parts
              else np.zeros(0, np.int64))
    return chunks, perm, row_of, pos


def row_owners(bucketed: BucketedRows, world: int) -> np.ndarray:
    """[n_rows] the rank that holds each original row when every bucket's
    rows are cut into ``world`` equal contiguous shares
    (parallel/mesh.py:row_share); reads the plan alone."""
    at = np.zeros(bucketed.n_rows_pad, np.int64)
    for b in bucketed.buckets:
        at[b.start:b.start + b.n_rows] = (np.arange(b.n_rows)
                                          // (b.n_rows // world))
    return at[bucketed.perm]


def dense_to_coo(X: np.ndarray, weights: Optional[np.ndarray] = None):
    """Dense matrix with NaN-coded missing entries -> COO triplets
    (the reference's dense X with NAN holes, upstream cmfrec
    src/common.c:585-590)."""
    X = np.asarray(X)
    rows, cols = np.nonzero(~np.isnan(X))
    vals = X[rows, cols]
    wv = weights[rows, cols] if weights is not None else None
    return rows, cols, vals, wv
