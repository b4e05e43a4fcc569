"""cmfrec_torch's bucketed layout (data/shards.py planner, data/device_fill.py
fill) against cmfrec_tpu.data.shards.build_bucketed_rows on the same COO:
identical bucket boundaries, R, L, perm, row_of and lengths, and identical
(col, val, wgt) multisets per row (the column side's within-row order may
differ, as cmfrec_tpu's own device fill says).  Exact equality: the
layout is integer bookkeeping and the values are copied, not computed."""

import numpy as np
import pytest
import torch

from cmfrec_torch.data import shards
from cmfrec_torch.data.device_fill import build_bucketed_pair
from cmfrec_tpu.data import shards as jax_shards


def _power_law_coo(seed, m, n, nnz, weighted):
    """Power-law row and column degrees, unique pairs, and empty rows and
    columns (the first 5 of each never drawn)."""
    rng = np.random.default_rng(seed)
    pr = 1.0 / np.arange(1, m - 4) ** 0.9
    pc = 1.0 / np.arange(1, n - 4) ** 0.7
    rows = 5 + rng.choice(m - 5, nnz, p=pr / pr.sum())
    cols = 5 + rng.choice(n - 5, nnz, p=pc / pc.sum())
    pairs = np.unique(rows * n + cols)
    rng.shuffle(pairs)
    rows, cols = pairs // n, pairs % n
    vals = rng.normal(size=rows.size)
    wgt = rng.uniform(0.5, 2.0, rows.size) if weighted else None
    return rows, cols, vals, wgt


def _entries(bk, b, weighted):
    """(orig row, col, val[, wgt]) of a bucket's real slots, sorted."""
    idx, val = np.asarray(b.idx), np.asarray(b.val)
    ln = np.asarray(b.length).astype(np.int64)
    mask = np.arange(b.width)[None, :] < ln[:, None]
    rr = np.broadcast_to(bk.row_of[b.start:b.start + b.n_rows, None],
                         idx.shape)[mask]
    cols = [rr, idx[mask].astype(np.int64), val[mask]]
    if weighted:
        cols.append(np.asarray(b.wgt)[mask])
    order = np.lexsort(cols[::-1])
    return [c[order] for c in cols]


def _same_layout(got, want, weighted):
    assert (got.n_rows, got.n_cols, got.n_rows_pad) == (
        want.n_rows, want.n_cols, want.n_rows_pad)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.row_of, want.row_of)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert [(b.start, b.n_rows, b.n_real, b.width) for b in got.buckets] == [
        (b.start, b.n_rows, b.n_real, b.width) for b in want.buckets]
    for bg, bw in zip(got.buckets, want.buckets):
        np.testing.assert_array_equal(bg.length.numpy(), bw.length)
        assert bg.idx.dtype == torch.int32 and bg.val.dtype == torch.float32
        assert (bg.wgt is None) == (not weighted)
        for eg, ew in zip(_entries(got, bg, weighted),
                          _entries(want, bw, weighted)):
            np.testing.assert_array_equal(eg, ew)
        # padding slots are zero
        pad = np.arange(bg.width)[None, :] >= bg.length.numpy()[:, None]
        assert not bg.idx.numpy()[pad].any() and not bg.val.numpy()[pad].any()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("max_block_elems", [1 << 23, 512])
def test_pair_matches_jax_host_build(weighted, max_block_elems, monkeypatch):
    """Both orientations; the small slab cap splits buckets into chunks."""
    monkeypatch.setattr(shards, "MAX_BLOCK_ELEMS", max_block_elems)
    m, n = 300, 200
    rows, cols, vals, wgt = _power_law_coo(3, m, n, 4000, weighted)
    RB, CB = build_bucketed_pair(rows, cols, vals, m, n, wgt, device="cpu")
    assert RB.to("cpu") is RB  # moves the bucket tensors in place
    kw = dict(weights=wgt, dtype=np.float32, max_block_elems=max_block_elems)
    _same_layout(RB, jax_shards.build_bucketed_rows(rows, cols, vals, m, n,
                                                    **kw), weighted)
    _same_layout(CB, jax_shards.build_bucketed_rows(cols, rows, vals, n, m,
                                                    **kw), weighted)
    assert RB.counts[:5].sum() == 0 and CB.counts[:5].sum() == 0
    assert RB.nnz == CB.nnz == rows.size


def test_plan_layout_matches_jax_on_many_degrees(monkeypatch):
    """Thousands of distinct degrees take the DP's subsampled-candidate
    branch; the plans must still be identical."""
    monkeypatch.setattr(shards, "MAX_BLOCK_ELEMS", 1 << 16)
    rng = np.random.default_rng(7)
    counts = np.minimum(rng.pareto(0.8, 30000) * 3, 50000).astype(np.int64)
    counts[rng.uniform(size=counts.size) < 0.05] = 0
    order = np.argsort(-counts, kind="stable")
    assert np.unique(counts).size > 400
    got = shards.plan_layout(counts, order, counts.size)
    want = jax_shards.plan_layout(counts, order, counts.size, 8, 1 << 16, 8)
    assert got[0] == want[0] and got[3] == want[3]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert len({w for (_, _, _, w, _) in got[0]}) <= shards.MAX_BUCKETS


def test_dense_to_coo_matches_jax():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(7, 5))
    X[rng.uniform(size=X.shape) < 0.4] = np.nan
    W = rng.uniform(size=X.shape)
    for got, want in zip(shards.dense_to_coo(X, W),
                         jax_shards.dense_to_coo(X, W)):
        np.testing.assert_array_equal(got, want)
