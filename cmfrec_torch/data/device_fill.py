"""Both orientations of the bucketed layout, filled on the fit's device
(port of cmfrec_tpu/data/device_fill.py::build_bucketed_pair_device).

The COO arrays are uploaded once as plain tensors.  The stable row sort and
the row/column counts run on the device; the counts come to the host, where
shards.plan_layout plans both sides; the entries are scattered into one
flat padded buffer per side with int64 destinations, and the transposed side
comes from a stable sort of the column ids.  This replaces the reference's
host-side dual CSR+CSC build (upstream cmfrec src/collective.c:6452
convert_sparse_X).

The buckets match the JAX package's host build structurally (boundaries,
perm, row_of, R, L, lengths); the within-row entry order of the column side
may differ (both are valid CSR layouts and solve identical systems).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .shards import ROW_BLOCK, Bucket, BucketedRows, plan_layout


def _device_sort_coo(rows, cols, vals, wgt):
    """CSR entry order from raw COO: a stable sort by row id on the device."""
    order = torch.argsort(rows, stable=True)
    return (rows[order], cols[order], vals[order],
            None if wgt is None else wgt[order])


def _transpose_order(ids):
    """Stable order of the CSR entries by column id."""
    return torch.argsort(ids, stable=True)


def _fill_device(row_e, ids, vals, wgt, counts, perm, pos_starts, widths,
                 flat_offsets, F):
    """Scatter row-sorted entries into the side's flat padded buffers.
    ``row_e`` is each entry's row id, ``counts`` the entries per row."""
    nnz = ids.shape[0]
    indptr_ex = torch.cumsum(counts, 0) - counts
    within = torch.arange(nnz, device=ids.device) - indptr_ex[row_e]
    p = perm[row_e]
    b = torch.searchsorted(pos_starts, p, right=True) - 1
    dest = flat_offsets[b] + (p - pos_starts[b]) * widths[b] + within  # int64
    idx_flat = torch.zeros(F, dtype=torch.int32, device=ids.device)
    idx_flat[dest] = ids.to(torch.int32)
    val_flat = torch.zeros(F, dtype=vals.dtype, device=ids.device)
    val_flat[dest] = vals
    wgt_flat = None
    if wgt is not None:
        wgt_flat = torch.zeros(F, dtype=wgt.dtype, device=ids.device)
        wgt_flat[dest] = wgt
    return idx_flat, val_flat, wgt_flat


def _one_side(counts_dev, n_rows, n_cols, row_block=ROW_BLOCK):
    """Plan one orientation on the host from its device-side counts."""
    counts = counts_dev.cpu().numpy().astype(np.int64)
    row_order = np.argsort(-counts, kind="stable").astype(np.int64)
    chunks, perm, row_of, n_rows_pad = plan_layout(counts, row_order, n_rows,
                                                   row_block)
    sizes = np.array([R * w for (_, R, _, w, _) in chunks], np.int64)
    dev = counts_dev.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    meta = dict(
        chunks=chunks, F=int(sizes.sum()),
        pos_starts=t([c[0] for c in chunks]),
        widths=t([c[3] for c in chunks]),
        flat_offsets=t(np.concatenate([[0], np.cumsum(sizes)[:-1]])
                       if len(chunks) else []),
        perm=t(perm),
    )
    out = BucketedRows(n_rows=n_rows, n_cols=n_cols, n_rows_pad=n_rows_pad,
                       perm=perm, row_of=row_of, counts=counts,
                       row_block=row_block)
    return out, meta


def _attach(out: BucketedRows, meta, counts_dev, idx_f, val_f, wgt_f):
    """Cut the flat buffers into per-bucket [R, L] views."""
    lengths = torch.zeros(out.n_rows_pad, dtype=torch.int32,
                          device=counts_dev.device)
    lengths[meta["perm"]] = counts_dev.to(torch.int32)
    off = 0
    for (pos, R, n_real, w, _cs) in meta["chunks"]:
        sz = R * w
        out.buckets.append(Bucket(
            start=pos, n_rows=R, n_real=n_real, width=w,
            idx=idx_f[off:off + sz].view(R, w),
            val=val_f[off:off + sz].view(R, w),
            length=lengths[pos:pos + R],
            wgt=None if wgt_f is None else wgt_f[off:off + sz].view(R, w),
        ))
        off += sz
    return out


def _upload_sorted(rows, cols, vals, weights, dev, dtype):
    def up(a, dt):
        return torch.as_tensor(np.asarray(a, dt)).to(dev)

    rows_d, cols_d = up(rows, np.int64), up(cols, np.int64)
    wgt_d = None if weights is None else up(weights, dtype)
    return rows_d, cols_d, _device_sort_coo(rows_d, cols_d,
                                           up(vals, dtype), wgt_d)


def _fill(row_e, ids, vals, wgt, counts, meta):
    return _fill_device(row_e, ids, vals, wgt, counts, meta["perm"],
                        meta["pos_starts"], meta["widths"],
                        meta["flat_offsets"], meta["F"])


def build_bucketed_pair(
    rows, cols, vals, m: int, n: int,
    weights: Optional[np.ndarray] = None, *, device,
    m_eff: Optional[int] = None, n_eff: Optional[int] = None,
    dtype=np.float32, row_block: int = ROW_BLOCK,
):
    """(row-oriented, column-oriented) BucketedRows of the COO triplets,
    with values (and weights) of ``dtype`` (the fit's) and int32 column
    ids on ``device``.
    ``m_eff`` >= m and ``n_eff`` >= n give either side extra rows with no
    entries (side-info-only entities of a collective fit); the other side's
    column count stays m or n.  ``row_block`` pads the buckets' row counts
    (parallel/mesh.py:mesh_row_block under a mesh)."""
    dev = torch.device(device)
    m_eff = m if m_eff is None else m_eff
    n_eff = n if n_eff is None else n_eff
    rows_d, cols_d, (row_e, ids, svals, swgt) = _upload_sorted(
        rows, cols, vals, weights, dev, dtype)
    counts_r = torch.bincount(rows_d, minlength=m_eff)
    counts_c = torch.bincount(cols_d, minlength=n_eff)
    del rows_d, cols_d

    RB, meta_r = _one_side(counts_r, m_eff, n, row_block)
    CB, meta_c = _one_side(counts_c, n_eff, m, row_block)
    _attach(RB, meta_r, counts_r,
            *_fill(row_e, ids, svals, swgt, counts_r, meta_r))
    order2 = _transpose_order(ids)
    _attach(CB, meta_c, counts_c,
            *_fill(ids[order2], row_e[order2], svals[order2],
                   None if swgt is None else swgt[order2], counts_c, meta_c))
    return RB, CB


def build_bucketed_rows(rows, cols, vals, n_rows: int, n_cols: int, *,
                        device, dtype=np.float32,
                        row_block: int = ROW_BLOCK) -> BucketedRows:
    """The row-oriented BucketedRows alone (the feature side of sparse side
    information: rows are features, columns entities), values of
    ``dtype``."""
    dev = torch.device(device)
    rows_d, _, (row_e, ids, svals, _) = _upload_sorted(rows, cols, vals,
                                                        None, dev, dtype)
    counts = torch.bincount(rows_d, minlength=n_rows)
    out, meta = _one_side(counts, n_rows, n_cols, row_block)
    return _attach(out, meta, counts,
                   *_fill(row_e, ids, svals, None, counts, meta))
