"""Both orientations of the bucketed layout, filled on the fit's device
(port of cmfrec_tpu/data/device_fill.py::build_bucketed_pair_device).

The COO arrays are uploaded once as plain tensors.  The stable row sort and
the row/column counts run on the device; the counts come to the host, where
shards.plan_layout plans both sides; the entries are scattered into one
flat padded buffer per side with int64 destinations, and the transposed side
comes from a stable sort of the column ids.  This replaces the reference's
host-side dual CSR+CSC build (upstream cmfrec src/collective.c:6452
convert_sparse_X).

Under a mesh of two ranks or more (:func:`build_bucketed_pair_share`,
:func:`build_bucketed_rows_share`) a rank builds only its share: both
sides are planned on the host from the whole counts (``np.bincount``, the
same plan on every rank), the entries whose row this rank holds are
selected on the host, and only they are uploaded, sorted and scattered
into the rank's slices of each bucket, as the JAX package places each
bucket row-sharded (cmfrec_tpu/solvers/drivers.py:116-131, 390-394).  The
share equals the cut of the whole build (parallel/mesh.py:shard_bucketed)
bit for bit.

The buckets match the JAX package's host build structurally (boundaries,
perm, row_of, R, L, lengths); the within-row entry order of the column side
may differ (both are valid CSR layouts and solve identical systems).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import mesh_row_block, share_plan, world_rank
from ..utils import profiling
from .shards import ROW_BLOCK, Bucket, BucketedRows, plan_layout, row_owners


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


def _plan(counts, n_rows, n_cols, row_block=ROW_BLOCK) -> BucketedRows:
    """Plan one orientation on the host from its row counts: the bucketed
    layout with every bucket's tensors None."""
    counts = np.asarray(counts, np.int64)
    row_order = np.argsort(-counts, kind="stable").astype(np.int64)
    chunks, perm, row_of, n_rows_pad = plan_layout(counts, row_order, n_rows,
                                                   row_block)
    out = BucketedRows(n_rows=n_rows, n_cols=n_cols, n_rows_pad=n_rows_pad,
                       perm=perm, row_of=row_of, counts=counts,
                       row_block=row_block)
    out.buckets = [Bucket(start=pos, n_rows=R, n_real=n_real, width=w,
                          idx=None, val=None, length=None)
                   for (pos, R, n_real, w, _cs) in chunks]
    return out


def _fill(row_e, ids, vals, wgt, counts, buckets, perm):
    """Scatter row-sorted entries into flat buffers laid out as ``buckets``
    (a whole side, or a rank's shares of it)."""
    dev = ids.device
    sizes = np.array([b.n_rows * b.width for b in buckets], np.int64)

    def t(a):
        return profiling.upload(np.asarray(a, np.int64), dev)

    return _fill_device(
        row_e, ids, vals, wgt, counts, t(perm),
        t([b.start for b in buckets]), t([b.width for b in buckets]),
        t(np.concatenate([[0], np.cumsum(sizes)[:-1]]) if len(buckets)
          else []), int(sizes.sum()))


def _attach(buckets, lengths, idx_f, val_f, wgt_f):
    """Give ``buckets`` their [R, L] views of the flat buffers and their
    slices of ``lengths`` (the buckets' rows, concatenated)."""
    off = row = 0
    for b in buckets:
        R, w = b.n_rows, b.width
        b.idx = idx_f[off:off + R * w].view(R, w)
        b.val = val_f[off:off + R * w].view(R, w)
        b.wgt = None if wgt_f is None else wgt_f[off:off + R * w].view(R, w)
        b.length = lengths[row:row + R]
        off += R * w
        row += R


def _upload(a, dt, dev):
    """A host array on the fit's device: every entry a build uploads
    passes here."""
    return profiling.upload(np.asarray(a, dt), dev)


def _upload_sorted(rows, cols, vals, weights, dev, dtype):
    rows_d, cols_d = _upload(rows, np.int64, dev), _upload(cols, np.int64, dev)
    wgt_d = None if weights is None else _upload(weights, dtype, dev)
    return rows_d, cols_d, _device_sort_coo(rows_d, cols_d,
                                           _upload(vals, dtype, dev), wgt_d)


def _whole_side(counts_d, n_rows, n_cols, row_block, row_e, ids, vals, wgt):
    """One whole orientation: planned from its device-side counts, every
    bucket filled from the row-sorted entries."""
    out = _plan(profiling.to_host(counts_d), n_rows, n_cols, row_block)
    lengths = torch.zeros(out.n_rows_pad, dtype=torch.int32,
                          device=counts_d.device)
    lengths[profiling.upload(out.perm, counts_d.device)] = \
        counts_d.to(torch.int32)
    _attach(out.buckets, lengths,
            *_fill(row_e, ids, vals, wgt, counts_d, out.buckets, out.perm))
    return out


def _share_side(plan: BucketedRows, own, other, vals, wgt, mesh, dev, dtype,
                by_other: bool = False) -> BucketedRows:
    """This rank's share of one orientation of ``plan``: each bucket's
    contiguous slice of rows (parallel/mesh.py:share_plan), filled from the
    entries whose row (``own``, host ids) this rank holds, selected on the
    host and uploaded alone.  Selection keeps the entries' order, so the
    stable sorts on the device (by ``other`` first under ``by_other``, as
    the whole build's column side, then by ``own``) give each entry the
    slot the whole build gives it."""
    world, rank = world_rank(mesh)
    share = share_plan(plan, mesh)
    held = row_owners(plan, world) == rank
    sel = np.flatnonzero(held[own])
    own_d = _upload(own[sel], np.int64, dev)
    other_d = _upload(other[sel], np.int64, dev)
    vals_d = _upload(vals[sel], dtype, dev)
    wgt_d = None if wgt is None else _upload(wgt[sel], dtype, dev)
    order = (torch.argsort(other_d, stable=True) if by_other
             else torch.arange(sel.size, device=dev))
    order = order[torch.argsort(own_d[order], stable=True)]
    ro = np.concatenate([plan.row_of[b.start:b.start + b.n_rows]
                         for b in share.buckets] + [np.zeros(0, np.int64)])
    lengths = np.where(ro >= 0, plan.counts[np.maximum(ro, 0)], 0)
    _attach(share.buckets,
            profiling.upload(lengths.astype(np.int32), dev),
            *_fill(own_d[order], other_d[order], vals_d[order],
                   None if wgt_d is None else wgt_d[order],
                   profiling.upload(np.where(held, plan.counts, 0), dev),
                   share.buckets, plan.perm))
    return share


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

    RB = _whole_side(counts_r, m_eff, n, row_block, row_e, ids, svals, swgt)
    order2 = _transpose_order(ids)
    CB = _whole_side(counts_c, n_eff, m, row_block, ids[order2],
                     row_e[order2], svals[order2],
                     None if swgt is None else swgt[order2])
    return RB, CB


def build_bucketed_pair_share(
    rows, cols, vals, m: int, n: int,
    weights: Optional[np.ndarray] = None, *, device, mesh,
    m_eff: Optional[int] = None, n_eff: Optional[int] = None,
    dtype=np.float32,
):
    """((RB, CB), (RB_share, CB_share)): both sides' plans (bucket rows
    dividing over ``mesh``) and this rank's shares of them, with the
    tensors of the rank's rows alone (:func:`build_bucketed_pair`'s
    arguments).  The plans carry no tensors; they are what the start, the
    warm start and the big-axis ring read.  Without a mesh or at a world of
    one the whole build, which is then both plan and share."""
    row_block = mesh_row_block(mesh)
    if world_rank(mesh)[0] == 1:
        pair = build_bucketed_pair(rows, cols, vals, m, n, weights,
                                   device=device, m_eff=m_eff, n_eff=n_eff,
                                   dtype=dtype, row_block=row_block)
        return pair, pair
    dev = torch.device(device)
    m_eff = m if m_eff is None else m_eff
    n_eff = n if n_eff is None else n_eff
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    weights = None if weights is None else np.asarray(weights)
    RB = _plan(np.bincount(rows, minlength=m_eff), m_eff, n, row_block)
    CB = _plan(np.bincount(cols, minlength=n_eff), n_eff, m, row_block)
    return (RB, CB), (
        _share_side(RB, rows, cols, vals, weights, mesh, dev, dtype),
        _share_side(CB, cols, rows, vals, weights, mesh, dev, dtype,
                    by_other=True))


def build_bucketed_rows(rows, cols, vals, n_rows: int, n_cols: int, *,
                        device, dtype=np.float32,
                        row_block: int = ROW_BLOCK) -> BucketedRows:
    """The row-oriented BucketedRows alone (the feature side of sparse side
    information: rows are features, columns entities), values of
    ``dtype``."""
    dev = torch.device(device)
    rows_d, _, (row_e, ids, svals, _) = _upload_sorted(rows, cols, vals,
                                                        None, dev, dtype)
    return _whole_side(torch.bincount(rows_d, minlength=n_rows), n_rows,
                       n_cols, row_block, row_e, ids, svals, None)


def build_bucketed_rows_share(rows, cols, vals, n_rows: int, n_cols: int, *,
                              device, mesh, dtype=np.float32):
    """(plan, share) of :func:`build_bucketed_rows` over ``mesh``, as
    :func:`build_bucketed_pair_share` builds each side: the whole build,
    both plan and share, without a mesh or at a world of one."""
    row_block = mesh_row_block(mesh)
    if world_rank(mesh)[0] == 1:
        out = build_bucketed_rows(rows, cols, vals, n_rows, n_cols,
                                  device=device, dtype=dtype,
                                  row_block=row_block)
        return out, out
    rows = np.asarray(rows, np.int64)
    plan = _plan(np.bincount(rows, minlength=n_rows), n_rows, n_cols,
                 row_block)
    return plan, _share_side(plan, rows, np.asarray(cols, np.int64),
                             np.asarray(vals), None, mesh,
                             torch.device(device), dtype)
