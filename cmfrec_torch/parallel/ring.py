"""The big-axis ring: opposing factors row-sharded at rest and in transit
(port of cmfrec_tpu/parallel/ring.py).

Under ``shard_opposing_rows=True`` no rank holds an opposing factor matrix
whole.  Each rank keeps the rows it solved, its share of every bucket
(parallel/mesh.py:row_share), concatenated bucket by bucket: the
rank's **shard**, S/D rows of the S a side has over D ranks.  The shards in
rank order are the side's **ring order** (:class:`RingSide`); the bucket
slots that index a side are rewritten into it once a fit, so a half-step
reads the shards as they lie, and each slot array is grouped by the shard
that holds its rows once a fit (:class:`ShardSlots`).  A part's rows are
then taken by rotating the shards around the ranks, each slot's row copied
in at the stop where its shard visits, and its Gram and rhs summed once
from them, as ops/rowsolve.py sums any part:

    ms = 0                            # [R, L, K]
    for t in 0..D-1:                  # rank d holds shard (d+t) mod D
        ms[slots of shard (d+t) mod D] = their rows of visiting_shard
        visiting_shard <- shard of rank d+1   (batch_isend_irecv)
    G = sum_l cw ms ms^T ;  rhs = sum_l cv ms

The JAX package's ``ppermute`` becomes ``torch.distributed.
batch_isend_irecv`` (NCCL between cards, gloo between CPU processes): each
rank sends to rank d-1 and receives from d+1, the next shard posted before
the current one is read and waited for after, so two shards are live.  D-1
sends a ring (the JAX package's last rotation only restores the layout;
at a world of one nothing is sent).  Sums over a whole sharded matrix (a
Gram base B^T B, the NA-as-zero rhs base) are each rank's partial sum and
one all-reduce (parallel/mesh.py:reduce_sum).

Constraints and cost:
  * Cholesky and coordinate-descent solves only: truncated CG would need
    one ring per matvec; the drivers raise on ``use_cg=True``;
  * the JAX package sums each stop's masked slots into G and rhs, D
    passes over all of a rank's slots and D Gram products a part.  Here
    each slot's row is copied once and a part's Gram is one product, so
    a row's systems are those slice 7a's data-parallel mesh= builds from
    the whole matrix, bit for bit (a slot past its row's length reads 0
    here, where 7a reads a row it weights by 0);
  * sums over a whole sharded matrix take each rank's real rows in their
    original order (:func:`row_sum`), so at a world of one every sum is
    the meshless fit's, bit for bit;
  * one ring a bucket and ringed part, as in the JAX package, so that a
    bucket's [R, L, K] rows and [R, K, K] systems are the only ones held:
    D-1 transfers of S/D rows each and their waits; the slot lists cost
    4 B a slot for the fit;
  * a matrix of fewer than RING_MIN_ROWS x D rows (side information of a
    few rows) is all-gathered instead, as the JAX package gathers it;
  * the ranks' row ids and slot layouts are alike on every rank, so every
    rank enters every ring, a bucket whose share holds only padding rows
    included;
  * a rank draws its start one seeded block at a time and keeps its rows
    of each (:meth:`RingSide.keep`): the start is the meshless one and no
    factor matrix is whole on a rank before the end of the fit.
"""

from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils import profiling
from .mesh import gather_blocks, gather_rows, reduce_sum, world_rank

# a part whose opposing matrix has fewer than this many rows a rank is
# gathered whole (cmfrec_tpu/ops/rowsolve.py:128-129)
RING_MIN_ROWS = 8


def pad_rows_to(mat: torch.Tensor, mult: int) -> torch.Tensor:
    """``mat`` with zero rows appended up to a multiple of ``mult`` rows."""
    pad = (-mat.shape[0]) % mult
    if pad == 0:
        return mat
    return torch.cat([mat, mat.new_zeros((pad,) + tuple(mat.shape[1:]))])


def rings(n_rows: int, mesh) -> bool:
    """Whether a part whose opposing matrix has ``n_rows`` rows in all is
    assembled by the ring (else gathered whole).  ``n_rows`` is the same on
    every rank, so every rank decides alike."""
    return n_rows >= RING_MIN_ROWS * world_rank(mesh)[0]


def _rotations(shard: torch.Tensor, mesh):
    """(t, the visiting shard) for t = 0..D-1: this rank's shard first,
    then each next one as it arrives from rank d+1, its transfer posted
    before the current one is handed out and waited for after."""
    world, rank = world_rank(mesh)
    group = mesh.get_group()
    cur = shard.contiguous()
    for t in range(world):
        reqs, nxt = [], None
        if t < world - 1:
            nxt = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, (rank - 1) % world, group),
                dist.P2POp(dist.irecv, nxt, (rank + 1) % world, group)])
        yield t, cur
        for r in reqs:
            r.wait()
        cur = nxt


class ShardSlots:
    """The slots of one part (ring-order ids ``idx`` [R, L] into a matrix
    held in shards of ``chunk`` rows over ``mesh``) grouped by the stop of
    this rank's rings at which the shard that holds their rows visits
    (shard (rank + t) mod D at stop t): ``order`` holds the flat positions
    r L + l of the slots below their rows' ``length`` (every slot where
    none is given), stop by stop, ``bounds[t]:bounds[t + 1]`` those of stop
    t.  Built once a fit (:func:`shard_slots`): 4 B a slot, as ``idx``.
    At a world of one there is no grouping: the ring is a gather."""

    def __init__(self, idx: torch.Tensor, length: Optional[torch.Tensor],
                 chunk: int, mesh):
        self.world, self.rank = world_rank(mesh)
        self.mesh, self.chunk, self.idx = mesh, int(chunk), idx
        self.shape = tuple(idx.shape)
        self.order = self.bounds = None
        if self.world == 1:
            return
        R, L = self.shape
        stop = ((idx.long() // chunk - self.rank) % self.world).reshape(-1)
        if length is not None:
            live = (torch.arange(L, device=idx.device)[None, :]
                    < length[:, None]).reshape(-1)
            stop = torch.where(live, stop, self.world)
        counts = torch.bincount(stop, minlength=self.world + 1)
        # one host read a part, once a fit
        self.bounds = [0] + counts[:self.world].cumsum(0).tolist()
        self.order = torch.sort(stop, stable=True).indices[
            :self.bounds[-1]].to(torch.int32)

    def stop(self, t: int):
        """(flat positions, rows in the visiting shard) of stop t's slots."""
        pos = self.order[self.bounds[t]:self.bounds[t + 1]].long()
        off = ((self.rank + t) % self.world) * self.chunk
        return pos, self.idx.reshape(-1)[pos] - off


# each slot array's ShardSlots, built at its first ring and kept while the
# array lives (the slot arrays of a fit are rewritten into ring order once
# and live as long as the fit: so each is grouped once a fit)
_SLOTS: dict = {}


def shard_slots(idx: torch.Tensor, length: Optional[torch.Tensor],
                chunk: int, mesh) -> ShardSlots:
    """``ShardSlots(idx, length, chunk, mesh)``, made once for each slot
    array ``idx`` and shard size."""
    key = (id(idx), int(chunk))
    hit = _SLOTS.get(key)
    if hit is not None and hit[0]() is idx:
        return hit[1]
    slots = ShardSlots(idx, length, chunk, mesh)
    _SLOTS[key] = (weakref.ref(idx, lambda _, key=key: _SLOTS.pop(key, None)),
                   slots)
    return slots


def _ring_take(shard: torch.Tensor, slots: ShardSlots) -> torch.Tensor:
    """[R L, ...] the rows of a row-sharded ``shard`` [S/D, ...] that
    ``slots`` read, each copied in at the stop where its shard visits; 0
    on slots past a row's length."""
    R, L = slots.shape
    out = shard.new_zeros((R * L,) + tuple(shard.shape[1:]))
    for t, visiting in _rotations(shard, slots.mesh):
        pos, loc = slots.stop(t)
        out.index_copy_(0, pos, visiting.index_select(0, loc))
    return out


def ring_rows(shard: torch.Tensor, slots: ShardSlots,
              mxu_bf16: bool = False) -> torch.Tensor:
    """[R, L, K] the rows of a row-sharded matrix (this rank's shard [S/D,
    K]) at a part's slots: ops/rowsolve.py:gather_rows of the whole matrix
    (bf16 under ``mxu_bf16``), but for 0 on slots past a row's length.
    One ring of the shard (bf16 under ``mxu_bf16``, half the bytes)."""
    from ..ops.rowsolve import gather_rows

    if slots.world == 1:
        return gather_rows(shard, slots.idx, mxu_bf16)
    if mxu_bf16:
        shard = shard.to(torch.bfloat16)
    return _ring_take(shard, slots).view(*slots.shape, shard.shape[1])


def ring_take(shard: torch.Tensor, slots: ShardSlots) -> torch.Tensor:
    """[R, L] the values of a row-sharded vector (this rank's shard [S/D])
    at a part's slots: the opposing biases its rhs coefficients read, as
    ``vec[idx]`` of the whole vector reads them (0 past a row's length).
    One ring of the vector."""
    if slots.world == 1:
        return shard[slots.idx]
    return _ring_take(shard, slots).view(slots.shape)


def ring_part_system(shard: torch.Tensor, slots: ShardSlots,
                     cw: torch.Tensor, cv: torch.Tensor,
                     mxu_bf16: bool = False):
    """The per-row Gram and rhs of one sparse part whose opposing matrix is
    row-sharded (cmfrec_tpu/parallel/ring.py:56-119): this rank's shard
    [S/D, K], its rows' slots (``slots``) and their coefficients cw/cv
    [R, L] (0 past a row's length) give this rank's (G [R, K, K], rhs
    [R, K]), from the part's rows taken by one ring (:func:`ring_rows`),
    summed as ops/rowsolve.py sums a part: in f32 under ``mxu_bf16``, else
    in the shard's dtype."""
    from ..ops.rowsolve import SparsePart, part_gram, part_rhs

    part = SparsePart(shard, slots.idx, cw, cv, slots)
    ms = ring_rows(shard, slots, mxu_bf16)
    return part_gram(part, mxu_bf16, ms), part_rhs(part, mxu_bf16, ms)


class RingSide:
    """One side's rows in ring order over ``mesh``: rank r's shard is its
    share of every bucket of ``bucketed`` (a plan: its buckets' start and
    rows, ``perm`` and ``row_of``; no tensor is read), concatenated
    bucket by bucket, and the shards follow each other in rank order.  At a
    world of one it is the bucketed layout's own concatenation (the JAX
    package's concat order, cmfrec_tpu/solvers/drivers.py:562-589)."""

    def __init__(self, bucketed, mesh, device, dtype):
        world, rank = world_rank(mesh)
        # this rank's rows of each bucket
        self.sizes = [b.n_rows // world for b in bucketed.buckets]
        self.mesh, self.rank = mesh, rank
        self.chunk = int(sum(self.sizes))
        self.n_total = self.chunk * world
        pos = np.empty(bucketed.n_rows_pad, np.int64)
        local, off = [], 0
        for b, s in zip(bucketed.buckets, self.sizes):
            o = np.arange(b.n_rows, dtype=np.int64)
            pos[b.start + o] = (o // s) * self.chunk + off + o % s
            local.append(bucketed.row_of[b.start + rank * s:
                                         b.start + (rank + 1) * s])
            off += s
        self.device = torch.device(device)
        self.dtype = dtype
        # original row -> ring position
        self.pos_of = pos[bucketed.perm]
        # this rank's ring rows -> original row (-1 on padding rows)
        self.row_of = (np.concatenate(local) if local
                       else np.zeros(0, np.int64))
        self.mask = self.rows_below(None)
        real = np.nonzero(self.row_of >= 0)[0]
        # this rank's real rows in the order of their original ids
        self.order = profiling.upload(
            real[np.argsort(self.row_of[real], kind="stable")], self.device)

    def ordered(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's real rows of ``t`` (rows in ring order) in the order
        of their original ids."""
        return t.index_select(0, self.order)

    def rows_below(self, limit: Optional[int]) -> torch.Tensor:
        """1 on this rank's real rows (of original id below ``limit``, where
        given), 0 elsewhere: the real-row and X-row masks in ring order
        (cmfrec_tpu/solvers/collective.py:780-792)."""
        keep = self.row_of >= 0
        if limit is not None:
            keep &= self.row_of < limit
        return profiling.upload(keep, self.device, self.dtype)

    def remap(self, idx: torch.Tensor) -> torch.Tensor:
        """Slot ids that index this side (original row ids, int32)
        rewritten into its ring order, once a fit
        (cmfrec_tpu/solvers/drivers.py:562-589)."""
        pos = profiling.upload(self.pos_of, idx.device, torch.int32)
        return pos[idx.long()]

    def remap_slots(self, bucketed_share) -> None:
        """``remap`` of every bucket's slots of a layout whose columns are
        this side's rows (this rank's share of the opposing side), in
        place."""
        for b in bucketed_share.buckets:
            b.idx = self.remap(b.idx)

    def keep(self, shard: torch.Tensor, blk: torch.Tensor,
             rows: np.ndarray) -> None:
        """Write into ``shard`` (this rank's [S/D, K]) its rows of ``blk``,
        one block of a seeded start whose rows are the original rows
        ``rows`` (-1 on padding rows; solvers/als.py:init_blocks)."""
        real = np.nonzero(rows >= 0)[0]
        at = self.pos_of[rows[real]] - self.rank * self.chunk
        mine = (at >= 0) & (at < self.chunk)
        if mine.any():
            shard[profiling.upload(at[mine], shard.device)] = \
                blk[profiling.upload(real[mine], blk.device)]

    def split(self, shard: torch.Tensor) -> list:
        """A shard's per-bucket blocks: this rank's rows of each bucket."""
        return list(torch.split(shard, self.sizes))

    def whole(self, blocks):
        """The whole per-bucket blocks from every rank's own: one
        all-gather (the end of a fit, a checkpoint)."""
        return gather_blocks(blocks, self.mesh)

    def values(self, whole: np.ndarray) -> torch.Tensor:
        """This rank's rows of a per-row array given for the whole side in
        original order (zeros on padding rows and rows past it)."""
        out = np.zeros((self.chunk,) + whole.shape[1:], whole.dtype)
        ok = (self.row_of >= 0) & (self.row_of < whole.shape[0])
        out[ok] = whole[self.row_of[ok]]
        return profiling.upload(out, self.device)

    def shard(self, blocks) -> torch.Tensor:
        """This rank's shard of a factor matrix from its solved blocks:
        padding rows zeroed (they carry random starts or solutions that
        would pollute shared Grams; cmfrec_tpu/solvers/drivers.py:592-609)."""
        return torch.cat(blocks, 0) * self.mask[:, None]


def row_sum(fn, side: Optional[RingSide], mesh, *mats):
    """``fn(*mats)``, a sum over the rows of the row-aligned ``mats`` (a Gram
    base B^T B, a cross term B^T U, a column sum): as it is without a ring
    (``side`` None); under the ring over this rank's real rows in their
    original order (RingSide.ordered, None passing through), added over the
    ranks.  At a world of one the meshless sum, bit for bit."""
    if side is None:
        return fn(*mats)
    return reduce_sum(fn(*(None if m is None else side.ordered(m)
                           for m in mats)), mesh)


def opposing_operand(mat: torch.Tensor, bias: Optional[torch.Tensor], mesh):
    """One part's opposing operand under the ring: (matrix, bias, ring).  A
    matrix of RING_MIN_ROWS x D rows or more stays this rank's shard and
    the part rings (``ring`` is the mesh); a smaller one is gathered whole
    with its bias (``ring`` None)."""
    if rings(mat.shape[0] * world_rank(mesh)[0], mesh):
        return mat, bias, mesh
    return (gather_rows(mat, mesh),
            None if bias is None else gather_rows(bias, mesh), None)
