"""Data-parallel fitting over a 1-D ``DeviceMesh``
(port of cmfrec_tpu/parallel/mesh.py, the data-parallel mode).

The JAX package has one controller: it places arrays on a ``Mesh`` and XLA
inserts the collectives.  The port is SPMD, one process a card
(``torchrun``, or ``init_distributed`` with an address), NCCL between
cards and gloo between CPU processes:

  * every rank calls the same fit with the same inputs and builds the same
    host plan: bucket layout, permutations, padding, and the starting
    factors, drawn whole from the seed and then sliced, so that the start
    does not depend on the world size;
  * each rank builds, keeps and solves only its own share of the rows of
    every row-sharded array (the bucketed layouts, the dense forms, the
    side information's slices): equal contiguous shares of each bucket's
    rows, or of the dense form's padded rows (:func:`row_share`).  It
    uploads only the entries of those rows and fills only its slices
    (data/device_fill.py:build_bucketed_pair_share, solvers/
    dense_masked.py), so that no rank's card holds the whole data;
  * after each half-step :func:`gather_rows` (one all-gather) makes the
    newly solved factors whole on every rank: the all-gather XLA inserts
    for the replicated opposing matrix.  Gram bases (B^T B, C^T C and the
    like) are formed from those whole matrices on every rank, so no
    cross-rank sum enters the ALS row solves;
  * where the JAX package sums over the mesh (the L-BFGS objective and its
    gradient, the dense engine's bias start) the port sums with
    :func:`reduce_sum`;
  * every rank returns the whole model, the same bits on every rank.

Every host decision of a fit reads an all-reduced value or one computed
from replicated tensors: CG's all-frozen exit in exact mode
(:func:`any_rank`), the L-BFGS line search's branches, the dense-engine
budget (:func:`reduce_min`).  A rank that branched differently would
leave the others waiting in a collective, so every group is made with a
finite ``timeout`` and a hang ends in an error.

A mesh of one rank runs the same slicing and collectives as a mesh of
four; only ``mesh=None`` skips them.  Only rank 0 writes a checkpoint
(utils/checkpoint.py), the others wait at a barrier.

The big-axis mode (``shard_opposing_rows=True``) keeps the opposing
matrices row-sharded instead of gathering them after each half-step:
parallel/ring.py.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# bucket row counts are multiples of this without a mesh (data/shards.py)
from ..data.shards import ROW_BLOCK
from ..utils import profiling

MESH_AXIS = "d"
# the collectives' time limit: a rank that raised mid-fit, or ranks that
# branched apart, fail the others' collectives after this long
TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device_type: str = "cuda",
                     timeout: datetime.timedelta = TIMEOUT):
    """Join (or make) the process group and return the 1-D mesh over it
    (cmfrec_tpu/parallel/mesh.py:29-47).

    * ``num_processes > 1``: ``coordinator_address`` (``host:port`` or a
      ``tcp://`` / ``file://`` URL), ``num_processes`` and ``process_id``
      name this process's place in the world;
    * no arguments, under ``torchrun``: its ``RANK``, ``WORLD_SIZE`` and
      ``LOCAL_RANK``;
    * otherwise a world of one on a local store (no network).

    NCCL for ``device_type="cuda"`` (each process on the card of its local
    rank), gloo for ``"cpu"``.  An already initialized group is kept."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed(device_type='cuda'): torch sees "
                           "no CUDA device")
    backend = "nccl" if device_type == "cuda" else "gloo"
    local_rank = 0
    if dist.is_initialized():
        local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    elif num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("num_processes > 1 needs coordinator_address "
                             "and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=int(num_processes),
                                rank=int(process_id), timeout=timeout)
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    return make_mesh(device_type=device_type)


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cuda"):
    """The 1-D ``DeviceMesh`` named ``"d"`` over the initialized world
    (init_distributed); ``n_devices``, where given, must be its size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "init_distributed() on every rank first")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"make_mesh(n_devices={n_devices}): the world has "
                         f"{world} processes, one a device")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(MESH_AXIS,))


def check_mesh(mesh, device) -> None:
    """A fit's ``mesh=``: None, or a 1-D ``DeviceMesh`` whose device type is
    the fit's.  Nothing falls back to the CPU."""
    if mesh is None:
        return
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError("mesh= must be a 1-D torch.distributed DeviceMesh "
                        "(cmfrec_torch.parallel.mesh.make_mesh), got "
                        f"{type(mesh).__name__}")
    dev = torch.device(device)
    if mesh.device_type != dev.type:
        raise ValueError(f"mesh= is a {mesh.device_type!r} DeviceMesh but "
                         f"the fit runs on device={str(device)!r}")


def world_rank(mesh) -> tuple[int, int]:
    """(world size, this rank's place); (1, 0) without a mesh."""
    if mesh is None:
        return 1, 0
    return int(mesh.size()), int(mesh.get_local_rank())


def mesh_row_block(mesh) -> int:
    """Bucket row counts that divide over the mesh: lcm(ROW_BLOCK, world)
    (cmfrec_tpu/solvers/drivers.py:105-113)."""
    return int(np.lcm(ROW_BLOCK, world_rank(mesh)[0]))


def row_share(n_rows: int, mesh) -> slice:
    """This rank's contiguous slice of ``n_rows`` rows, a multiple of the
    world size (the whole without a mesh)."""
    world, rank = world_rank(mesh)
    if n_rows % world:
        raise ValueError(f"row_share: {n_rows} rows do not divide over "
                         f"{world} ranks")
    share = n_rows // world
    return slice(rank * share, (rank + 1) * share)


def even_share(n: int, mesh) -> slice:
    """This rank's contiguous slice of ``n`` items (observations) cut as
    evenly as they go: the first n*r//world to n*(r+1)//world."""
    world, rank = world_rank(mesh)
    return slice(n * rank // world, n * (rank + 1) // world)


def padded_share(n_rows: int, mesh, multiple: int) -> int:
    """Rows a rank holds of ``n_rows`` padded so that every rank's share is
    equal and a multiple of ``multiple`` (``n_rows`` itself, if already a
    multiple, without a mesh or at world size 1)."""
    world, _ = world_rank(mesh)
    share = -(-n_rows // world)
    return -(-share // multiple) * multiple


def _group(mesh):
    return mesh.get_group()


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' equal row shares ``t`` stacked in rank order: one
    all-gather (``t`` itself without a mesh)."""
    if mesh is None:
        return t
    world, _ = world_rank(mesh)
    t = t.contiguous()
    out = torch.empty((world * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, t, group=_group(mesh))
    return out


def reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks, the same bits on every rank: one
    all-reduce (``t`` itself without a mesh)."""
    if mesh is None:
        return t
    t = t.contiguous().clone()
    dist.all_reduce(t, group=_group(mesh))
    return t


def _reduce_scalar(x, mesh, device, op):
    t = torch.tensor([x], dtype=torch.float64 if isinstance(x, float)
                     else torch.int64, device=device)
    dist.all_reduce(t, op=op, group=_group(mesh))
    profiling.synced(t.element_size())
    return t.item()


def any_rank(flag: torch.Tensor, mesh) -> bool:
    """Whether a 0-d bool tensor is True on any rank (a host decision every
    rank takes alike)."""
    if mesh is None:
        return bool(flag)
    return bool(_reduce_scalar(int(bool(flag)), mesh, flag.device,
                               dist.ReduceOp.MAX))


def reduce_min(x: int, mesh, device) -> int:
    """The least of an integer over the ranks (``x`` without a mesh)."""
    if mesh is None:
        return x
    return int(_reduce_scalar(int(x), mesh, device, dist.ReduceOp.MIN))


def barrier(mesh) -> None:
    if mesh is not None:
        dist.barrier(group=_group(mesh))


def is_writer(mesh) -> bool:
    """Whether this rank writes files for the fit (rank 0)."""
    return world_rank(mesh)[1] == 0


def share_plan(bucketed, mesh):
    """This rank's share of a BucketedRows' plan: every bucket cut to its
    contiguous slice of rows (:func:`row_share`), ``start`` and ``n_real``
    moved with it, its tensors None; ``perm``, ``row_of`` and ``counts``
    stay the whole layout's.  Each bucket's row count divides over the
    mesh (:func:`mesh_row_block`)."""
    from ..data.shards import Bucket, BucketedRows

    out = BucketedRows(n_rows=bucketed.n_rows, n_cols=bucketed.n_cols,
                       n_rows_pad=bucketed.n_rows_pad, perm=bucketed.perm,
                       row_of=bucketed.row_of, counts=bucketed.counts,
                       row_block=bucketed.row_block)
    for b in bucketed.buckets:
        sl = row_share(b.n_rows, mesh)
        out.buckets.append(Bucket(
            start=b.start + sl.start, n_rows=sl.stop - sl.start,
            n_real=int(np.clip(b.n_real - sl.start, 0, sl.stop - sl.start)),
            width=b.width, idx=None, val=None, length=None))
    return out


def shard_bucketed(bucketed, mesh):
    """The cut of a whole BucketedRows to this rank's share
    (:func:`share_plan` with each bucket's tensors cut to its rows); the
    whole layout gives up its tensors (cmfrec_tpu/parallel/mesh.py:60-62).
    The fits never build a whole layout under a mesh: each rank builds its
    share from its entries alone (data/device_fill.py:
    build_bucketed_pair_share), which equals this cut bit for bit.  This
    cut serves callers that hold a whole layout (a half-step alone, the
    share build's tests).  The bucketed layout itself without a mesh."""
    if mesh is None:
        return bucketed
    out = share_plan(bucketed, mesh)
    for b, c in zip(bucketed.buckets, out.buckets):
        sl = slice(c.start - b.start, c.start - b.start + c.n_rows)
        c.idx, c.val, c.length, c.wgt = (
            None if t is None else t[sl].clone()
            for t in (b.idx, b.val, b.length, b.wgt))
        b.idx = b.val = b.length = b.wgt = None
    return out


def local_blocks(blocks, bucketed_share, mesh):
    """This rank's rows of whole per-bucket factor blocks (views)."""
    if mesh is None:
        return blocks
    _, rank = world_rank(mesh)
    return [blk[rank * b.n_rows:(rank + 1) * b.n_rows]
            for b, blk in zip(bucketed_share.buckets, blocks)]


def gather_blocks(local, mesh):
    """Whole per-bucket blocks from every rank's solved shares ``local``:
    one all-gather for all the buckets of a side."""
    if mesh is None:
        return local
    world, _ = world_rank(mesh)
    sizes = [blk.shape[0] for blk in local]
    whole = gather_rows(torch.cat(local, 0), mesh)
    whole = whole.view(world, sum(sizes), *local[0].shape[1:])
    out, off = [], 0
    for s in sizes:
        out.append(whole[:, off:off + s].reshape(world * s,
                                                 *local[0].shape[1:]))
        off += s
    return out


def shard_opposing(opp, mesh, shard_rows: bool = False):
    """An opposing factor matrix as a fit holds it
    (cmfrec_tpu/parallel/mesh.py:73-76): whole on every rank, or under
    ``shard_rows`` (the big-axis ring, parallel/ring.py) this rank's
    contiguous share of its rows, zero rows appended to a multiple of the
    world size first.  ``opp`` itself without a mesh."""
    if mesh is None or not shard_rows:
        return opp
    from .ring import pad_rows_to

    opp = pad_rows_to(opp, world_rank(mesh)[0])
    return opp[row_share(opp.shape[0], mesh)].clone()
