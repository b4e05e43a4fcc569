"""The cases of tests/test_torch_ring.py: the big-axis ring
(``shard_opposing_rows=True``, cmfrec_torch/parallel/ring.py), the port's
counterpart of tests/test_multidevice.py:282-548.

The data (:func:`ring_problem`) is a 133 x 96 matrix of rank 4 whose
rows fall in three degree buckets (one of 5 real rows and 3 padding rows,
so at 3 ranks two ranks hold only padding rows of it) and whose columns
fall in two: few bucket shapes keep cmfrec_tpu's compile time, most of
the file's, small.

Each case is ``case(pkg, mesh)`` as in tests/mesh_cases.py: through
cmfrec_torch on the CPU (``pkg="port"``; with a mesh the ring, without one
the port's meshless fit of the same call), through cmfrec_tpu meshless
(``pkg="jax"``) or, for the explicit Cholesky fit, through cmfrec_tpu's own
ring on a 2-device mesh (``pkg="jax_ring"``), from the same numpy inputs
and init= factors.  Like mesh_cases it imports neither JAX nor cmfrec_tpu
at import time: the ranks import it and run only the port.
"""

from __future__ import annotations

import numpy as np

from .mesh_cases import _init, _np


def ring_problem():
    """(rows, cols, vals, m, n): users 0-95 rate a band of 24 items, users
    96-127 one of 40, users 128-132 one of 8 (circulant bands, so items
    have 37 or 38 ratings); values of a rank-4 product plus N(0, 0.1^2)."""
    rng = np.random.default_rng(1234)
    m, n, k_true = 133, 96, 4
    spans = [(u, 24) if u < 96 else (3 * u, 40) if u < 128 else (7 * u, 8)
             for u in range(m)]
    rows = np.concatenate([np.full(w, u) for u, (_, w) in enumerate(spans)])
    cols = np.concatenate([(s + np.arange(w)) % n for s, w in spans])
    A = rng.normal(size=(m, k_true))
    B = rng.normal(size=(n, k_true))
    vals = (A @ B.T)[rows, cols] + 0.1 * rng.normal(size=rows.size)
    return rows, cols, vals, m, n


def _fit_kw(pkg, mesh):
    if pkg == "port":
        return dict(device="cpu", mesh=mesh,
                    shard_opposing_rows=mesh is not None)
    if pkg == "jax_ring":
        from cmfrec_tpu.parallel.mesh import make_mesh

        return dict(mesh=make_mesh(2), shard_opposing_rows=True)
    return {}


def _drivers(pkg):
    if pkg == "port":
        from cmfrec_torch.solvers import drivers
    else:
        from cmfrec_tpu.solvers import drivers
    return drivers


def _collective(pkg):
    if pkg == "port":
        from cmfrec_torch.solvers import collective
    else:
        from cmfrec_tpu.solvers import collective
    return collective


# --------------------------------------------------------------------- #
# the ring itself (tests/test_multidevice.py:282-343, :450-471)          #
# --------------------------------------------------------------------- #


def ring_halfstep(pkg, mesh):
    """One explicit A half-step by Cholesky from numpy factors (:282-312),
    under a mesh against an opposing matrix row-sharded by
    shard_opposing(shard_rows=True): a contiguous share of each rank is
    the matrix's ring order, so the slots' column ids index it as they
    are."""
    rows, cols, vals, m, n = ring_problem()
    k, k_pad = 6, 8
    rng = np.random.default_rng(0)
    A0 = np.zeros((m, k_pad), np.float32)
    A0[:, :k] = rng.normal(size=(m, k)) / np.sqrt(k)
    B0 = (0.1 * rng.normal(size=(n, k_pad))).astype(np.float32)
    ext = np.concatenate([A0, np.zeros((1, k_pad), np.float32)])
    if pkg == "port":
        import torch

        from cmfrec_torch.data.device_fill import build_bucketed_pair
        from cmfrec_torch.parallel.mesh import (
            gather_blocks, local_blocks, mesh_row_block, shard_bucketed,
            shard_opposing)
        from cmfrec_torch.solvers.als import (SidePlan, blocks_to_orig,
                                              update_side)

        RB, _ = build_bucketed_pair(rows, cols, vals, m, n, device="cpu",
                                    row_block=mesh_row_block(mesh))
        blocks = [torch.from_numpy(ext[RB.row_of[b.start:b.start + b.n_rows]])
                  for b in RB.buckets]
        perm = torch.as_tensor(RB.perm)
        share = shard_bucketed(RB, mesh)
        B = torch.from_numpy(B0)
        if mesh is None:
            out = update_side(SidePlan(share, "explicit", n), blocks, B,
                              None, torch.ones(k_pad), method="chol")
        else:
            out = gather_blocks(update_side(
                SidePlan(share, "explicit", n),
                local_blocks(blocks, share, mesh),
                shard_opposing(B, mesh, True), None, torch.ones(k_pad),
                method="chol", ring_mesh=mesh), mesh)
        return {"A": blocks_to_orig(out, perm).numpy()}
    import jax.numpy as jnp

    from cmfrec_tpu.data.shards import build_bucketed_rows
    from cmfrec_tpu.solvers.als import SidePlan, blocks_to_orig, update_side

    RB = build_bucketed_rows(rows, cols, vals, m, n, dtype=np.float32,
                             row_block=8)
    blocks = [jnp.asarray(ext[RB.row_of[b.start:b.start + b.n_rows]])
              for b in RB.buckets]
    out = update_side(SidePlan(RB, "explicit", n), blocks, jnp.asarray(B0),
                      None, jnp.ones(k_pad, jnp.float32), method="chol",
                      dtype=np.float32)
    return {"A": np.asarray(blocks_to_orig(out, jnp.asarray(RB.perm), m))}


def ring_system(pkg, mesh):
    """ring_part_system against the assembly of the whole matrix (:315-343):
    S = 100 rows padded to the mesh, R = 48 rows of 16 slots, 4 of them
    padding."""
    rng = np.random.default_rng(1234)
    S, K, R, L = 100, 12, 48, 16
    mat = rng.standard_normal((S, K)).astype(np.float32)
    idx = rng.integers(0, S, (R, L)).astype(np.int32)
    cw = rng.random((R, L)).astype(np.float32)
    cv = rng.standard_normal((R, L)).astype(np.float32)
    cw[:, 12:] = 0
    cv[:, 12:] = 0
    if pkg == "port":
        import torch

        from cmfrec_torch.ops.rowsolve import SparsePart, assemble_system
        from cmfrec_torch.parallel.mesh import (
            gather_rows, row_share, shard_opposing)
        from cmfrec_torch.parallel.ring import ShardSlots, ring_part_system

        t = [torch.from_numpy(a) for a in (mat, idx, cw, cv)]
        if mesh is None:
            G, rhs = assemble_system([SparsePart(*t)], torch.zeros(K))
        else:
            rows_ = row_share(R, mesh)
            shard = shard_opposing(t[0], mesh, True)
            G, rhs = ring_part_system(
                shard, ShardSlots(t[1][rows_], None, shard.shape[0], mesh),
                *(a[rows_] for a in t[2:]))
            G, rhs = gather_rows(G, mesh), gather_rows(rhs, mesh)
        return {"G": G.numpy(), "rhs": rhs.numpy()}
    import jax.numpy as jnp

    from cmfrec_tpu.parallel.mesh import make_mesh
    from cmfrec_tpu.parallel.ring import (pad_rows_to, ring_part_system,
                                          shard_rows)

    jmesh = make_mesh(2)
    G, rhs = ring_part_system(
        shard_rows(pad_rows_to(jnp.asarray(mat), 2), jmesh),
        *(shard_rows(jnp.asarray(a), jmesh) for a in (idx, cw, cv)),
        mesh=jmesh)
    return {"G": np.asarray(G), "rhs": np.asarray(rhs)}


# --------------------------------------------------------------------- #
# the classic drivers (:346-447)                                         #
# --------------------------------------------------------------------- #


def _explicit(pkg, mesh, *, k, seed, init_seed, dtype=np.float32, **kw):
    rows, cols, vals, m, n = ring_problem()
    init = _init(init_seed, dtype, A=(m, k), B=(n, k), biasA=(m,),
                 biasB=(n,))
    if kw.get("nonneg"):
        vals = np.abs(vals)
        init = {key: np.abs(v) for key, v in init.items()}
    res = _drivers(pkg).fit_explicit_als(
        rows, cols, vals, m, n, k=k, use_cg=False, seed=seed, init=init,
        dtype=dtype, engine="sparse", **kw, **_fit_kw(pkg, mesh))
    return _np(res, ("A", "B", "biasA", "biasB"))


def explicit(pkg, mesh):
    """The explicit fit by Cholesky, biases included (:346-366)."""
    return _explicit(pkg, mesh, k=5, lambda_=0.7, niter=4, seed=3,
                     init_seed=11)


def explicit_na0(pkg, mesh):
    """NA_as_zero: the G0 and r0 bases summed over the shards (:369-387)."""
    return _explicit(pkg, mesh, k=4, lambda_=1.5, niter=2, seed=3,
                     init_seed=31, NA_as_zero=True)


def explicit_nonneg(pkg, mesh):
    """nonneg: coordinate descent on the ring-assembled systems."""
    return _explicit(pkg, mesh, k=4, lambda_=1.5, niter=2, seed=3,
                     init_seed=32, nonneg=True)


def explicit_f64(pkg, mesh):
    """float64: the ring accumulates in float64 (:390-404)."""
    return _explicit(pkg, mesh, k=4, lambda_=0.9, niter=2, seed=7,
                     init_seed=33, dtype=np.float64)


def implicit(pkg, mesh):
    """fit_implicit_als: the B^T B base summed over the shards
    (:407-420)."""
    rows, cols, vals, m, n = ring_problem()
    init = _init(34, A=(m, 5), B=(n, 5))
    res = _drivers(pkg).fit_implicit_als(
        rows, cols, np.maximum(1.0, np.abs(vals) * 4), m, n, k=5,
        lambda_=1.0, niter=3, use_cg=False, alpha=2.0, seed=5, init=init,
        **_fit_kw(pkg, mesh))
    return _np(res, ("A", "B"))


def never_materializes(pkg, mesh):
    """The explicit fit's iterations with the ranks' collectives recorded
    (:450-471): the rows of every all-gather's output, and every tensor the
    ring sends.  The fit's own arrays too, held like any case."""
    if pkg != "port" or mesh is None:
        return explicit(pkg, mesh)
    import torch.distributed as dist

    from cmfrec_torch.solvers import drivers

    seen = {"gather": [], "send": []}
    inside = [False]
    real = {}

    def wrap(name, kind, shape_of):
        fn = getattr(dist, name, None)
        if fn is None:
            return
        real[name] = fn

        def spy(*a, **kw):
            if inside[0]:
                seen[kind].extend(shape_of(*a, **kw))
            return fn(*a, **kw)

        setattr(dist, name, spy)

    def gathered(out, *a, **kw):
        return [tuple(out.shape)]

    def sent(ops, *a, **kw):
        return [tuple(op.tensor.shape) for op in ops if op.op is dist.isend]

    wrap("all_gather_into_tensor", "gather", gathered)
    wrap("all_gather_single", "gather", gathered)
    wrap("batch_isend_irecv", "send", sent)
    it = drivers._explicit_sparse_iteration

    def iteration(*a, **kw):
        inside[0] = True
        try:
            return it(*a, **kw)
        finally:
            inside[0] = False

    drivers._explicit_sparse_iteration = iteration
    try:
        out = explicit(pkg, mesh)
    finally:
        drivers._explicit_sparse_iteration = it
        for name, fn in real.items():
            setattr(dist, name, fn)
    out["gather_rows"] = np.asarray([s[0] for s in seen["gather"]], np.int64)
    out["send_shapes"] = np.asarray([s + (0,) * (2 - len(s))
                                     for s in seen["send"]],
                                    np.int64).reshape(-1, 2)
    return out


def checkpoint(pkg, mesh):
    """The explicit fit's mid-fit checkpoints (every iteration of 3): under
    the ring every rank gathers the state and rank 0 writes the file; the
    second iteration's file loaded back on every rank."""
    import os
    import shutil
    import tempfile

    rows, cols, vals, m, n = ring_problem()
    init = _init(41, A=(m, 4), B=(n, 4), biasA=(m,), biasB=(n,))
    if pkg == "port":
        from cmfrec_torch.utils.checkpoint import load_fit_checkpoint
    else:
        from cmfrec_tpu.utils.checkpoint import load_fit_checkpoint
    box = [tempfile.mkdtemp() if mesh is None or mesh.get_local_rank() == 0
           else None]
    if mesh is not None:
        import torch.distributed as dist

        dist.broadcast_object_list(box, src=0, group=mesh.get_group())
    path = os.path.join(box[0], "ckpt.npz")
    _drivers(pkg).fit_explicit_als(
        rows, cols, vals, m, n, k=4, lambda_=0.9, niter=3, use_cg=False,
        seed=3, init=init, engine="sparse", checkpoint_path=path,
        checkpoint_every=1, **_fit_kw(pkg, mesh))
    saved, done = load_fit_checkpoint(path)
    if mesh is not None:
        dist.barrier(group=mesh.get_group())
    if box[0] and (mesh is None or mesh.get_local_rank() == 0):
        shutil.rmtree(box[0])
    return {"done": np.asarray(done),
            **{key: np.asarray(v) for key, v in saved.items()}}


# --------------------------------------------------------------------- #
# the collective drivers (:478-548)                                      #
# --------------------------------------------------------------------- #


def _side_sparse(rng, n_ent, p, density=0.5):
    mask = rng.uniform(size=(n_ent, p)) < density
    r, c = np.nonzero(mask)
    return (r, c, rng.normal(size=r.size), n_ent, p, False, None)


def collective_explicit(pkg, mesh):
    """Sparse side info, biases (:478-495); here with 20 side-only users
    (m_u > m), whose X-row masks follow the ring order."""
    rows, cols, vals, m, n = ring_problem()
    rng = np.random.default_rng(35)
    init = _init(36, A=(m + 20, 5), B=(n, 5), C=(6, 5), biasA=(m + 20,),
                 biasB=(n,))
    res = _collective(pkg).fit_collective_explicit_als(
        rows, cols, vals, m, n, side_U=_side_sparse(rng, m + 20, 6),
        k=5, lambda_=0.8, w_user=0.6, niter=3, use_cg=False, seed=3,
        init=init, **_fit_kw(pkg, mesh))
    return _np(res, ("A", "B", "C", "biasA", "biasB"))


def collective_dense_ifeat(pkg, mesh):
    """Dense side info (the whole-matrix C solve from the shards' sums) and
    implicit features (the Ai / Bi half-steps on the ring) (:498-519);
    init= with C, Ai and Bi keeps both packages' meshless fits on their
    bucketed routes."""
    rows, cols, vals, m, n = ring_problem()
    U = np.random.default_rng(37).normal(size=(m, 5))
    U = (U - U.mean(0)).astype(np.float32)
    init = _init(38, A=(m, 4), B=(n, 4), C=(5, 4), Ai=(m, 4), Bi=(n, 4))
    res = _collective(pkg).fit_collective_explicit_als(
        rows, cols, vals, m, n, side_U=(None, None, None, m, 5, True, U),
        k=4, lambda_=0.9, w_user=0.7, niter=3, use_cg=False,
        user_bias=False, item_bias=False, seed=5, center_U=False,
        add_implicit_features=True, w_implicit=0.5, init=init,
        **_fit_kw(pkg, mesh))
    return _np(res, ("A", "B", "C", "Ai", "Bi"))


def collective_implicit(pkg, mesh):
    """The collective implicit fit with sparse side info (:522-536), the
    items' side info under NA_as_zero_item: D's 16 rows (9 features
    padded) ring at two ranks, C's 8 (6 features) are gathered whole."""
    rows, cols, vals, m, n = ring_problem()
    rng = np.random.default_rng(39)
    init = _init(40, A=(m, 5), B=(n, 5), C=(6, 5), D=(9, 5))
    res = _collective(pkg).fit_collective_implicit_als(
        rows, cols, np.maximum(1.0, np.abs(vals) * 4), m, n,
        side_U=_side_sparse(rng, m, 6), side_I=_side_sparse(rng, n, 9),
        NA_as_zero_item=True, k=5, lambda_=1.2, alpha=2.0, niter=3,
        use_cg=False, seed=5, init=init, **_fit_kw(pkg, mesh))
    return _np(res, ("A", "B", "C", "D"))


CASES = {fn.__name__: fn for fn in (
    ring_halfstep, ring_system, explicit, explicit_na0, explicit_nonneg,
    explicit_f64, implicit, never_materializes, checkpoint,
    collective_explicit, collective_dense_ifeat, collective_implicit)}
