"""The cases of the mesh tests (tests/test_torch_mesh*.py) and the runner
that plays them on every rank of a gloo group.

Each case is ``case(pkg, mesh)``: the same call on the same numpy inputs
and init= factors through cmfrec_torch (``pkg="port"``, on the CPU, with
``mesh`` a 1-D DeviceMesh or None) or through cmfrec_tpu (``pkg="jax"``,
meshless), returning a dict of numpy arrays.  This module imports neither
JAX nor cmfrec_tpu at import time: the ranks are spawned processes that
import it and run only the port.

``Group(names, world, tmp)`` spawns ``world`` processes (the ``spawn``
start method) that join one gloo group on a ``file://`` store,
each running every named case with the group's mesh and saving its
results; ``Group.results()`` joins them under a deadline, so a collective
that hangs fails the test instead of the suite.  ``cases`` names the
module whose ``CASES`` the ranks play (tests/ring_cases.py for the ring).
``Refs(batches, tmp, cases)`` computes cmfrec_tpu's results of the named
cases in spawned processes, one a batch, beside the ranks.
"""

from __future__ import annotations

import importlib
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np

# the parent's join deadline from the group's start (each rank imports
# torch, joins the group and runs a file's cases in a few seconds)
JOIN_TIMEOUT = 120
RANK_THREADS = 1


def problem():
    """tests/test_multidevice.py's ``problem`` fixture (rng 1234): a
    128 x 96 rank-4 matrix, 30% observed."""
    rng = np.random.default_rng(1234)
    m, n, k_true = 128, 96, 4
    A = rng.normal(size=(m, k_true))
    B = rng.normal(size=(n, k_true))
    mask = rng.uniform(size=(m, n)) < 0.3
    rows, cols = np.nonzero(mask)
    vals = (A @ B.T)[rows, cols] + 0.1 * rng.normal(size=rows.size)
    return rows, cols, vals, m, n


def _init(seed, dtype=np.float32, **shapes):
    rng = np.random.default_rng(seed)
    return {key: (0.3 * rng.normal(size=shape)).astype(dtype)
            for key, shape in shapes.items()}


def _np(res, keys):
    out = {}
    for key in keys:
        v = res[key]
        if v is None:
            continue
        out[key] = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
    return out


def _port_kw(pkg, mesh):
    return dict(mesh=mesh, device="cpu") if pkg == "port" else {}


# --------------------------------------------------------------------- #
# the bucketed drivers (tests/test_multidevice.py:76-170)                #
# --------------------------------------------------------------------- #


def halfstep(pkg, mesh):
    """One explicit A half-step by Cholesky on the bucketed layout
    (row_block 8) from numpy factors (:45-82)."""
    rows, cols, vals, m, n = problem()
    k, k_pad = 6, 8
    rng = np.random.default_rng(0)
    A0 = np.zeros((m, k_pad), np.float32)
    A0[:, :k] = rng.normal(size=(m, k)) / np.sqrt(k)
    B0 = (0.1 * rng.normal(size=(n, k_pad))).astype(np.float32)
    if pkg == "port":
        import torch

        from cmfrec_torch.data.device_fill import build_bucketed_pair
        from cmfrec_torch.parallel.mesh import mesh_row_block, shard_bucketed
        from cmfrec_torch.solvers.als import SidePlan, blocks_to_orig, update_side

        RB, _ = build_bucketed_pair(rows, cols, vals, m, n, device="cpu",
                                    row_block=mesh_row_block(mesh))
        ext = torch.cat([torch.from_numpy(A0), torch.zeros(1, k_pad)])
        blocks = [ext[torch.as_tensor(RB.row_of[b.start:b.start + b.n_rows])]
                  for b in RB.buckets]
        perm = torch.as_tensor(RB.perm)
        plan = SidePlan(shard_bucketed(RB, mesh), "explicit", n)
        out = update_side(plan, blocks, torch.from_numpy(B0), None,
                          torch.ones(k_pad), method="chol", mesh=mesh)
        return {"A": blocks_to_orig(out, perm).numpy()}
    import jax.numpy as jnp

    from cmfrec_tpu.data.shards import build_bucketed_rows
    from cmfrec_tpu.solvers.als import SidePlan, blocks_to_orig, update_side

    RB = build_bucketed_rows(rows, cols, vals, m, n, dtype=np.float32,
                             row_block=8)
    ext = np.concatenate([A0, np.zeros((1, k_pad), np.float32)])
    blocks = [jnp.asarray(ext[RB.row_of[b.start:b.start + b.n_rows]])
              for b in RB.buckets]
    out = update_side(SidePlan(RB, "explicit", n), blocks, jnp.asarray(B0),
                      None, jnp.ones(k_pad, jnp.float32), method="chol",
                      dtype=np.float32)
    return {"A": np.asarray(blocks_to_orig(out, jnp.asarray(RB.perm), m))}


def _explicit(pkg, mesh, **kw):
    rows, cols, vals, m, n = problem()
    k = kw.pop("k", 5)
    init = _init(11, A=(m, k), B=(n, k), biasA=(m,), biasB=(n,))
    if kw.get("nonneg"):
        init = {key: np.abs(v) for key, v in init.items()}
    if pkg == "port":
        from cmfrec_torch.solvers import drivers
    else:
        from cmfrec_tpu.solvers import drivers
    res = drivers.fit_explicit_als(rows, cols, vals, m, n, k=k, lambda_=0.7,
                                   engine="sparse", seed=3, init=init,
                                   dtype=np.float32, **kw,
                                   **_port_kw(pkg, mesh))
    return _np(res, ("A", "B", "biasA", "biasB"))


def explicit_cholesky(pkg, mesh):
    """fit_explicit_als(engine="sparse") by Cholesky (:85)."""
    return _explicit(pkg, mesh, niter=4, use_cg=False)


def explicit_cg(pkg, mesh):
    """fit_explicit_als(engine="sparse", mesh=) with CG (:105)."""
    return _explicit(pkg, mesh, niter=4)


def explicit_cd(pkg, mesh):
    """nonneg=True: every bucket by coordinate descent."""
    return _explicit(pkg, mesh, niter=3, nonneg=True, center=False)


def explicit_world3(pkg, mesh):
    """A mesh of 3 ranks (:265): bucket rows padded to lcm(8, 3) = 24."""
    return _explicit(pkg, mesh, niter=2, k=4)


def implicit(pkg, mesh):
    """fit_implicit_als(mesh=) (:122)."""
    rows, cols, vals, m, n = problem()
    init = _init(12, A=(m, 5), B=(n, 5))
    if pkg == "port":
        from cmfrec_torch.solvers import drivers
    else:
        from cmfrec_tpu.solvers import drivers
    res = drivers.fit_implicit_als(rows, cols, np.abs(vals) + 1.0, m, n, k=5,
                                   lambda_=1.0, niter=4, seed=3, init=init,
                                   **_port_kw(pkg, mesh))
    return _np(res, ("A", "B"))


def _collective(pkg):
    if pkg == "port":
        from cmfrec_torch.solvers import collective
    else:
        from cmfrec_tpu.solvers import collective
    return collective


def collective_explicit(pkg, mesh):
    """The collective explicit fit with dense side info and k splits, the
    bucketed route (:135)."""
    rows, cols, vals, m, n = problem()
    U = np.random.default_rng(13).normal(size=(m, 7))
    init = _init(14, A=(m, 6), B=(n, 5), C=(7, 5), biasA=(m,), biasB=(n,))
    res = _collective(pkg).fit_collective_explicit_als(
        rows, cols, vals, m, n, side_U=(None, None, None, m, 7, True, U),
        k=4, k_user=1, k_main=1, lambda_=0.8, niter=3, use_cg=True,
        max_cg_steps=3, seed=3, dtype=np.float32, init=init,
        **_port_kw(pkg, mesh))
    return _np(res, ("A", "B", "C", "biasA", "biasB"))


def collective_implicit(pkg, mesh):
    """The collective implicit fit with sparse side info: the aligned parts
    and the feature buckets (:153)."""
    rows, cols, vals, m, n = problem()
    rng = np.random.default_rng(15)
    Ur, Uc, Uv = rng.integers(0, m, 300), rng.integers(0, 6, 300), \
        rng.normal(size=300)
    init = _init(16, A=(m, 4), B=(n, 4), C=(6, 4))
    res = _collective(pkg).fit_collective_implicit_als(
        rows, cols, np.abs(vals) + 1.0, m, n,
        side_U=(Ur, Uc, Uv, m, 6, False, None), k=4, lambda_=1.0, niter=3,
        seed=3, dtype=np.float32, init=init, **_port_kw(pkg, mesh))
    return _np(res, ("A", "B", "C"))


def topn(pkg, mesh):
    """topn_sharded against the plain ranking (:172), at 1,024 items and
    at 1,021 (padding over the ranks)."""
    rng = np.random.default_rng(17)
    n, k = 1024, 16
    B = rng.normal(size=(n, k)).astype(np.float32)
    a = rng.normal(size=k).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    out = {}
    for size in (n, n - 3):
        if pkg == "port":
            import torch

            from cmfrec_torch.parallel.topn import topn_sharded

            idx, s = topn_sharded(torch.from_numpy(a),
                                  torch.from_numpy(B[:size]), 10,
                                  torch.from_numpy(bias[:size]), mesh)
            idx, s = idx.numpy(), s.numpy()
        else:
            s_all = B[:size].astype(np.float64) @ a + bias[:size]
            idx = np.argsort(-s_all, kind="stable")[:10]
            s = s_all[idx]
        out[f"idx{size}"], out[f"scores{size}"] = idx, s
    return out


# --------------------------------------------------------------------- #
# the dense engine, the models, L-BFGS and offsets (:189-612)            #
# --------------------------------------------------------------------- #


def _dense_data(density=0.5):
    """tests/test_multidevice.py:194-200 (rng 1234), on a half-point grid
    (exact in the engine's bf16 X)."""
    rng = np.random.default_rng(1234)
    m, n, k = 96, 64, 4
    A0 = rng.normal(size=(m, k))
    B0 = rng.normal(size=(n, k))
    mask = rng.uniform(size=(m, n)) < density
    ro, co = np.nonzero(mask)
    vals = np.round(2 * ((A0 @ B0.T)[ro, co] + 3.0
                         + 0.05 * rng.normal(size=ro.size))) / 2
    init = _init(18, A=(m, k), B=(n, k), biasA=(m,), biasB=(n,))
    return ro, co, vals, m, n, k, init


def _dense(pkg, mesh, density=0.5, **kw):
    ro, co, vals, m, n, k, init = _dense_data(density)
    common = dict(weights=None, k=k, lam6=np.full(6, 0.5), max_cg_steps=3,
                  finalize_chol=True, finalize_steps=16, user_bias=True,
                  item_bias=True, glob_mean=float(vals.mean()),
                  scale_lam=False, scale_bias_const=False, seed=3,
                  verbose=False, **kw)
    if pkg == "port":
        from cmfrec_torch.convert import init_from_arrays
        from cmfrec_torch.solvers.dense_masked import (
            fit_explicit_dense_masked)

        res = fit_explicit_dense_masked(ro, co, vals, m, n, device="cpu",
                                        init=init_from_arrays(init, "cpu"),
                                        mesh=mesh, **common)
    else:
        from cmfrec_tpu.solvers.dense_pallas import fit_explicit_dense_pallas

        res = fit_explicit_dense_pallas(ro, co, vals, m, n, biasA0=None,
                                        biasB0=None, dtype=np.float32,
                                        interpret=True, init=init, **common)
    out = _np(res, ("A", "B", "biasA", "biasB"))
    out["pred"] = (out["A"][ro] * out["B"][co]).sum(1)
    return out


def dense_plain(pkg, mesh):
    """The dense-masked engine, a bf16 bulk iteration and the f32 polish
    (:189).  Two iterations, not :189's six: the two packages' bf16
    roundings of T*W flip apart and grow over the bulk iterations
    (tests/test_torch_dense_fit.py), to 7.8e-3 of the predictions at six
    and 1.3e-4 at two."""
    return _dense(pkg, mesh, niter=2)


def dense_exact(pkg, mesh):
    """Exact mode: the all-frozen exit taken over every rank (:215)."""
    return _dense(pkg, mesh, niter=4, exact=True)


def dense_rows(pkg, mesh):
    """dense_plain's fit on 8% of the cells, where the f32 polish's K1
    walks each rank's row lists of W and WT (masked_matmul.takes_rows)."""
    return _dense(pkg, mesh, density=0.08, niter=2)


def _patched_init(driver_mod, name, init):
    """``driver_mod.<name>`` handing ``init`` to every call (the models fit
    through their drivers' module attributes)."""
    fn = getattr(driver_mod, name)

    def wrapped(*a, **kw):
        kw["init"] = init
        return fn(*a, **kw)

    return fn, wrapped


def models(pkg, mesh):
    """CMF.fit(X, mesh=) and CMF_implicit.fit(X, mesh=) (:244), each from
    one init= handed to its driver.  On the CPU the port's CMF takes the
    dense-masked engine and cmfrec_tpu's its bucketed one, so CMF runs in
    exact mode (use_cg=False: both solve to the f32 fixed point, where bf16
    and f32 CG iterates part by 1e-2 in three iterations) on ratings of a
    half-point grid (exact in the dense engine's bf16 X)."""
    import scipy.sparse as sp

    rows, cols, vals, m, n = problem()
    vals = np.round(2 * vals) / 2
    if pkg == "port":
        import cmfrec_torch as lib
        from cmfrec_torch.solvers import drivers
        extra = dict(device="cpu")
        fit_kw = dict(mesh=mesh)
    else:
        import cmfrec_tpu as lib
        from cmfrec_tpu.solvers import drivers
        extra, fit_kw = {}, {}
    out = {}
    for name, cls, v, init, kw in (
            ("cmf", "CMF", vals,
             _init(19, A=(m, 4), B=(n, 4), biasA=(m,), biasB=(n,)),
             dict(lambda_=0.7, use_float=True, use_cg=False)),
            ("implicit", "CMF_implicit", np.abs(vals) + 1.0,
             _init(20, A=(m, 4), B=(n, 4)), dict(lambda_=1.0))):
        fn_name = "fit_explicit_als" if name == "cmf" else "fit_implicit_als"
        real, wrapped = _patched_init(drivers, fn_name, init)
        setattr(drivers, fn_name, wrapped)
        try:
            model = getattr(lib, cls)(k=4, niter=3, **kw, **extra).fit(
                sp.coo_matrix((v, (rows, cols)), shape=(m, n)), **fit_kw)
        finally:
            setattr(drivers, fn_name, real)
        out[f"{name}_A"], out[f"{name}_B"] = model.A_, model.B_
        if name == "cmf":
            out["cmf_pred"] = model.predict(rows, cols)
    return out


def omf_models(pkg, mesh):
    """OMF_explicit (L-BFGS, float64), OMF_implicit (ALS, exact mode) and
    ContentBased (L-BFGS, float64) through fit(..., mesh=), each from one
    init handed to its offsets solver (as tests/test_torch_omf.py does)."""
    import scipy.sparse as sp

    rows, cols, vals, m, n = problem()
    rng = np.random.default_rng(27)
    U, I = rng.normal(size=(m, 5)), rng.normal(size=(n, 4))
    X = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    plays = sp.coo_matrix((np.abs(vals) + 1.0, (rows, cols)), shape=(m, n))
    if pkg == "port":
        import cmfrec_torch as lib
        from cmfrec_torch.solvers import offsets
        extra, fit_kw = dict(device="cpu"), dict(mesh=mesh)
    else:
        import cmfrec_tpu as lib
        from cmfrec_tpu.solvers import offsets
        extra, fit_kw = {}, {}
    lbfgs_init = _init(28, np.float64, A=(m, 3), B=(n, 3), C=(5, 3),
                       D=(4, 3), C_bias=(3,), D_bias=(3,))
    content_init = {key: v for key, v in lbfgs_init.items()
                    if key not in ("A", "B")}
    out = {}
    for name, cls, kw, data, side, solver, key, init, attrs in (
            ("omf", "OMF_explicit", dict(k=3, lambda_=1.5, maxiter=25,
                                         use_float=False), X,
             dict(U=U, I=I), "fit_offsets_explicit_lbfgs", "init_params",
             lbfgs_init, ("A_", "B_", "C_", "D_", "Am_")),
            ("omf_implicit", "OMF_implicit",
             dict(k=3, lambda_=2.0, alpha=2.0, niter=2, use_cg=False,
                  use_float=True), plays, dict(U=U), "fit_offsets_als",
             "init", _init(29, A=(m, 3), B=(n, 3)), ("Am_", "C_")),
            ("content", "ContentBased",
             dict(k=3, lambda_=5.0, maxiter=25, use_float=False,
                  start_with_ALS=False), X, dict(U=U, I=I),
             "fit_offsets_explicit_lbfgs", "init_params", content_init,
             ("C_", "D_"))):
        real = getattr(offsets, solver)
        setattr(offsets, solver,
                lambda *a, _r=real, _k=key, _i=init, **k: _r(*a, **{**k,
                                                                    _k: _i}))
        try:
            model = getattr(lib, cls)(**kw, **extra).fit(data, **side,
                                                         **fit_kw)
        finally:
            setattr(offsets, solver, real)
        for attr in attrs:
            out[f"{name}_{attr}"] = np.asarray(getattr(model, attr))
    return out


def lbfgs(pkg, mesh):
    """The collective L-BFGS fit with dense, sparse and binary side info in
    float64 (:550)."""
    rows, cols, vals, m, n = problem()
    rng = np.random.default_rng(21)
    U = rng.normal(size=(m, 7))
    Ub = (rng.uniform(size=(m, 3)) < 0.5).astype(np.float64)
    Ir, Ic, Iv = rng.integers(0, n, 200), rng.integers(0, 4, 200), \
        rng.normal(size=200)
    init = _init(22, np.float64, A=(m, 6), B=(n, 5), C=(7, 5), D=(4, 4),
                 Cb=(3, 5), biasA=(m,), biasB=(n,))
    if pkg == "port":
        from cmfrec_torch.solvers.lbfgs import fit_collective_explicit_lbfgs
    else:
        from cmfrec_tpu.solvers.lbfgs import fit_collective_explicit_lbfgs
    res = fit_collective_explicit_lbfgs(
        rows, cols, vals, m, n, side_U=(None, None, None, m, 7, True, U),
        side_I=(Ir, Ic, Iv, n, 4, False, None),
        side_Ub=(None, None, None, m, 3, True, Ub), k=4, k_user=1, k_main=1,
        lambda_=0.8, w_user=0.9, maxiter=25, corr_pairs=4, dtype=np.float64,
        seed=3, init=init, **_port_kw(pkg, mesh))
    return _np(res, ("A", "B", "C", "D", "Cb", "biasA", "biasB"))


def offsets_lbfgs(pkg, mesh):
    """The exact offsets fit at k = 128 in float64 (:578)."""
    rows, cols, vals, m, n = problem()
    rng = np.random.default_rng(23)
    U, I = rng.normal(size=(m, 6)), rng.normal(size=(n, 5))
    init = _init(24, np.float64, A=(m, 129), B=(n, 129), C=(6, 130),
                 D=(5, 130), C_bias=(130,), D_bias=(130,), biasA=(m,),
                 biasB=(n,))
    if pkg == "port":
        from cmfrec_torch.solvers.offsets import fit_offsets_explicit_lbfgs
    else:
        from cmfrec_tpu.solvers.offsets import fit_offsets_explicit_lbfgs
    res = fit_offsets_explicit_lbfgs(
        rows, cols, vals, m, n, side_U=(None, None, None, m, 6, True, U),
        side_I=(None, None, None, n, 5, True, I), k=128, k_sec=2, k_main=1,
        lambda_=1.0, w_user=0.8, maxiter=25, corr_pairs=5, dtype=np.float64,
        seed=3, init_params=init, **_port_kw(pkg, mesh))
    return _np(res, ("A", "B", "C", "D", "C_bias", "Am", "Bm", "biasA"))


def offsets_als(pkg, mesh):
    """fit_offsets_als(mesh=) passes to the ALS fit (:600), in exact mode
    on half-point ratings for the reasons models() gives."""
    rows, cols, vals, m, n = problem()
    vals = np.round(2 * vals) / 2
    U = np.random.default_rng(25).normal(size=(m, 6))
    init = _init(26, A=(m, 5), B=(n, 5), biasA=(m,), biasB=(n,))
    if pkg == "port":
        from cmfrec_torch.solvers.offsets import fit_offsets_als
    else:
        from cmfrec_tpu.solvers.offsets import fit_offsets_als
    res = fit_offsets_als(rows, cols, vals, m, n,
                          side_U=(None, None, None, m, 6, True, U), k=5,
                          lambda_=0.9, niter=3, use_cg=False, seed=3,
                          dtype=np.float32, init=init, **_port_kw(pkg, mesh))
    return _np(res, ("Am", "C", "A"))


# --------------------------------------------------------------------- #
# each rank's share of the bucketed layouts (data/device_fill.py)        #
# --------------------------------------------------------------------- #


def layout_problem():
    """60 x 40 with one row of 35 entries beside ~6 a row and one column of
    20 beside ~8 a column, duplicate (row, col) pairs among them: at 2 and
    3 ranks some bucket's share holds only padding rows."""
    rng = np.random.default_rng(19)
    m, n = 60, 40
    rows = np.concatenate([rng.integers(0, m, 300), np.full(35, 3),
                           rng.integers(0, m, 20)])
    cols = np.concatenate([rng.integers(0, n, 300), rng.integers(0, n, 35),
                           np.full(20, 7)])
    return (rows, cols, rng.normal(size=rows.size),
            rng.uniform(0.5, 2.0, size=rows.size), m, n)


def _plan_arrays(tag, b):
    """A BucketedRows' plan: perm, row_of, counts, each bucket's (start,
    rows, real rows, width)."""
    return {f"{tag}__perm": b.perm, f"{tag}__row_of": b.row_of,
            f"{tag}__counts": b.counts,
            f"{tag}__buckets": np.array(
                [(c.start, c.n_rows, c.n_real, c.width) for c in b.buckets],
                np.int64).reshape(-1, 4)}


def _tensors(tag, b):
    """Plan and tensors of a (share of a) BucketedRows."""
    out = _plan_arrays(tag, b)
    for i, c in enumerate(b.buckets):
        for f in ("idx", "val", "length", "wgt"):
            t = getattr(c, f)
            if t is not None:
                out[f"{tag}__{i}__{f}"] = t.numpy()
    return out


def _builds():
    """The share builds' arguments: (tag, weights, m_eff extra, n_eff
    extra), unweighted and weighted, with and without side-info-only
    entities."""
    return (("u", False, 0, 0), ("w", True, 0, 0), ("u_eff", False, 5, 3),
            ("w_eff", True, 5, 3))


def layout_pair(pkg, mesh):
    """build_bucketed_pair_share against shard_bucketed of the whole
    build_bucketed_pair (``share__*`` against ``cut__*``), both sides, and
    its plans against the whole build's (``plan__*``, ``whole__*``)."""
    from cmfrec_torch.data.device_fill import (build_bucketed_pair,
                                               build_bucketed_pair_share)
    from cmfrec_torch.parallel.mesh import mesh_row_block, shard_bucketed

    rows, cols, vals, wgt, m, n = layout_problem()
    out = {}
    for tag, weighted, dm, dn in _builds():
        kw = dict(device="cpu", m_eff=m + dm, n_eff=n + dn)
        w = wgt if weighted else None
        plans, shares = build_bucketed_pair_share(rows, cols, vals, m, n, w,
                                                  mesh=mesh, **kw)
        whole = build_bucketed_pair(rows, cols, vals, m, n, w,
                                    row_block=mesh_row_block(mesh), **kw)
        for side, plan, share, lay in zip("AB", plans, shares, whole):
            out.update(_plan_arrays(f"plan__{tag}{side}", plan))
            out.update(_plan_arrays(f"whole__{tag}{side}", lay))
            out.update(_tensors(f"share__{tag}{side}", share))
            out.update(_tensors(f"cut__{tag}{side}",
                                shard_bucketed(lay, mesh)))
    return out


def layout_rows(pkg, mesh):
    """build_bucketed_rows_share (the feature side of sparse side
    information) against shard_bucketed of build_bucketed_rows."""
    from cmfrec_torch.data.device_fill import (build_bucketed_rows,
                                               build_bucketed_rows_share)
    from cmfrec_torch.parallel.mesh import mesh_row_block, shard_bucketed

    rows, cols, vals, _, m, n = layout_problem()
    plan, share = build_bucketed_rows_share(cols, rows, vals, n, m + 5,
                                            device="cpu", mesh=mesh)
    whole = build_bucketed_rows(cols, rows, vals, n, m + 5, device="cpu",
                                row_block=mesh_row_block(mesh))
    return {**_plan_arrays("plan__F", plan), **_plan_arrays("whole__F", whole),
            **_tensors("share__F", share),
            **_tensors("cut__F", shard_bucketed(whole, mesh))}


def _main_plan(mesh):
    from cmfrec_torch.data.device_fill import build_bucketed_pair_share

    rows, cols, vals, _, m, n = layout_problem()
    (RB, _), _ = build_bucketed_pair_share(rows, cols, vals, m, n,
                                           device="cpu", mesh=mesh,
                                           m_eff=m + 5)
    return RB


def _cut_blocks(plan, blocks, mesh):
    """Each bucket's tensors cut to this rank's rows of it."""
    from cmfrec_torch.parallel.mesh import row_share

    out = []
    for b, blk in zip(plan.buckets, blocks):
        sl = row_share(b.n_rows, mesh)
        out.append(tuple(t[sl] for t in blk) if isinstance(blk, tuple)
                   else (blk[sl],))
    return out


def _block_arrays(tag, blocks):
    return {f"{tag}__{i}__{j}": t.numpy() for i, blk in enumerate(blocks)
            for j, t in enumerate(blk if isinstance(blk, tuple) else (blk,))}


def layout_aligned(pkg, mesh):
    """collective.build_aligned_parts of a sparse side matrix (65 entities,
    side-only ones among them) on this rank's rows against the cut of the
    whole build."""
    from cmfrec_torch.solvers.collective import build_aligned_parts

    RB = _main_plan(mesh)
    rng = np.random.default_rng(20)
    r_s = rng.integers(0, 65, 200)
    c_s = rng.integers(0, 9, 200)
    v_s = rng.normal(size=200)
    share = build_aligned_parts(RB, r_s, c_s, v_s, 65, "cpu", mesh=mesh)
    whole = build_aligned_parts(RB, r_s, c_s, v_s, 65, "cpu")
    return {**_block_arrays("share__S", share),
            **_block_arrays("cut__S", _cut_blocks(RB, whole, mesh))}


def layout_dense(pkg, mesh):
    """collective._bucket_dense_slices of a dense side matrix of fewer rows
    than the bucketing (rows past it zero) on this rank's rows against the
    cut of the whole build."""
    from cmfrec_torch.solvers.collective import _bucket_dense_slices

    RB = _main_plan(mesh)
    M = np.random.default_rng(21).normal(size=(58, 4)).astype(np.float32)
    return {**_block_arrays("share__D",
                            _bucket_dense_slices(RB, M, "cpu", mesh)),
            **_block_arrays("cut__D", _cut_blocks(
                RB, _bucket_dense_slices(RB, M, "cpu"), mesh))}


def layout_uploads(pkg, mesh):
    """The entries build_bucketed_pair_share uploads to this rank, counted
    by wrapping device_fill._upload (``uploads``: each upload's length),
    beside the nnz of the rank's share of each side (``share_nnz``: the sum
    of its rows' lengths)."""
    from cmfrec_torch.data import device_fill

    rows, cols, vals, wgt, m, n = layout_problem()
    sizes = []
    real = device_fill._upload

    def counted(a, dt, dev):
        sizes.append(np.asarray(a).size)
        return real(a, dt, dev)

    device_fill._upload = counted
    try:
        _, shares = device_fill.build_bucketed_pair_share(
            rows, cols, vals, m, n, wgt, device="cpu", mesh=mesh)
    finally:
        device_fill._upload = real
    return {"uploads": np.asarray(sizes, np.int64),
            "share_nnz": np.asarray([sum(int(b.length.sum())
                                         for b in s.buckets)
                                     for s in shares], np.int64),
            "nnz": np.asarray(rows.size)}


LAYOUT = ["layout_pair", "layout_rows", "layout_aligned", "layout_dense",
          "layout_uploads"]

CASES = {fn.__name__: fn for fn in (
    halfstep, explicit_cholesky, explicit_cg, explicit_cd, explicit_world3,
    implicit, collective_explicit, collective_implicit, topn, dense_plain,
    dense_exact, dense_rows, models, omf_models, lbfgs, offsets_lbfgs, offsets_als,
    layout_pair, layout_rows, layout_aligned, layout_dense, layout_uploads)}


# --------------------------------------------------------------------- #
# the checks the test files share                                        #
# --------------------------------------------------------------------- #


def assert_ranks_agree(ranks):
    """(i) every rank's arrays are rank 0's, bit for bit."""
    r0, *rest = ranks
    for r in rest:
        assert r.keys() == r0.keys()
        for key in r0:
            np.testing.assert_array_equal(r[key], r0[key], err_msg=key)


def assert_meshless(got, want, summed=False):
    """(ii) a mesh fit against the meshless one: bitwise, or with
    ``summed`` (an L-BFGS fit, whose objective adds the ranks' parts)
    within 1e-10 of each array's max|.|."""
    assert got.keys() == want.keys()
    for key in want:
        if summed:
            np.testing.assert_allclose(
                got[key], want[key], rtol=0,
                atol=1e-10 * float(np.abs(want[key]).max()), err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def assert_close_to(got, want, tol):
    """(iii) a mesh fit against cmfrec_tpu's: ``tol`` maps a key (None:
    every other key) to (rtol, atol), or to None to skip it; ids are
    compared exactly."""
    for key in want:
        t = tol.get(key, tol.get(None))
        if key.startswith("idx"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        elif t is not None:
            np.testing.assert_allclose(got[key], want[key], rtol=t[0],
                                       atol=t[1], err_msg=key)


def _same_bits(got, want, key):
    assert got.dtype == want.dtype and got.shape == want.shape, key
    assert got.tobytes() == want.tobytes(), key


def assert_share_is_cut(res):
    """A layout case on one rank: every ``share__*`` array is its
    ``cut__*`` twin and every ``plan__*`` its ``whole__*`` twin, bit for
    bit and key for key; an ``uploads`` case uploaded each side's own,
    values and weights of its share's entries alone."""
    if "uploads" in res:
        n_a, n_b = (int(x) for x in res["share_nnz"])
        want = [n_a] * 4 + [n_b] * 4  # ids, other ids, values, weights
        assert res["uploads"].tolist() == want
        return
    pairs = (("share__", "cut__"), ("plan__", "whole__"))
    for mine, twin in pairs:
        keys = {k[len(mine):] for k in res if k.startswith(mine)}
        assert keys == {k[len(twin):] for k in res if k.startswith(twin)}
        for k in keys:
            _same_bits(res[mine + k], res[twin + k], mine + k)
    assert all(k.startswith(("share__", "cut__", "plan__", "whole__"))
               for k in res)


def assert_layout_group(ranks, name):
    """A layout case on every rank of a group: each rank's share is the cut
    of the whole build (:func:`assert_share_is_cut`), the ranks' shares of
    each side's entries add up to all of them, and the last rank's share
    of some bucket holds only padding rows (every rank enters every
    ring, parallel/ring.py)."""
    for res in ranks:
        assert_share_is_cut(res)
    if name == "layout_uploads":
        nnz = int(ranks[0]["nnz"])
        assert sum(r["share_nnz"] for r in ranks).tolist() == [nnz, nnz]
        assert all((r["share_nnz"] < nnz).all() for r in ranks)
    if name == "layout_pair":
        last = ranks[-1]
        assert any((last[f"share__{tag}{side}__buckets"][:, 2] == 0).any()
                   for tag, *_ in _builds() for side in "AB")


class Meshless(dict):
    """Each case's meshless port result, computed once a module."""

    def __missing__(self, name):
        self[name] = CASES[name]("port", None)
        return self[name]


# --------------------------------------------------------------------- #
# the ranks                                                              #
# --------------------------------------------------------------------- #


def _rank(rank, world, store, names, out_dir, cases):
    """One rank: join the gloo group, run ``names`` of module ``cases``
    with its mesh, save each case's arrays as ``<name>.<rank>.npz``."""
    try:
        import torch

        torch.set_num_threads(RANK_THREADS)
        from cmfrec_torch.parallel.mesh import init_distributed

        table = importlib.import_module(cases).CASES
        mesh = init_distributed(f"file://{store}", world, rank,
                                device_type="cpu")
        for name in names:
            np.savez(Path(out_dir) / f"{name}.{rank}.npz",
                     **table[name]("port", mesh))
        import torch.distributed as dist

        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise SystemExit(1)


def _refs(names, cases, out_dir):
    """One process of ``Refs``: JAX configured as tests/conftest.py does,
    each ``name`` (a case, or ``case:pkg``; pkg "jax" by default) of
    module ``cases`` saved as ``<name>.ref.npz``."""
    try:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
        jax.config.update("jax_enable_x64", True)
        table = importlib.import_module(cases).CASES
        for name in names:
            case, _, pkg = name.partition(":")
            np.savez(Path(out_dir) / f"{name}.ref.npz",
                     **table[case](pkg or "jax", None))
    except BaseException:
        traceback.print_exc()
        raise SystemExit(1)


class _Spawned:
    """Processes started together and joined under JOIN_TIMEOUT."""

    def __init__(self, tmp, targets):
        self.out = Path(tmp) / "out"
        self.out.mkdir(parents=True, exist_ok=True)
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=fn, args=args)
                      for fn, args in targets]
        self.t0 = time.monotonic()
        for p in self.procs:
            p.start()
        self._results = None

    def _join(self, what):
        for p in self.procs:
            p.join(max(0.0, JOIN_TIMEOUT - (time.monotonic() - self.t0)))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        self.close()
        if hung:
            raise AssertionError(f"{what} {hung} of {len(self.procs)} did "
                                 f"not finish within {JOIN_TIMEOUT} s")
        codes = [p.exitcode for p in self.procs]
        if any(codes):
            raise AssertionError(f"{what} exit codes {codes}")

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join()


class Group(_Spawned):
    """A running group of ranks; ``results()`` waits for it."""

    def __init__(self, names, world, tmp, cases=__name__):
        tmp = Path(tmp)
        self.names, self.world = list(names), world
        super().__init__(tmp, [
            (_rank, (r, world, str(tmp / "store"), self.names,
                     str(tmp / "out"), cases)) for r in range(world)])

    def results(self):
        """{case: [each rank's dict of arrays]}; raises if a rank failed
        or the group outlived JOIN_TIMEOUT."""
        if self._results is None:
            self._join("ranks")
            self._results = {
                name: [dict(np.load(self.out / f"{name}.{r}.npz"))
                       for r in range(self.world)]
                for name in self.names}
        return self._results


class Refs(_Spawned):
    """cmfrec_tpu's results of the cases named in ``batches`` (lists of
    ``case`` or ``case:pkg``), one spawned process a batch; ``results()``
    waits for them."""

    def __init__(self, batches, tmp, cases):
        self.names = [name for batch in batches for name in batch]
        super().__init__(tmp, [(_refs, (list(batch), cases,
                                         str(Path(tmp) / "out")))
                               for batch in batches])

    def results(self):
        """{name: dict of arrays}; raises if a process failed or outlived
        JOIN_TIMEOUT."""
        if self._results is None:
            self._join("reference processes")
            self._results = {name: dict(np.load(self.out / f"{name}.ref.npz"))
                             for name in self.names}
        return self._results
