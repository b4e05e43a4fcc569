"""cmfrec_torch's coordinate-descent solver against cmfrec_tpu's.

rowsolve.solve_cd (the CPU path, the float64 path's reference and the CD
kernel's twin) against cmfrec_tpu.ops.rowsolve.solve_cd on the same G and
rhs, against scipy's NNLS, and its early stop against all ``max_steps``;
the op's wrapper on the CPU; the fits that take it (``nonneg``,
``nonneg_C``, ``nonneg_D``, ``l1_lambda``) through the drivers of both
packages from one ``init=``; and the warm and cold serving of carried
models with these options.  The kernel itself is held against the twin on
the card in tests/test_torch_kernels_gpu.py.

Tolerances, relative to max|cmfrec_tpu| (the largest reading over the
cases at these sizes in brackets): solve_cd float64 1e-12 (4.9e-16),
float32 1e-5 (3.9e-7); the fits float64 1e-8 (2.6e-14), float32 1e-4
(1.2e-5: ALS carries the roundings of one half-step into the next);
serving float64 1e-8 (7.1e-16), float32 2e-5 (3.4e-7).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import cmfrec_tpu
from cmfrec_torch.convert import cmf_from_arrays
from cmfrec_torch.models.cmf import CMF, CMF_implicit
from cmfrec_torch.ops import coord_descent, rowsolve, sparse_cg
from cmfrec_torch.solvers import collective, drivers
from cmfrec_tpu.ops import rowsolve as jrowsolve
from cmfrec_tpu.solvers import collective as jcollective
from cmfrec_tpu.solvers import drivers as jdrivers

CD_TOL = {np.float64: 1e-12, np.float32: 1e-5}
FIT_TOL = {np.float64: 1e-8, np.float32: 1e-4}
SERVE_TOL = {np.float64: 1e-8, np.float32: 2e-5}
DTYPES = [pytest.param(np.float64, id="f64"),
          pytest.param(np.float32, id="f32")]


def _rel(port, ref):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return float(np.abs(port.astype(np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-300))


# --------------------------------------------------------------------- #
# (a) the solver                                                         #
# --------------------------------------------------------------------- #


def _system(R=24, K=7, seed=0, bad_diag=False):
    """R positive definite K x K systems of ridge form (f64), with l1 of
    both shapes; with ``bad_diag`` row 0's coordinate 1 has a zero
    diagonal (and no coupling), which safe_diag replaces by 1."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(R, 2 * K, K))
    G = np.einsum("rlk,rlm->rkm", M, M) + 0.3 * np.eye(K)
    rhs = 2.0 * rng.normal(size=(R, K))
    if bad_diag:
        G[0, 1, :] = G[0, :, 1] = 0.0
    l1 = {"K": rng.uniform(0.1, 1.0, K),
          "RK": rng.uniform(0.1, 1.0, (R, K)),
          None: np.zeros(K)}
    return G, rhs, l1


SOLVER_CASES = {
    "nonneg": dict(nonneg=True, l1=None),
    "l1_K": dict(nonneg=False, l1="K"),
    "l1_RK": dict(nonneg=False, l1="RK"),
    "nonneg_l1": dict(nonneg=True, l1="RK"),
    "diag_le_0": dict(nonneg=True, l1="K", bad_diag=True),
}


@pytest.mark.parametrize("max_steps", [3, 300], ids=["truncated",
                                                    "converged"])
@pytest.mark.parametrize("case", list(SOLVER_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_solve_cd_matches_jax(dtype, case, max_steps):
    cfg = SOLVER_CASES[case]
    G, rhs, l1 = _system(bad_diag=cfg.get("bad_diag", False))
    l1 = l1[cfg["l1"]]
    want = np.asarray(jrowsolve.solve_cd(
        jnp.asarray(G.astype(dtype)), jnp.asarray(rhs.astype(dtype)),
        jnp.asarray(l1.astype(dtype)), nonneg=cfg["nonneg"],
        max_steps=max_steps))
    got, sweeps = rowsolve.solve_cd(
        torch.as_tensor(G.astype(dtype)), torch.as_tensor(rhs.astype(dtype)),
        torch.as_tensor(l1.astype(dtype)), cfg["nonneg"], max_steps,
        return_sweeps=True)
    assert got.dtype == torch_dtype(dtype)
    assert _rel(got, want) <= CD_TOL[dtype]
    if cfg["nonneg"]:
        assert float(got.min()) >= 0.0
    else:
        assert float(got.min()) < 0.0 < float(got.max())
    assert int(sweeps.max()) == max_steps if max_steps == 3 else \
        int(sweeps.max()) <= max_steps


def torch_dtype(dtype):
    return torch.float64 if np.dtype(dtype) == np.float64 else torch.float32


def test_nonneg_matches_scipy_nnls():
    """float64 nonneg CD without l1 is NNLS on the normal equations:
    min ||L^T a - L^-1 rhs|| subject to a >= 0, G = L L^T (as
    tests/test_rowsolve.py holds the JAX solver)."""
    from scipy.optimize import nnls

    G, rhs, _ = _system(R=8, K=6, seed=3)
    got = rowsolve.solve_cd(torch.as_tensor(G), torch.as_tensor(rhs),
                            torch.zeros(6, dtype=torch.float64), True,
                            1000).numpy()
    assert (got == 0).any() and (got > 0).any()  # the constraint binds
    for r in range(G.shape[0]):
        Lr = np.linalg.cholesky(G[r])
        want, _ = nnls(Lr.T, np.linalg.solve(Lr, rhs[r]))
        np.testing.assert_allclose(got[r], want, rtol=0, atol=1e-8)


@pytest.mark.parametrize("dtype", DTYPES)
def test_early_stop_is_bitwise_all_steps(dtype):
    """Leaving the loop once every row is done gives the bits of running
    every sweep (done rows are frozen), whatever sweep each row stops at."""
    G, rhs, l1 = _system(R=40, K=6, seed=4)
    args = (torch.as_tensor(G.astype(dtype)),
            torch.as_tensor(rhs.astype(dtype)),
            torch.as_tensor(l1["RK"].astype(dtype)), False, 400)
    early, sweeps = rowsolve.solve_cd(*args, return_sweeps=True)
    full = rowsolve.solve_cd(*args, stop_early=False)
    if dtype == np.float64:  # f64 rows converge, at different sweeps
        assert int(sweeps.max()) < 400
        assert int(sweeps.min()) < int(sweeps.max())
    assert torch.equal(early, full)


def test_wrapper_runs_the_twin_on_the_cpu():
    """On CPU tensors the op is rowsolve.solve_cd (no launch counted); a G
    shared by every row (row stride 0) gives the expanded copy's result."""
    G, rhs, l1 = _system(R=10, K=5, seed=5)
    Gt, rt = torch.as_tensor(G), torch.as_tensor(rhs)
    lt = torch.as_tensor(l1["K"])
    before = coord_descent.solve_cd.launches
    got = coord_descent.solve_cd(Gt, rt, lt, nonneg=True, max_steps=50)
    assert coord_descent.solve_cd.launches == before
    assert torch.equal(got, rowsolve.solve_cd(Gt, rt, lt, True, 50))
    shared = Gt[0].expand(10, 5, 5)
    assert shared.stride(0) == 0
    assert torch.equal(
        coord_descent.solve_cd(shared, rt, lt, nonneg=False, max_steps=50),
        rowsolve.solve_cd(shared.contiguous(), rt, lt, False, 50))


@pytest.mark.parametrize("bad", ["dtype", "mixed", "shape", "l1_shape",
                                 "strides", "rhs_layout", "steps", "device"])
def test_wrapper_raises_on_what_it_does_not_take(bad):
    G, rhs = (torch.as_tensor(a) for a in _system(R=4, K=3)[:2])
    l1 = torch.full((3,), 0.1, dtype=torch.float64)
    kw = dict(nonneg=True, max_steps=5)
    args = {
        "dtype": (G.half(), rhs.half(), l1.half()),
        "mixed": (G.float(), rhs, l1),
        "shape": (G[:, :2, :], rhs, l1),
        "l1_shape": (G, rhs, l1[:2]),
        "strides": (G.transpose(1, 2), rhs, l1),
        "rhs_layout": (G, rhs.T.contiguous().T, l1),
        "steps": (G, rhs, l1),
        "device": (G.to("meta"), rhs.to("meta"), l1.to("meta")),
    }[bad]
    if bad == "steps":
        kw["max_steps"] = -1
    with pytest.raises(ValueError, match="solve_cd"):
        coord_descent.solve_cd(*args, **kw)


# --------------------------------------------------------------------- #
# (b) the fits, from one init=                                           #
# --------------------------------------------------------------------- #

M, N, K = 60, 40, 4


def _data(seed=2, mean=3.0):
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, M * N, 700))
    rows, cols = pairs // N, pairs % N
    vals = np.round(2 * (mean + rng.normal(size=rows.size))) / 2
    init = {"A": np.abs(0.3 * rng.normal(size=(M, K))),
            "B": np.abs(0.3 * rng.normal(size=(N, K))),
            "biasA": 0.1 * rng.normal(size=M),
            "biasB": 0.1 * rng.normal(size=N)}
    return rng, rows, cols, vals, init


class _Spy:
    """Counts the CD op's calls and K3's (which no CD fit may reach)."""

    def __init__(self, mp):
        self.cd = self.k3 = 0
        real_cd, real_k3 = coord_descent.solve_cd, sparse_cg.bucket_cg

        def cd(*a, **kw):
            self.cd += 1
            return real_cd(*a, **kw)

        def k3(*a, **kw):
            self.k3 += 1
            return real_k3(*a, **kw)

        mp.setattr(coord_descent, "solve_cd", cd)
        mp.setattr(sparse_cg, "bucket_cg", k3)


EXPLICIT = {
    # a negative mean: the clamp at 0 applies; both biases: 15 clipped
    # passes of the bias init
    "nonneg": dict(nonneg=True, mean=-0.4),
    "nonneg_weighted": dict(nonneg=True, weights=True, center=False),
    "l1": dict(l1_lambda=0.3),
    "l1_scale_lam": dict(l1_lambda=0.02, scale_lam=True),
    "l1_nonneg_no_bias": dict(l1_lambda=[0, 0, 0.2, 0.1, 0, 0], nonneg=True,
                              user_bias=False, item_bias=False),
}


@pytest.mark.parametrize("case", list(EXPLICIT))
@pytest.mark.parametrize("dtype", DTYPES)
def test_explicit_fit_matches_jax(dtype, case, monkeypatch):
    kw = dict(EXPLICIT[case])
    rng, rows, cols, vals, init = _data(mean=kw.pop("mean", 3.0))
    if kw.pop("weights", False):
        kw["weights"] = rng.uniform(0.5, 2.0, rows.size)
    common = dict(k=K, lambda_=1.5, niter=3, seed=3, init=init, dtype=dtype,
                  **kw)
    rj = jdrivers.fit_explicit_als(rows, cols, vals, M, N, **common)
    spy = _Spy(monkeypatch)
    rt = drivers.fit_explicit_als(rows, cols, vals, M, N, device="cpu",
                                  **common)
    assert spy.cd > 0 and spy.k3 == 0
    assert rt["glob_mean"] == pytest.approx(rj["glob_mean"], abs=1e-15)
    if case == "nonneg":
        assert rt["glob_mean"] == 0.0  # clamped
    for key in ("A", "B", "biasA", "biasB"):
        if rj[key] is None:
            assert rt[key] is None
            continue
        assert rt[key].dtype == torch_dtype(dtype), key
        assert _rel(rt[key], rj[key]) <= FIT_TOL[dtype], key
        if kw.get("nonneg"):
            assert float(rt[key].min()) >= 0.0, key
    if "l1" in case and not kw.get("nonneg"):
        assert float((rt["A"] == 0).float().mean()) > 0.0


IMPLICIT = {
    "nonneg": dict(nonneg=True),
    "l1": dict(l1_lambda=0.5),
    "nonneg_l1_log": dict(nonneg=True, l1_lambda=0.2, apply_log_transf=True,
                          adjust_weight=True),
}


@pytest.mark.parametrize("case", list(IMPLICIT))
@pytest.mark.parametrize("dtype", DTYPES)
def test_implicit_fit_matches_jax(dtype, case, monkeypatch):
    rng, rows, cols, _, init = _data()
    vals = rng.uniform(1, 10, rows.size)
    common = dict(k=K, lambda_=0.9, alpha=2.0, niter=3, seed=3, dtype=dtype,
                  init={key: init[key] for key in "AB"}, **IMPLICIT[case])
    rj = jdrivers.fit_implicit_als(rows, cols, vals, M, N, **common)
    spy = _Spy(monkeypatch)
    rt = drivers.fit_implicit_als(rows, cols, vals, M, N, device="cpu",
                                  **common)
    assert spy.cd > 0 and spy.k3 == 0
    for key in ("A", "B"):
        assert rt[key].dtype == torch_dtype(dtype), key
        assert _rel(rt[key], rj[key]) <= FIT_TOL[dtype], key
        if common.get("nonneg"):
            assert float(rt[key].min()) >= 0.0, key


def _side_data(seed=12, m=90, n=60, p=4, q=3):
    rng = np.random.default_rng(seed)
    rows, cols = np.nonzero(rng.uniform(size=(m, n)) < 0.25)
    vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
    U = rng.normal(size=(m, p))
    Id = rng.normal(size=(n, q))
    Us = sp.random(m, p, density=0.5, random_state=1).tocoo()
    Is = sp.random(n, q, density=0.6, random_state=2).tocoo()
    return rows, cols, vals, m, n, {"dense": U, "sparse": Us}, \
        {"dense": Id, "sparse": Is}


def _side(S, n_ent):
    if isinstance(S, np.ndarray):
        return (None, None, None, n_ent, S.shape[1], True, S)
    return (S.row, S.col, S.data, n_ent, S.shape[1], False, None)


COLLECTIVE = {
    # dense U and I: the C and D updates are _dense_full_solve's CD branch,
    # one G shared by every side column
    "dense-U-I": dict(U="dense", I="dense", nonneg=True, nonneg_C=True,
                      nonneg_D=True, center=False),
    "dense-U-l1-scaled": dict(U="dense", l1_lambda=[0, 0, .05, .05, .1, 0],
                              nonneg_C=True, scale_lam=True),
    "sparse-U-I": dict(U="sparse", I="sparse", nonneg_C=True, nonneg_D=True),
    "sparse-U-na0-l1": dict(U="sparse", NA_as_zero_user=True,
                            l1_lambda=0.1, nonneg_D=True, I="sparse"),
    "implicit-features-nonneg": dict(add_implicit_features=True,
                                     nonneg=True, center=False),
    "implicit-dense-U": dict(U="dense", nonneg=True, nonneg_C=True,
                             implicit=True),
    "implicit-sparse-I": dict(I="sparse", nonneg_D=True, l1_lambda=0.2,
                              implicit=True),
}


def _full_init(m, n, p, q, kw):
    rng = np.random.default_rng(0)
    k = 3
    shapes = dict(A=(m, k), B=(n, k))
    if kw.get("U"):
        shapes["C"] = (p, k)
    if kw.get("I"):
        shapes["D"] = (q, k)
    if not kw.get("implicit"):
        shapes.update(biasA=(m,), biasB=(n,))
        if kw.get("add_implicit_features"):
            shapes.update(Ai=(m, k), Bi=(n, k))
    return {key: np.abs(0.3 * rng.normal(size=s))
            for key, s in shapes.items()}


@pytest.mark.parametrize("case", list(COLLECTIVE))
@pytest.mark.parametrize("dtype", DTYPES)
def test_collective_fit_matches_jax(dtype, case, monkeypatch):
    """The bucketed collective route from one init= with every key: the
    constrained halves by CD (C and D under nonneg_C / nonneg_D, dense and
    sparse side info, explicit and implicit), the others by CG or
    Cholesky."""
    kw = dict(COLLECTIVE[case])
    rows, cols, vals, m, n, Us, Is = _side_data()
    implicit = kw.pop("implicit", False)
    init = _full_init(m, n, 4, 3, dict(COLLECTIVE[case]))
    for key, S, dim in (("U", Us, m), ("I", Is, n)):
        if key in kw:
            kw["side_" + key] = _side(S[kw.pop(key)], dim)
    common = dict(k=3, niter=3, lambda_=1.0, init=init, dtype=dtype, **kw)
    if implicit:
        vals = np.abs(vals) + 1.0
        fj = jcollective.fit_collective_implicit_als
        ft = collective.fit_collective_implicit_als
    else:
        fj = jcollective.fit_collective_explicit_als
        ft = collective.fit_collective_explicit_als
    rj = fj(rows, cols, vals, m, n, **common)
    spy = _Spy(monkeypatch)
    rt = ft(rows, cols, vals, m, n, device="cpu", **common)
    assert spy.cd > 0
    for key in init:
        assert rt[key].dtype == torch_dtype(dtype), key
        assert _rel(rt[key], rj[key]) <= FIT_TOL[dtype], key
    for flag, key in (("nonneg", "A"), ("nonneg", "B"), ("nonneg_C", "C"),
                      ("nonneg_D", "D")):
        if kw.get(flag):
            assert float(rt[key].min()) >= 0.0, key


@pytest.mark.parametrize("kw", [dict(nonneg=True), dict(l1_lambda=0.1)],
                         ids=["nonneg", "l1_lambda"])
@pytest.mark.parametrize("implicit", [False, True])
def test_engine_dense_raises_the_jax_message(implicit, kw):
    _, rows, cols, vals, _ = _data()
    port = drivers.fit_implicit_als if implicit else drivers.fit_explicit_als
    common = dict(k=K, niter=1, engine="dense", **kw)
    with pytest.raises(ValueError) as got:
        port(rows, cols, np.abs(vals) + 1, M, N, device="cpu", **common)
    assert str(got.value) == drivers.DENSE_CD_MESSAGE
    if not implicit:  # cmfrec_tpu's implicit fit takes no engine=
        with pytest.raises(ValueError) as want:
            jdrivers.fit_explicit_als(rows, cols, vals, M, N, **common)
        assert str(got.value) == str(want.value)


# --------------------------------------------------------------------- #
# (c) serving carried models                                             #
# --------------------------------------------------------------------- #

P = 5
SERVING = {
    "nonneg": dict(nonneg=True, center=False),
    "l1": dict(l1_lambda=0.15),
    "l1_scale_lam": dict(l1_lambda=0.02, scale_lam=True),
    "implicit_nonneg": dict(nonneg=True, implicit=True),
    "implicit_l1": dict(l1_lambda=0.3, implicit=True),
}


def _carried(case, dtype, seed=0):
    """(cmfrec_tpu model, port model) holding the same f32-representable
    arrays, with side info (C_), so that cold factors exist."""
    cfg = dict(SERVING[case])
    implicit = cfg.pop("implicit", False)
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=0.5):
        a = scale * rng.normal(size=shape)
        if cfg.get("nonneg"):
            a = np.abs(a)
        return a.astype(np.float32).astype(np.float64)

    use_float = dtype == np.float32
    cls = cmfrec_tpu.CMF_implicit if implicit else cmfrec_tpu.CMF
    jm = cls(k=K, lambda_=[0.7, 0.8, 1.5, 1.2, 0.9, 1.1],
             use_float=use_float, **cfg)
    jm._reset()
    jm.dtype_ = np.dtype(dtype)
    arrays = dict(A=f32(M, K), B=f32(N, K), C=f32(P, K, scale=0.4),
                  U_colmeans=rng.normal(size=P))
    if not implicit:
        arrays.update(user_bias=f32(M, scale=0.3),
                      item_bias=f32(N, scale=0.3), glob_mean=3.25)
    for key in ("A", "B", "C", "user_bias", "item_bias"):
        if key in arrays:
            setattr(jm, key + "_", arrays[key].astype(dtype))
    jm.U_colmeans_ = arrays["U_colmeans"]
    if implicit:
        jm.w_main_multiplier_ = 0.75
        arrays["w_main_multiplier"] = 0.75
    else:
        jm.glob_mean_ = arrays["glob_mean"]
    jm.is_fitted_ = True
    jm.force_precompute_for_predictions()
    tm = cmf_from_arrays(**arrays, params=jm.get_params(),
                         cls=CMF_implicit if implicit else CMF,
                         device="cpu")
    tm.force_precompute_for_predictions()
    assert tm.dtype_ == np.dtype(dtype)
    return jm, tm, implicit


@pytest.mark.parametrize("case", list(SERVING))
@pytest.mark.parametrize("dtype", DTYPES)
def test_serving_matches_jax(dtype, case):
    """factors_warm, factors_multiple, topN_warm and factors_cold of a
    carried model with nonneg or l1_lambda: every one a CD solve
    (``_cache_stats`` counts them), none a cached closed form."""
    jm, tm, implicit = _carried(case, dtype)
    rng = np.random.default_rng(7)
    Xn = sp.random(20, N, density=0.2, random_state=3, format="coo")
    Xn.data = (1.0 + rng.uniform(0, 4, Xn.nnz)).round(1)
    Unew = rng.normal(size=(6, P))
    X_col, X_val = Xn.col[Xn.row == 0], Xn.data[Xn.row == 0]
    tol = SERVE_TOL[dtype]
    assert _rel(tm.factors_warm(X_col=X_col, X_val=X_val),
                jm.factors_warm(X_col=X_col, X_val=X_val)) <= tol
    assert _rel(tm.factors_multiple(X=Xn), jm.factors_multiple(X=Xn)) <= tol
    assert _rel(tm.factors_cold(U=Unew[0]), jm.factors_cold(U=Unew[0])) <= tol
    np.testing.assert_array_equal(
        tm.topN_warm(n=5, X_col=X_col, X_val=X_val),
        jm.topN_warm(n=5, X_col=X_col, X_val=X_val))
    stats = tm._cache_stats
    assert stats.get("warm_cd_implicit" if implicit else "warm_cd", 0) == 4
    for key in ("warm_fused", "warm_fused_implicit", "cold_matmul", "bechol",
                "warm_dense_matmul"):
        assert key not in stats, key
    if tm.nonneg:
        assert tm.factors_multiple(X=Xn).min() >= 0.0
