"""cmfrec_torch's float64 and Jacobi-PCG routes, float64 serving and the
carry-over of float64 models, against cmfrec_tpu on the same inputs (JAX
runs with x64 on, tests/conftest.py).  Both packages start every fit from
one init= (jax.random and torch draw different numbers).

Tolerances, as max|port - cmfrec_tpu| / max|cmfrec_tpu| of every factor,
bias and served row:
- float64: 1e-10 (readings 1e-15 .. 1e-13).  The same fits in float32
  differ from float64 by 5e-7 .. 1e-6 (test_float32_differs_from_float64
  holds that gap above 100x the tolerance), so an f64 route that computed
  in f32 anywhere fails;
- float32 with Jacobi PCG: 1e-4 (f32 arithmetic in another order; readings
  ~5e-7 bucketed, ~7e-6 against cmfrec_tpu's dense XLA engine, which the
  tests' x64 promotes to float64).
Each float64 case also asserts the dtype of the blocks the solves ran on,
through spies on the solvers, and that the bucket-CG op (K3's wrapper) and
the dense-masked engine (K1/K2) were not called.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cmfrec_torch
import cmfrec_tpu
from cmfrec_torch.convert import cmf_from_arrays, init_from_arrays
from cmfrec_torch.ops import rowsolve, sparse_cg
from cmfrec_torch.solvers import als, collective, dense_engine, dense_masked
from cmfrec_torch.solvers import drivers
from cmfrec_tpu.solvers import collective as jcollective
from cmfrec_tpu.solvers import dense_engine as jdense_engine
from cmfrec_tpu.solvers import drivers as jdrivers

F64_TOL = 1e-10
F32_TOL = 1e-4
M, N, K = 60, 40, 4


def _rel(port, ref):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(port.astype(np.float64) - ref).max()
                 / np.abs(ref).max())


def _tol(dtype):
    return F64_TOL if np.dtype(dtype) == np.float64 else F32_TOL


def _data(seed=2, m=M, n=N, k=K):
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, m * n, 700))  # ROADMAP F5: no dups
    rows, cols = pairs // n, pairs % n
    vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
    init = {"A": 0.3 * rng.normal(size=(m, k)),
            "B": 0.3 * rng.normal(size=(n, k)),
            "biasA": 0.1 * rng.normal(size=m),
            "biasB": 0.1 * rng.normal(size=n)}
    return rng, rows, cols, vals, init


class _Spy:
    """Records the dtypes the solvers see and the calls of the kernels'
    ops: dense_engine.dense_cg_update (P, X, Be), als.solve_bucket (the
    warm start, the values, the opposing matrix), bucket_cg and the
    dense-masked engine's fits."""

    def __init__(self, mp):
        self.dtypes, self.k3, self.k12 = set(), 0, 0
        real_dense = dense_engine.dense_cg_update
        real_bucket = als.solve_bucket
        real_k3 = sparse_cg.bucket_cg

        def dense(P, X, W, Be, *a, **kw):
            self.dtypes |= {P.dtype, X.dtype, Be.dtype}
            return real_dense(P, X, W, Be, *a, **kw)

        def bucket(parts, a_prev, *a, **kw):
            self.dtypes |= {a_prev.dtype, parts[0].val.dtype,
                            parts[0].opp.dtype}
            return real_bucket(parts, a_prev, *a, **kw)

        def k3(*a, **kw):
            self.k3 += 1
            return real_k3(*a, **kw)

        mp.setattr(dense_engine, "dense_cg_update", dense)
        mp.setattr(als, "solve_bucket", bucket)
        mp.setattr(sparse_cg, "bucket_cg", k3)
        for mod in (drivers, collective):
            for name in ("fit_explicit_dense_masked",
                         "fit_implicit_dense_masked",
                         "fit_collective_dense_masked",
                         "fit_collective_implicit_dense_masked"):
                if hasattr(mod, name):
                    real = getattr(mod, name)
                    mp.setattr(mod, name, self._count_k12(real))

    def _count_k12(self, real):
        def wrapped(*a, **kw):
            self.k12 += 1
            return real(*a, **kw)
        return wrapped

    def check(self, dtype, k3_allowed=False):
        want = torch.float64 if np.dtype(dtype) == np.float64 else \
            torch.float32
        assert self.dtypes == {want}, self.dtypes
        assert self.k12 == 0
        if not k3_allowed:
            assert self.k3 == 0


# --------------------------------------------------------------------- #
# (a) the dense engine                                                   #
# --------------------------------------------------------------------- #


def _dense_problem(dtype, weighted, seed=0):
    rng = np.random.default_rng(seed)
    m, n, Kx = 30, 20, 5
    mask = rng.uniform(size=(m, n)) < 0.3
    mask[3] = False  # a row with no observations solves to zero
    X = np.where(mask, rng.normal(size=(m, n)), 0.0)
    W = mask * (rng.uniform(0.5, 2.0, (m, n)) if weighted else 1.0)
    f = dict(P0=0.3 * rng.normal(size=(m, Kx)),
             P1=0.3 * rng.normal(size=(n, Kx)),
             Be0=rng.normal(size=(n, Kx)), Be1=rng.normal(size=(m, Kx)),
             ob0=0.1 * rng.normal(size=n), ob1=0.1 * rng.normal(size=m),
             lam=np.linspace(0.5, 1.5, Kx), lc=np.eye(Kx)[-1] * 0.7,
             mult0=mask.sum(1).astype(float), mult1=mask.sum(0).astype(float))
    return X, W, mask, {key: v.astype(dtype) for key, v in f.items()}


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["mask", "weights"])
@pytest.mark.parametrize("rows_axis", [0, 1])
@pytest.mark.parametrize("jacobi", [False, True], ids=["cg", "jacobi"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_dense_cg_update_matches_jax(dtype, jacobi, rows_axis, weighted):
    """dense_cg_update against cmfrec_tpu's on one problem: the unweighted
    port holds W as its int8 mask, cmfrec_tpu as a float matrix."""
    import jax.numpy as jnp

    X, W, mask, f = _dense_problem(dtype, weighted)
    r = str(rows_axis)
    args = [f["P" + r], X.astype(dtype), W.astype(dtype), f["Be" + r],
            f["ob" + r], f["lam"], f["mult" + r], f["lc"]]
    want = np.asarray(jdense_engine.dense_cg_update(
        *[jnp.asarray(a) for a in args], n_steps=3, rows_axis=rows_axis,
        jacobi=jacobi))
    targs = [torch.as_tensor(a) for a in args]
    if not weighted:
        targs[2] = torch.as_tensor(mask.astype(np.int8))
    got = dense_engine.dense_cg_update(*targs, n_steps=3,
                                       rows_axis=rows_axis, jacobi=jacobi)
    assert got.dtype == targs[0].dtype
    assert _rel(got, want) <= _tol(dtype)
    if rows_axis == 0:
        assert (got[3] == 0).all()


def test_dense_from_coo_matches_jax():
    _, rows, cols, vals, _ = _data()
    w = np.linspace(0.5, 2.0, rows.size)
    for weights in (None, w):
        X, W = dense_engine.dense_from_coo(rows, cols, vals, M, N, weights,
                                           dtype=torch.float64, device="cpu")
        Xj, Wj = jdense_engine.dense_from_coo(rows, cols, vals, M, N, weights,
                                              np.float64)
        assert X.dtype == torch.float64
        assert W.dtype == (torch.int8 if weights is None else torch.float64)
        np.testing.assert_array_equal(X.numpy(), np.asarray(Xj))
        np.testing.assert_array_equal(W.numpy().astype(np.float64),
                                      np.asarray(Wj, np.float64))


def test_chunked_products_match_one_product(monkeypatch):
    """The masked products formed a few rows at a time equal the one-shot
    product (chunks of 7 rows here)."""
    X, W, mask, f = _dense_problem(np.float64, True)
    full = [dense_engine.dense_cg_update(
        torch.as_tensor(f["P" + r]), torch.as_tensor(X),
        torch.as_tensor(W), torch.as_tensor(f["Be" + r]),
        torch.as_tensor(f["ob" + r]), torch.as_tensor(f["lam"]), None, None,
        3, int(r), jacobi=True) for r in "01"]
    monkeypatch.setattr(dense_engine, "CHUNK_BYTES", 7 * N * 8)
    for r, want in zip("01", full):
        got = dense_engine.dense_cg_update(
            torch.as_tensor(f["P" + r]), torch.as_tensor(X),
            torch.as_tensor(W), torch.as_tensor(f["Be" + r]),
            torch.as_tensor(f["ob" + r]), torch.as_tensor(f["lam"]), None,
            None, 3, int(r), jacobi=True)
        assert _rel(got, want) <= 1e-13


# --------------------------------------------------------------------- #
# (b) the explicit fits                                                  #
# --------------------------------------------------------------------- #

EXPLICIT = {
    "dense-f64": dict(engine="dense", dtype=np.float64),
    "dense-f64-pcg": dict(engine="dense", dtype=np.float64,
                          precondition_cg=True),
    "dense-f64-scaled-weighted": dict(engine="dense", dtype=np.float64,
                                      scale_lam=True, scale_bias_const=True,
                                      weighted=True),
    "dense-f64-no-cg": dict(engine="dense", dtype=np.float64, use_cg=False),
    "dense-f32-pcg": dict(engine="dense", dtype=np.float32,
                          precondition_cg=True),
    "dense-f32-pcg-no-polish": dict(engine="dense", dtype=np.float32,
                                    precondition_cg=True,
                                    finalize_chol=False),
    "sparse-f64": dict(engine="sparse", dtype=np.float64),
    "sparse-f64-chol": dict(engine="sparse", dtype=np.float64, use_cg=False),
    "sparse-f64-pcg": dict(engine="sparse", dtype=np.float64,
                           precondition_cg=True),
    "sparse-f64-na0": dict(engine="sparse", dtype=np.float64,
                           NA_as_zero=True),
    "sparse-f64-na0-weighted": dict(engine="sparse", dtype=np.float64,
                                    NA_as_zero=True, weighted=True),
    "sparse-f32-pcg": dict(engine="sparse", dtype=np.float32,
                           precondition_cg=True),
}


@pytest.mark.parametrize("case", list(EXPLICIT))
def test_explicit_fit_matches_jax(case, monkeypatch):
    """The explicit fits, both engines.  The weights lie on a 1/8 grid: the
    port sums a row's weights (scale_lam's multiplier) in the fit's dtype,
    cmfrec_tpu's dense engine in float32 (ROADMAP F7), and on this grid
    both sums are exact."""
    rng, rows, cols, vals, init = _data()
    kw = dict(EXPLICIT[case])
    if kw.pop("weighted", False):
        kw["weights"] = rng.integers(4, 17, rows.size) / 8.0
    common = dict(k=K, lambda_=0.5, niter=3, seed=3, **kw)
    rj = jdrivers.fit_explicit_als(rows, cols, vals, M, N, init=init,
                                   dense_budget_bytes=1 << 40, **common)
    spy = _Spy(monkeypatch)
    rt = drivers.fit_explicit_als(rows, cols, vals, M, N, device="cpu",
                                  init=init_from_arrays(init, "cpu"),
                                  **common)
    spy.check(kw["dtype"])
    for key in ("A", "B", "biasA", "biasB"):
        assert rt[key].dtype == spy.dtypes.copy().pop(), key
        assert _rel(rt[key], rj[key]) <= _tol(kw["dtype"]), key
    assert rt["glob_mean"] == pytest.approx(rj["glob_mean"])


@pytest.mark.parametrize("budget,engine", [(None, "dense"),
                                           (1000, "bucketed")])
def test_auto_route_follows_the_budget(budget, engine, monkeypatch):
    """engine="auto" in float64 takes the plain dense engine when its dense
    form fits the budget (unbounded on the CPU) and the bucketed engine
    otherwise, as cmfrec_tpu does with the same budget; both agree."""
    _, rows, cols, vals, init = _data()
    common = dict(k=K, lambda_=0.5, niter=2, dtype=np.float64, init=init)
    calls = []
    for name in ("_fit_explicit_dense", "_fit_explicit_bucketed"):
        real = getattr(drivers, name)
        monkeypatch.setattr(drivers, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    monkeypatch.setattr(drivers, "_dense_budget", lambda dev: budget)
    rt = drivers.fit_explicit_als(rows, cols, vals, M, N, device="cpu",
                                  **common)
    assert calls == ["_fit_explicit_" + engine]
    rj = jdrivers.fit_explicit_als(rows, cols, vals, M, N,
                                   dense_budget_bytes=budget or 1 << 40,
                                   **common)
    assert _rel(rt["A"], rj["A"]) <= F64_TOL


def test_float32_differs_from_float64():
    """The gap the float64 tolerance must stay 100x below: the same fits in
    float32 and float64 from one init, on both engines."""
    _, rows, cols, vals, init = _data()
    for engine in ("dense", "sparse"):
        out = [drivers.fit_explicit_als(
            rows, cols, vals, M, N, k=K, lambda_=0.5, niter=3, init=init,
            engine=engine, dtype=dt, device="cpu", precondition_cg=True)
            for dt in (np.float32, np.float64)]
        assert _rel(out[0]["A"], out[1]["A"].numpy()) >= 100 * F64_TOL


def test_engine_dense_rejects_what_it_cannot_fit():
    _, rows, cols, vals, _ = _data()
    with pytest.raises(ValueError, match="no NA_as_zero form"):
        drivers.fit_explicit_als(rows, cols, vals, M, N, k=K, niter=1,
                                 engine="dense", NA_as_zero=True,
                                 dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="takes float32 without"):
        drivers.fit_implicit_als(rows, cols, np.abs(vals), M, N, k=K,
                                 niter=1, engine="dense", dtype=np.float64,
                                 device="cpu")
    # the dense-masked engine's own guard
    for kw in (dict(dtype=np.float64), dict(precondition_cg=True)):
        with pytest.raises(ValueError, match="kernels K1/K2"):
            dense_masked.fit_implicit_dense_masked(
                rows, cols, np.abs(vals), M, N, k=K, lam6=np.ones(6),
                niter=1, max_cg_steps=3, finalize_steps=16,
                finalize_chol=False, alpha=1.0, w_main_multiplier=1.0,
                seed=1, verbose=False, device="cpu", **kw)


# --------------------------------------------------------------------- #
# (c) the implicit fits                                                  #
# --------------------------------------------------------------------- #

IMPLICIT = {
    "f64-cg": dict(dtype=np.float64),
    "f64-chol": dict(dtype=np.float64, use_cg=False),
    "f64-finalize": dict(dtype=np.float64, finalize_chol=True),
    "f64-log-adjust": dict(dtype=np.float64, apply_log_transf=True,
                           adjust_weight=True),
    "f64-pcg": dict(dtype=np.float64, precondition_cg=True),
    "f32-pcg": dict(dtype=np.float32, precondition_cg=True),
}


@pytest.mark.parametrize("case", list(IMPLICIT))
def test_implicit_fit_matches_jax(case, monkeypatch):
    rng, rows, cols, _, init = _data()
    vals = rng.uniform(1, 10, rows.size)
    init = {key: init[key] for key in ("A", "B")}
    kw = IMPLICIT[case]
    common = dict(k=K, lambda_=0.9, alpha=2.0, niter=3, seed=3, init=init,
                  **kw)
    rj = jdrivers.fit_implicit_als(rows, cols, vals, M, N, **common)
    spy = _Spy(monkeypatch)
    rt = drivers.fit_implicit_als(rows, cols, vals, M, N, device="cpu",
                                  **common)
    spy.check(kw["dtype"])
    for key in ("A", "B"):
        assert _rel(rt[key], rj[key]) <= _tol(kw["dtype"]), key


# --------------------------------------------------------------------- #
# (d) the collective fits                                                #
# --------------------------------------------------------------------- #


def _side_data(seed=12, m=90, n=60, p=4, q=3):
    rng = np.random.default_rng(seed)
    rows, cols = np.nonzero(rng.uniform(size=(m, n)) < 0.25)
    vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
    U = rng.normal(size=(m, p))
    Us = sp.random(m, p, density=0.5, random_state=1).tocoo()
    Is = sp.random(n, q, density=0.6, random_state=2).tocoo()
    return rows, cols, vals, m, n, U, Us, Is


def _side(S, n_ent):
    if isinstance(S, np.ndarray):
        return (None, None, None, n_ent, S.shape[1], True, S)
    return (S.row, S.col, S.data, n_ent, S.shape[1], False, None)


# each case in float64; the PCG cases named in F32_PCG also in float32
COLLECTIVE = {
    "dense-U": dict(U="dense"),
    "sparse-U-I": dict(U="sparse", I="sparse"),
    "NA_as_zero_user": dict(U="sparse", NA_as_zero_user=True),
    "implicit-features": dict(add_implicit_features=True),
    "k-splits-scaled": dict(U="dense", I="sparse", k_user=1, k_item=2,
                            k_main=1, scale_lam=True,
                            scale_lam_sideinfo=True),
    "dense-U-pcg": dict(U="dense", precondition_cg=True),
    "implicit-dense-U": dict(U="dense", implicit=True),
    "implicit-sparse-I-na0": dict(I="sparse", NA_as_zero_item=True,
                                  implicit=True),
    "implicit-sparse-U-pcg": dict(U="sparse", precondition_cg=True,
                                  implicit=True),
}
F32_PCG = ("implicit-sparse-U-pcg",)


def _full_init(m, n, p, q, kw):
    """init= for every key of the fit, from a fixed seed."""
    rng = np.random.default_rng(0)
    k, ku, ki, km = 3, kw.get("k_user", 0), kw.get("k_item", 0), \
        kw.get("k_main", 0)
    shapes = dict(A=(m, ku + k + km), B=(n, ki + k + km))
    if kw.get("U"):
        shapes["C"] = (p, ku + k)
    if kw.get("I"):
        shapes["D"] = (q, ki + k)
    if not kw.get("implicit"):
        shapes.update(biasA=(m,), biasB=(n,))
        if kw.get("add_implicit_features"):
            shapes.update(Ai=(m, k + km), Bi=(n, k + km))
    return {key: 0.3 * rng.normal(size=s) for key, s in shapes.items()}


@pytest.mark.parametrize("case,dtype", [
    pytest.param(case, dt, id=f"{case}-{name}")
    for case in COLLECTIVE
    for dt, name in ((np.float64, "f64"), (np.float32, "f32"))
    # float32 without PCG is the dense-masked route, held in
    # tests/test_torch_collective_*.py
    if dt == np.float64 or case in F32_PCG])
def test_collective_fit_matches_jax(case, dtype, monkeypatch):
    """The collective fits on the bucketed route from one init= with every
    key, float64 (and float32 where the case runs Jacobi PCG)."""
    kw = dict(COLLECTIVE[case])
    rows, cols, vals, m, n, U, Us, Is = _side_data()
    init = _full_init(m, n, U.shape[1], Is.shape[1], kw)
    implicit = kw.pop("implicit", False)
    for key, S, dim in (("U", {"dense": U, "sparse": Us}, m),
                        ("I", {"sparse": Is}, n)):
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
    spy.check(dtype)
    for key in init:
        assert rt[key].dtype == spy.dtypes.copy().pop(), key
        assert _rel(rt[key], rj[key]) <= _tol(dtype), key


# --------------------------------------------------------------------- #
# (f) float64 serving (P4) of carried-over float64 models (P5)           #
# --------------------------------------------------------------------- #


def _serving_data(seed=5, m=80, n=50, p=4):
    rng = np.random.default_rng(seed)
    X = sp.random(m, n, density=0.25, random_state=seed, format="coo")
    X.data = np.round(2 * (3 + rng.normal(size=X.nnz))) / 2
    U = rng.normal(size=(m, p))
    return rng, X, U


def _chol_dtypes(mp):
    seen = set()
    real = rowsolve.solve_chol_ex

    def spy(G, rhs):
        seen.add(G.dtype)
        return real(G, rhs)

    mp.setattr(rowsolve, "solve_chol_ex", spy)
    return seen


@pytest.mark.parametrize("carry", ["load", "cmf_from_arrays"])
@pytest.mark.parametrize("cls", ["CMF", "CMF_implicit"])
def test_float64_serving_matches_jax(cls, carry, tmp_path, monkeypatch):
    """A float64 cmfrec_tpu model with side info, carried across by load
    or cmf_from_arrays: float64 arrays and dtype_, and factors_warm,
    factors_multiple, factors_cold and topN_warm in float64 against
    cmfrec_tpu's at 1e-10."""
    rng, X, U = _serving_data()
    Xf = X if cls == "CMF" else sp.coo_matrix(
        (np.abs(X.data) + 1.0, (X.row, X.col)), shape=X.shape)
    jm = getattr(cmfrec_tpu, cls)(k=3, niter=2, lambda_=2.0,
                                  use_float=False).fit(Xf, U=U)
    if carry == "load":
        path = str(tmp_path / "m.npz")
        jm.save(path)
        tm = getattr(cmfrec_torch, cls).load(path, device="cpu")
    else:
        tm = cmf_from_arrays(
            A=jm.A_, B=jm.B_, user_bias=jm.user_bias_,
            item_bias=jm.item_bias_, glob_mean=jm.glob_mean_, C=jm.C_,
            U_colmeans=jm.U_colmeans_, params=jm.get_params(),
            w_main_multiplier=getattr(jm, "w_main_multiplier_", 1.0),
            cls=getattr(cmfrec_torch, cls), device="cpu")
    assert tm.dtype_ == np.float64
    assert all(np.asarray(getattr(tm, a)).dtype == np.float64
               for a in ("A_", "B_", "C_"))
    tm.force_precompute_for_predictions()
    seen = _chol_dtypes(monkeypatch)
    cols, xv = np.array([1, 4, 7, 9]), np.array([3.5, 1.0, 4.5, 2.0])
    u = U[0]
    pairs = [(tm.factors_warm(X_col=cols, X_val=xv, U=u),
              jm.factors_warm(X_col=cols, X_val=xv, U=u)),
             (tm.factors_warm(X_col=cols, X_val=xv),
              jm.factors_warm(X_col=cols, X_val=xv)),
             (tm.factors_cold(U=u), jm.factors_cold(U=u)),
             (tm.factors_multiple(X=X.tocsr()[:9]),
              jm.factors_multiple(X=X.tocsr()[:9]))]
    for got, want in pairs:
        got = got[0] if isinstance(got, tuple) else got
        want = want[0] if isinstance(want, tuple) else want
        assert np.asarray(got).dtype == np.float64
        assert _rel(got, want) <= F64_TOL
    assert seen == {torch.float64}
    ti, ts = tm.topN_warm(n=5, X_col=cols, X_val=xv, output_score=True)
    ji, js = jm.topN_warm(n=5, X_col=cols, X_val=xv, output_score=True)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    assert ts.dtype == np.float64 and _rel(ts, js) <= F64_TOL


def test_from_model_matrices_keeps_float64():
    rng = np.random.default_rng(3)
    A, B = rng.normal(size=(20, 3)), rng.normal(size=(15, 3))
    ub, ib = rng.normal(size=20), rng.normal(size=15)
    tm = cmfrec_torch.CMF.from_model_matrices(
        A, B, glob_mean=3.0, user_bias=ub, item_bias=ib, use_float=False,
        device="cpu")
    jm = cmfrec_tpu.CMF.from_model_matrices(
        A, B, glob_mean=3.0, user_bias=ub, item_bias=ib, use_float=False)
    assert tm.dtype_ == np.float64 and tm.A_.dtype == np.float64
    assert tm.user_bias_.dtype == np.float64
    got = tm.factors_warm(X_col=[0, 3], X_val=[4.0, 2.5])
    assert got.dtype == np.float64
    assert _rel(got, jm.factors_warm(X_col=[0, 3], X_val=[4.0, 2.5])) <= \
        F64_TOL
    ti = cmfrec_torch.CMF_implicit.from_model_matrices(
        A, B, use_float=False, device="cpu")
    assert ti.A_.dtype == np.float64 and ti.dtype_ == np.float64
    assert ti.factors_warm(X_col=[0, 3], X_val=[4.0, 2.5]).dtype == \
        np.float64


def test_init_from_arrays_keeps_the_arrays_dtype():
    _, _, _, _, init = _data()
    out = init_from_arrays(init, "cpu")
    assert {v.dtype for v in out.values()} == {torch.float64}
    out = init_from_arrays({key: v.astype(np.float32)
                            for key, v in init.items()}, "cpu")
    assert {v.dtype for v in out.values()} == {torch.float32}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_float64_checkpoint_loads_in_the_other_package(writer, tmp_path):
    """An f64 model saved by either package loads in the other with float64
    arrays and dtype_ float64, and predicts the same."""
    _, X, U = _serving_data(7)
    kw = dict(k=3, niter=2, lambda_=2.0, use_float=False)
    path = str(tmp_path / "f64.npz")
    if writer == "port":
        first = cmfrec_torch.CMF(**kw, device="cpu").fit(X, U=U)
        first.save(path)
        other = cmfrec_tpu.CMF.load(path)
    else:
        first = cmfrec_tpu.CMF(**kw).fit(X, U=U)
        first.save(path)
        other = cmfrec_torch.CMF.load(path, device="cpu")
    assert np.dtype(other.dtype_) == np.float64
    for attr in ("A_", "B_", "C_", "user_bias_", "item_bias_"):
        assert np.asarray(getattr(first, attr)).dtype == np.float64, attr
        assert np.asarray(getattr(other, attr)).dtype == np.float64, attr
    r, c = X.row[:20], X.col[:20]
    assert _rel(np.asarray(other.predict(r, c)),
                np.asarray(first.predict(r, c))) <= F64_TOL


# --------------------------------------------------------------------- #
# (g) fault P3: the log of a value <= 0 raises                          #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("site", ["MostPopular.fit", "factors_warm",
                                  "factors_warm_multiple"])
def test_log_of_a_value_not_above_zero_raises(site):
    rng, X, U = _serving_data(8)
    plays = sp.coo_matrix((np.abs(X.data) + 1.0, (X.row, X.col)),
                          shape=X.shape)
    if site == "MostPopular.fit":
        zero = plays.copy()
        zero.data[0] = 0.0
        call = (lambda: cmfrec_torch.MostPopular(
            implicit=True, apply_log_transf=True, device="cpu").fit(zero))
    else:
        model = cmfrec_torch.OMF_implicit(
            k=3, niter=1, apply_log_transf=True, device="cpu").fit(plays,
                                                                   U=U)
        if site == "factors_warm":
            call = (lambda: model.factors_warm(X_col=[1, 2],
                                               X_val=[0.0, 3.0]))
        else:
            call = (lambda: model.factors_warm_multiple(sp.coo_matrix(
                ([2.0, 0.0], ([0, 1], [1, 2])), shape=(2, X.shape[1]))))
    with pytest.raises(ValueError, match="apply_log_transf needs every "
                                         "value > 0"):
        call()
