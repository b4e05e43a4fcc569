"""cmfrec_torch's offsets models (OMF_explicit, OMF_implicit,
ContentBased) against cmfrec_tpu's on the same inputs.

- the fits through the public models from one init (handed to both
  packages' solvers by wrapping them): the L-BFGS fits in float64 at 1e-6
  of max|param|; the ALS fits (Cholesky, use_cg=False) at the JAX
  package's own bound for the port's exact mode against its bucketed
  Cholesky, 2e-4 of max|Am| (tests/test_exact_dense.py, and
  tests/test_torch_cmf.py's model-level Cholesky comparison);
- solvers.offsets.fit_offsets_als against cmfrec_tpu's on its CPU route;
- each branch of warm.offsets_warm_batch (implicit, plain ridge, exact,
  k_sec) on models carried across by save/load: within 2e-6 of max|a| on
  float64 models and 1e-4 on float32 ones, with the branch counter
  ``_cache_stats["omf_gram"]``;
- the serving surface (cold, warm, new items, topN) at 1e-5 (the port
  projects attributes and scores in f32);
- save/load both ways, convert.model_from_arrays, and the ALS fits at
  their float64 defaults (ROADMAP slice 1 item 1) against cmfrec_tpu from
  one init (1e-8 of max|param|).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import cmfrec_torch
import cmfrec_tpu
from cmfrec_torch.convert import model_from_arrays
from cmfrec_torch.solvers import offsets as toff
from cmfrec_torch.solvers import warm as twarm
from cmfrec_tpu.solvers import offsets as joff
from cmfrec_tpu.solvers import warm as jwarm

M, N, P, Q = 50, 40, 6, 5


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) <= tol * float(np.abs(b).max())


def _data(seed=0):
    rng = np.random.default_rng(seed)
    mask = rng.uniform(size=(M, N)) < 0.35
    X = np.where(mask, np.round(2 * (3 + rng.normal(size=(M, N)))) / 2,
                 np.nan)
    U = rng.normal(size=(M, P))
    I = rng.normal(size=(N, Q))
    U[rng.uniform(size=U.shape) < 0.1] = np.nan
    return rng, X, U, I


def _plays(X):
    return sp.coo_matrix(np.nan_to_num(np.abs(X) + 1.0 * ~np.isnan(X)))


def _with_init(monkeypatch, name, init, key):
    """Wrap both packages' offsets solver ``name`` so that every call
    takes ``init`` under the keyword ``key``."""
    for mod in (joff, toff):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _r=real, **kw: _r(*a, **{**kw,
                                                                key: init}))
    import cmfrec_tpu.models.omf as jomf
    import cmfrec_torch.models.omf as tomf

    for mod in (jomf, tomf):
        monkeypatch.setattr(mod, "offsets_solver",
                            joff if mod is jomf else toff)


def _lbfgs_init(rng, k, k_sec, k_main):
    kAB, kCD = k + k_main, k_sec + k
    init = {"C": 0.3 * rng.normal(size=(P, kCD)),
            "D": 0.3 * rng.normal(size=(Q, kCD)),
            "C_bias": 0.1 * rng.normal(size=kCD), "D_bias": np.zeros(kCD)}
    if kAB:
        init["A"] = 0.3 * rng.normal(size=(M, kAB))
        init["B"] = 0.3 * rng.normal(size=(N, kAB))
    return init


FIT_ATTRS = ("A_", "B_", "C_", "D_", "C_bias_", "D_bias_", "Am_", "Bm_",
             "user_bias_", "item_bias_", "U_colmeans_", "I_colmeans_")


def _same_fit(tm, jm, tol):
    for attr in FIT_ATTRS:
        want = getattr(jm, attr)
        if want is None:
            assert getattr(tm, attr) is None, attr
            continue
        assert _close(getattr(tm, attr), want, tol), attr
    assert tm.glob_mean_ == pytest.approx(jm.glob_mean_, rel=1e-12)


@pytest.mark.parametrize("kw", [dict(k=3), dict(k=2, k_sec=1, k_main=1),
                                dict(k=3, exact=True, w_user=1.3)],
                         ids=["plain", "k_sec_main", "exact"])
def test_omf_explicit_lbfgs_matches_jax(kw, monkeypatch):
    rng, X, U, I = _data()
    init = _lbfgs_init(rng, kw["k"], kw.get("k_sec", 0), kw.get("k_main", 0))
    _with_init(monkeypatch, "fit_offsets_explicit_lbfgs", init, "init_params")
    params = dict(lambda_=1.5, maxiter=50, use_float=False, **kw)
    jm = cmfrec_tpu.OMF_explicit(**params).fit(X, U=U, I=I)
    tm = cmfrec_torch.OMF_explicit(**params, device="cpu").fit(X, U=U, I=I)
    _same_fit(tm, jm, 1e-6)
    assert tm.niter_ == jm.niter_
    assert tm.fit_stats_["n_evals"] >= 50
    rows, cols = np.nonzero(~np.isnan(X))
    np.testing.assert_allclose(tm.predict(rows[:40], cols[:40]),
                               jm.predict(rows[:40], cols[:40]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(tm.topN(3, n=6), jm.topN(3, n=6))


def _als_init(rng, k, implicit=False):
    init = {"A": (0.3 * rng.normal(size=(M, k))).astype(np.float32),
            "B": (0.3 * rng.normal(size=(N, k))).astype(np.float32)}
    return init


def test_omf_explicit_als_matches_jax(monkeypatch):
    """ALS at use_cg=False, niter=1, from one init: the port's exact mode
    against cmfrec_tpu's bucketed Cholesky (2e-4), then the attribute
    regression of both on their own Am (f64 on the host)."""
    rng, X, U, I = _data(1)
    _with_init(monkeypatch, "fit_offsets_als", _als_init(rng, 3), "init")
    params = dict(k=3, lambda_=1.5, method="als", niter=1, use_cg=False,
                  use_float=True, user_bias=False, item_bias=False)
    jm = cmfrec_tpu.OMF_explicit(**params).fit(X, U=U, I=I)
    tm = cmfrec_torch.OMF_explicit(**params, device="cpu").fit(X, U=U, I=I)
    _same_fit(tm, jm, 2e-4)
    # the regression holds: A = Am - U C - C_bias on U as densify_side
    # makes it (missing entries are 0 before the column centering)
    Ud = np.nan_to_num(U) - tm.U_colmeans_[None, :]
    np.testing.assert_allclose(tm.A_, tm.Am_ - Ud @ tm.C_ - tm.C_bias_,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("implicit", [False, True],
                         ids=["explicit", "implicit"])
def test_fit_offsets_als_matches_jax(implicit):
    rng, X, U, I = _data(2)
    Xs = _plays(X) if implicit else sp.coo_matrix(np.nan_to_num(X))
    if not implicit:
        r, c = np.nonzero(~np.isnan(X))
        Xs = sp.coo_matrix((X[r, c], (r, c)), shape=X.shape)
    side_U = (None, None, None, M, P, True, np.nan_to_num(U))
    side_I = (None, None, None, N, Q, True, I)
    kw = dict(side_U=side_U, side_I=side_I, implicit=implicit, k=4,
              lambda_=2.0, niter=2, use_cg=False, init=_als_init(rng, 4),
              alpha=2.0, dtype=np.float32)
    args = (Xs.row, Xs.col, Xs.data, M, N)
    rj = joff.fit_offsets_als(*args, **kw)
    rt = toff.fit_offsets_als(*args, device="cpu", **kw)
    for key in ("Am", "Bm", "A", "B", "C", "D", "C_bias", "D_bias"):
        assert _close(rt[key], rj[key], 2e-4), key
    for key in ("biasA", "biasB"):
        if rj[key] is None:
            assert rt[key] is None
        else:
            assert _close(rt[key], rj[key], 2e-4), key
    assert rt["w_main_multiplier"] == rj["w_main_multiplier"]


def test_omf_implicit_matches_jax(monkeypatch):
    rng, X, U, I = _data(3)
    _with_init(monkeypatch, "fit_offsets_als", _als_init(rng, 3), "init")
    params = dict(k=3, lambda_=2.0, alpha=2.0, niter=1, use_cg=False,
                  use_float=True)
    Xp = _plays(X)
    jm = cmfrec_tpu.OMF_implicit(**params).fit(Xp, U=U)
    tm = cmfrec_torch.OMF_implicit(**params, device="cpu").fit(Xp, U=U)
    _same_fit(tm, jm, 2e-4)
    assert tm.w_main_multiplier_ == jm.w_main_multiplier_


def test_content_based_matches_jax(monkeypatch):
    """ContentBased's L-BFGS from one init_params (start_with_ALS off,
    f64), then its own serving: predict_new, topN_new, factors_multiple."""
    rng, X, U, I = _data(4)
    init = _lbfgs_init(rng, 3, 0, 0)
    _with_init(monkeypatch, "fit_offsets_explicit_lbfgs", init, "init_params")
    params = dict(k=3, lambda_=5.0, maxiter=50, use_float=False,
                  start_with_ALS=False, user_bias=True)
    jm = cmfrec_tpu.ContentBased(**params).fit(X, U=U, I=I)
    tm = cmfrec_torch.ContentBased(**params, device="cpu").fit(X, U=U, I=I)
    _same_fit(tm, jm, 1e-6)
    Un, In = U[:7], I[:7]
    np.testing.assert_allclose(tm.predict_new(Un, In), jm.predict_new(Un, In),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tm.factors_multiple(Un),
                               jm.factors_multiple(Un), rtol=0, atol=1e-5)
    got = tm.topN_new(n=5, U=U[0], I=I, output_score=True)
    want = jm.topN_new(n=5, U=U[0], I=I, output_score=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tm.topN_new(n=5, U=U[1]),
                                  jm.topN_new(n=5, U=U[1]))


def test_content_based_start_with_als_runs_both_fits(monkeypatch):
    """start_with_ALS: five ALS iterations (the port's driver) hand C, D
    and the intercepts to the L-BFGS fit as its init_params."""
    rng, X, U, I = _data(5)
    seen = []
    real = toff.fit_offsets_explicit_lbfgs
    monkeypatch.setattr(toff, "fit_offsets_explicit_lbfgs",
                        lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    tm = cmfrec_torch.ContentBased(k=3, maxiter=30, device="cpu").fit(
        X, U=U, I=I)
    init = seen[0]["init_params"]
    assert sorted(init) == ["C", "C_bias", "D", "D_bias"]
    assert init["C"].shape == (P, 3) and np.isfinite(tm.Am_).all()
    assert tm.Am_.shape == (M, 3) and tm.A_ is None


# --------------------------------------------------------------------- #
# serving: offsets_warm_batch and the public surface                    #
# --------------------------------------------------------------------- #


def _carried(cls_kw, X, U, I, tmp_path, implicit=False, **fit_kw):
    """A port model fitted on the CPU and the same arrays in cmfrec_tpu
    (its save, cmfrec_tpu's load), both with their caches built."""
    cls = "OMF_implicit" if implicit else "OMF_explicit"
    tm = getattr(cmfrec_torch, cls)(**cls_kw, device="cpu").fit(
        _plays(X) if implicit else X, U=U, I=I, **fit_kw)
    path = str(tmp_path / "omf.npz")
    tm.save(path)
    jm = getattr(cmfrec_tpu, cls).load(path)
    for m in (jm, tm):
        m.force_precompute_for_predictions()
        m._cache_stats = {}
    return jm, tm


BRANCHES = {
    "ridge": dict(k=3, lambda_=1.5, maxiter=40),
    "ridge_bias": dict(k=3, lambda_=1.5, maxiter=40),
    "exact": dict(k=3, lambda_=1.5, maxiter=40, exact=True),
    "k_sec": dict(k=2, k_sec=1, k_main=1, lambda_=1.5, maxiter=40),
}


def _warm_rows(rng, R=7, L=6, weights=True):
    idx = rng.integers(0, N, size=(R, L))
    vals = np.round(2 * (3 + rng.normal(size=(R, L)))) / 2
    lengths = np.array([6, 2, 0, 1, 6, 3, 4])[:R]
    wgt = rng.uniform(0.5, 2.0, size=(R, L)) if weights else None
    return idx, vals, wgt, lengths


@pytest.mark.parametrize("use_float", [False, True], ids=["f64", "f32"])
@pytest.mark.parametrize("branch", sorted(BRANCHES) + ["implicit"])
def test_offsets_warm_batch_matches_jax(branch, use_float, tmp_path):
    rng, X, U, I = _data(6)
    implicit = branch == "implicit"
    kw = (dict(k=3, lambda_=2.0, alpha=2.0, niter=2, use_cg=False)
          if implicit else BRANCHES[branch])
    # the implicit model is fitted in f32 (ALS) and served in either dtype
    jm, tm = _carried(dict(kw, use_float=use_float or implicit), X, U, I,
                      tmp_path, implicit=implicit)
    jm.dtype_ = tm.dtype_ = np.dtype(np.float32 if use_float
                                     else np.float64)
    idx, vals, wgt, lengths = _warm_rows(rng, weights=not implicit)
    base = (tm.factors_cold_multiple(U[:7]).astype(np.float64)
            if branch in ("exact", "k_sec") else None)
    call = dict(wgt=wgt, base=base, implicit=implicit, alpha=2.0,
                return_bias=branch == "ridge_bias" or branch == "exact")
    got = twarm.offsets_warm_batch(tm, idx, vals, lengths, **call)
    want = jwarm.offsets_warm_batch(jm, idx, vals, lengths, **call)
    tol = 1e-4 if use_float else 2e-6
    got, want = ((got, want) if isinstance(want, tuple)
                 else ((got,), (want,)))
    for g, w in zip(got, want):
        assert np.asarray(g).shape == np.asarray(w).shape
        assert _close(g, w, tol)
    assert np.asarray(got[0]).dtype == np.asarray(want[0]).dtype
    # the plain ridge takes no Gram from the cache; the other branches do
    uses_gram = branch != "ridge" and branch != "ridge_bias"
    for m in (jm, tm):
        assert m._cache_stats.get("omf_gram", 0) == int(uses_gram), branch


def test_offsets_warm_batch_without_the_cache():
    rng, X, U, I = _data(7)
    tm = cmfrec_torch.OMF_explicit(k=2, k_sec=1, lambda_=1.5, maxiter=30,
                                   device="cpu").fit(X, U=U, I=I)
    idx, vals, wgt, lengths = _warm_rows(rng)
    with_cache = twarm.offsets_warm_batch(tm, idx, vals, lengths, wgt=wgt)
    tm._precomputed = {}
    tm._cache_stats = {}
    without = twarm.offsets_warm_batch(tm, idx, vals, lengths, wgt=wgt)
    assert "omf_gram" not in tm._cache_stats
    np.testing.assert_allclose(without, with_cache, rtol=0, atol=1e-12)


def test_omf_explicit_serving_matches_jax(tmp_path):
    rng, X, U, I = _data(8)
    jm, tm = _carried(dict(k=2, k_sec=1, k_main=1, lambda_=1.5, maxiter=40,
                           use_float=False), X, U, I, tmp_path)
    Xn = X[:5].copy()
    items = np.arange(5)
    calls = [
        lambda m: m.factors_cold(U=U[0]),
        lambda m: m.factors_cold(U_col=[0, 2], U_val=[1.0, -0.5]),
        lambda m: m.factors_cold_multiple(U[:4]),
        lambda m: m.item_factors_cold(I=I[1]),
        lambda m: m.item_factors_cold(I_col=[1, 3], I_val=[0.5, 2.0]),
        lambda m: m.predict_cold(items, U=U[2]),
        lambda m: m.predict_cold_multiple(items[:4], U=U[:4]),
        lambda m: m.predict_new(items[:4], I=I[:4]),
        lambda m: m.factors_warm(X=Xn[0]),
        lambda m: m.factors_warm(X_col=[1, 5], X_val=[3.0, 4.5], U=U[1],
                                 return_bias=True),
        lambda m: m.factors_warm(X=Xn[1], U=U[1], return_raw_A=True,
                                 exact=True),
        lambda m: m.factors_warm_multiple(Xn, U=U[:5]),
        lambda m: m.predict_warm(items, X=Xn[2]),
        lambda m: m.predict_warm_multiple(Xn, items, U=U[:5]),
        lambda m: m.transform(Xn),
    ]
    for i, call in enumerate(calls):
        got, want = call(tm), call(jm)
        for g, w in (zip(got, want) if isinstance(want, tuple)
                     else [(got, want)]):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64), rtol=0,
                                       atol=1e-5, err_msg=str(i))
    for call in (lambda m: m.topN_cold(n=5, U=U[0]),
                 lambda m: m.topN_warm(n=5, X=Xn[0], exclude=[1, 2]),
                 lambda m: m.topN_new(2, I=I[:9], n=4),
                 lambda m: m.topN(1, n=5, include=np.arange(12))):
        np.testing.assert_array_equal(call(tm), call(jm))


def test_omf_implicit_serving_matches_jax(tmp_path):
    rng, X, U, I = _data(9)
    jm, tm = _carried(dict(k=3, lambda_=2.0, alpha=2.0, niter=2,
                           use_cg=False, use_float=True), X, U, I, tmp_path,
                      implicit=True)
    Xn = _plays(X[:6])
    calls = [
        lambda m: m.factors_warm(X_col=[1, 4], X_val=[2.0, 5.0]),
        lambda m: m.factors_warm(X_col=[1, 4], X_val=[2.0, 5.0], U=U[0],
                                 return_raw_A=True),
        lambda m: m.factors_warm_multiple(Xn),
        lambda m: m.predict_warm(np.arange(6), X_col=[2], X_val=[3.0]),
        lambda m: m.predict_warm_multiple(Xn, np.arange(6)),
        lambda m: m.factors_cold(U=U[3]),
    ]
    for i, call in enumerate(calls):
        np.testing.assert_allclose(np.asarray(call(tm), np.float64),
                                   np.asarray(call(jm), np.float64), rtol=0,
                                   atol=1e-5, err_msg=str(i))
    np.testing.assert_array_equal(
        tm.topN_warm(n=5, X_col=[1, 4], X_val=[2.0, 5.0]),
        jm.topN_warm(n=5, X_col=[1, 4], X_val=[2.0, 5.0]))


# --------------------------------------------------------------------- #
# carrying state across; rejections                                     #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("cls", ["OMF_explicit", "OMF_implicit",
                                 "ContentBased"])
def test_save_load_both_ways(cls, tmp_path):
    rng, X, U, I = _data(10)
    kw = {"OMF_explicit": dict(k=3, maxiter=20),
          "OMF_implicit": dict(k=3, niter=2, use_float=True),
          # cmfrec_tpu's own float32 L-BFGS start fails under x64 (a
          # float64 scale times its float32 draws), so float64 here
          "ContentBased": dict(k=3, maxiter=20, start_with_ALS=False,
                               use_float=False)}[cls]
    Xf = _plays(X) if cls == "OMF_implicit" else X
    jm = getattr(cmfrec_tpu, cls)(**kw).fit(Xf, U=U, I=I)
    tm = getattr(cmfrec_torch, cls)(**kw, device="cpu").fit(Xf, U=U, I=I)
    rows, cols = np.arange(10), np.arange(10) % N
    for src, dst_pkg in ((jm, cmfrec_torch), (tm, cmfrec_tpu)):
        path = str(tmp_path / f"{cls}_{dst_pkg.__name__}.npz")
        src.save(path)
        extra = {"device": "cpu"} if dst_pkg is cmfrec_torch else {}
        dst = getattr(dst_pkg, cls).load(path, **extra)
        assert type(dst).__name__ == cls and dst.is_fitted_
        for attr in FIT_ATTRS:
            a, b = getattr(dst, attr), getattr(src, attr)
            assert (a is None) == (b is None), attr
            if a is not None:
                np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(np.asarray(dst.predict(rows, cols)),
                                   np.asarray(src.predict(rows, cols)),
                                   rtol=0, atol=1e-5)
    # and the port's model from the cmfrec_tpu model's arrays
    arrays = {name: getattr(jm, name, None)
              for name in cmfrec_torch.OMF_explicit._ARRAY_ATTRS}
    conv = model_from_arrays(getattr(cmfrec_torch, cls), arrays,
                             params=jm.get_params(), glob_mean=jm.glob_mean_,
                             device="cpu")
    np.testing.assert_allclose(conv.predict(rows, cols),
                               np.asarray(jm.predict(rows, cols)), rtol=0,
                               atol=1e-5)
    assert conv.dtype_ == np.dtype(np.float32 if kw.get(
        "use_float", cls == "ContentBased") else np.float64)


def test_model_from_arrays_rejects_what_it_cannot_carry():
    with pytest.raises(ValueError, match="cls must be one of"):
        model_from_arrays(cmfrec_torch.CMF, {})
    with pytest.raises(ValueError, match="not fitted array attributes"):
        model_from_arrays(cmfrec_torch.OMF_explicit, {"Zm_": np.ones(2)},
                          device="cpu")


@pytest.mark.parametrize("make", [
    lambda: cmfrec_torch.OMF_explicit(k=3, method="als", use_float=False,
                                      device="cpu"),
    lambda: cmfrec_torch.OMF_implicit(k=3, device="cpu"),
    lambda: cmfrec_torch.ContentBased(k=3, use_float=False, device="cpu"),
], ids=["omf_explicit_als", "omf_implicit", "content_based_als"])
def test_float64_under_als_raises(make, monkeypatch):
    """The ALS fits at their float64 defaults (ROADMAP slice 1 item 1; the
    name is the earlier rejection's): OMF_explicit(method="als"),
    OMF_implicit() and ContentBased(use_float=False)'s ALS start fit in
    float64 from one init handed to both packages' fit_offsets_als, and
    every fitted array matches cmfrec_tpu's within 1e-8 of max|.|."""
    rng, X, U, I = _data(11)
    _with_init(monkeypatch, "fit_offsets_als", _als_init(rng, 3), "init")
    model = make()
    implicit = isinstance(model, cmfrec_torch.OMF_implicit)
    Xf = _plays(X) if implicit else X
    params = model.get_params()
    params.pop("device")
    if isinstance(model, cmfrec_torch.ContentBased):
        # the L-BFGS after the ALS start; at the default lambda (100) it
        # takes C and D to ~1e-12, where a relative comparison reads noise
        params.update(maxiter=20, lambda_=1.0)
    want = type(model).__name__
    jm = getattr(cmfrec_tpu, want)(**params)
    tm = type(model)(**params, device="cpu")
    fit = dict(U=U) if implicit else dict(U=U, I=I)
    jm.fit(Xf, **fit)
    tm.fit(Xf, **fit)
    assert tm.dtype_ == np.float64 and tm.Am_.dtype == np.float64
    _same_fit(tm, jm, 1e-8)


def test_option_checks_as_cmfrec_tpu():
    for kw, match in ((dict(method="sgd"), "'method'"),
                      (dict(method="als", k_sec=1), "k_sec"),
                      (dict(method="als", lambda_=np.ones(6)),
                       "Different regularization"),
                      (dict(method="als", w_user=2.0), "w_user")):
        for pkg, extra in ((cmfrec_tpu, {}), (cmfrec_torch, {"device": "cpu"})):
            with pytest.raises(ValueError, match=match):
                pkg.OMF_explicit(**kw, **extra)
    _, X, U, I = _data(12)
    with pytest.raises(ValueError, match="requires both U and I"):
        cmfrec_torch.ContentBased(device="cpu").fit(X, U=U, I=None)
