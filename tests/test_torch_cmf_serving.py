"""The serving surface of cmfrec_torch's CMF, CMF_implicit and CMF_imputer
against cmfrec_tpu's on the same carried model: warm and cold factors,
predict and topN of new users and new items, the batch calls on both of
their routes, transform, from_model_matrices, swap_users_and_items,
drop_nonessential_matrices, collective models fitted by the port, and
serving after save/load both ways.

The port serves in f32 and cmfrec_tpu here in f64, on the same
f32-representable arrays: TOL is the largest relative gap allowed."""

import numpy as np
import pytest

import cmfrec_torch
import cmfrec_tpu
from cmfrec_torch.convert import cmf_from_arrays
from cmfrec_torch.models import cmf as tcmf
from cmfrec_torch.solvers import warm

M, N, K, P, Q = 60, 45, 5, 7, 6
# max|port - cmfrec_tpu| / max|cmfrec_tpu|; readings <= 8.2e-7 (the f32
# solves; predictions add the f32 factors' rounding)
TOL = 5e-6


def close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, f"{err:.3e} (tol {tol:.0e})"


def _f32(rng, *shape, scale=0.5):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def carried(implicit=False, precompute=True, seed=0, **params):
    """(cmfrec_tpu model, port model) on the same arrays: A, B, biases (for
    CMF), and side-info factors C, D with their column means."""
    rng = np.random.default_rng(seed)
    arrays = dict(A=_f32(rng, M, K), B=_f32(rng, N, K),
                  C=_f32(rng, P, K, scale=0.4), D=_f32(rng, Q, K, scale=0.4),
                  U_colmeans=rng.normal(size=P),
                  I_colmeans=rng.normal(size=Q))
    if implicit:
        jm = cmfrec_tpu.CMF_implicit(k=K, lambda_=1.5, alpha=2.0, **params)
    else:
        jm = cmfrec_tpu.CMF(k=K, lambda_=[0.6, 0.7, 1.5, 1.2, 1, 1],
                            **params)
        arrays.update(user_bias=_f32(rng, M, scale=0.3),
                      item_bias=_f32(rng, N, scale=0.3), glob_mean=3.5)
    jm._reset()
    jm.dtype_ = np.dtype(np.float64)
    for key, v in arrays.items():
        if key == "glob_mean":
            jm.glob_mean_ = v
        else:
            setattr(jm, key + "_", np.asarray(v, np.float64))
    jm.w_main_multiplier_ = 1.0
    jm.is_fitted_ = True
    tm = cmf_from_arrays(**arrays, params=jm.get_params(),
                         cls=tcmf.CMF_implicit if implicit else tcmf.CMF,
                         device="cpu")
    if precompute:
        jm.force_precompute_for_predictions()
        tm.force_precompute_for_predictions()
    return jm, tm


def new_users(seed=1, R=10, power=False):
    """Dense new-user rows of X with NaN where unobserved (the first row
    empty), or with ``power`` a sparse COO batch of power-law degrees."""
    rng = np.random.default_rng(seed)
    if power:
        import scipy.sparse as sp

        deg = np.minimum((rng.pareto(1.0, R) * 2).astype(np.int64) + 1, N)
        rows = np.repeat(np.arange(R), deg)
        cols = np.concatenate([rng.choice(N, d, replace=False) for d in deg])
        vals = 1.0 + rng.poisson(3.0, rows.size)
        return sp.coo_matrix((vals, (rows, cols)), shape=(R, N))
    X = 1.0 + rng.poisson(3.0, size=(R, N)).astype(np.float64)
    X[rng.uniform(size=X.shape) < 0.7] = np.nan
    X[0] = np.nan
    return X


def side(seed=2, R=10, width=P, nan=0.0):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(R, width))
    U[rng.uniform(size=U.shape) < nan] = np.nan
    return U


@pytest.mark.parametrize("precompute", [False, True])
def test_cmf_one_new_user(precompute):
    jm, tm = carried(precompute=precompute)
    X = new_users()
    x = X[3]
    cols = np.flatnonzero(~np.isnan(x))
    W = np.linspace(0.5, 2.0, N)
    u = side(R=1)[0]
    u_nan = side(R=1, nan=0.4, seed=5)[0]
    items = np.array([0, 7, 44, 7])
    calls = [
        ("factors_warm", dict(X=x)),
        ("factors_warm", dict(X=x, W=W, return_bias=True)),
        ("factors_warm", dict(X_col=cols, X_val=x[cols], U=u_nan,
                              return_bias=True)),
        ("factors_warm", dict(X_col=cols, X_val=x[cols], U_col=[0, 3],
                              U_val=[0.5, -1.0])),
        ("factors_cold", dict(U=u)),
        ("factors_cold", dict(U_col=[1, 2], U_val=[1.0, 0.2])),
        ("predict_warm", dict(items=items, X=x, U=u)),
        ("predict_cold", dict(items=items, U=u)),
    ]
    for name, kw in calls:
        t, j = getattr(tm, name)(**kw), getattr(jm, name)(**kw)
        if isinstance(j, tuple):
            close(t[0], j[0])
            assert abs(t[1] - j[1]) <= TOL * max(abs(j[1]), 1e-3)
        else:
            close(t, j)
    some = np.arange(0, N, 3)
    for name, kw in (("topN_warm", dict(X=x)), ("topN_cold", dict(U=u))):
        for extra in ({}, {"include": some}, {"exclude": some}):
            ti, ts = getattr(tm, name)(n=6, output_score=True, **kw, **extra)
            ji, js = getattr(jm, name)(n=6, output_score=True, **kw, **extra)
            np.testing.assert_array_equal(ti, ji)
            close(ts, js)


@pytest.mark.parametrize("precompute", [False, True])
def test_cmf_many_new_users(precompute, monkeypatch):
    jm, tm = carried(precompute=precompute)
    X = new_users()
    U = side(R=X.shape[0], nan=0.2)
    items = np.arange(X.shape[0]) * 4
    grouped = []
    real = warm.factors_explicit_grouped
    monkeypatch.setattr(warm, "factors_explicit_grouped",
                        lambda *a, **k: grouped.append(1) or real(*a, **k))
    for kw in (dict(X=X), dict(X=X, U=U), dict(U=side(R=8)),
               dict(X=X, W=np.full(X.shape, 1.5))):
        t = tm.factors_multiple(**kw, return_bias=True)
        j = jm.factors_multiple(**kw, return_bias=True)
        close(t[0], j[0])
        close(t[1], j[1])
    assert not grouped  # small batches keep the padded route
    Xp = new_users(R=400, power=True)
    assert tcmf._route_grouped(Xp.row, 400)
    for U_ in (None, side(R=400)):
        close(tm.factors_multiple(X=Xp, U=U_), jm.factors_multiple(X=Xp, U=U_))
    assert len(grouped) == 2
    close(tm.predict_warm_multiple(X, items), jm.predict_warm_multiple(X, items))
    close(tm.predict_cold_multiple(items[:8], U=side(R=8)),
          jm.predict_cold_multiple(items[:8], U=side(R=8)))
    for replace in (False, True):
        t = tm.transform(X, replace_existing=replace)
        close(t, jm.transform(X, replace_existing=replace))
        if not replace:
            obs = ~np.isnan(X)
            np.testing.assert_array_equal(t[obs], X[obs])
            assert not np.isnan(t).any()


def test_cmf_new_items():
    jm, tm = carried()
    Inew = side(R=9, width=Q, seed=3)
    close(tm.item_factors_cold(I=Inew[0]), jm.item_factors_cold(I=Inew[0]))
    close(tm.item_factors_cold(I_col=[0, 2], I_val=[1.0, -0.5]),
          jm.item_factors_cold(I_col=[0, 2], I_val=[1.0, -0.5]))
    users = np.arange(9) * 5
    close(tm.predict_new(users, I=Inew), jm.predict_new(users, I=Inew))
    ti, ts = tm.topN_new(4, I=Inew, n=5, output_score=True)
    ji, js = jm.topN_new(4, I=Inew, n=5, output_score=True)
    np.testing.assert_array_equal(ti, ji)
    close(ts, js)
    # the swapped copy starts empty and leaves the model's caches alone
    cache = dict(tm._device_cache)
    sw = tm.swap_users_and_items()
    assert sw._device_cache == {} and tm._device_cache == cache
    assert sw.A_ is tm.B_ and sw.C_ is tm.D_ and "extB" in sw._precomputed
    jsw = jm.swap_users_and_items()
    xs = np.full(M, np.nan)
    xs[::4] = 3.0
    close(sw.factors_warm(X=xs), jsw.factors_warm(X=xs))
    close(sw.factors_cold(U=Inew[1]), jsw.factors_cold(U=Inew[1]))


def test_cmf_from_model_matrices():
    rng = np.random.default_rng(4)
    A, B = _f32(rng, M, K), _f32(rng, N, K)
    ub, ib = _f32(rng, M), _f32(rng, N)
    kw = dict(glob_mean=3.0, user_bias=ub, item_bias=ib, lambda_=2.0,
              scale_lam=True, scaling_biasA=7.5)
    tm = tcmf.CMF.from_model_matrices(A, B, **kw, device="cpu")
    jm = cmfrec_tpu.CMF.from_model_matrices(A.astype(np.float64),
                                            B.astype(np.float64),
                                            use_float=False, **kw)
    assert tm.scale_bias_const and tm.scaling_biasA_ == 7.5
    x = new_users(seed=6)[2]
    close(tm.factors_warm(X=x), jm.factors_warm(X=x))
    np.testing.assert_array_equal(tm.topN_warm(X=x, n=5),
                                  jm.topN_warm(X=x, n=5))
    assert tm._cache_stats == {"warm_fused": 2}
    ti = tcmf.CMF_implicit.from_model_matrices(A, B, alpha=3.0, device="cpu")
    ji = cmfrec_tpu.CMF_implicit.from_model_matrices(
        A.astype(np.float64), B.astype(np.float64), alpha=3.0,
        use_float=False)
    cols = np.array([1, 5, 9])
    close(ti.factors_warm(X_col=cols, X_val=[1.0, 4.0, 2.0]),
          ji.factors_warm(X_col=cols, X_val=[1.0, 4.0, 2.0]))


def test_drop_nonessential_matrices():
    jm, tm = carried()
    x = new_users(seed=7)[4]
    tm.topN(3)  # device copies of A_ and B_
    for model in (jm, tm):
        model.drop_nonessential_matrices()
        assert model.A_ is None and model.D_ is None
        assert model.user_bias_ is None
        assert "BeTBeChol" not in model._precomputed
    assert "A_" not in tm._device_cache and "B_" in tm._device_cache
    close(tm.factors_warm(X=x, return_bias=True)[0],
          jm.factors_warm(X=x, return_bias=True)[0])
    np.testing.assert_array_equal(tm.topN_warm(X=x, n=5),
                                  jm.topN_warm(X=x, n=5))
    close(tm.factors_cold(U=side(R=1)[0]), jm.factors_cold(U=side(R=1)[0]))


@pytest.mark.parametrize("precompute", [False, True])
def test_cmf_implicit_surface(precompute, monkeypatch):
    jm, tm = carried(implicit=True, precompute=precompute)
    X = new_users(seed=9)
    x = X[5]
    cols = np.flatnonzero(~np.isnan(x))
    u = side(R=1)[0]
    items = np.array([3, 9, 30])
    for name, kw in (
            ("factors_warm", dict(X_col=cols, X_val=x[cols])),
            ("factors_warm", dict(X_col=cols, X_val=x[cols], U=u)),
            ("factors_cold", dict(U=u)),
            ("factors_cold", dict(U_col=[0, 4], U_val=[1.0, -2.0])),
            ("predict_warm", dict(items=items, X_col=cols, X_val=x[cols])),
            ("predict_cold", dict(items=items, U=u))):
        close(getattr(tm, name)(**kw), getattr(jm, name)(**kw))
    some = np.arange(0, N, 4)
    for name, kw in (("topN_warm", dict(X_col=cols, X_val=x[cols])),
                     ("topN_cold", dict(U=u))):
        for extra in ({}, {"include": some}, {"exclude": some}):
            ti, ts = getattr(tm, name)(n=6, output_score=True, **kw, **extra)
            ji, js = getattr(jm, name)(n=6, output_score=True, **kw, **extra)
            np.testing.assert_array_equal(ti, ji)
            close(ts, js)
    grouped = []
    real = warm.factors_implicit_grouped
    monkeypatch.setattr(warm, "factors_implicit_grouped",
                        lambda *a, **k: grouped.append(1) or real(*a, **k))
    Xp = new_users(R=400, power=True)
    for kw in (dict(X=X), dict(X=X, U=side(R=X.shape[0])), dict(X=Xp),
               dict(U=side(R=6))):
        close(tm.factors_multiple(**kw), jm.factors_multiple(**kw))
    assert len(grouped) == 1
    itm = np.arange(X.shape[0])
    close(tm.predict_warm_multiple(X, itm), jm.predict_warm_multiple(X, itm))
    close(tm.predict_cold_multiple(itm[:6], U=side(R=6)),
          jm.predict_cold_multiple(itm[:6], U=side(R=6)))
    Inew = side(R=7, width=Q, seed=3)
    close(tm.item_factors_cold(I=Inew[2]), jm.item_factors_cold(I=Inew[2]))
    close(tm.predict_new(np.arange(7), I=Inew),
          jm.predict_new(np.arange(7), I=Inew))
    np.testing.assert_array_equal(tm.topN_new(2, I=Inew, n=4),
                                  jm.topN_new(2, I=Inew, n=4))


def test_implicit_log_transform_rejects_values_below_one():
    """F4 on the serving path: apply_log_transf raises on values <= 0 (the
    log of which is -inf or NaN), as the port's fit does."""
    _, tm = carried(implicit=True, apply_log_transf=True)
    jm, _ = carried(implicit=True, apply_log_transf=True)
    cols = np.array([1, 2, 3])
    close(tm.factors_warm(X_col=cols, X_val=[1.5, 2.0, 9.0]),
          jm.factors_warm(X_col=cols, X_val=[1.5, 2.0, 9.0]))
    for call in (lambda: tm.factors_warm(X_col=cols, X_val=[1.0, 0.0, 2.0]),
                 lambda: tm.factors_multiple(X=np.array([[1.0, -1.0]
                                                         + [np.nan] * (N - 2)]))):
        with pytest.raises(ValueError, match="apply_log_transf"):
            call()


def test_imputer_fit_transform():
    rng = np.random.default_rng(11)
    m, n = 80, 30
    A, B = rng.normal(size=(m, 3)), rng.normal(size=(n, 3))
    full = 3.0 + A @ B.T
    X = full + 0.1 * rng.normal(size=full.shape)
    X[rng.uniform(size=X.shape) < 0.4] = np.nan
    kw = dict(k=4, lambda_=1.0, niter=8, use_cg=False)
    tm = cmfrec_torch.CMF_imputer(**kw, device="cpu")
    out = tm.fit_transform(X)
    jout = cmfrec_tpu.CMF_imputer(**kw).fit_transform(X)
    obs = ~np.isnan(X)
    np.testing.assert_array_equal(out[obs], X[obs])
    assert not np.isnan(out).any()
    close(out, tm.transform(X), 0.0)
    err_t = np.sqrt(np.mean((out - full)[~obs] ** 2))
    err_j = np.sqrt(np.mean((jout - full)[~obs] ** 2))
    assert err_t < 0.5 * np.std(full) and abs(err_t - err_j) < 0.1 * err_j
    # the same arrays carried into a new imputer serve the same imputations
    carried_ = cmf_from_arrays(A=tm.A_, B=tm.B_, user_bias=tm.user_bias_,
                               item_bias=tm.item_bias_,
                               glob_mean=tm.glob_mean_,
                               params=tm.get_params(),
                               cls=cmfrec_torch.CMF_imputer, device="cpu")
    assert type(carried_) is cmfrec_torch.CMF_imputer
    close(carried_.transform(X), out, 1e-6)


@pytest.mark.parametrize("implicit", [False, True])
def test_port_fitted_collective_models_serve_as_jax(implicit, tmp_path):
    """Collective models fitted on the port's dense route (side info, and
    implicit features for CMF), carried to cmfrec_tpu by save/load: both
    packages serve them alike."""
    rng = np.random.default_rng(12)
    m, n = 70, 40
    rows, cols = np.nonzero(rng.uniform(size=(m, n)) < 0.3)
    vals = (1.0 + rng.poisson(2.0, rows.size)).astype(np.float64)
    U, I = rng.normal(size=(m, 5)), rng.normal(size=(n, 4))
    if implicit:
        tm = cmfrec_torch.CMF_implicit(k=4, niter=3, device="cpu")
    else:
        tm = cmfrec_torch.CMF(k=4, niter=3, add_implicit_features=True,
                              device="cpu")
    tm.fit_triplets(rows, cols, vals, m, n, U=U, I=I)
    path = str(tmp_path / "port.npz")
    tm.save(path)
    jm = cmfrec_tpu.CMF.load(path)
    jm.force_precompute_for_predictions()
    x = np.full(n, np.nan)
    x[::3] = 2.0
    xc = np.flatnonzero(~np.isnan(x))
    new_U = rng.normal(size=(6, 5))
    if implicit:
        close(tm.factors_warm(X_col=xc, X_val=x[xc], U=new_U[0]),
              jm.factors_warm(X_col=xc, X_val=x[xc], U=new_U[0]))
    else:
        close(tm.factors_warm(X=x, U=new_U[0]),
              jm.factors_warm(X=x, U=new_U[0]))
    close(tm.factors_multiple(U=new_U), jm.factors_multiple(U=new_U))
    new_I = rng.normal(size=(3, 4))
    close(tm.predict_new(np.arange(3), I=new_I),
          jm.predict_new(np.arange(3), I=new_I))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_serving_after_save_load(direction, tmp_path):
    jm, tm = carried(precompute=False)
    path = str(tmp_path / "m.npz")
    if direction == "jax_to_port":
        jm.save(path)
        tm = tcmf.CMF.load(path, device="cpu")
        assert tm._precomputed == {}
    else:
        tm.save(path)
        jm = cmfrec_tpu.CMF.load(path)
    X = new_users(seed=13)
    close(tm.factors_multiple(X=X), jm.factors_multiple(X=X))
    close(tm.factors_cold(U=side(R=1)[0]), jm.factors_cold(U=side(R=1)[0]))
    tm.force_precompute_for_predictions()
    close(tm.transform(X), jm.transform(X))


def test_dataframe_new_users():
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(14)
    rows, cols = np.nonzero(rng.uniform(size=(40, 25)) < 0.3)
    df = pd.DataFrame({"UserId": [f"u{r}" for r in rows],
                       "ItemId": cols + 500,
                       "Rating": 1.0 + rng.poisson(2.0, rows.size)})
    jm = cmfrec_tpu.CMF(k=3, niter=2).fit(df)
    tm = cmf_from_arrays(A=jm.A_, B=jm.B_, user_bias=jm.user_bias_,
                         item_bias=jm.item_bias_, glob_mean=jm.glob_mean_,
                         user_mapping=jm.user_mapping_,
                         item_mapping=jm.item_mapping_,
                         params=jm.get_params(), device="cpu")
    new = pd.DataFrame({"UserId": ["a", "a", "b", "c"],
                        "ItemId": [500, 503, 510, 520],
                        "Rating": [4.0, 2.0, 3.0, 5.0]})
    mapping = tm.user_mapping_
    close(tm.factors_multiple(X=new), jm.factors_multiple(X=new), 1e-5)
    assert tm.user_mapping_ is mapping  # stateless
    close(tm.predict_warm_multiple(new.iloc[[0, 2, 3]], [501, 502, 503]),
          jm.predict_warm_multiple(new.iloc[[0, 2, 3]], [501, 502, 503]),
          1e-5)
    with pytest.raises(ValueError, match="unknown item"):
        tm.factors_multiple(X=pd.DataFrame({"UserId": ["a"],
                                            "ItemId": [99],
                                            "Rating": [1.0]}))
