"""cmfrec_torch.solvers.warm against cmfrec_tpu.solvers.warm on the same
carried model: the precompute key by key, every branch of the explicit and
implicit batch solvers, fused against eager, grouped against ungrouped,
zero-degree rows, the device cache's identity key (F3), and the options the
port rejects.

The models are built from the same f32-representable arrays in both
packages (cmfrec_tpu's model holds them as f64, the port's as f32), so the
host precompute agrees to f64 rounding and the solves to f32 rounding.
"""

import numpy as np
import pytest
import torch

import cmfrec_tpu
from cmfrec_torch.convert import cmf_from_arrays
from cmfrec_torch.models.cmf import CMF, CMF_implicit
from cmfrec_torch.solvers import warm
from cmfrec_tpu.solvers import warm as jwarm

M, N, K, P = 50, 40, 4, 6
LAMBDA = [0.7, 0.8, 1.5, 1.2, 0.9, 1.1]
# max|port - cmfrec_tpu| / max|cmfrec_tpu| of the port's f32 solves against
# the f64 reference: readings <= 4.7e-7 over every branch at these sizes
TOL = 2e-6
# the host precompute: both packages compute it in f64 from the same values
PRE_TOL = 1e-12

EXPLICIT = {
    "plain": {},
    "no_bias": dict(user_bias=False, item_bias=False),
    "scale_lam": dict(scale_lam=True, scale_bias_const=True),
    "scale_side": dict(scale_lam_sideinfo=True, side=True),
    "scale_lam_side": dict(scale_lam=True, side=True),
    "na0": dict(NA_as_zero=True),
    "side": dict(side=True),
    "side_na0u": dict(side=True, NA_as_zero_user=True),
    "implicit_features": dict(add_implicit_features=True, side=True),
    "k_user_main": dict(k_user=2, k_item=1, k_main=1, side=True),
}


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def carried(case="plain", seed=0, precompute=True):
    """(cmfrec_tpu model, port model) holding the same fitted arrays."""
    cfg = dict(EXPLICIT[case])
    side = cfg.pop("side", False)
    rng = np.random.default_rng(seed)
    ku, ki, km = (cfg.get(key, 0) for key in ("k_user", "k_item", "k_main"))
    jm = cmfrec_tpu.CMF(k=K, lambda_=LAMBDA, w_main=1.3, w_user=0.8,
                        w_implicit=0.6, **cfg)
    jm._reset()
    jm.dtype_ = np.dtype(np.float64)
    arrays = dict(
        A=_f32(rng, M, ku + K + km, scale=0.5),
        B=_f32(rng, N, ki + K + km, scale=0.5),
        user_bias=(_f32(rng, M, scale=0.3)
                   if cfg.get("user_bias", True) else None),
        item_bias=(_f32(rng, N, scale=0.3)
                   if cfg.get("item_bias", True) else None),
        glob_mean=3.25,
        C=_f32(rng, P, ku + K, scale=0.4) if side else None,
        U_colmeans=rng.normal(size=P) if side else None,
        Bi=(_f32(rng, N, K, scale=0.3)
            if cfg.get("add_implicit_features") else None),
    )
    for key in ("A", "B", "user_bias", "item_bias", "C", "Bi"):
        v = arrays[key]
        setattr(jm, key + "_", None if v is None else v.astype(np.float64))
    jm.U_colmeans_ = arrays["U_colmeans"]
    jm.glob_mean_ = arrays["glob_mean"]
    if cfg.get("scale_bias_const"):
        jm.scaling_biasA_, jm.scaling_biasB_ = 2.5, 3.5
    jm.is_fitted_ = True
    tm = cmf_from_arrays(**arrays, params=jm.get_params(),
                         scaling_biasA=jm.scaling_biasA_,
                         scaling_biasB=jm.scaling_biasB_, device="cpu")
    if precompute:
        jm.force_precompute_for_predictions()
        tm.force_precompute_for_predictions()
    return jm, tm


def carried_implicit(side=False, seed=0, precompute=True, **kw):
    rng = np.random.default_rng(seed)
    jm = cmfrec_tpu.CMF_implicit(k=K, lambda_=LAMBDA, alpha=2.0,
                                 w_main=1.1, w_user=0.7, **kw)
    jm._reset()
    jm.dtype_ = np.dtype(np.float64)
    arrays = dict(A=_f32(rng, M, K, scale=0.5), B=_f32(rng, N, K, scale=0.5),
                  C=_f32(rng, P, K, scale=0.4) if side else None,
                  U_colmeans=rng.normal(size=P) if side else None)
    jm.A_, jm.B_ = (arrays[key].astype(np.float64) for key in "AB")
    jm.C_ = None if arrays["C"] is None else arrays["C"].astype(np.float64)
    jm.U_colmeans_ = arrays["U_colmeans"]
    jm.w_main_multiplier_ = 0.75
    jm.is_fitted_ = True
    tm = cmf_from_arrays(**arrays, params=jm.get_params(),
                         w_main_multiplier=0.75, cls=CMF_implicit,
                         device="cpu")
    if precompute:
        jm.force_precompute_for_predictions()
        tm.force_precompute_for_predictions()
    return jm, tm


def new_rows(seed=1, R=12, full=False, zero=2, weights=False):
    """Padded new-user rows: R users, the first ``zero`` with no
    observations; with ``full`` every user observes every item."""
    rng = np.random.default_rng(seed)
    if full:
        idx = np.broadcast_to(np.arange(N), (R, N)).copy()
        lens = np.full(R, N)
        vals = 3.0 + rng.normal(size=(R, N))
    else:
        deg = rng.integers(1, N // 2, R)
        deg[:zero] = 0
        rows = np.repeat(np.arange(R), deg)
        cols = np.concatenate([rng.choice(N, d, replace=False) for d in deg])
        idx, vals, _, lens = warm.pack_padded_rows(
            rows, cols, 3.0 + rng.normal(size=rows.size), None, R)
    wgt = rng.uniform(0.5, 2.0, size=idx.shape) if weights else None
    return idx, vals, wgt, lens


def side_rows(seed=2, R=12, nan=True):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(R, P))
    if nan:
        U[rng.uniform(size=U.shape) < 0.3] = np.nan
    return U


def close(port, ref, tol=TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    top = max(np.abs(ref).max(), 1e-30)
    err = np.abs(port - ref).max() / top
    assert err <= tol, f"{err:.3e} of max|ref| {top:.3e} (tol {tol:.0e})"


# ----------------------------------------------------------------------- #
# the precompute                                                           #
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("case", list(EXPLICIT) + ["implicit",
                                                   "implicit_side"])
def test_build_precomputed_key_by_key(case):
    if case.startswith("implicit"):
        jm, tm = carried_implicit(side=case == "implicit_side")
    else:
        jm, tm = carried(case)
    jpre, tpre = jm._precomputed, tm._precomputed
    assert set(jpre) <= set(tpre), set(jpre) - set(tpre)
    for key, ref in jpre.items():
        if isinstance(ref, np.ndarray):
            close(tpre[key], ref, PRE_TOL)
        else:
            assert tpre[key] == ref, key
    # the lazy TransBtBinvBt, built on first use in both
    if "TransBtBinvBt_G" in jpre:
        close(warm._trans_btb_inv_bt(tm), jwarm._trans_btb_inv_bt(jm),
              PRE_TOL * 100)


def test_fit_builds_the_precompute():
    """Repair: CMF.fit and CMF_implicit.fit build the prediction caches
    when precompute_for_predictions is set, as cmfrec_tpu's fits do."""
    rng = np.random.default_rng(3)
    rows, cols = np.nonzero(rng.uniform(size=(40, 30)) < 0.3)
    vals = 1.0 + rng.poisson(2.0, rows.size)
    for cls in (CMF, CMF_implicit):
        model = cls(k=3, niter=2, device="cpu").fit_triplets(
            rows, cols, vals, 40, 30)
        assert {"extB", "BtB", "BtBw"} <= set(model._precomputed)
        assert warm.precomputed(model) is model._precomputed
        cold = cls(k=3, niter=2, precompute_for_predictions=False,
                   device="cpu").fit_triplets(rows, cols, vals, 40, 30)
        assert cold._precomputed == {}


# ----------------------------------------------------------------------- #
# explicit                                                                 #
# ----------------------------------------------------------------------- #

# (model case, inputs, the port's branch, cmfrec_tpu's branch): which cached
# or fused branch each case must take (None: the eager Cholesky)
BRANCHES = [
    ("plain", "warm", "warm_fused", "warm_fused"),
    ("no_bias", "warm", "warm_fused", "warm_fused"),
    ("scale_lam", "warm", "warm_fused", None),  # F1: the port's gate admits it
    ("plain", "weighted", None, None),
    ("scale_lam", "weighted", None, None),
    ("plain", "dense", "warm_dense_matmul", "warm_dense_matmul"),
    ("na0", "warm", "na0_base", "na0_base"),
    ("na0", "weighted", "na0_base", "na0_base"),
    ("implicit_features", "warm", "bitbi", "bitbi"),
    ("implicit_features", "cold", "bitbi", "bitbi"),
    ("side", "warm_U", None, None),
    ("side", "cold", "cold_matmul", "cold_matmul"),
    ("side", "cold_nan", None, None),
    ("side", "full_U", "bechol", "bechol"),
    ("side_na0u", "warm_U", "ctcw", "ctcw"),
    # a scaled full row's multiplier is the cache's: the port's gate admits
    # it, cmfrec_tpu's takes the Cholesky path to the same factors
    ("scale_side", "full_U", "bechol", None),
    ("scale_lam_side", "full_U", "bechol", None),
    ("scale_lam_side", "warm_U", None, None),
    ("scale_side", "warm_U", None, None),
    ("scale_side", "cold", "cold_matmul", "cold_matmul"),
    ("k_user_main", "warm_U", None, None),
    ("k_user_main", "cold", "cold_matmul", "cold_matmul"),
]


def _inputs(kind):
    """(idx, vals, wgt, lengths, U) of a branch case."""
    if kind in ("cold", "cold_nan"):
        R = 12
        return (np.zeros((R, 0), np.int64), np.zeros((R, 0)), None,
                np.zeros(R, np.int64), side_rows(nan=kind == "cold_nan"))
    idx, vals, wgt, lens = new_rows(full=kind in ("dense", "full_U"),
                                    weights=kind == "weighted")
    U = (side_rows(nan=kind == "warm_U") if kind in ("warm_U", "full_U")
         else None)
    return idx, vals, wgt, lens, U


@pytest.mark.parametrize("case,kind,branch,jax_branch", BRANCHES,
                         ids=[f"{c}-{k}" for c, k, _, _ in BRANCHES])
def test_explicit_batch_branches(case, kind, branch, jax_branch):
    jm, tm = carried(case)
    idx, vals, wgt, lens, U = _inputs(kind)
    a_j, b_j = jwarm.factors_explicit_batch(jm, idx, vals, wgt, lens, U=U)
    a_t, b_t = warm.factors_explicit_batch(tm, idx, vals, wgt, lens, U=U)
    close(a_t, a_j)
    close(b_t, b_j)
    stats = tm.__dict__.get("_cache_stats", {})
    jstats = jm.__dict__.get("_cache_stats", {})
    assert (list(stats) == [branch] if branch else not stats), stats
    assert (jax_branch in jstats) if jax_branch else not (
        set(jstats) & {"warm_fused", "warm_dense_matmul", "bechol",
                       "cold_matmul"}), jstats
    # the same call on the uncached branches
    _, t0 = carried(case, precompute=False)
    a_0, b_0 = warm.factors_explicit_batch(t0, idx, vals, wgt, lens, U=U)
    close(a_0, a_j)
    close(b_0, b_j)


@pytest.mark.parametrize("case", ["plain", "no_bias", "scale_lam"])
def test_fused_matches_eager(case):
    _, tm = carried(case)
    idx, vals, _, lens = new_rows(seed=5, R=20, zero=3)
    fused = warm.factors_explicit_batch(tm, idx, vals, None, lens)
    eager = warm.factors_explicit_batch(tm, idx, vals, None, lens,
                                        _no_fused=True)
    assert tm._cache_stats == {"warm_fused": 1}
    for f, e in zip(fused, eager):
        close(f, e, 1e-6)


def test_scale_bias_const_matches_the_numpy_oracle():
    """F1 for the port: the case of cmfrec_tpu's
    test_warm_factors_scale_bias_const (tests/test_models_api.py), carried
    into the port, in f32 on the fused path, against the direct NumPy solve
    with the constant bias penalty and against cmfrec_tpu's eager path."""
    rng = np.random.default_rng(0)  # that test's ``rng`` fixture
    m, n, k = 60, 40, 4
    rows = rng.integers(0, m, 900)
    cols = rng.integers(0, n, 900)
    vals = np.round(2 * (rng.normal(size=900) + 3.0)) / 2
    jm = cmfrec_tpu.CMF(k=k, lambda_=2.0, niter=4, scale_lam=True,
                        scale_bias_const=True, use_float=False).fit_triplets(
        rows, cols, vals, m, n)
    tm = cmf_from_arrays(A=jm.A_, B=jm.B_, user_bias=jm.user_bias_,
                         item_bias=jm.item_bias_, glob_mean=jm.glob_mean_,
                         params=jm.get_params(),
                         scaling_biasA=jm.scaling_biasA_,
                         scaling_biasB=jm.scaling_biasB_, device="cpu")
    assert tm.scale_bias_const and tm.scaling_biasA_ == 900 / m
    obs = np.arange(0, n, 3, dtype=np.int64)
    xv = np.linspace(1.0, 5.0, obs.size)
    B = tm.B_.astype(np.float64)
    Be = np.concatenate([B[obs], np.ones((obs.size, 1))], axis=1)
    lam_diag = np.full(k + 1, 2.0 * obs.size)
    lam_diag[k] = 2.0 * tm.scaling_biasA_
    rhs = Be.T @ (xv - tm.glob_mean_ - tm.item_bias_.astype(np.float64)[obs])
    sol = np.linalg.solve(Be.T @ Be + np.diag(lam_diag), rhs)
    a, bias = warm.factors_explicit_batch(tm, obs[None], xv[None], None,
                                          np.array([obs.size]))
    assert tm._cache_stats == {"warm_fused": 1}
    # f32 solve of a 5 x 5 system whose factors are ~1e-6 and bias ~3e-3:
    # readings <= 3.1e-6
    close(a[0], sol[:k], 1e-5)
    close(bias, sol[k:], 1e-5)
    a_j, b_j = jwarm.factors_explicit_batch(jm, obs[None], xv[None], None,
                                            np.array([obs.size]),
                                            _no_fused=True)
    close(a, a_j, 1e-5)
    close(bias, b_j, 1e-5)


@pytest.mark.parametrize("case", ["plain", "na0", "implicit_features",
                                  "side"])
def test_grouped_matches_ungrouped(case):
    """Degree-grouped factors are row for row those of the ungrouped call,
    to f32 rounding: the groups pad each row to another width than the
    ungrouped batch does, and a batched product of another width sums in
    another order (readings <= 2.3e-7 of max|a|)."""
    _, tm = carried(case)
    rng = np.random.default_rng(7)
    R = 300
    deg = np.minimum((rng.pareto(1.0, R) * 3).astype(np.int64), N)
    deg[:5] = 0
    rows = np.repeat(np.arange(R), deg)
    cols = np.concatenate([rng.choice(N, d, replace=False) for d in deg])
    vals = 3.0 + rng.normal(size=rows.size)
    wgt = rng.uniform(0.5, 2.0, rows.size) if case == "na0" else None
    U = side_rows(R=R) if case == "side" else None
    idx, vv, ww, lens = warm.pack_padded_rows(rows, cols, vals, wgt, R)
    a1, b1 = warm.factors_explicit_batch(tm, idx, vv, ww, lens, U=U)
    a2, b2 = warm.factors_explicit_grouped(tm, rows, cols, vals, wgt, R, U=U,
                                           row_block=16)
    close(a2, a1, 1e-6)
    close(b2, b1, 1e-6)
    if case == "plain":
        assert not a2[:5].any() and not b2[:5].any()


def test_zero_degree_rows_are_zero():
    """Rows with no data anywhere solve to zeros (the reference's
    zero_out), on every route; with side info they get a cold solve."""
    for case in ("plain", "scale_lam", "no_bias"):
        _, tm = carried(case)
        idx, vals, _, lens = new_rows(zero=4)
        for nf in (False, True):
            a, b = warm.factors_explicit_batch(tm, idx, vals, None, lens,
                                               _no_fused=nf)
            assert not a[:4].any() and not b[:4].any()
            assert np.abs(a[4:]).min(axis=1).all()
    jm, tm = carried("side")
    idx, vals, _, lens = new_rows(zero=4)
    U = side_rows()
    a, _ = warm.factors_explicit_batch(tm, idx, vals, None, lens, U=U)
    close(a, jwarm.factors_explicit_batch(jm, idx, vals, None, lens, U=U)[0])
    assert np.abs(a[:4]).max() > 0


# ----------------------------------------------------------------------- #
# implicit                                                                 #
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("side", [False, True])
@pytest.mark.parametrize("precompute", [False, True])
def test_implicit_batch(side, precompute):
    jm, tm = carried_implicit(side=side, precompute=precompute)
    idx, vals, _, lens = new_rows(seed=9, zero=2)
    vals = np.abs(vals) + 0.5
    U = side_rows(R=idx.shape[0]) if side else None
    a_j = jwarm.factors_implicit_batch(jm, idx, vals, lens, U=U)
    a_t = warm.factors_implicit_batch(tm, idx, vals, lens, U=U)
    close(a_t, a_j)
    stats = tm.__dict__.get("_cache_stats", {})
    assert ("warm_fused_implicit" in stats) == (not side)
    assert ("implicit_gram" in stats) == precompute
    if not side:
        assert not a_t[:2].any()
        eager = warm.factors_implicit_batch(tm, idx, vals, lens,
                                            _no_fused=True)
        close(a_t, eager, 1e-6)
    else:
        assert np.abs(a_t[:2]).max() > 0  # side info still solves them
    a_g = warm.factors_implicit_grouped(
        tm, np.repeat(np.arange(len(lens)), lens),
        idx[np.arange(idx.shape[1])[None, :] < lens[:, None]],
        vals[np.arange(idx.shape[1])[None, :] < lens[:, None]], len(lens),
        U=U, row_block=4)
    close(a_g, a_t, 1e-6)


@pytest.mark.parametrize("na0_user", [False, True])
def test_cold_implicit(na0_user):
    jm, tm = carried_implicit(side=True, NA_as_zero_user=na0_user)
    U = side_rows(R=9)
    close(warm.factors_cold_implicit(tm, U), jwarm.factors_cold_implicit(jm, U))


# ----------------------------------------------------------------------- #
# caches, failures and rejections                                          #
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("precompute", [False, True])
def test_new_B_invalidates_the_device_copy(precompute):
    """F3: the device copy is keyed on the identity of the model's array,
    so a new B_ of the same shape (and the precompute built from the old
    one) is not served."""
    jm, tm = carried("plain", precompute=precompute)
    idx, vals, _, lens = new_rows()
    warm.factors_explicit_batch(tm, idx, vals, None, lens)
    old = tm._device_cache["warm:extB"][2]
    newB = (tm.B_ * 1.5).astype(np.float32)
    tm.B_ = newB
    jm.B_ = newB.astype(np.float64)
    jm._precomputed = {}
    a_t, _ = warm.factors_explicit_batch(tm, idx, vals, None, lens)
    assert tm._device_cache["warm:extB"][2] is not old
    assert warm.precomputed(tm) == {}
    close(a_t, jwarm.factors_explicit_batch(jm, idx, vals, None, lens)[0])
    # the same array again: the cached copy is reused
    cached = tm._device_cache["warm:extB"][2]
    warm.factors_explicit_batch(tm, idx, vals, None, lens)
    assert tm._device_cache["warm:extB"][2] is cached


def test_failed_factorization_raises():
    """A system that is not positive definite raises; it is not solved
    some other way."""
    _, tm = carried("plain", precompute=False)
    tm.lambda_ = -50.0  # past the constructor's check: an indefinite G
    idx, vals, _, lens = new_rows(zero=0)
    for nf in (False, True):
        with pytest.raises(torch.linalg.LinAlgError, match="not positive"):
            warm.factors_explicit_batch(tm, idx, vals, None, lens,
                                        _no_fused=nf)
    rows = np.repeat(np.arange(len(lens)), lens)
    cols = idx[np.arange(idx.shape[1])[None, :] < lens[:, None]]
    with pytest.raises(torch.linalg.LinAlgError):
        warm.factors_explicit_grouped(tm, rows, cols, np.ones(rows.size),
                                      None, len(lens))


@pytest.mark.parametrize("kw", [dict(nonneg=True), dict(l1_lambda=0.1)],
                         ids=["nonneg", "l1_lambda"])
@pytest.mark.parametrize("implicit", [False, True])
def test_coordinate_descent_options_raise(kw, implicit):
    """A model loaded from a cmfrec_tpu checkpoint may carry nonneg or
    l1_lambda; their solves need rowsolve.solve_cd."""
    _, tm = (carried_implicit(precompute=False) if implicit
             else carried("plain", precompute=False))
    for key, v in kw.items():
        setattr(tm, key, v)
    idx, vals, _, lens = new_rows()
    with pytest.raises(ValueError, match="slice 4 item 10"):
        if implicit:
            warm.factors_implicit_batch(tm, idx, vals, lens)
        else:
            warm.factors_explicit_batch(tm, idx, vals, None, lens)


def test_binary_side_info_raises():
    """A model fit without binary side info raises on U_bin, with
    cmfrec_tpu's message; predict_new takes I_bin and, as cmfrec_tpu,
    does not use it."""
    jm, tm = carried("side")
    for model in (jm, tm):
        for call in (lambda: model.factors_warm(X_col=[0], X_val=[3.0],
                                                U_bin=np.ones(3)),
                     lambda: model.factors_cold(U=np.ones(P),
                                                U_bin=np.ones(3)),
                     lambda: model.factors_multiple(U=np.ones((2, P)),
                                                    U_bin=np.ones((2, 3)))):
            with pytest.raises(ValueError,
                               match="fit without binary user side info"):
                call()
    np.testing.assert_array_equal(
        tm.predict_new(0, I=np.ones(P), I_bin=np.ones(3)),
        tm.predict_new(0, I=np.ones(P)))
