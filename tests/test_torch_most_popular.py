"""cmfrec_torch.MostPopular against cmfrec_tpu.MostPopular on the same
inputs: the fitted biases and the global mean within 1e-12 (both sum in
float64; the port on the model's device), predict and topN the same,
save/load both ways, and the constructor's checks."""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

import cmfrec_torch
import cmfrec_tpu
from cmfrec_torch.convert import model_from_arrays

M, N = 60, 45


def _data(seed=0, weights=False):
    rng = np.random.default_rng(seed)
    rows, cols = np.nonzero(rng.uniform(size=(M, N)) < 0.3)
    vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
    W = rng.uniform(0.5, 2.0, size=rows.size) if weights else None
    X = sp.coo_matrix((vals, (rows, cols)), shape=(M, N))
    return X, W


CASES = {
    "plain": dict(),
    "uncentered": dict(center=False),
    "user_bias": dict(user_bias=True),
    "scale_lam": dict(user_bias=True, scale_lam=True),
    "scale_bias_const": dict(user_bias=True, scale_lam=True,
                             scale_bias_const=True),
    "item_scale_lam": dict(scale_lam=True, lambda_=0.5),
    "lambda6": dict(user_bias=True, lambda_=[1.0, 3.0, 0, 0, 0, 0]),
    "na_as_zero": dict(NA_as_zero=True),
    "na_as_zero_user_bias": dict(NA_as_zero=True, user_bias=True),
    "weights": dict(user_bias=True, weights=True),
    "weights_item_only": dict(weights=True, lambda_=2.0),
    "na_as_zero_weights": dict(NA_as_zero=True, user_bias=True,
                               weights=True, scale_lam=True),
    "implicit": dict(implicit=True, alpha=2.0),
    "implicit_log": dict(implicit=True, apply_log_transf=True),
}


def _pair(case, seed=0):
    kw = dict(CASES[case])
    X, W = _data(seed, weights=kw.pop("weights", False))
    if kw.get("implicit"):
        X = sp.coo_matrix((np.abs(X.data) + 1.0, (X.row, X.col)),
                          shape=X.shape)
    jm = cmfrec_tpu.MostPopular(**kw).fit(X, W=W)
    tm = cmfrec_torch.MostPopular(**kw, device="cpu").fit(X, W=W)
    return jm, tm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_matches_cmfrec_tpu(case):
    jm, tm = _pair(case)
    assert tm.item_bias_.dtype == np.float64
    assert _rel(tm.item_bias_, jm.item_bias_) <= 1e-12
    if jm.user_bias_ is None:
        assert tm.user_bias_ is None
    else:
        assert _rel(tm.user_bias_, jm.user_bias_) <= 1e-12
    assert tm.glob_mean_ == pytest.approx(jm.glob_mean_, rel=1e-12, abs=0)
    assert tm.A_.shape == (M, 0) and tm.B_.shape == (N, 0)


@pytest.mark.parametrize("case", ["plain", "user_bias", "implicit"])
def test_predict_and_topn_match(case):
    jm, tm = _pair(case, seed=1)
    users, items = np.arange(20) % M, (np.arange(20) * 7) % N
    np.testing.assert_allclose(tm.predict(users, items),
                               jm.predict(users, items), rtol=1e-12, atol=0)
    assert isinstance(tm.predict(3, 4), float)
    assert tm.predict(3, 4) == pytest.approx(jm.predict(3, 4), rel=1e-12)
    some = np.arange(0, N, 3)
    for extra in ({}, {"include": some}, {"exclude": some}):
        got = tm.topN(2, n=6, output_score=True, **extra)
        want = jm.topN(2, n=6, output_score=True, **extra)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-12, atol=0)
        np.testing.assert_array_equal(tm.topN(n=6, **extra),
                                      jm.topN(n=6, **extra))


def test_dataframe_ids():
    X, _ = _data(2)
    df = pd.DataFrame({"UserId": [f"u{r}" for r in X.row],
                       "ItemId": X.col + 100, "Rating": X.data})
    jm = cmfrec_tpu.MostPopular(user_bias=True).fit(df)
    tm = cmfrec_torch.MostPopular(user_bias=True, device="cpu").fit(df)
    users = np.asarray(jm.user_mapping_)[:5]
    items = np.asarray(jm.item_mapping_)[:5]
    np.testing.assert_allclose(tm.predict(users, items),
                               jm.predict(users, items), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(tm.topN(n=4), jm.topN(n=4))


@pytest.mark.parametrize("case", ["user_bias", "implicit"])
def test_save_load_both_ways(case, tmp_path):
    jm, tm = _pair(case, seed=3)
    users, items = np.arange(10), np.arange(10)
    for src, pkg in ((jm, cmfrec_torch), (tm, cmfrec_tpu)):
        path = str(tmp_path / f"mp_{pkg.__name__}.npz")
        src.save(path)
        extra = {"device": "cpu"} if pkg is cmfrec_torch else {}
        dst = pkg.MostPopular.load(path, **extra)
        assert dst.implicit == src.implicit
        np.testing.assert_array_equal(dst.item_bias_, src.item_bias_)
        np.testing.assert_array_equal(np.asarray(dst.predict(users, items)),
                                      np.asarray(src.predict(users, items)))
    arrays = {name: getattr(jm, name, None)
              for name in ("A_", "B_", "user_bias_", "item_bias_")}
    conv = model_from_arrays(cmfrec_torch.MostPopular, arrays,
                             params=jm.get_params(), glob_mean=jm.glob_mean_,
                             device="cpu")
    np.testing.assert_array_equal(conv.predict(users, items),
                                  jm.predict(users, items))


def test_constructor_checks_and_the_device():
    with pytest.raises(ValueError, match="scale_lam"):
        cmfrec_torch.MostPopular(implicit=True, scale_lam=True)
    with pytest.raises(ValueError, match="apply_log_transf"):
        cmfrec_torch.MostPopular(implicit=False, apply_log_transf=True)
    assert cmfrec_torch.MostPopular().device == "cuda"
    with pytest.raises(RuntimeError, match="Model is not fitted"):
        cmfrec_torch.MostPopular(device="cpu").predict(0, 0)
