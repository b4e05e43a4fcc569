"""cmfrec_torch.CMF_implicit against cmfrec_tpu.CMF_implicit: both beat
popularity on preference-structured data, a port model carried over from a
JAX one (by arrays, or by the JAX model's .npz) ranks exactly as the JAX
model does, and the options the port does not bring yet raise."""

import numpy as np
import pytest
import scipy.sparse as sp

import cmfrec_torch
import cmfrec_tpu
from cmfrec_torch.convert import cmf_from_arrays
from cmfrec_torch.solvers import drivers


def _preference_data(seed=0, m=240, n=150, k_true=4):
    """The verify notes' implicit recipe: a preference-structured mask
    (prob = sigmoid(A B^T - 1.5)) with play counts; 20% of each user's
    items held out."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, k_true))
    B = rng.normal(size=(n, k_true))
    prob = 1.0 / (1.0 + np.exp(-(A @ B.T - 1.5)))
    rows, cols = np.nonzero(rng.uniform(size=(m, n)) < prob)
    vals = 1.0 + rng.poisson(3.0, rows.size)
    test = rng.uniform(size=rows.size) < 0.2
    return rows, cols, vals, test, m, n


def _p_at_10(A, B, rows, cols, test, m, n):
    """Mean P@10 of the scores A B^T over users with held-out items, train
    items excluded (the model's own ranking: an implicit model has no
    biases)."""
    tr = ~test
    scores = np.asarray(A, np.float64) @ np.asarray(B, np.float64).T
    scores[rows[tr], cols[tr]] = -np.inf
    top = np.argsort(-scores, axis=1, kind="stable")[:, :10]
    hits = []
    for u in range(m):
        held = set(cols[test & (rows == u)])
        if held:
            hits.append(len(held.intersection(top[u])) / min(10, len(held)))
    return float(np.mean(hits))


def test_both_beat_popularity_and_carry_over(tmp_path):
    rows, cols, vals, test, m, n = _preference_data()
    tr = ~test
    kw = dict(k=8, lambda_=1.0, alpha=1.0, niter=8)
    jm = cmfrec_tpu.CMF_implicit(**kw).fit_triplets(
        rows[tr], cols[tr], vals[tr], m, n)
    tm = cmfrec_torch.CMF_implicit(**kw, device="cpu").fit_triplets(
        rows[tr], cols[tr], vals[tr], m, n)
    assert tm.A_.shape == (m, 8) and tm.A_.dtype == np.float32
    assert tm.user_bias_ is None and tm.glob_mean_ == 0.0

    pop = np.bincount(cols[tr], minlength=n).astype(np.float64)
    p_pop = _p_at_10(np.ones((m, 1)), pop[:, None], rows, cols, test, m, n)
    p_jax = _p_at_10(jm.A_, jm.B_, rows, cols, test, m, n)
    p_torch = _p_at_10(tm.A_, tm.B_, rows, cols, test, m, n)
    assert p_jax > 1.2 * p_pop and p_torch > 1.2 * p_pop, (p_jax, p_torch,
                                                           p_pop)
    for u in (0, 1, 2):  # topN agrees with the model's own ranking
        seen = cols[tr & (rows == u)]
        s = tm.A_[u].astype(np.float64) @ tm.B_.T.astype(np.float64)
        s[seen] = -np.inf
        np.testing.assert_array_equal(np.sort(tm.topN(u, n=10, exclude=seen)),
                                      np.sort(np.argsort(-s)[:10]))

    path = str(tmp_path / "jax_implicit.npz")
    jm.save(path)
    carried = [
        cmf_from_arrays(A=jm.A_, B=jm.B_, params=jm.get_params(),
                        w_main_multiplier=jm.w_main_multiplier_,
                        cls=cmfrec_torch.CMF_implicit, device="cpu"),
        cmfrec_torch.CMF_implicit.load(path, device="cpu"),
    ]
    for u in (5, 77, 160):
        seen = cols[tr & (rows == u)]
        want = np.asarray(jm.topN(u, n=10, exclude=seen))
        for port in carried:
            assert isinstance(port, cmfrec_torch.CMF_implicit)
            np.testing.assert_array_equal(port.topN(u, n=10, exclude=seen),
                                          want)
    for port in carried:
        np.testing.assert_allclose(port.predict(rows[:50], cols[:50]),
                                   np.asarray(jm.predict(rows[:50], cols[:50])),
                                   rtol=0, atol=1e-5)


def test_save_load_roundtrip(tmp_path):
    rows, cols, vals, _, m, n = _preference_data(seed=1, m=60, n=40)
    model = cmfrec_torch.CMF_implicit(k=4, niter=2, device="cpu")
    model.fit_triplets(rows, cols, vals, m, n)
    path = str(tmp_path / "torch_implicit.npz")
    model.save(path)
    again = cmfrec_torch.CMF_implicit.load(path, device="cpu")
    assert again.get_params() == model.get_params()
    np.testing.assert_array_equal(again.topN(3, n=5), model.topN(3, n=5))
    jm = cmfrec_tpu.CMF_implicit.load(path)
    np.testing.assert_array_equal(np.asarray(jm.topN(3, n=5)),
                                  model.topN(3, n=5))


_SMALL = _preference_data(seed=2, m=30, n=20)


# dense side info fits now, through the dense-masked engine (ROADMAP slice
# 3); k_user through the bucketed collective route; Jacobi PCG and float64
# (ROADMAP slice 1 item 1) through the bucketed engine's plain solves,
# matching cmfrec_tpu from one init=
DENSE = "runs on the dense engine"
COLLECTIVE = "runs on the bucketed collective route"
PLAIN = "runs the bucketed engine's plain solves as cmfrec_tpu"
CD = "runs coordinate descent as cmfrec_tpu"
# a mesh= that is not a 1-D DeviceMesh raises a TypeError naming it
# (data-parallel mesh= is ROADMAP slice 7a, tests/test_torch_mesh*.py)
NOT_A_MESH = "DeviceMesh"


def _plain_matches_cmfrec_tpu(call, X, mp, cd=False):
    """``call(X, pkg=, **kw)`` fits a CMF_implicit of ``pkg``: both
    packages' drivers start from one init=, the port's solves never call
    the bucket-CG op (K3's wrapper), and A_/B_ match cmfrec_tpu's in the
    model's dtype: float64 within 1e-8, float32 (Jacobi PCG, or ``cd``:
    nonneg and l1_lambda, whose solves must call the CD op) within 1e-4 of
    max|.|."""
    from cmfrec_torch.ops import coord_descent, sparse_cg
    from cmfrec_tpu.solvers import drivers as jdrivers

    m, n = X.shape
    rng = np.random.default_rng(0)
    init = {"A": 0.3 * rng.normal(size=(m, 50)),
            "B": 0.3 * rng.normal(size=(n, 50))}
    for mod in (drivers, jdrivers):
        real = mod.fit_implicit_als
        mp.setattr(mod, "fit_implicit_als",
                   lambda *a, _r=real, **kw: _r(*a, **{**kw, "init": init}))
    k3, cd_calls = [], []
    real_k3, real_cd = sparse_cg.bucket_cg, coord_descent.solve_cd
    mp.setattr(sparse_cg, "bucket_cg",
               lambda *a, **kw: k3.append(1) or real_k3(*a, **kw))
    mp.setattr(coord_descent, "solve_cd",
               lambda *a, **kw: cd_calls.append(1) or real_cd(*a, **kw))
    got = call(X, device="cpu")
    want = call(X, pkg=cmfrec_tpu)
    assert not k3 and bool(cd_calls) == cd
    if got.nonneg:
        assert got.A_.min() >= 0.0 and got.B_.min() >= 0.0
    tol = 1e-8 if got.dtype_ == np.float64 else 1e-4
    for attr in ("A_", "B_"):
        g, w = getattr(got, attr), np.asarray(getattr(want, attr))
        assert g.dtype == got.dtype_, attr
        assert np.abs(g - w).max() <= tol * np.abs(w).max(), attr


@pytest.mark.parametrize("call,match", [
    (lambda X: cmfrec_torch.CMF_implicit(device="cpu").fit(
        X, U=np.ones((30, 2))), DENSE),
    (lambda X: cmfrec_torch.CMF_implicit(device="cpu").fit(
        X, I=np.ones((20, 2))), DENSE),
    (lambda X: cmfrec_torch.CMF_implicit(k_user=2, device="cpu").fit(X),
     COLLECTIVE),
    # nonneg and l1_lambda (ROADMAP slice 4 item 10) fit by coordinate
    # descent, as cmfrec_tpu
    (lambda X, pkg=cmfrec_torch, **kw: pkg.CMF_implicit(
        nonneg=True, niter=3, **kw).fit(X), CD),
    (lambda X, pkg=cmfrec_torch, **kw: pkg.CMF_implicit(
        l1_lambda=0.1, niter=3, **kw).fit(X), CD),
    (lambda X, pkg=cmfrec_torch, **kw: pkg.CMF_implicit(
        precondition_cg=True, **kw).fit(X), PLAIN),
    (lambda X, pkg=cmfrec_torch, **kw: pkg.CMF_implicit(
        use_float=False, **kw).fit(X), PLAIN),
    (lambda X: cmfrec_torch.CMF_implicit(device="cpu").fit(X, mesh=object()),
     NOT_A_MESH),
    (lambda X: cmfrec_torch.CMF_implicit(alpha=0.0, device="cpu"),
     "'alpha' must be positive"),
    (lambda X: cmfrec_torch.CMF_implicit(
        apply_log_transf=True, device="cpu").fit(
            sp.coo_matrix((np.zeros(X.nnz), (X.row, X.col)), shape=X.shape)),
     "apply_log_transf"),
], ids=["U", "I", "k_user", "nonneg", "l1_lambda", "precondition_cg",
        "float64", "mesh", "alpha", "log_of_zero"])
def test_out_of_slice_options_raise(call, match, monkeypatch):
    rows, cols, vals, _, m, n = _SMALL
    X = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    if match in (PLAIN, CD):
        _plain_matches_cmfrec_tpu(call, X, monkeypatch, cd=match == CD)
        return
    if match not in (DENSE, COLLECTIVE):
        with pytest.raises(TypeError if match == NOT_A_MESH else ValueError,
                           match=match):
            call(X)
        return
    from cmfrec_torch.solvers import collective

    built, routed = [], []
    real = drivers._build_pair
    monkeypatch.setattr(drivers, "_build_pair",
                        lambda *a: built.append(a) or real(*a))
    real_collective = collective._fit_collective_implicit_bucketed
    monkeypatch.setattr(collective, "_fit_collective_implicit_bucketed",
                        lambda *a, **kw: routed.append(a)
                        or real_collective(*a, **kw))
    model = call(X)
    assert len(routed) == (1 if match == COLLECTIVE else 0)
    width = 52 if match == COLLECTIVE else 50
    assert not built and model.A_.shape == (m, width)
    assert np.isfinite(model.A_).all() and np.isfinite(model.B_).all()


@pytest.mark.parametrize("fmt", ["ndarray", "dataframe"])
def test_side_info_surfaces(fmt, tmp_path):
    """CMF_implicit with dense side info: U=/I= as arrays or as DataFrames
    keyed by UserId/ItemId give the same fit, on the dense engine; the
    column means are cmfrec_tpu's exactly, and a cmfrec_tpu collective
    implicit model's .npz loads into the port whole."""
    rows, cols, vals, test, m, n = _preference_data(seed=3, m=80, n=50)
    rng = np.random.default_rng(3)
    U, I = rng.normal(size=(m, 3)) + 1.0, rng.normal(size=(n, 2))
    kw = dict(k=4, lambda_=1.0, niter=3)
    X = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    ref = cmfrec_torch.CMF_implicit(**kw, device="cpu").fit(X, U=U, I=I)
    assert ref.C_.shape == (3, 4) and ref.D_.shape == (2, 4)
    jm = cmfrec_tpu.CMF_implicit(**kw).fit(X, U=U, I=I)
    for attr in ("U_colmeans_", "I_colmeans_"):
        np.testing.assert_array_equal(getattr(ref, attr), getattr(jm, attr))
    if fmt == "ndarray":
        path = str(tmp_path / "jax_collective_implicit.npz")
        jm.save(path)
        port = cmfrec_torch.CMF_implicit.load(path, device="cpu")
        for attr in ("A_", "B_", "C_", "D_", "U_colmeans_", "I_colmeans_"):
            np.testing.assert_array_equal(getattr(port, attr),
                                          np.asarray(getattr(jm, attr)))
        np.testing.assert_array_equal(port.topN(4, n=5),
                                      np.asarray(jm.topN(4, n=5)))
        return
    import pandas as pd

    # DataFrame ids are reindexed in first-appearance order: the fit equals
    # the positional fit on those codes
    ucodes, umap = pd.factorize(rows + 1000)
    icodes, imap = pd.factorize(cols + 2000)
    want = cmfrec_torch.CMF_implicit(**kw, device="cpu").fit(
        sp.coo_matrix((vals, (ucodes, icodes)), shape=(m, n)),
        U=U[np.asarray(umap) - 1000], I=I[np.asarray(imap) - 2000])
    order = rng.permutation(m)
    Udf = pd.DataFrame(U[order], columns=["a", "b", "c"])
    Udf.insert(0, "UserId", order + 1000)
    Idf = pd.DataFrame(I[::-1], columns=["d", "e"])
    Idf.insert(0, "ItemId", np.arange(n)[::-1] + 2000)
    got = cmfrec_torch.CMF_implicit(**kw, device="cpu").fit(
        pd.DataFrame({"UserId": rows + 1000, "ItemId": cols + 2000,
                      "Value": vals}), U=Udf, I=Idf)
    np.testing.assert_array_equal(got.C_, want.C_)
    np.testing.assert_array_equal(got.A_, want.A_)
