"""cmfrec_torch.CMF's fit/predict/topN/save/load surface against
cmfrec_tpu.CMF on the same inputs, plus the slice's rejections."""

import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import cmfrec_torch
import cmfrec_tpu
from cmfrec_torch.convert import cmf_from_arrays
from cmfrec_torch.solvers import drivers, lbfgs


def _recipe_data():
    """The drive recipe of the repo's verification notes (verify/SKILL.md)."""
    rng = np.random.default_rng(0)
    m, n, k_true = 2000, 500, 8
    A = rng.normal(size=(m, k_true))
    B = rng.normal(size=(n, k_true))
    full = 3.5 + 0.7 * A @ B.T
    rows, cols = np.nonzero(rng.uniform(size=(m, n)) < 0.06)
    vals = full[rows, cols] + 0.3 * rng.normal(size=rows.size)
    test = rng.uniform(size=rows.size) < 0.15
    return rows, cols, vals, test, m, n


def _rmse(model, rows, cols, vals):
    return float(np.sqrt(np.mean((model.predict(rows, cols) - vals) ** 2)))


# At the recipe's 10 iterations truncated CG(3) is still moving and the fit
# depends on the random init (seed-to-seed spread ~2% in both packages), so
# the CG case runs 25 iterations, where both have settled; exact mode
# settles within the recipe's 10.
@pytest.mark.parametrize("kw", [dict(niter=25), dict(niter=10, use_cg=False)],
                         ids=["cg", "exact"])
def test_drive_recipe_matches_jax(kw):
    rows, cols, vals, test, m, n = _recipe_data()
    tr = ~test
    fitted = [
        pkg.CMF(k=30, lambda_=2.0, **kw, **extra).fit_triplets(
            rows[tr], cols[tr], vals[tr], m, n)
        for pkg, extra in ((cmfrec_tpu, {}), (cmfrec_torch, {"device": "cpu"}))
    ]
    base = float(np.sqrt(np.mean((vals[tr].mean() - vals[test]) ** 2)))
    rj, rt = (_rmse(f, rows[test], cols[test], vals[test]) for f in fitted)
    assert rt < 0.75 * base and rj < 0.75 * base
    assert abs(rt - rj) / rj < 0.03, (rt, rj)
    assert fitted[1].A_.shape == (m, 30) and fitted[1].A_.dtype == np.float32


@pytest.fixture(scope="module")
def jax_model():
    """A cmfrec_tpu CMF fitted on a DataFrame with non-positional ids."""
    rng = np.random.default_rng(4)
    m, n = 120, 80
    rows, cols = np.nonzero(rng.uniform(size=(m, n)) < 0.2)
    vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
    df = pd.DataFrame({"UserId": [f"u{r}" for r in rows],
                       "ItemId": cols + 1000, "Rating": vals})
    return cmfrec_tpu.CMF(k=6, lambda_=1.0, niter=3).fit(df)


def _port_of(jm, how, tmp_path):
    if how == "convert":
        return cmf_from_arrays(
            A=jm.A_, B=jm.B_, user_bias=jm.user_bias_,
            item_bias=jm.item_bias_, glob_mean=jm.glob_mean_,
            user_mapping=jm.user_mapping_, item_mapping=jm.item_mapping_,
            params=jm.get_params(), device="cpu")
    path = str(tmp_path / "jax_model.npz")
    jm.save(path)
    return cmfrec_torch.CMF.load(path, device="cpu")


@pytest.mark.parametrize("how", ["convert", "load"])
def test_same_factors_same_answers(jax_model, how, tmp_path):
    jm = jax_model
    tm = _port_of(jm, how, tmp_path)
    assert tm.is_fitted_ and tm.reindex_
    users = np.asarray(jm.user_mapping_)[:30]
    items = np.asarray(jm.item_mapping_)[np.arange(30) % 50]
    np.testing.assert_allclose(tm.predict(users, items),
                               np.asarray(jm.predict(users, items)),
                               rtol=0, atol=1e-5)
    # unknown ids: mean plus the known bias, as cmfrec_tpu does
    np.testing.assert_allclose(tm.predict(["nobody"], [1000]),
                               np.asarray(jm.predict(["nobody"], [1000])),
                               rtol=0, atol=1e-5)
    some = np.asarray(jm.item_mapping_)[:25]
    for u in users[:5]:
        for extra in ({}, {"include": some}, {"exclude": some}):
            np.testing.assert_array_equal(tm.topN(u, n=7, **extra),
                                          jm.topN(u, n=7, **extra))
        ti, ts = tm.topN(u, n=7, output_score=True)
        ji, js = jm.topN(u, n=7, output_score=True)
        np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=1e-5)


def _small_fit_data(seed=9):
    rng = np.random.default_rng(seed)
    m, n = 90, 60
    rows, cols = np.nonzero(rng.uniform(size=(m, n)) < 0.25)
    vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
    return rows, cols, vals, m, n


def test_save_load_roundtrip_and_params(tmp_path):
    rows, cols, vals, m, n = _small_fit_data()
    model = cmfrec_torch.CMF(k=5, lambda_=[0.5, 0.6, 1.0, 1.1, 0, 0],
                             niter=3, device="cpu")
    params = model.get_params()
    assert params["device"] == "cpu" and params["lambda_"][2] == 1.0
    model.set_params(k=6, niter=2)
    assert model.k == 6
    with pytest.raises(ValueError, match="Invalid parameter"):
        model.set_params(not_a_param=1)
    model.fit_triplets(rows, cols, vals, m, n)
    with pytest.raises(ValueError, match="after the model has been fit"):
        model.set_params(k=3)
    path = str(tmp_path / "torch_model.npz")
    model.save(path)
    again = cmfrec_torch.CMF.load(path, device="cpu")
    assert again.get_params() == model.get_params()
    np.testing.assert_array_equal(again.predict(rows, cols),
                                  model.predict(rows, cols))
    np.testing.assert_array_equal(again.topN(3, n=5), model.topN(3, n=5))
    # and cmfrec_tpu reads the same file
    jm = cmfrec_tpu.CMF.load(path)
    np.testing.assert_allclose(np.asarray(jm.predict(rows, cols)),
                               model.predict(rows, cols), rtol=0, atol=1e-5)


def test_device_factors_uploaded_once_and_follow_new_arrays():
    rows, cols, vals, m, n = _small_fit_data()
    model = cmfrec_torch.CMF(k=4, lambda_=1.0, niter=2, device="cpu")
    model.fit_triplets(rows, cols, vals, m, n)
    first = model.predict(rows, cols)
    B_dev = model._on_device("B_")
    model.topN(0, n=5)
    assert model._on_device("B_") is B_dev  # reused, not uploaded again
    # assigning a new array is seen by the next request
    model.A_ = np.zeros_like(model.A_)
    np.testing.assert_allclose(
        model.predict(rows, cols),
        model.glob_mean_ + model.user_bias_[rows] + model.item_bias_[cols],
        rtol=0, atol=1e-5)
    # a refit drops the old copies
    model.fit_triplets(rows, cols, vals, m, n)
    assert model._on_device("B_") is not B_dev
    np.testing.assert_array_equal(model.predict(rows, cols), first)


@pytest.mark.parametrize("fmt", ["dense_nan", "dataframe"])
def test_input_formats_fit_alike(fmt):
    rows, cols, vals, m, n = _small_fit_data()
    kw = dict(k=4, lambda_=1.0, niter=2, device="cpu")
    if fmt == "dense_nan":
        ref = cmfrec_torch.CMF(**kw).fit(sp.coo_matrix((vals, (rows, cols)),
                                                       shape=(m, n)))
        X = np.full((m, n), np.nan)
        X[rows, cols] = vals
        got = cmfrec_torch.CMF(**kw).fit(X)
        np.testing.assert_array_equal(got.predict(rows, cols),
                                      ref.predict(rows, cols))
    else:
        # DataFrame ids are reindexed in first-appearance order: the fit
        # equals the positional fit on those codes, answered by id
        uid, iid = np.array([f"u{r}" for r in rows]), cols + 500
        ucodes, _ = pd.factorize(uid)
        icodes, _ = pd.factorize(iid)
        ref = cmfrec_torch.CMF(**kw).fit(sp.coo_matrix(
            (vals, (ucodes, icodes)), shape=(ucodes.max() + 1,
                                             icodes.max() + 1)))
        got = cmfrec_torch.CMF(**kw).fit(pd.DataFrame(
            {"UserId": uid, "ItemId": iid, "Rating": vals}))
        assert got.reindex_
        np.testing.assert_array_equal(got.predict(uid, iid),
                                      ref.predict(ucodes, icodes))
        np.testing.assert_array_equal(
            got.topN(uid[0], n=5),
            np.asarray(got.item_mapping_)[ref.topN(ucodes[0], n=5)])


_TRIPLETS = _small_fit_data()


def _fit_beyond_the_device_budget():
    # the budget is the card's free memory; stand in a 1000-byte card
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(drivers, "_dense_budget", lambda dev: 1000)
        return drivers.fit_explicit_als(*_TRIPLETS, device="cpu")


# Cases that earlier slices rejected and the bucketed engine now fits: the
# test asserts that they run, through the bucketed engine (its layout build
# is called), to finite factors.  DENSE: the same through the dense-masked
# engine (no layout build); COLLECTIVE: through the bucketed collective
# route.
BUCKETED = "runs on the bucketed engine"
DENSE = "runs on the dense engine"
COLLECTIVE = "runs on the bucketed collective route"
LBFGS = "runs the L-BFGS fit"


@pytest.mark.parametrize("call,match", [
    # ROADMAP slice 6's case keeps its id: method="lbfgs" fits by L-BFGS
    # (its default maxiter cut to 50 here)
    pytest.param(lambda X: cmfrec_torch.CMF(method="lbfgs", maxiter=50,
                                            device="cpu").fit(X), LBFGS,
                 id="<lambda>-slice 6"),
    # the three cases of ROADMAP slice 2 keep their ids: dense side info and
    # implicit features fit on the dense engine, k_user on the bucketed
    # collective route
    pytest.param(lambda X: cmfrec_torch.CMF(device="cpu").fit(
        X, U=np.ones((90, 2))), DENSE, id="<lambda>-slice 2_0"),
    pytest.param(lambda X: cmfrec_torch.CMF(
        add_implicit_features=True, device="cpu").fit(X), DENSE,
        id="<lambda>-slice 2_1"),
    pytest.param(lambda X: cmfrec_torch.CMF(k_user=2, device="cpu").fit(X),
                 COLLECTIVE, id="<lambda>-slice 2_2"),
    (lambda X: cmfrec_torch.CMF(nonneg=True, center=False,
                                device="cpu").fit(X), "slice 4"),
    (lambda X: cmfrec_torch.CMF(l1_lambda=0.1, device="cpu").fit(X),
     "slice 4"),
    (lambda X: cmfrec_torch.CMF(NA_as_zero=True, device="cpu").fit(
        X, W=np.ones(X.nnz)), BUCKETED),
    (lambda X: cmfrec_torch.CMF(precondition_cg=True, device="cpu").fit(X),
     "slice 1 item 1"),
    (lambda X: cmfrec_torch.CMF(use_float=False, device="cpu").fit(X),
     "slice 1 item 1"),
    (lambda X: drivers.fit_explicit_als(*_TRIPLETS, mesh=object(),
                                        device="cpu"), "slice 7"),
    (lambda X: drivers.fit_explicit_als(*_TRIPLETS, shard_opposing_rows=True,
                                        device="cpu"), "slice 7"),
    (lambda X: drivers.fit_explicit_als(*_TRIPLETS, engine="sparse",
                                        device="cpu"), BUCKETED),
    (lambda X: _fit_beyond_the_device_budget(), BUCKETED),
])
def test_out_of_slice_options_raise(call, match, monkeypatch):
    rows, cols, vals, m, n = _TRIPLETS
    X = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    if match not in (BUCKETED, DENSE, COLLECTIVE, LBFGS):
        with pytest.raises(ValueError, match=match):
            call(X)
        return
    from cmfrec_torch.solvers import collective

    built, routed = [], []
    real = drivers._build_pair
    monkeypatch.setattr(drivers, "_build_pair",
                        lambda *a: built.append(a) or real(*a))
    real_collective = collective._fit_collective_explicit_bucketed
    monkeypatch.setattr(collective, "_fit_collective_explicit_bucketed",
                        lambda *a, **kw: routed.append(a)
                        or real_collective(*a, **kw))
    calls = []
    real_lbfgs = lbfgs.run_lbfgs
    monkeypatch.setattr(lbfgs, "run_lbfgs",
                        lambda *a, **kw: calls.append(a) or real_lbfgs(*a,
                                                                       **kw))
    out = call(X)
    assert len(calls) == (1 if match == LBFGS else 0)
    A = out.A_ if isinstance(out, cmfrec_torch.CMF) else out["A"].numpy()
    assert len(built) == (1 if match == BUCKETED else 0)
    assert len(routed) == (1 if match == COLLECTIVE else 0)
    width = 42 if match == COLLECTIVE else 40
    assert A.shape == (m, width) and np.isfinite(A).all()


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rows, cols, vals, m, n = _small_fit_data()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cmfrec_torch.CMF(k=3, niter=1).fit_triplets(rows, cols, vals, m, n)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drivers.fit_explicit_als(rows, cols, vals, m, n, device="cuda")


def test_import_leaves_jax_out():
    code = ("import sys, cmfrec_torch, cmfrec_torch.convert, "
            "cmfrec_torch.solvers.drivers, cmfrec_torch.solvers.als, "
            "cmfrec_torch.ops.predict, cmfrec_torch.ops.rowsolve, "
            "cmfrec_torch.ops.sparse_cg, cmfrec_torch.data.shards, "
            "cmfrec_torch.data.device_fill; "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'cmfrec_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(__import__("pathlib").Path(
                             __file__).resolve().parents[1]))
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("k,k_pad,engine,raises", [
    (255, 256, "dense", False),
    (256, 320, "dense", True),
    (300, 304, "bucketed", True),
    (256, 256, "bucketed", False),
])
def test_kernel_k_check(k, k_pad, engine, raises):
    """Fault P1: past K=256 the card's kernels have no path; the drivers'
    check raises there, naming the limit and the ROADMAP item, and never on
    the CPU."""
    drivers.check_kernel_k(k, k_pad, engine, torch.device("cpu"))
    if raises:
        with pytest.raises(ValueError, match=r"K <= 256 \(ROADMAP section 2"):
            drivers.check_kernel_k(k, k_pad, engine, torch.device("cuda"))
    else:
        drivers.check_kernel_k(k, k_pad, engine, torch.device("cuda"))


@pytest.mark.parametrize("fit", ["explicit", "implicit"])
def test_kernel_k_check_comes_before_any_upload(fit, monkeypatch):
    """On a card (stood in for here), k=300 raises at the top of the
    driver: no layout build, no dense setup, no upload."""
    monkeypatch.setattr(drivers, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(drivers, "_dense_budget", lambda dev: 1 << 40)

    def no_work(*a, **kw):
        raise AssertionError("the fit went past the check")

    for name in ("_build_pair", "fit_explicit_dense_masked",
                 "_fit_explicit_bucketed", "fit_implicit_dense_masked"):
        monkeypatch.setattr(drivers, name, no_work)
    monkeypatch.setattr(torch.Tensor, "to", no_work)
    monkeypatch.setattr(torch, "as_tensor", no_work)
    rows, cols, vals, m, n = _small_fit_data()
    with pytest.raises(ValueError, match=r"pads it to K=3(20|04)"):
        if fit == "explicit":
            drivers.fit_explicit_als(rows, cols, vals, m, n, k=300)
        else:
            drivers.fit_implicit_als(rows, cols, vals, m, n, k=300)


def test_cmf_fit_takes_mesh():
    """Fault P2: CMF.fit has the reference's mesh= keyword; None fits, a
    mesh raises naming slice 7."""
    rows, cols, vals, m, n = _small_fit_data()
    X = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    model = cmfrec_torch.CMF(k=4, lambda_=1.0, niter=2, device="cpu")
    ref = cmfrec_torch.CMF(k=4, lambda_=1.0, niter=2, device="cpu").fit(X)
    np.testing.assert_array_equal(model.fit(X, mesh=None).predict(rows, cols),
                                  ref.predict(rows, cols))
    with pytest.raises(ValueError, match="slice 7"):
        cmfrec_torch.CMF(k=4, niter=1, device="cpu").fit(X, mesh=object())


# ----------------------------------------------------------------------- #
# collective fits (side information, implicit features)                    #
# ----------------------------------------------------------------------- #


def _side_data(seed=12, m=90, n=60, p=4, q=3):
    rows, cols, vals, m, n = _small_fit_data(seed)
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(m, p)) + 0.3
    I = rng.normal(size=(n, q)) - 0.2
    return rows, cols, vals, m, n, U, I


@pytest.mark.parametrize("fmt", ["ndarray", "dataframe"])
def test_side_info_surfaces_fit_alike(fmt):
    """U=/I= as arrays aligned with X's positions, or as DataFrames keyed by
    UserId/ItemId in any row order, give the same fit; the side-info column
    means are cmfrec_tpu's, exactly."""
    rows, cols, vals, m, n, U, I = _side_data()
    kw = dict(k=4, lambda_=1.0, niter=3, add_implicit_features=True)
    X = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    ref = cmfrec_torch.CMF(**kw, device="cpu").fit(X, U=U, I=I)
    assert ref.C_.shape == (4, 4) and ref.D_.shape == (3, 4)
    assert ref.Ai_.shape == (m, 4) and ref.Bi_.shape == (n, 4)
    jm = cmfrec_tpu.CMF(**kw).fit(X, U=U, I=I)
    for attr in ("U_colmeans_", "I_colmeans_"):
        np.testing.assert_array_equal(getattr(ref, attr), getattr(jm, attr))
    if fmt == "ndarray":
        got = cmfrec_torch.CMF(**kw, device="cpu").fit(
            X, U=U.astype(np.float32), I=I.astype(np.float32))
        np.testing.assert_allclose(got.C_, ref.C_, rtol=0, atol=1e-6)
        return
    uid, iid = np.array([f"u{r}" for r in rows]), cols + 500
    ucodes, umap = pd.factorize(uid)
    icodes, imap = pd.factorize(iid)
    Xc = sp.coo_matrix((vals, (ucodes, icodes)),
                       shape=(ucodes.max() + 1, icodes.max() + 1))
    Uc = U[[int(u[1:]) for u in umap]]
    Ic = I[np.asarray(imap) - 500]
    want = cmfrec_torch.CMF(**kw, device="cpu").fit(Xc, U=Uc, I=Ic)
    order = np.random.default_rng(0).permutation(m)
    Udf = pd.DataFrame(U[order], columns=[f"f{j}" for j in range(4)])
    Udf.insert(0, "UserId", [f"u{r}" for r in order])
    Idf = pd.DataFrame(I, columns=["g0", "g1", "g2"])
    Idf.insert(0, "ItemId", np.arange(n) + 500)
    got = cmfrec_torch.CMF(**kw, device="cpu").fit(
        pd.DataFrame({"UserId": uid, "ItemId": iid, "Rating": vals}),
        U=Udf, I=Idf)
    np.testing.assert_array_equal(got.predict(uid, iid),
                                  want.predict(ucodes, icodes))
    np.testing.assert_array_equal(got.C_, want.C_)
    np.testing.assert_array_equal(got.U_colmeans_, want.U_colmeans_)


@pytest.mark.parametrize("case", ["side_info", "implicit_features"])
def test_side_factors_match_jax_bucketed_cholesky(case):
    """At use_cg=False and niter=1 from one init, the port's dense engine
    against cmfrec_tpu's collective fit on the CPU (its bucketed Cholesky
    route): C/D/Ai/Bi are solved from the init in both (closed forms, 1e-5),
    A/B are the converged CG against the Cholesky (2e-4, the JAX package's
    own bound for this comparison, tests/test_exact_dense.py)."""
    from cmfrec_torch.solvers import collective
    from cmfrec_tpu.solvers.collective import fit_collective_explicit_als

    rows, cols, vals, m, n, U, I = _side_data()
    rng = np.random.default_rng(2)
    init = dict(A=rng.normal(size=(m, 3)).astype(np.float32),
                B=rng.normal(size=(n, 3)).astype(np.float32))
    kw = dict(k=3, niter=1, lambda_=0.5, use_cg=False, user_bias=False,
              item_bias=False, center=False, w_user=0.7, w_item=1.3,
              init=init)
    if case == "side_info":
        sides = dict(side_U=(None, None, None, m, U.shape[1], True, U),
                     side_I=(None, None, None, n, I.shape[1], True, I))
        keys = ("C", "D")
    else:
        sides = dict(add_implicit_features=True, w_implicit=0.5)
        keys = ("Ai", "Bi")
    rj = fit_collective_explicit_als(rows, cols, vals, m, n, dtype=np.float32,
                                     **sides, **kw)
    rt = collective.fit_collective_explicit_als(rows, cols, vals, m, n,
                                                device="cpu", **sides, **kw)
    for key in keys:
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(rj[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
    for key in ("A", "B"):
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(rj[key]),
                                   rtol=0, atol=2e-4, err_msg=key)
    if case == "side_info":
        for key in ("U_colmeans", "I_colmeans"):
            np.testing.assert_array_equal(rt[key], rj[key])


def _port_side_fit(**kw):
    rows, cols, vals, m, n, U, I = _side_data()
    X = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    return cmfrec_torch.CMF(k=4, lambda_=1.0, niter=2, device="cpu",
                            **kw).fit(X, U=U, I=I)


def _over_budget(call):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(drivers, "_dense_budget", lambda dev: 1000)
        return call()


def _seeded_init(m, n, kw):
    """init= for every key a collective fit with the arguments ``kw`` has,
    from a fixed seed, so that both packages start from the same factors
    (jax.random and torch draw different numbers)."""
    rng = np.random.default_rng(0)
    sU, sI = kw.get("side_U"), kw.get("side_I")
    m_eff, n_eff = max(m, sU[3] if sU else 0), max(n, sI[3] if sI else 0)
    k, ku, ki, km = (kw.get(key, 0) for key in ("k", "k_user", "k_item",
                                                 "k_main"))
    shapes = dict(A=(m_eff, ku + k + km), B=(n_eff, ki + k + km))
    if sU:
        shapes["C"] = (sU[4], ku + k)
    if sI:
        shapes["D"] = (sI[4], ki + k)
    if "alpha" not in kw:  # explicit
        shapes.update(biasA=(m_eff,), biasB=(n_eff,))
        if kw.get("add_implicit_features"):
            shapes.update(Ai=(m_eff, k + km), Bi=(n_eff, k + km))
    init = {key: (0.3 * rng.normal(size=shape)).astype(np.float32)
            for key, shape in shapes.items()}
    init.update(kw.get("init") or {})
    return init


def _hand_over_init(mp):
    """Both packages' collective drivers get _seeded_init's init=."""
    from cmfrec_torch.solvers import collective as port_collective
    from cmfrec_tpu.solvers import collective as jax_collective

    for mod in (port_collective, jax_collective):
        for name in ("fit_collective_explicit_als",
                     "fit_collective_implicit_als"):
            fn = getattr(mod, name)

            def wrapped(rows, cols, vals, m, n, _fn=fn, **kw):
                kw["init"] = _seeded_init(m, n, kw)
                return _fn(rows, cols, vals, m, n, **kw)

            mp.setattr(mod, name, wrapped)


def _collective_driver(pkg, **kw):
    """The explicit collective driver of ``pkg`` on _side_data's dense U."""
    rows, cols, vals, m, n, U, _ = _side_data()
    side_U = (None, None, None, m, U.shape[1], True, U)
    if pkg == "port":
        from cmfrec_torch.solvers.collective import (
            fit_collective_explicit_als)
        kw["device"] = "cpu"
    else:
        from cmfrec_tpu.solvers.collective import fit_collective_explicit_als
    return fit_collective_explicit_als(rows, cols, vals, m, n, side_U=side_U,
                                       k=3, niter=1, **kw)


def _fit_model(pkg, cls, kw, X, U, W=None):
    mod = cmfrec_torch if pkg == "port" else cmfrec_tpu
    extra = dict(device="cpu") if pkg == "port" else {}
    args = dict(k=3, niter=2)
    args.update(kw)
    model = getattr(mod, cls)(**args, **extra)
    fit = dict(U=U) if U is not None else {}
    if W is not None:
        fit["W"] = W
    return model.fit(X, **fit)


# The configurations that only the bucketed collective route takes: a model
# class, its arguments, what U= becomes (from _side_data's dense U), and
# whether the fit is weighted
BUCKETED_CASES = {
    "sparse_U": ("CMF", {}, sp.csr_matrix, False),
    "nan_in_U": ("CMF", {}, lambda U: np.where(np.eye(*U.shape) > 0, np.nan,
                                                U), False),
    "fewer_rows_than_X": ("CMF", {}, lambda U: U[:80], False),
    "more_rows_than_X": ("CMF", {}, lambda U: np.vstack([U, U[:5]]), False),
    "k_item": ("CMF", dict(k_item=2), lambda U: U, False),
    "k_main": ("CMF", dict(k_main=2), lambda U: U, False),
    "w_main": ("CMF", dict(w_main=0.5), lambda U: U, False),
    "NA_as_zero": ("CMF", dict(NA_as_zero=True, add_implicit_features=True),
                   lambda U: None, False),
    "NA_as_zero_user": ("CMF", dict(NA_as_zero_user=True), lambda U: U,
                        False),
    "implicit_features_weighted": ("CMF", dict(add_implicit_features=True),
                                   lambda U: None, True),
    "init_with_C": (None, {}, None, False),
    "over_the_budget": ("CMF", {}, lambda U: U, False),
    "implicit_sparse_U": ("CMF_implicit", {}, sp.csr_matrix, False),
    "implicit_NA_as_zero_item": ("CMF_implicit", dict(NA_as_zero_item=True),
                                 lambda U: U, False),
    "implicit_k_main": ("CMF_implicit", dict(k_main=1), lambda U: U, False),
    "implicit_over_the_budget": ("CMF_implicit", {}, lambda U: U, False),
}
MODEL_ATTRS = ("A_", "B_", "C_", "D_", "Ai_", "Bi_", "user_bias_",
               "item_bias_")


@pytest.mark.parametrize("case", list(BUCKETED_CASES))
def test_bucketed_collective_configurations_fit(case):
    """Each configuration that the dense engine does not take fits through
    the public model on the bucketed collective route and matches
    cmfrec_tpu's model (its bucketed route on the CPU) from the same init=:
    every fitted factor and the predictions within 1e-5."""
    rows, cols, vals, m, n, U, _ = _side_data()
    X = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    cls, kw, side, weighted = BUCKETED_CASES[case]
    if cls is None:  # the driver, with a warm start that carries C
        init = _seeded_init(m, n, dict(
            k=3, side_U=(None, None, None, m, U.shape[1], True, U)))
        got = _collective_driver("port", init=init)
        want = _collective_driver("jax", init=init, dtype=np.float32)
        assert "scaling_biasA" in got  # the bucketed route's result
        for key in ("A", "B", "C", "biasA", "biasB"):
            np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                       atol=1e-5, err_msg=key)
        return
    W = np.linspace(0.5, 2.0, X.nnz) if weighted else None
    with pytest.MonkeyPatch.context() as mp:
        _hand_over_init(mp)
        fit = (_over_budget if "over_the_budget" in case
               else lambda call: call())
        got = fit(lambda: _fit_model("port", cls, kw, X, side(U), W))
        want = _fit_model("jax", cls, kw, X, side(U), W)
    for attr in MODEL_ATTRS:
        g, w = getattr(got, attr), getattr(want, attr)
        if w is None:
            assert g is None, attr
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=attr)
    assert got.A_.shape[0] == (m + 5 if case == "more_rows_than_X" else m)
    np.testing.assert_allclose(got.predict(rows, cols),
                               want.predict(rows, cols), rtol=0, atol=1e-5)


@pytest.mark.parametrize("call,match", [
    # the later slices' rejections keep their messages in a collective fit
    (lambda X, U: cmfrec_torch.CMF(nonneg_C=True, device="cpu").fit(X, U=U),
     "slice 4 item 10, the coordinate-descent solver"),
    (lambda X, U: cmfrec_torch.CMF(device="cpu").fit(X, U=U, mesh=object()),
     "slice 7"),
    (lambda X, U: cmfrec_torch.CMF(use_float=False, device="cpu").fit(
        X, U=U), "slice 1 item 1"),
], ids=["nonneg_C", "mesh", "float64"])
def test_bucketed_collective_configurations_raise(call, match):
    rows, cols, vals, m, n, U, _ = _side_data()
    X = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    with pytest.raises(ValueError, match=match):
        call(X, U)


@pytest.mark.parametrize("model", ["CMF", "CMF_implicit"])
@pytest.mark.parametrize("reindexed", [True, False])
def test_side_ids_not_in_x_extend_the_mapping(model, reindexed):
    """A side-info DataFrame with an id that X lacks (a side-info-only
    entity) extends the user mapping and the factor matrix as cmfrec_tpu's
    model does; the side-only user's factors are solved from side info."""
    rows, cols, vals, m, n, U, _ = _side_data()
    off = 1000 if reindexed else 0
    X = (pd.DataFrame({"UserId": rows + off, "ItemId": cols, "Rating": vals})
         if reindexed else sp.coo_matrix((vals, (rows, cols)), shape=(m, n)))
    Udf = pd.DataFrame(np.vstack([U, U[:1]]), columns=list("abcd"))
    Udf.insert(0, "UserId", np.arange(m + 1) + off)
    with pytest.MonkeyPatch.context() as mp:
        _hand_over_init(mp)
        got = getattr(cmfrec_torch, model)(k=3, niter=1, device="cpu").fit(
            X, U=Udf)
        want = getattr(cmfrec_tpu, model)(k=3, niter=1).fit(X, U=Udf)
    if reindexed:
        np.testing.assert_array_equal(got.user_mapping_, want.user_mapping_)
        assert got.user_mapping_[-1] == m + off
    assert got.A_.shape[0] == want.A_.shape[0] == m + 1
    assert np.abs(got.A_[m]).max() > 0
    np.testing.assert_allclose(got.A_, want.A_, rtol=0, atol=1e-5)


def test_refit_without_side_info_clears_side_state():
    rows, cols, vals, m, n, U, I = _side_data()
    X = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    model = cmfrec_torch.CMF(k=4, niter=2, add_implicit_features=True,
                             device="cpu").fit(X, U=U, I=I)
    assert model.C_ is not None and model.Ai_ is not None
    model.add_implicit_features = False
    model.fit(X)
    for attr in ("C_", "D_", "Ai_", "Bi_", "U_colmeans_", "I_colmeans_"):
        assert getattr(model, attr) is None, attr


COLLECTIVE_ATTRS = ("A_", "B_", "C_", "D_", "Ai_", "Bi_", "user_bias_",
                    "item_bias_", "U_colmeans_", "I_colmeans_")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax",
                                       "convert"])
def test_collective_model_round_trip_with_jax(direction, tmp_path):
    """A collective model's state crosses between the packages whole: by
    .npz either way, or by convert.cmf_from_arrays; both then predict
    alike."""
    rows, cols, vals, m, n, U, I = _side_data()
    X = sp.coo_matrix((vals, (rows, cols)), shape=(m, n))
    kw = dict(k=4, lambda_=1.0, niter=2, add_implicit_features=True)
    path = str(tmp_path / "collective.npz")
    if direction == "port_to_jax":
        src = cmfrec_torch.CMF(**kw, device="cpu").fit(X, U=U, I=I)
        src.save(path)
        dst = cmfrec_tpu.CMF.load(path)
    else:
        src = cmfrec_tpu.CMF(**kw).fit(X, U=U, I=I)
        if direction == "jax_to_port":
            src.save(path)
            dst = cmfrec_torch.CMF.load(path, device="cpu")
        else:
            dst = cmf_from_arrays(
                A=src.A_, B=src.B_, user_bias=src.user_bias_,
                item_bias=src.item_bias_, glob_mean=src.glob_mean_,
                C=src.C_, D=src.D_, Ai=src.Ai_, Bi=src.Bi_,
                U_colmeans=src.U_colmeans_, I_colmeans=src.I_colmeans_,
                params=src.get_params(), device="cpu")
    for attr in COLLECTIVE_ATTRS:
        got, want = getattr(dst, attr), getattr(src, attr)
        assert got is not None, attr
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=attr)
    np.testing.assert_allclose(np.asarray(dst.predict(rows, cols)),
                               np.asarray(src.predict(rows, cols)), rtol=0,
                               atol=1e-5)
