"""cmfrec_torch's L-BFGS family against cmfrec_tpu's on the same inputs.

- solvers/lbfgs_core.py against optax.lbfgs + value_and_grad_from_state,
  float64: the first 30 iterates within 1e-9 of max|x|;
- the joint objective and its gradient (solvers/lbfgs.py) against
  jax.value_and_grad of cmfrec_tpu's own loss_fn (captured from its fit),
  float64, within 1e-12 relative;
- fit_collective_explicit_lbfgs and fit_offsets_explicit_lbfgs from one
  init=: float64 at maxiter=50, parameters within 1e-6 of max|param| and
  the same niter; float32 at maxiter=200, the final objective within 1e-4
  relative;
- CMF(method="lbfgs") with binary side info through the public models,
  and its serving (warm.factors_bin_batch): within 2e-6 of max|a| on a
  float64 model, 1e-4 on a float32 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cmfrec_torch
import cmfrec_tpu
from cmfrec_torch.solvers import lbfgs as tl
from cmfrec_torch.solvers import offsets as toff
from cmfrec_torch.solvers import warm as twarm
from cmfrec_torch.solvers.lbfgs_core import FlatParams, Lbfgs
from cmfrec_tpu.solvers import lbfgs as jl
from cmfrec_tpu.solvers import offsets as joff
from cmfrec_tpu.solvers import warm as jwarm

M, N, K = 40, 30, 4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _close(a, b, tol):
    """max|a - b| <= tol * max|b| (zeros equal zeros)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) <= tol * float(np.abs(b).max())


# --------------------------------------------------------------------- #
# the core against optax                                                #
# --------------------------------------------------------------------- #


def _quadratic(seed=0, n=24):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(n, n))
    Q = Q @ Q.T + 0.1 * np.eye(n)
    b = rng.normal(size=n)
    x0 = {"x": rng.normal(size=n), "y": rng.normal(size=(3, 4))}
    Qt, bt = torch.tensor(Q), torch.tensor(b)

    def jloss(p):
        return (0.5 * p["x"] @ Q @ p["x"] - b @ p["x"]
                + 0.5 * jnp.sum(p["y"] * p["y"]))

    def tloss(p):
        return (0.5 * p["x"] @ Qt @ p["x"] - bt @ p["x"]
                + 0.5 * torch.sum(p["y"] * p["y"]))

    return jloss, tloss, x0


def _sparse_l2(seed=0):
    """_term_sparse (with biases and weights) + L2, cmfrec_tpu's and the
    port's term functions."""
    rng = np.random.default_rng(seed)
    rows, cols = np.nonzero(rng.uniform(size=(M, N)) < 0.3)
    vals = rng.normal(size=rows.size)
    wgt = rng.uniform(0.5, 2.0, size=rows.size)
    x0 = {"A": 0.3 * rng.normal(size=(M, K)), "B": 0.3 * rng.normal(size=(N, K)),
          "biasA": np.zeros(M), "biasB": 0.1 * rng.normal(size=N)}
    lam = {"A": 1.5, "B": 0.7, "biasA": 0.3, "biasB": 0.2}
    r_j, c_j, v_j, w_j = (jnp.asarray(a) for a in (rows, cols, vals, wgt))
    r_t, c_t, v_t, w_t = (torch.as_tensor(a) for a in (rows, cols, vals, wgt))

    def jloss(p):
        f = jl._term_sparse(p["A"], p["B"], r_j, c_j, v_j, w_j, p["biasA"],
                            p["biasB"])
        for name, mat in p.items():
            f = f + 0.5 * lam[name] * jnp.sum(mat * mat)
        return f

    def tloss(p):
        f = tl._term_sparse(p["A"], p["B"], r_t, c_t, v_t, w_t, p["biasA"],
                            p["biasB"])
        for name in sorted(p):
            f = f + 0.5 * lam[name] * torch.sum(p[name] * p[name])
        return f

    return jloss, tloss, x0


@pytest.mark.parametrize("memory", [1, 4, 7])
@pytest.mark.parametrize("problem", [_quadratic, _sparse_l2],
                         ids=["quadratic", "sparse_l2"])
def test_core_follows_optax(problem, memory):
    jloss, tloss, x0 = problem()
    opt = optax.lbfgs(memory_size=memory)
    params = {key: jnp.asarray(v) for key, v in x0.items()}
    state = opt.init(params)
    vg = optax.value_and_grad_from_state(jloss)

    @jax.jit
    def jstep(params, state):
        value, grad = vg(params, state=state)
        updates, state = opt.update(grad, state, params, value=value,
                                    grad=grad, value_fn=jloss)
        return optax.apply_updates(params, updates), state, value

    layout = FlatParams({key: torch.tensor(v) for key, v in x0.items()})
    x = layout.flatten({key: torch.tensor(v) for key, v in x0.items()})
    core = Lbfgs(tl.value_and_grad_of(tloss, layout), x, memory)
    for it in range(30):
        params, state, value = jstep(params, state)
        x, tvalue = core.step(x)
        tp = layout.views(x)
        assert abs(tvalue - float(value)) <= 1e-9 * max(abs(float(value)), 1)
        scale = max(float(jnp.max(jnp.abs(v))) for v in params.values())
        err = max(float(np.abs(tp[key].numpy() - np.asarray(params[key])).max())
                  for key in params)
        assert err <= 1e-9 * scale, (it, err, scale)
    # one value and slope read a trial, one slope read an iteration (and
    # the first value)
    assert core.host_syncs == core.linesearch_steps + 30 + 1
    assert core.n_evals == core.linesearch_steps + 1


def test_core_line_search_that_fails_as_optax():
    """A gradient of the wrong sign: the direction only climbs, every
    trial fails the sufficient decrease, the search gives up after its 20
    trials and, with no safe step found, takes its last trial (optax's
    _try_safe_step) -- to the same point as optax."""
    x0 = np.array([1.0, -2.0, 0.5])
    wrong = {"x": -2.0 * x0}

    def jloss(p):
        return jnp.sum(p["x"] * p["x"])

    def tloss(p):
        return torch.sum(p["x"] * p["x"])

    opt = optax.lbfgs(memory_size=3)
    params = {"x": jnp.asarray(x0)}
    updates, _ = opt.update({"x": jnp.asarray(wrong["x"])}, opt.init(params),
                            params, value=jnp.asarray(5.25),
                            grad={"x": jnp.asarray(wrong["x"])},
                            value_fn=jloss)
    want = optax.apply_updates(params, updates)["x"]

    layout = FlatParams({"x": torch.tensor(x0)})
    core = Lbfgs(tl.value_and_grad_of(tloss, layout), torch.tensor(x0), 3)
    core.value, core.grad = 5.25, torch.tensor(wrong["x"])
    got, value = core.step(torch.tensor(x0))
    assert value == 5.25 and core.linesearch_steps == 20
    assert np.abs(got.numpy() - x0).max() < 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-15)


# --------------------------------------------------------------------- #
# the joint objective and its gradient                                  #
# --------------------------------------------------------------------- #


def _side(rng, n_ent, p, kind, binary=False):
    dense = ((rng.uniform(size=(n_ent, p)) < 0.5).astype(np.float64) if binary
             else rng.normal(size=(n_ent, p)))
    if kind == "dense":
        return (None, None, None, n_ent, p, True, dense)
    r, c = np.nonzero(rng.uniform(size=(n_ent, p)) < 0.5)
    return (r, c, dense[r, c], n_ent, p, False, None)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    rows, cols = np.nonzero(rng.uniform(size=(M, N)) < 0.3)
    vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
    return rng, rows, cols, vals


OBJECTIVE_CASES = {
    "plain": dict(),
    "dense_UI": dict(U="dense", I="dense"),
    "coo_UI": dict(U="coo", I="coo"),
    "dense_bin": dict(Ub="dense", Ib="dense"),
    "coo_bin_weights": dict(Ub="coo", Ib="coo", weights=True),
    "k_splits_all": dict(U="coo", I="dense", Ub="dense", Ib="coo",
                         k_user=1, k_item=2, k_main=1, weights=True,
                         w_main=0.7, w_user=1.3, w_item=0.4,
                         lambda_=[0.5, 0.6, 1.0, 1.1, 1.2, 1.3]),
}


def _case(name, seed=0):
    cfg = dict(OBJECTIVE_CASES[name])
    rng, rows, cols, vals = _data(seed)
    sides = {}
    for key, n_ent, p in (("U", M, 5), ("I", N, 6), ("Ub", M, 3),
                          ("Ib", N, 4)):
        kind = cfg.pop(key, None)
        sides["side_" + key] = (None if kind is None else
                                _side(rng, n_ent, p, kind, key.endswith("b")))
    weights = (rng.uniform(0.5, 2.0, size=rows.size)
               if cfg.pop("weights", False) else None)
    kw = dict(k=K, lambda_=cfg.pop("lambda_", 1.0), **cfg, **sides)
    ku, ki, km = (kw.get(key, 0) for key in ("k_user", "k_item", "k_main"))
    init = {"A": 0.3 * rng.normal(size=(M, ku + K + km)),
            "B": 0.3 * rng.normal(size=(N, ki + K + km)),
            "biasA": 0.1 * rng.normal(size=M),
            "biasB": 0.1 * rng.normal(size=N)}
    for key, pname, width in (("U", "C", ku + K), ("I", "D", ki + K),
                              ("Ub", "Cb", ku + K), ("Ib", "Db", ki + K)):
        if sides["side_" + key] is not None:
            init[pname] = 0.3 * rng.normal(size=(sides["side_" + key][4],
                                                 width))
    return rows, cols, vals, weights, kw, init


class _Captured(Exception):
    pass


def _jax_loss(monkeypatch, fit, *args, **kw):
    """cmfrec_tpu's loss_fn, captured where its fit hands it to optax."""
    seen = {}

    def capture(fn):
        seen["loss"] = fn
        raise _Captured

    monkeypatch.setattr(optax, "value_and_grad_from_state", capture)
    with pytest.raises(_Captured):
        fit(*args, **kw)
    return seen["loss"]


@pytest.mark.parametrize("case", sorted(OBJECTIVE_CASES))
def test_objective_and_gradient_match_jax(case, monkeypatch):
    rows, cols, vals, weights, kw, init = _case(case)
    loss = _jax_loss(monkeypatch, jl.fit_collective_explicit_lbfgs, rows,
                     cols, vals, M, N, weights=weights, dtype=np.float64,
                     init=init, **kw)
    params = {key: jnp.asarray(v) for key, v in init.items()}
    jv, jg = jax.value_and_grad(loss)(params)
    prob = tl.CollectiveProblem(rows, cols, vals, M, N, weights=weights,
                                dtype=np.float64, device="cpu", **kw)
    tv, tg = prob.value_and_grad(prob.init_params(1, init))
    assert sorted(tg) == sorted(jg)
    assert abs(float(tv) - float(jv)) <= 1e-12 * abs(float(jv))
    for key in jg:
        assert _rel(tg[key].numpy(), jg[key]) <= 1e-12, key


@pytest.mark.parametrize("case", ["plain", "coo_UI", "k_splits_all"])
def test_offsets_objective_matches_jax(case, monkeypatch):
    """The offsets objective (Am/Bm from A, U C + C_bias, k_sec, k_main)
    and its gradient, against cmfrec_tpu's."""
    rng, rows, cols, vals = _data(1)
    kw = {"plain": dict(k=K),
          "coo_UI": dict(k=K, side_U=_side(rng, M, 5, "coo"),
                         side_I=_side(rng, N, 6, "dense")),
          "k_splits_all": dict(k=2, k_sec=2, k_main=1,
                               side_U=_side(rng, M, 5, "dense"),
                               side_I=_side(rng, N, 6, "coo"), w_user=1.3,
                               w_item=0.6,
                               lambda_=[0.5, 0.6, 1.0, 1.1, 1.2, 1.3])}[case]
    weights = rng.uniform(0.5, 2.0, size=rows.size)
    loss = _jax_loss(monkeypatch, joff.fit_offsets_explicit_lbfgs, rows, cols,
                     vals, M, N, weights=weights, dtype=np.float64, **kw)
    prob = toff.OffsetsProblem(rows, cols, vals, M, N, weights=weights,
                               dtype=np.float64, device="cpu", **kw)
    tp = prob.init_params(3)
    for key in tp:
        tp[key] = torch.as_tensor(0.3 * rng.normal(size=tuple(tp[key].shape)))
    jv, jg = jax.value_and_grad(loss)({key: jnp.asarray(v.numpy())
                                       for key, v in tp.items()})
    layout = FlatParams(tp)
    tv, tg = tl.value_and_grad_of(prob.loss, layout)(layout.flatten(tp))
    tg = layout.views(tg)
    assert abs(float(tv) - float(jv)) <= 1e-12 * abs(float(jv))
    for key in jg:
        assert _rel(tg[key].numpy(), jg[key]) <= 1e-12, key


# --------------------------------------------------------------------- #
# the fits                                                              #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("case", ["dense_UI", "k_splits_all"])
def test_collective_fit_matches_jax_f64(case):
    rows, cols, vals, weights, kw, init = _case(case, seed=2)
    args = (rows, cols, vals, M, N)
    common = dict(weights=weights, dtype=np.float64, maxiter=50, init=init,
                  **kw)
    rj = jl.fit_collective_explicit_lbfgs(*args, **common)
    rt = tl.fit_collective_explicit_lbfgs(*args, device="cpu", **common)
    assert rt["niter"] == rj["niter"] and rt["nfev"] == rj["nfev"]
    for key in ("A", "B", "C", "D", "Cb", "Db", "biasA", "biasB"):
        if rj[key] is None:
            assert rt[key] is None
            continue
        assert rt[key].dtype == np.float64
        assert _rel(rt[key], rj[key]) <= 1e-6, key
    assert rt["glob_mean"] == rj["glob_mean"]
    for key in ("U_colmeans", "I_colmeans"):
        if rj[key] is not None:
            np.testing.assert_allclose(rt[key], rj[key], rtol=1e-12)
    # the measured counters: a read for each trial, each slope, the start
    assert rt["host_syncs"] == rt["linesearch_steps"] + 50 + 1
    assert len(rt["values"]) == 50


def test_collective_fit_matches_jax_f32():
    rows, cols, vals, weights, kw, init = _case("dense_bin", seed=3)
    args = (rows, cols, vals, M, N)
    common = dict(weights=weights, maxiter=200, init=init, **kw)
    rj = jl.fit_collective_explicit_lbfgs(*args, dtype=np.float32, **common)
    rt = tl.fit_collective_explicit_lbfgs(*args, dtype=np.float32,
                                          device="cpu", **common)
    assert rt["A"].dtype == np.float32
    prob = tl.CollectiveProblem(*args, weights=weights, dtype=np.float64,
                                device="cpu", **kw)

    def objective(res):
        return float(prob.loss({key: torch.as_tensor(
            np.asarray(res[key], np.float64)) for key in init}))

    fj, ft = objective(rj), objective(rt)
    assert abs(ft - fj) <= 1e-4 * abs(fj), (ft, fj)
    assert ft < 0.5 * objective(init)


def _offsets_case(rng, rows):
    U = rng.normal(size=(M, 5))
    I = rng.normal(size=(N, 6))
    U[rng.uniform(size=U.shape) < 0.1] = np.nan
    kw = dict(k=2, k_sec=1, k_main=1, lambda_=0.8, w_user=1.2, w_item=0.9,
              side_U=(None, None, None, M, 5, False, None),
              side_I=(None, None, None, N, 6, True, I))
    r, c = np.nonzero(~np.isnan(U))
    kw["side_U"] = (r, c, U[r, c], M, 5, False, None)
    init = {"A": 0.3 * rng.normal(size=(M, 3)),
            "B": 0.3 * rng.normal(size=(N, 3)),
            "C": 0.3 * rng.normal(size=(5, 3)),
            "D": 0.3 * rng.normal(size=(6, 3)),
            "C_bias": 0.1 * rng.normal(size=3), "D_bias": np.zeros(3),
            "biasA": np.zeros(M), "biasB": 0.1 * rng.normal(size=N)}
    return kw, init, rng.uniform(0.5, 2.0, size=rows.size)


@pytest.mark.parametrize("dtype,maxiter", [(np.float64, 50),
                                           (np.float32, 200)],
                         ids=["f64", "f32"])
def test_offsets_fit_matches_jax(dtype, maxiter):
    rng, rows, cols, vals = _data(4)
    kw, init, weights = _offsets_case(rng, rows)
    if dtype == np.float32:
        # float32 paths part within a few iterations (summation order); at
        # lambda 0.8 both are still 2% above the optimum after 200
        # iterations, at lambda 4 within 1e-4 of it, so the objective
        # compares where they end, not two points on diverging paths
        kw["lambda_"] = 4.0
    args = (rows, cols, vals, M, N)
    common = dict(weights=weights, dtype=dtype, maxiter=maxiter,
                  init_params=init, **kw)
    rj = joff.fit_offsets_explicit_lbfgs(*args, **common)
    rt = toff.fit_offsets_explicit_lbfgs(*args, device="cpu", **common)
    if dtype == np.float64:
        assert rt["niter"] == rj["niter"]
        for key in ("A", "B", "C", "D", "C_bias", "D_bias", "Am", "Bm",
                    "biasA", "biasB"):
            assert _rel(rt[key], rj[key]) <= 1e-6, key
        np.testing.assert_allclose(rt["U_colmeans"], rj["U_colmeans"],
                                   rtol=1e-12)
        return
    prob = toff.OffsetsProblem(*args, weights=weights, dtype=np.float64,
                               device="cpu", **kw)

    def objective(res):
        return float(prob.loss({key: torch.as_tensor(
            np.asarray(res[key], np.float64)) for key in init}))

    fj, ft = objective(rj), objective(rt)
    assert abs(ft - fj) <= 1e-4 * abs(fj), (ft, fj)


def test_fits_reject_a_mesh():
    rows, cols, vals, _, kw, _ = _case("plain")
    with pytest.raises(ValueError, match="slice 7"):
        tl.fit_collective_explicit_lbfgs(rows, cols, vals, M, N,
                                         mesh=object(), device="cpu", **kw)
    with pytest.raises(ValueError, match="slice 7"):
        toff.fit_offsets_explicit_lbfgs(rows, cols, vals, M, N, k=K,
                                        mesh=object(), device="cpu")


# --------------------------------------------------------------------- #
# CMF(method="lbfgs") and binary side info through the public models    #
# --------------------------------------------------------------------- #


def _bin_models(dtype, monkeypatch):
    """cmfrec_tpu's and the port's CMF(method="lbfgs") with U, U_bin and
    I_bin, fitted from one init= (handed to both fits by wrapping them)."""
    rows, cols, vals, weights, kw, init = _case("k_splits_all", seed=5)
    import scipy.sparse as sp

    X = sp.coo_matrix((vals, (rows, cols)), shape=(M, N))
    rng = np.random.default_rng(6)
    U = rng.normal(size=(M, 5))
    Ub = (rng.uniform(size=(M, 3)) < 0.5).astype(float)
    Ib = (rng.uniform(size=(N, 4)) < 0.5).astype(float)
    init = {key: init[key] for key in ("A", "B", "biasA", "biasB")}
    init["C"] = 0.3 * rng.normal(size=(5, 1 + K))
    init["Cb"] = 0.3 * rng.normal(size=(3, 1 + K))
    init["Db"] = 0.3 * rng.normal(size=(4, 2 + K))
    params = dict(k=K, k_user=1, k_item=2, k_main=1, lambda_=0.8,
                  w_user=1.2, method="lbfgs", maxiter=60,
                  use_float=dtype == np.float32)
    models = []
    for pkg, mod, extra in ((cmfrec_tpu, jl, {}),
                            (cmfrec_torch, tl, {"device": "cpu"})):
        real = mod.fit_collective_explicit_lbfgs
        monkeypatch.setattr(mod, "fit_collective_explicit_lbfgs",
                            lambda *a, _r=real, **k: _r(*a, init=init, **k))
        models.append(pkg.CMF(**params, **extra).fit(X, U=U, U_bin=Ub,
                                                     I_bin=Ib))
    return models, U, Ub, Ib


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_cmf_lbfgs_with_binary_side_info(dtype, monkeypatch, tmp_path):
    (jm, tm), U, Ub, Ib = _bin_models(dtype, monkeypatch)
    assert tm.niter_ == jm.niter_ and tm.nfev_ == jm.nfev_
    assert tm.fit_stats_["n_evals"] > 0
    if dtype == np.float64:
        for attr in ("A_", "B_", "C_", "Cb_", "Db_", "user_bias_",
                     "item_bias_"):
            assert _rel(getattr(tm, attr), getattr(jm, attr)) <= 1e-6, attr
        rows = np.arange(6)
        np.testing.assert_allclose(tm.predict(rows, rows),
                                   np.asarray(jm.predict(rows, rows)),
                                   rtol=0, atol=1e-5)
    else:
        # float32 paths part by summation order: the final objective (in
        # f64) within 1e-4
        rows, cols, vals, _, _, _ = _case("k_splits_all", seed=5)
        prob = tl.CollectiveProblem(
            rows, cols, vals, M, N, k=K, k_user=1, k_item=2, k_main=1,
            lambda_=0.8, w_user=1.2, dtype=np.float64, device="cpu",
            side_U=(None, None, None, M, 5, True, U),
            side_Ub=(None, None, None, M, 3, True, Ub),
            side_Ib=(None, None, None, N, 4, True, Ib))

        def objective(m):
            return float(prob.loss({
                key: torch.as_tensor(np.asarray(getattr(m, attr),
                                                np.float64))
                for key, attr in (("A", "A_"), ("B", "B_"), ("C", "C_"),
                                  ("Cb", "Cb_"), ("Db", "Db_"),
                                  ("biasA", "user_bias_"),
                                  ("biasB", "item_bias_"))}))

        assert abs(objective(tm) - objective(jm)) <= 1e-4 * objective(jm)
    # serving from the same fitted arrays (the port's model as cmfrec_tpu
    # saves it, read back by cmfrec_tpu), so that only the solves differ
    path = str(tmp_path / "bin.npz")
    tm.save(path)
    jm = cmfrec_tpu.CMF.load(path)
    jm.dtype_ = tm.dtype_ = np.dtype(dtype)
    tol = 2e-6 if dtype == np.float64 else 1e-4
    X_col, X_val = np.array([1, 4, 7]), np.array([3.0, 4.5, 2.0])
    pairs = [
        lambda m: m.factors_warm(X_col=X_col, X_val=X_val, U=U[0],
                                 U_bin=Ub[0], return_bias=True),
        lambda m: m.factors_cold(U=U[1], U_bin=Ub[1]),
        lambda m: m.factors_cold(U_bin=Ub[2]),
        lambda m: m.item_factors_cold(I_bin=Ib[3]),
        lambda m: m.factors_multiple(U=U[:4], U_bin=Ub[:4],
                                     return_bias=True),
        lambda m: m.predict_cold_multiple(np.arange(4), U=U[:4],
                                          U_bin=Ub[:4]),
        lambda m: m.predict_warm(np.arange(5), X_col=X_col, X_val=X_val,
                                 U_bin=Ub[0]),
    ]
    for i, call in enumerate(pairs):
        got, want = call(tm), call(jm)
        for g, w in (zip(got, want) if isinstance(want, tuple)
                     else [(got, want)]):
            assert _close(g, w, tol), (i, g, w)
    got = tm.topN_warm(n=5, X_col=X_col, X_val=X_val, U_bin=Ub[0])
    np.testing.assert_array_equal(got, jm.topN_warm(n=5, X_col=X_col,
                                                    X_val=X_val, U_bin=Ub[0]))
    np.testing.assert_array_equal(tm.topN_cold(n=5, U_bin=Ub[1]),
                                  jm.topN_cold(n=5, U_bin=Ub[1]))


@pytest.mark.parametrize("cold", [False, True], ids=["warm", "cold"])
def test_factors_bin_batch_matches_jax(cold, monkeypatch, tmp_path):
    (_, tm), U, Ub, _ = _bin_models(np.float64, monkeypatch)
    path = str(tmp_path / "bin.npz")
    tm.save(path)
    jm = cmfrec_tpu.CMF.load(path)
    jm.dtype_ = tm.dtype_ = np.dtype(np.float64)
    rng = np.random.default_rng(7)
    R, L = 6, 5
    idx = rng.integers(0, N, size=(R, L))
    vals = np.round(2 * (3 + rng.normal(size=(R, L)))) / 2
    wgt = rng.uniform(0.5, 2.0, size=(R, L))
    lengths = np.array([5, 3, 0, 1, 5, 2])
    Uq = U[:R].copy()
    Uq[0, 1] = np.nan
    kw = dict(U=Uq, U_bin=Ub[:R], cold=cold, return_bias=not cold,
              maxiter=100)
    got = twarm.factors_bin_batch(tm, idx, vals, wgt, lengths, **kw)
    want = jwarm.factors_bin_batch(jm, idx, vals, wgt, lengths, **kw)
    for g, w in (zip(got, want) if not cold else [(got, want)]):
        assert _close(g, w, 2e-6)


def test_binary_side_info_needs_lbfgs():
    import scipy.sparse as sp

    _, rows, cols, vals = _data()
    X = sp.coo_matrix((vals, (rows, cols)), shape=(M, N))
    with pytest.raises(ValueError, match="requires method='lbfgs'"):
        cmfrec_torch.CMF(k=K, device="cpu").fit(X, U_bin=np.ones((M, 2)))
    for kw, match in ((dict(NA_as_zero=True), "NA_as_zero"),
                      (dict(add_implicit_features=True), "implicit_features"),
                      (dict(nonneg=True), "non-negativity"),
                      (dict(scale_lam=True), "scale_lam"),
                      (dict(l1_lambda=0.1), "L1")):
        with pytest.raises(ValueError, match=match):
            cmfrec_torch.CMF(method="lbfgs", device="cpu", **kw)


def test_cmf_with_binary_factors_carries_both_ways(monkeypatch, tmp_path):
    """A CMF with Cb_/Db_: cmfrec_tpu's save read by the port's load and by
    convert.cmf_from_arrays, the port's save read by cmfrec_tpu; each
    serves binary side info as the other does."""
    from cmfrec_torch.convert import cmf_from_arrays

    (jm, tm), U, Ub, Ib = _bin_models(np.float64, monkeypatch)
    path = str(tmp_path / "jax_bin.npz")
    jm.save(path)
    loaded = cmfrec_torch.CMF.load(path, device="cpu")
    conv = cmf_from_arrays(
        A=jm.A_, B=jm.B_, user_bias=jm.user_bias_, item_bias=jm.item_bias_,
        glob_mean=jm.glob_mean_, C=jm.C_, Cb=jm.Cb_, Db=jm.Db_,
        U_colmeans=jm.U_colmeans_, params=jm.get_params(), device="cpu")
    for port in (loaded, conv):
        for attr in ("Cb_", "Db_", "C_"):
            np.testing.assert_allclose(getattr(port, attr),
                                       getattr(jm, attr), rtol=1e-6, atol=0)
        port.dtype_ = np.dtype(np.float32)
        got = port.item_factors_cold(I_bin=Ib[0])
        jm.dtype_ = np.dtype(np.float32)
        assert _close(got, jm.item_factors_cold(I_bin=Ib[0]), 1e-4)
    path = str(tmp_path / "port_bin.npz")
    tm.save(path)
    back = cmfrec_tpu.CMF.load(path)
    np.testing.assert_array_equal(back.Db_, tm.Db_)
    np.testing.assert_array_equal(back.Cb_, tm.Cb_)
