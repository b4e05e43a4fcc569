"""cmfrec_torch's WRMF fits on the dense-masked engine against cmfrec_tpu's
fit_implicit_dense_pallas and fit_collective_implicit_dense_pallas (Pallas
kernels in interpret mode) on the same data and the same init= factors,
and the port's dense engine against its own bucketed engine.

Tolerances (max abs difference of A, B, C, D and the scores A B^T):
  * f32 operands (exact mode, the finalize_chol iteration): the same f32
    arithmetic in another summation order, 5e-5.
  * one bf16 bulk iteration: flipped roundings of T*W (T rounded to bf16
    against the bf16 Wx) move single CG iterates, 5e-4 (<= 4.4e-5 read over
    eight data seeds; test_one_bf16_iteration_at_every_seed holds it at
    four).  Through the shared Gram base B^T B a row moved on one side
    moves every row of the other in the next half-step, so the difference
    grows by iteration: at some seeds one row of B is off by ~6e-4 after
    two bf16 iterations and every row by ~2e-3 after three.  The
    multi-iteration cases are the f32 ones.
  * dense exact mode against the bucketed engine's Cholesky: CG to the
    per-row freeze against a factorization, 2e-4 (the JAX package's own
    bound for the same comparison, tests/test_exact_dense.py).
"""

import numpy as np
import pytest
import torch

from cmfrec_tpu.solvers.dense_pallas import (
    fit_collective_implicit_dense_pallas,
    fit_implicit_dense_pallas,
)
from cmfrec_torch.solvers import drivers
from cmfrec_torch.solvers.dense_masked import (
    fit_collective_implicit_dense_masked,
    fit_implicit_dense_masked,
)

M, N, K, P, Q = 64, 48, 4, 5, 3
TOL_F32, TOL_BF16, TOL_ENGINES = 5e-5, 5e-4, 2e-4


def _data(seed=4):
    """Play counts on unique pairs; every row and column observed (the
    dense engines zero rows without entries, the bucketed keeps them)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, M, 900), np.arange(M),
                           np.arange(N) % M])
    cols = np.concatenate([rng.integers(0, N, 900), np.arange(M) % N,
                           np.arange(N)])
    pairs = np.unique(rows * N + cols)  # the dense scatter dedupes
    rows, cols = pairs // N, pairs % N
    vals = rng.integers(1, 17, rows.size).astype(np.float64)
    U = rng.normal(size=(M, P)).astype(np.float32)
    I = rng.normal(size=(N, Q)).astype(np.float32)
    init = dict(A=0.3 * rng.normal(size=(M, K)).astype(np.float32),
                B=0.3 * rng.normal(size=(N, K)).astype(np.float32))
    return rows, cols, vals, U, I, init


COMMON = dict(k=K, lam6=np.array([0.5, 0.5, 2.0, 1.5, 0.9, 1.1]),
              max_cg_steps=3, finalize_steps=16, alpha=0.5, seed=1,
              verbose=False)


def _assert_close(rj, rt, keys, tol):
    for key in keys:
        if rj.get(key) is None:
            assert rt.get(key) is None, key
            continue
        assert rt[key].dtype == torch.float32 and rt[key].device.type == "cpu"
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(rj[key]),
                                   rtol=0, atol=tol, err_msg=key)
    scores = [np.asarray(r["A"], np.float64) @ np.asarray(r["B"], np.float64).T
              for r in (rj, {key: rt[key].numpy() for key in ("A", "B")})]
    np.testing.assert_allclose(scores[1], scores[0], rtol=0, atol=tol)


@pytest.mark.parametrize("case,kw,tol", [
    ("cg_bf16", dict(niter=1, finalize_chol=False), TOL_BF16),
    ("exact_mode", dict(niter=3, finalize_chol=False, exact=True), TOL_F32),
    # one bf16 bulk iteration, then the f32 finalize_chol iteration
    ("finalize_chol", dict(niter=2, finalize_chol=True), TOL_BF16),
    ("one_f32_iteration", dict(niter=1, finalize_chol=True), TOL_F32),
    ("w_main_multiplier", dict(niter=1, finalize_chol=False,
                               w_main_multiplier=0.3), TOL_BF16),
])
def test_implicit_fit_matches_pallas(case, kw, tol):
    rows, cols, vals, _, _, init = _data()
    kw = {"w_main_multiplier": 1.0, **COMMON, **kw}
    rj = fit_implicit_dense_pallas(rows, cols, vals, M, N, dtype=np.float32,
                                   interpret=True, init=init, **kw)
    rt = fit_implicit_dense_masked(rows, cols, vals, M, N, device="cpu",
                                   init=init, **kw)
    assert rt["w_main_multiplier"] == kw["w_main_multiplier"]
    _assert_close(rj, rt, ("A", "B"), tol)


@pytest.mark.parametrize("case,kw,side,tol", [
    ("U_cg_bf16", dict(niter=1, finalize_chol=False), "U", TOL_BF16),
    ("U_and_I_cg_bf16", dict(niter=1, finalize_chol=False,
                             w_main_multiplier=0.4), "UI", TOL_BF16),
    ("I_exact_mode", dict(niter=2, finalize_chol=False, exact=True), "I",
     TOL_F32),
    ("U_and_I_one_f32_iteration", dict(niter=1, finalize_chol=True), "UI",
     TOL_F32),
    ("U_and_I_exact_mode", dict(niter=3, finalize_chol=False, exact=True,
                                w_main_multiplier=0.4), "UI", TOL_F32),
])
def test_collective_implicit_fit_matches_pallas(case, kw, side, tol):
    rows, cols, vals, U, I, init = _data()
    kw = {"w_main_multiplier": 1.0, **COMMON, **kw,
          "U_dense": U if "U" in side else None,
          "I_dense": I if "I" in side else None, "w_user": 0.7, "w_item": 1.2}
    rj = fit_collective_implicit_dense_pallas(
        rows, cols, vals, M, N, dtype=np.float32, interpret=True, init=init,
        **kw)
    rt = fit_collective_implicit_dense_masked(rows, cols, vals, M, N,
                                              device="cpu", init=init, **kw)
    _assert_close(rj, rt, ("A", "B", "C", "D"), tol)


@pytest.mark.parametrize("seed", [1, 3, 5, 6])
@pytest.mark.parametrize("side", ["", "UI"])
def test_one_bf16_iteration_at_every_seed(side, seed):
    """One bf16 bulk iteration from a shared init holds the bf16 tolerance
    at any data seed (readings <= 4.4e-5 over eight seeds), so the bf16 half
    steps are checked where the multi-iteration cases, on one seed, are
    not."""
    rows, cols, vals, U, I, init = _data(seed)
    kw = {"w_main_multiplier": 1.0, **COMMON, "niter": 1,
          "finalize_chol": False}
    if side:
        kw.update(U_dense=U, I_dense=I, w_user=0.7, w_item=1.2)
        fj, ft = (fit_collective_implicit_dense_pallas,
                  fit_collective_implicit_dense_masked)
    else:
        fj, ft = fit_implicit_dense_pallas, fit_implicit_dense_masked
    rj = fj(rows, cols, vals, M, N, dtype=np.float32, interpret=True,
            init=init, **kw)
    rt = ft(rows, cols, vals, M, N, device="cpu", init=init, **kw)
    _assert_close(rj, rt, ("A", "B", "C", "D") if side else ("A", "B"),
                  TOL_BF16)


def test_collective_implicit_niter_zero_side_factors():
    """With no iteration C and D are the numpy closed form on the init."""
    rows, cols, vals, U, I, init = _data()
    rt = fit_collective_implicit_dense_masked(
        rows, cols, vals, M, N, U_dense=U, I_dense=I, w_user=0.7,
        w_item=1.2, niter=0, finalize_chol=False, w_main_multiplier=1.0,
        device="cpu", init=init, **COMMON)
    for key, S, w, lam in (("C", U, 0.7, 0.9), ("D", I, 1.2, 1.1)):
        F = init["A" if key == "C" else "B"].astype(np.float64)
        want = np.linalg.solve(w * F.T @ F + lam * np.eye(K), w * F.T @ S).T
        np.testing.assert_allclose(rt[key].numpy(), want, rtol=0,
                                   atol=TOL_F32, err_msg=key)


@pytest.mark.parametrize("niter", [1, 3])
def test_dense_engine_matches_bucketed_engine(niter):
    """The port's two implicit engines in exact mode (use_cg=False): the
    dense engine's f32 CG to the per-row freeze against the bucketed
    engine's per-row Cholesky, from one init."""
    rows, cols, vals, _, _, init = _data(seed=3)
    kw = dict(k=K, lambda_=2.0, alpha=0.5, niter=niter, use_cg=False,
              init=init, device="cpu")
    dense = drivers.fit_implicit_als(rows, cols, vals, M, N, engine="dense",
                                     **kw)
    sparse = drivers.fit_implicit_als(rows, cols, vals, M, N, engine="sparse",
                                      **kw)
    for key in ("A", "B"):
        np.testing.assert_allclose(dense[key].numpy(), sparse[key].numpy(),
                                   rtol=0, atol=TOL_ENGINES, err_msg=key)


@pytest.mark.parametrize("engine,want", [
    ("auto", "_build_pair"), ("sparse", "_build_pair"),
    ("dense", "fit_implicit_dense_masked")])
def test_engine_choice(engine, want, monkeypatch):
    """engine="auto" keeps to the bucketed engine even where a card's budget
    would hold the dense form (stood in for here: a budget on the CPU);
    "dense" asks for the dense engine.  dense_bytes, which the collective
    implicit fit holds to the budget, counts 10 B a padded entry."""
    rows, cols, vals, _, _, init = _data()
    taken = []
    for name in ("fit_implicit_dense_masked", "_build_pair"):
        real = getattr(drivers, name)
        monkeypatch.setattr(drivers, name, lambda *a, _n=name, _r=real, **kw:
                            taken.append(_n) or _r(*a, **kw))
    need = drivers.dense_bytes(M, N, K, False, implicit=True)
    assert need == 64 * 64 * 10  # bf16 Wx, Xp and the int8 mask, twice
    monkeypatch.setattr(drivers, "_dense_budget", lambda dev: 100 * need)
    drivers.fit_implicit_als(rows, cols, vals, M, N, k=K, niter=1, init=init,
                             engine=engine, device="cpu")
    assert taken == [want]
