"""cmfrec_torch's collective explicit fit on the dense-masked engine against
cmfrec_tpu's fit_collective_dense_pallas (Pallas kernels in interpret mode)
on the same data, the same centered dense side info and the same init=
factors (jax.random and torch draw different numbers).

Tolerances (max abs difference of A, B, biases, C, D, Ai, Bi and the
predictions), as in test_torch_dense_fit.py:
  * f32 operands (one polish iteration, exact mode, the closed forms): the
    same f32 arithmetic in another summation order, 5e-5.
  * bf16 bulk iterations (two, then the f32 polish): a one-ulp flip of a
    bf16-rounded T*W entry moves a CG iterate and later iterations carry it,
    5e-4.  Where a flip lands on an entry that dominates its row's system,
    truncated CG moves that row by up to ~1e-3 (other data seeds show it,
    in the explicit engine too), so these cases run on one seed whose
    readings are 1e-6 to 2.4e-5; the f32 cases read <= 3e-6 here and hold
    at the other seeds tried.  A single bf16 iteration holds 5e-4 at every
    seed tried (<= 1.1e-5 over eight), and
    test_one_bf16_iteration_at_every_seed checks it at four.
  * weighted_side_info and no_biases ran two bf16 iterations and failed
    that bound on some machines (2.55e-3 and 1.01e-3): after one
    iteration both engines agree to 1.7e-6 and 9.4e-5, the second one's
    first half-step (B) departs by 1e-3 and 2.2e-3, in exact mode (f32
    operands, three iterations) they agree to 2.7e-6 and 3.3e-6, and a
    one-ulp change of the init alone moves the port's own weighted fit by
    2.6e-3: flipped bf16 roundings, which truncated CG carries.  The two
    cases keep their ids at one bf16 iteration, and
    test_two_iteration_cases_match_jax_in_float64 holds their three
    iterations in float64 (the bucketed collective route, both packages)
    at 1e-8.
"""

import numpy as np
import pytest
import torch

from cmfrec_tpu.solvers import collective as jcollective
from cmfrec_tpu.solvers.dense_pallas import fit_collective_dense_pallas
from cmfrec_torch.solvers import collective
from cmfrec_torch.solvers.dense_masked import fit_collective_dense_masked

M, N, K, P, Q = 64, 48, 4, 5, 3
TOL_F32, TOL_BF16 = 5e-5, 5e-4
KEYS = ("A", "B", "biasA", "biasB", "C", "D", "Ai", "Bi")


def _data(seed=6, weighted=False):
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, M * N, 1400))  # the dense scatter dedupes
    ro, co = pairs // N, pairs % N
    A0, B0 = rng.normal(size=(M, K)), rng.normal(size=(N, K))
    # half-point grid: exact in the engine's bf16 X storage
    vals = np.round(2 * ((A0 @ B0.T)[ro, co] + 3
                         + 0.3 * rng.normal(size=ro.size))) / 2
    wts = (np.round(rng.uniform(0.5, 2.0, size=ro.size) * 8) / 8
           if weighted else None)
    U = A0 @ rng.normal(size=(K, P)) + 0.5 * rng.normal(size=(M, P))
    I = B0 @ rng.normal(size=(K, Q)) + 0.5 * rng.normal(size=(N, Q))
    U, I = ((S - S.mean(axis=0)).astype(np.float32) for S in (U, I))
    init = dict(A=0.3 * rng.normal(size=(M, K)), B=0.3 * rng.normal(size=(N, K)),
                biasA=0.1 * rng.normal(size=M), biasB=0.1 * rng.normal(size=N))
    init = {key: v.astype(np.float32) for key, v in init.items()}
    return ro, co, vals, wts, U, I, init


def _fit_both(ro, co, vals, wts, U, I, init, **kw):
    common = dict(U_dense=U, I_dense=I, weights=wts, k=K,
                  lam6=np.array([0.5, 0.6, 0.7, 0.8, 0.9, 1.1]), w_user=0.8,
                  w_item=1.3, max_cg_steps=3, finalize_chol=True,
                  finalize_steps=16, user_bias=True, item_bias=True,
                  glob_mean=float(np.mean(vals)), scale_lam=False, seed=3,
                  verbose=False, init=init)
    common.update(kw)
    rj = fit_collective_dense_pallas(ro, co, vals, M, N, dtype=np.float32,
                                     interpret=True, **common)
    rt = fit_collective_dense_masked(ro, co, vals, M, N, device="cpu",
                                     **common)
    return rj, rt


def _assert_close(rj, rt, ro, co, tol):
    for key in KEYS:
        if rj[key] is None:
            assert rt[key] is None, key
            continue
        assert rt[key].dtype == torch.float32 and rt[key].device.type == "cpu"
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(rj[key]),
                                   rtol=0, atol=tol, err_msg=key)

    def pred(r):
        r = {key: None if v is None else np.asarray(v, np.float64)
             for key, v in r.items() if key in KEYS}
        p = np.einsum("ek,ek->e", r["A"][ro], r["B"][co])
        for key, idx in (("biasA", ro), ("biasB", co)):
            if r[key] is not None:
                p = p + r[key][idx]
        return p

    np.testing.assert_allclose(pred(rt), pred(rj), rtol=0, atol=tol)


SCALED = dict(scale_lam=True, scale_lam_sideinfo=True, scale_bias_const=True)


@pytest.mark.parametrize("case,kw,side,weighted,tol", [
    # 2 bf16 bulk iterations, then the f32 polish
    ("U_only", dict(niter=3), "U", False, TOL_BF16),
    ("I_only", dict(niter=3), "I", False, TOL_BF16),
    ("U_and_I", dict(niter=3), "UI", False, TOL_BF16),
    ("implicit_features", dict(niter=3, add_implicit_features=True), "",
     False, TOL_BF16),
    ("implicit_features_and_side_info",
     dict(niter=3, add_implicit_features=True, w_implicit=0.7), "UI", False,
     TOL_BF16),
    ("scale_lam_sideinfo_bias_const",
     dict(niter=3, add_implicit_features=True, **SCALED), "UI", False,
     TOL_BF16),
    # one bf16 iteration (see the module's notes; their three iterations
    # are held in float64 below)
    ("weighted_side_info", dict(niter=1, finalize_chol=False), "UI", True,
     TOL_BF16),
    ("no_biases", dict(niter=1, finalize_chol=False, user_bias=False,
                       item_bias=False), "U", False, TOL_BF16),
    # f32 throughout
    ("exact_mode", dict(niter=2, exact=True, add_implicit_features=True),
     "UI", False, TOL_F32),
    ("exact_weighted_scaled", dict(niter=2, exact=True, **SCALED), "UI",
     True, TOL_F32),
    # niter=1 with the polish: a single f32 iteration
    ("one_f32_iteration", dict(niter=1, add_implicit_features=True), "UI",
     False, TOL_F32),
    ("one_f32_iteration_scaled",
     dict(niter=1, add_implicit_features=True, **SCALED), "U", False,
     TOL_F32),
])
def test_collective_fit_matches_pallas(case, kw, side, weighted, tol):
    ro, co, vals, wts, U, I, init = _data(weighted=weighted)
    rj, rt = _fit_both(ro, co, vals, wts, U if "U" in side else None,
                       I if "I" in side else None, init, **kw)
    if "U" in side:
        assert rt["C"].shape == (P, K)
    _assert_close(rj, rt, ro, co, tol)


@pytest.mark.parametrize("case,kw,side,weighted", [
    ("weighted_side_info", {}, "UI", True),
    ("no_biases", dict(user_bias=False, item_bias=False), "U", False),
], ids=["weighted_side_info", "no_biases"])
def test_two_iteration_cases_match_jax_in_float64(case, kw, side, weighted):
    """The three iterations of weighted_side_info and no_biases in float64,
    through both packages' collective drivers (their bucketed route: the
    dense engines are float32), from one init=: every factor within 1e-8
    of max|cmfrec_tpu's|."""
    ro, co, vals, wts, U, I, init = _data(weighted=weighted)
    sides = {f"side_{key}": (None, None, None, S.shape[0], S.shape[1], True,
                             S.astype(np.float64))
             for key, S in (("U", U), ("I", I)) if key in side}
    init = {key: v.astype(np.float64) for key, v in init.items()}
    common = dict(k=K, lambda_=[0.5, 0.6, 0.7, 0.8, 0.9, 1.1], w_user=0.8,
                  w_item=1.3, niter=3, max_cg_steps=3, finalize_chol=True,
                  weights=wts, seed=3, init=init, dtype=np.float64, **sides,
                  **kw)
    rj = jcollective.fit_collective_explicit_als(ro, co, vals, M, N, **common)
    rt = collective.fit_collective_explicit_als(ro, co, vals, M, N,
                                                device="cpu", **common)
    for key in KEYS:
        if rj[key] is None:
            assert rt[key] is None, key
            continue
        want = np.asarray(rj[key])
        assert rt[key].dtype == torch.float64, key
        assert (np.abs(rt[key].numpy() - want).max()
                <= 1e-8 * np.abs(want).max()), key


@pytest.mark.parametrize("seed", [1, 3, 5, 6])
def test_one_bf16_iteration_at_every_seed(seed):
    """One bf16 bulk iteration with side info and implicit features holds
    the bf16 tolerance at any data seed (readings <= 1.1e-5 over eight
    seeds), where the cases of two bf16 iterations run on one seed."""
    ro, co, vals, wts, U, I, init = _data(seed)
    rj, rt = _fit_both(ro, co, vals, wts, U, I, init, niter=1,
                       finalize_chol=False, add_implicit_features=True)
    _assert_close(rj, rt, ro, co, TOL_BF16)


def test_niter_zero_side_factors_are_the_closed_form():
    """With no iteration the returned factors are the init, and C, D, Ai
    and Bi are solved from it: the numpy closed forms (the JAX package's
    dense route returns the same C/D; it leaves Ai/Bi at zero)."""
    ro, co, vals, _, U, I, init = _data()
    lam6 = np.array([0.5, 0.6, 0.7, 0.8, 0.9, 1.1])
    w_user, w_item, w_imp = 0.8, 1.3, 0.5
    rj, rt = _fit_both(ro, co, vals, None, U, I, init, niter=0,
                       add_implicit_features=True, w_implicit=w_imp)
    for key in ("A", "B", "biasA", "biasB"):
        np.testing.assert_array_equal(rt[key].numpy(), init[key])
    A, B = (init[key].astype(np.float64) for key in ("A", "B"))
    eye = np.eye(K)
    C = np.linalg.solve(w_user * A.T @ A + lam6[4] * eye, w_user * A.T @ U).T
    D = np.linalg.solve(w_item * B.T @ B + lam6[5] * eye, w_item * B.T @ I).T
    mask = np.zeros((M, N))
    mask[ro, co] = 1.0
    Ai = np.linalg.solve(B.T @ B + lam6[2] / w_imp * eye, (mask @ B).T).T
    Bi = np.linalg.solve(A.T @ A + lam6[3] / w_imp * eye, (mask.T @ A).T).T
    for key, want in (("C", C), ("D", D), ("Ai", Ai), ("Bi", Bi)):
        np.testing.assert_allclose(rt[key].numpy(), want, rtol=0,
                                   atol=TOL_F32, err_msg=key)
    for key in ("C", "D"):
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(rj[key]),
                                   rtol=0, atol=TOL_F32, err_msg=key)
