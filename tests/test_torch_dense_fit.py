"""cmfrec_torch's dense-masked engine against cmfrec_tpu's
fit_explicit_dense_pallas (Pallas kernels in interpret mode) on the same
data and the same init= factors (jax.random and torch draw different
numbers, so both start from one numpy init).

Tolerances (max abs difference of factors, biases and predictions):
  * f32 operands (the polish, exact mode, NA-as-zero closed form): the same
    f32 arithmetic in another summation order; ~4e-6 measured, 5e-5.
  * bf16 bulk iterations: a one-ulp flip of a bf16-rounded T*W entry moves
    a CG iterate and later iterations carry it; ~3e-5 measured, 5e-4.
"""

import numpy as np
import pytest
import torch

from cmfrec_tpu.solvers.dense_pallas import (
    _cg as jax_cg,
    fit_explicit_dense_pallas,
)
from cmfrec_torch.convert import init_from_arrays
from cmfrec_torch.solvers import drivers
from cmfrec_torch.solvers.dense_masked import _cg, fit_explicit_dense_masked

M, N, K = 64, 48, 4
TOL_F32, TOL_BF16 = 5e-5, 5e-4


def _data(seed=5, weighted=False, k=K):
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, M * N, 1400))  # the dense scatter dedupes
    ro, co = pairs // N, pairs % N
    A0, B0 = rng.normal(size=(M, K)), rng.normal(size=(N, K))
    # half-point grid: exact in the engine's bf16 X storage
    vals = np.round(2 * ((A0 @ B0.T)[ro, co] + 3
                         + 0.3 * rng.normal(size=ro.size))) / 2
    wts = (np.round(rng.uniform(0.5, 2.0, size=ro.size) * 8) / 8
           if weighted else None)
    init = dict(A=0.3 * rng.normal(size=(M, k)), B=0.3 * rng.normal(size=(N, k)),
                biasA=0.1 * rng.normal(size=M), biasB=0.1 * rng.normal(size=N))
    init = {key: v.astype(np.float32) for key, v in init.items()}
    return ro, co, vals, wts, init


def _fit_both(ro, co, vals, wts, init, **kw):
    common = dict(weights=wts, k=K, lam6=np.full(6, 0.5), max_cg_steps=3,
                  finalize_chol=True, finalize_steps=16, user_bias=True,
                  item_bias=True, glob_mean=float(np.mean(vals)),
                  scale_lam=False, scale_bias_const=False, seed=3,
                  verbose=False)
    common.update(kw)
    rj = fit_explicit_dense_pallas(ro, co, vals, M, N, biasA0=None,
                                   biasB0=None, dtype=np.float32,
                                   interpret=True, init=init, **common)
    rt = fit_explicit_dense_masked(
        ro, co, vals, M, N, device="cpu",
        init=None if init is None else init_from_arrays(init, "cpu"),
        **common)
    return rj, rt


def _assert_close(rj, rt, ro, co, tol):
    for key in ("A", "B", "biasA", "biasB"):
        if rj[key] is None:
            assert rt[key] is None
            continue
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(rj[key]),
                                   rtol=0, atol=tol, err_msg=key)

    def pred(r):
        A, B = np.asarray(r["A"], np.float64), np.asarray(r["B"], np.float64)
        p = r["glob_mean"] + np.einsum("ek,ek->e", A[ro], B[co])
        for key, idx in (("biasA", ro), ("biasB", co)):
            if r[key] is not None:
                p = p + np.asarray(r[key], np.float64)[idx]
        return p

    rt_np = {key: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for key, v in rt.items()}
    np.testing.assert_allclose(pred(rt_np), pred(rj), rtol=0, atol=tol)


@pytest.mark.parametrize("case,kw,weighted,tol", [
    # niter=1 with the polish: a single f32 iteration
    ("one_f32_iteration", dict(niter=1), False, TOL_F32),
    # 3 bf16 bulk iterations, then the f32 polish
    ("bulk_bf16_then_polish", dict(niter=4), False, TOL_BF16),
    ("exact_mode", dict(niter=2, exact=True), False, TOL_F32),
    ("scale_lam_bias_const", dict(niter=3, scale_lam=True,
                                  scale_bias_const=True), False, TOL_BF16),
    ("weighted", dict(niter=3), True, TOL_BF16),
    ("weighted_exact_scale_lam", dict(niter=2, exact=True, scale_lam=True),
     True, TOL_F32),
    ("na_as_zero", dict(niter=3, na_as_zero=True), False, TOL_F32),
    ("no_biases", dict(niter=3, user_bias=False, item_bias=False), False,
     TOL_BF16),
])
def test_dense_fit_matches_pallas(case, kw, weighted, tol):
    ro, co, vals, wts, init = _data(weighted=weighted)
    rj, rt = _fit_both(ro, co, vals, wts, init, **kw)
    assert rt["A"].device.type == "cpu" and rt["A"].dtype == torch.float32
    _assert_close(rj, rt, ro, co, tol)


def test_k_beyond_the_kernels_matches_pallas():
    """Fault P1: k=300 pads to K=320, past the card kernels' 256; the CPU
    twins take any K.  One f32 iteration (the polish) from shared factors.
    16 CG steps on 301-wide systems carry the f32 summation order ~10x as
    far as at k=4 (4e-5 measured on the factors, 1.6e-4 on predictions,
    which sum 300 products), hence TOL_BF16."""
    ro, co, vals, _, init = _data(k=300)
    rj, rt = _fit_both(ro, co, vals, None, init, niter=1, k=300)
    assert rt["A"].shape == (M, 300)
    _assert_close(rj, rt, ro, co, TOL_BF16)


def test_device_bias_init_matches_pallas():
    """Without init biases both engines start from their on-device 5-pass
    two-sided bias init; one f32 iteration from shared A/B pins it."""
    ro, co, vals, _, init = _data(seed=6)
    ab = dict(A=init["A"], B=init["B"])
    rj, rt = _fit_both(ro, co, vals, None, ab, niter=1, scale_lam=True)
    _assert_close(rj, rt, ro, co, TOL_F32)


def test_niter_zero_returns_init():
    ro, co, vals, _, init = _data()
    rj, rt = _fit_both(ro, co, vals, None, init, niter=0)
    for key in ("A", "B", "biasA", "biasB"):
        np.testing.assert_array_equal(rt[key].numpy(), init[key])
        np.testing.assert_array_equal(np.asarray(rj[key]), init[key])


@pytest.mark.parametrize("dyn_stop", [False, True])
def test_cg_matches_jax(dyn_stop):
    """The CG loop against cmfrec_tpu's on per-row SPD systems; the
    all-frozen exit (dyn_stop) returns exactly the fixed-step result."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    R, k = 64, 8
    Mx = rng.normal(size=(R, k, k))
    G = (np.einsum("rik,rjk->rij", Mx, Mx) + 2.0 * np.eye(k)).astype(np.float32)
    rhs = rng.normal(size=(R, k)).astype(np.float32)
    Gt, Gj = torch.from_numpy(G), jnp.asarray(G)
    a_t = _cg(torch.zeros(R, k), torch.from_numpy(rhs),
              lambda v: torch.einsum("rij,rj->ri", Gt, v), k + 1,
              dyn_stop=dyn_stop)
    a_j = jax_cg(jnp.zeros((R, k), jnp.float32), jnp.asarray(rhs),
                 lambda v: jnp.einsum("rij,rj->ri", Gj, v), k + 1,
                 dyn_stop=dyn_stop)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=1e-5)
    a_fixed = _cg(torch.zeros(R, k), torch.from_numpy(rhs),
                  lambda v: torch.einsum("rij,rj->ri", Gt, v), k + 1)
    np.testing.assert_array_equal(a_t.numpy(), a_fixed.numpy())
    ref = np.linalg.solve(G.astype(np.float64), rhs[..., None])[..., 0]
    np.testing.assert_allclose(a_t.numpy(), ref, rtol=0, atol=1e-4)


def test_checkpoint_resume_and_cross_load(tmp_path):
    """A mid-fit checkpoint written by the port loads through cmfrec_tpu's
    reader, and resuming from it reproduces the uninterrupted fit."""
    from cmfrec_tpu.utils.checkpoint import load_fit_checkpoint

    ro, co, vals, _, init = _data()
    kw = dict(k=K, lambda_=0.5, max_cg_steps=3, seed=3, device="cpu")
    path = str(tmp_path / "ckpt.npz")
    full = drivers.fit_explicit_als(ro, co, vals, M, N, niter=4, init=init,
                                    checkpoint_path=path, checkpoint_every=2,
                                    **kw)
    state, done = load_fit_checkpoint(path)
    assert done == 2
    resumed = drivers.fit_explicit_als(ro, co, vals, M, N, niter=2,
                                       init=state, **kw)
    for key in ("A", "B", "biasA", "biasB"):
        np.testing.assert_array_equal(resumed[key].numpy(),
                                      full[key].numpy())
