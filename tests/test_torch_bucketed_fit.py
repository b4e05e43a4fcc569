"""cmfrec_torch's bucketed engine against cmfrec_tpu.solvers.drivers on the
same data and the same init= factors (jax.random and torch draw different
numbers).  On the CPU both packages take the bucketed route in f32 (JAX's
bf16 operands are a TPU choice, the port's a card choice).  Pairs are
deduplicated (ROADMAP F5).

Tolerances (max |difference| of factors and biases): the same f32
arithmetic in another summation order; readings are ~2e-6 after 1
iteration and ~4e-6 after 3, so 1e-5 after one iteration and 5e-5 after
more."""

import numpy as np
import pytest

from cmfrec_torch.convert import init_from_arrays
from cmfrec_torch.solvers import drivers
from cmfrec_torch.utils.checkpoint import load_fit_checkpoint
from cmfrec_tpu.solvers import drivers as jax_drivers

M, N, K = 60, 40, 4


def _data(seed=2, k=K):
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, M * N, 700))
    rows, cols = pairs // N, pairs % N
    init = {"A": 0.3 * rng.normal(size=(M, k)),
            "B": 0.3 * rng.normal(size=(N, k)),
            "biasA": 0.1 * rng.normal(size=M),
            "biasB": 0.1 * rng.normal(size=N)}
    init = {key: v.astype(np.float32) for key, v in init.items()}
    return rng, rows, cols, init


def _compare(rj, rt, keys, tol):
    for key in keys:
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(rj[key]),
                                   rtol=0, atol=tol, err_msg=key)


@pytest.mark.parametrize("kw,tol", [
    (dict(niter=1), 1e-5),
    (dict(niter=3), 5e-5),
    (dict(niter=3, use_cg=False), 5e-5),
    (dict(niter=3, finalize_chol=True), 5e-5),
    (dict(niter=3, adjust_weight=True), 5e-5),
    (dict(niter=3, apply_log_transf=True), 5e-5),
], ids=["cg-1", "cg-3", "chol", "finalize_chol", "adjust_weight",
        "log_transf"])
def test_implicit_matches_jax(kw, tol):
    rng, rows, cols, init = _data()
    vals = rng.uniform(1, 10, rows.size)
    init = {key: init[key] for key in ("A", "B")}
    common = dict(k=K, lambda_=0.9, alpha=2.0, init=init, seed=3)
    rj = jax_drivers.fit_implicit_als(rows, cols, vals, M, N,
                                      dtype=np.float32, **common, **kw)
    common["init"] = init_from_arrays(init, "cpu")
    rt = drivers.fit_implicit_als(rows, cols, vals, M, N, device="cpu",
                                  **common, **kw)
    _compare(rj, rt, ("A", "B"), tol)
    assert rt["w_main_multiplier"] == pytest.approx(rj["w_main_multiplier"])


def test_log_transf_rejects_values_not_above_zero():
    _, rows, cols, _ = _data()
    vals = np.ones(rows.size)
    vals[3] = 0.0
    with pytest.raises(ValueError, match="apply_log_transf"):
        drivers.fit_implicit_als(rows, cols, vals, M, N, k=K, niter=1,
                                 apply_log_transf=True, device="cpu")


@pytest.mark.parametrize("kw,tol", [
    (dict(niter=1, finalize_chol=False), 1e-5),
    (dict(niter=3, scale_lam=True, scale_bias_const=True), 5e-5),
    (dict(niter=3, NA_as_zero=True, weighted=True), 5e-5),
    (dict(niter=3, NA_as_zero=True, use_cg=False), 5e-5),
    (dict(niter=3, finalize_chol=True, weighted=True), 5e-5),
], ids=["cg-1", "scale_lam-bias_const", "weighted-na0", "na0-chol",
        "finalize_chol-weighted"])
def test_explicit_sparse_matches_jax(kw, tol):
    rng, rows, cols, init = _data()
    vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
    kw = dict(kw)
    if kw.pop("weighted", False):
        kw["weights"] = rng.uniform(0.5, 2.0, rows.size)
    common = dict(k=K, lambda_=0.5, engine="sparse", seed=3, **kw)
    rj = jax_drivers.fit_explicit_als(rows, cols, vals, M, N, init=init,
                                      dtype=np.float32, **common)
    rt = drivers.fit_explicit_als(rows, cols, vals, M, N, device="cpu",
                                  init=init_from_arrays(init, "cpu"),
                                  **common)
    _compare(rj, rt, ("A", "B", "biasA", "biasB"), tol)
    assert rt["glob_mean"] == pytest.approx(rj["glob_mean"])


@pytest.mark.parametrize("fit,k", [("explicit", 300), ("implicit", 260)])
def test_k_beyond_the_kernels_matches_jax(fit, k):
    """Fault P1: k=300 (explicit, K=304) and k=260 (implicit, K=264) exceed
    the card kernels' 256; the CPU twins take any K.  Two CG iterations
    from shared factors; tolerance as above."""
    rng, rows, cols, init = _data(k=k)
    if fit == "implicit":
        vals = rng.uniform(1, 10, rows.size)
        init = {key: init[key] for key in ("A", "B")}
        common = dict(k=k, lambda_=0.9, alpha=2.0, niter=2, seed=3)
        call, jcall = drivers.fit_implicit_als, jax_drivers.fit_implicit_als
        keys = ("A", "B")
    else:
        vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
        common = dict(k=k, lambda_=0.5, niter=2, engine="sparse", seed=3)
        call, jcall = drivers.fit_explicit_als, jax_drivers.fit_explicit_als
        keys = ("A", "B", "biasA", "biasB")
    rj = jcall(rows, cols, vals, M, N, init=init, dtype=np.float32, **common)
    rt = call(rows, cols, vals, M, N, device="cpu",
              init=init_from_arrays(init, "cpu"), **common)
    assert rt["A"].shape == (M, k)
    _compare(rj, rt, keys, 5e-5)


def test_implicit_checkpoint_resume(tmp_path):
    """Mirror of tests/test_checkpoint.py::test_implicit_checkpoint_resume
    on the port: checkpoints at 2 and 4 of 6 iterations; resuming from 4
    reproduces the uninterrupted fit (same arithmetic, same order)."""
    rng = np.random.default_rng(2)
    m, n, nnz = 40, 25, 300
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    _, uix = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[uix], cols[uix]
    vals = rng.uniform(1, 10, rows.size)
    path = str(tmp_path / "ck.npz")
    kw = dict(k=4, lambda_=0.9, alpha=2.0, use_cg=True, finalize_chol=True,
              seed=3, device="cpu")
    full = drivers.fit_implicit_als(rows, cols, vals, m, n, niter=6, **kw)
    drivers.fit_implicit_als(rows, cols, vals, m, n, niter=6,
                             checkpoint_path=path, checkpoint_every=2, **kw)
    init, done = load_fit_checkpoint(path)
    assert done == 4
    resumed = drivers.fit_implicit_als(rows, cols, vals, m, n, niter=2,
                                       init=init, **kw)
    for key in ("A", "B"):
        np.testing.assert_allclose(resumed[key].numpy(), full[key].numpy(),
                                   rtol=0, atol=1e-6, err_msg=key)
