"""cmfrec_torch.ops.sparse_cg's plain twin (the op on CPU tensors) against
cmfrec_tpu's fused bucket-CG Pallas kernels in interpret mode and against
cmfrec_tpu.ops.rowsolve.solve_cg, mirroring tests/test_sparse_cg.py, plus
the wrapper's checks.  The kernel itself (CUDA) is held against the twin on
the card by tests/test_torch_kernels_gpu.py.

Tolerances: f32, the same arithmetic in another summation order: rtol 1e-5,
atol 1e-6, as tests/test_sparse_cg.py holds the Pallas kernel to solve_cg.
bf16 twin against solve_cg(mxu_bf16=True), the same rounding points: 1e-4
of max |solve_cg| (a flipped bf16 rounding of t is 2**-8 of one slot's
term)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmfrec_torch.ops import sparse_cg
from cmfrec_tpu.ops import sparse_cg as jax_sparse_cg
from cmfrec_tpu.ops.rowsolve import SparsePart, solve_cg


def make_bucket(rng, R=64, L=16, S=96, K=8, implicit=False):
    """tests/test_sparse_cg.py's bucket."""
    mat = rng.normal(size=(S, K)).astype(np.float32)
    idx = rng.integers(0, S, size=(R, L)).astype(np.int32)
    length = rng.integers(0, L + 1, size=R).astype(np.int32)
    msk = (np.arange(L)[None, :] < length[:, None]).astype(np.float32)
    if implicit:
        x = rng.uniform(1, 10, size=(R, L)).astype(np.float32)
        cw = 0.7 * x * msk
        cv = (1.0 + 0.7 * x) * msk
    else:
        val = rng.normal(size=(R, L)).astype(np.float32)
        cw = msk
        cv = val * msk
    return mat, idx, cw, cv, length


def _twin(mat, idx, cw, cv, gfix, lam_row, r0, a0, steps, length):
    t = [x if x is None or isinstance(x, torch.Tensor)
         else torch.as_tensor(np.array(x))
         for x in (mat, idx, cw, cv, gfix, lam_row, r0, a0, length)]
    return sparse_cg.bucket_cg(*t[:8], n_steps=steps, length=t[8]).numpy()


@pytest.mark.parametrize("implicit", [False, True])
@pytest.mark.parametrize("steps", [1, 3])
def test_twin_matches_pallas_and_solve_cg(rng, implicit, steps):
    mat, idx, cw, cv, length = make_bucket(rng, implicit=implicit)
    K, R = mat.shape[1], idx.shape[0]
    lam_vec = jnp.full(K, 1.3, jnp.float32)
    a0 = (0.1 * rng.normal(size=(R, K))).astype(np.float32)
    G0 = jnp.asarray(mat.T @ mat) if implicit else None
    part = SparsePart(*map(jnp.asarray, (mat, idx, cw, cv)))
    want = np.asarray(solve_cg([part], lam_vec, jnp.asarray(a0),
                               n_steps=steps, G0=G0))
    gfix = (G0 + jnp.diag(lam_vec)) if G0 is not None else jnp.diag(lam_vec)
    ms = jnp.take(jnp.asarray(mat), jnp.asarray(idx), axis=0)
    pallas = np.asarray(jax_sparse_cg.bucket_cg(
        ms, jnp.asarray(cw), jnp.asarray(cv), gfix, None, None,
        jnp.asarray(a0), n_steps=steps, interpret=True))
    got = _twin(mat, idx, cw, cv, gfix, None, None, a0, steps, length)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)


def test_twin_with_r0_and_lam_row(rng):
    """Per-row lambda (scale_lam) + rhs base (NA-as-zero) variant."""
    mat, idx, cw, cv, length = make_bucket(rng)
    K, R = mat.shape[1], idx.shape[0]
    lam_vec = jnp.full(K, 0.4, jnp.float32)
    lam_mult = jnp.asarray(rng.integers(1, 20, R).astype(np.float32))
    r0 = jnp.asarray(rng.normal(size=(R, K)).astype(np.float32))
    a0 = jnp.zeros((R, K), jnp.float32)
    part = SparsePart(*map(jnp.asarray, (mat, idx, cw, cv)))
    want = np.asarray(solve_cg([part], lam_vec, a0, n_steps=4,
                               lam_mult=lam_mult, r0=r0))
    lam_row = lam_vec[None, :] * lam_mult[:, None]
    gfix = jnp.zeros((K, K), jnp.float32)
    ms = jnp.take(jnp.asarray(mat), jnp.asarray(idx), axis=0)
    pallas = np.asarray(jax_sparse_cg.bucket_cg(
        ms, jnp.asarray(cw), jnp.asarray(cv), gfix, lam_row, r0, a0,
        n_steps=4, interpret=True))
    got = _twin(mat, idx, cw, cv, gfix, lam_row, r0, a0, 4, length)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("implicit", [False, True])
def test_twin_covers_the_packed_kernel(rng, implicit):
    """K4 (pack-2 lanes, K <= 64) solves K3's system: the twin at K = 8
    reproduces bucket_cg_packed, which runs at K padded to 64."""
    mat, idx, cw, cv, length = make_bucket(rng, implicit=implicit)
    K, R = mat.shape[1], idx.shape[0]
    a0 = (0.05 * rng.normal(size=(R, K))).astype(np.float32)
    G0 = mat.T @ mat if implicit else np.zeros((K, K), np.float32)
    gfix = (G0 + np.diag(np.full(K, 1.1, np.float32))).astype(np.float32)

    K2 = 64
    mat64 = np.zeros((mat.shape[0], K2), np.float32)
    mat64[:, :K] = mat
    ms = jnp.take(jnp.asarray(mat64), jnp.asarray(idx), axis=0)
    ms2 = jnp.concatenate([ms[:, 0::2, :], ms[:, 1::2, :]], axis=2)
    gfix64 = np.zeros((K2, K2), np.float32)
    gfix64[:K, :K] = gfix
    packed = np.asarray(jax_sparse_cg.bucket_cg_packed(
        ms2, jnp.asarray(cw[:, 0::2]), jnp.asarray(cw[:, 1::2]),
        jnp.asarray(cv[:, 0::2]), jnp.asarray(cv[:, 1::2]),
        jnp.asarray(gfix64), None, None,
        jnp.pad(jnp.asarray(a0), ((0, 0), (0, K2 - K))), n_steps=3,
        interpret=True))[:, :K]
    got = _twin(mat, idx, cw, cv, gfix, None, None, a0, 3, length)
    np.testing.assert_allclose(got, packed, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("implicit", [False, True])
def test_bf16_twin_matches_solve_cg_mxu_bf16(rng, implicit):
    mat, idx, cw, cv, length = make_bucket(rng, R=32, L=8, S=48, K=8,
                                           implicit=implicit)
    K, R = mat.shape[1], idx.shape[0]
    lam_vec = jnp.full(K, 1.0, jnp.float32)
    a0 = np.zeros((R, K), np.float32)
    part = SparsePart(*map(jnp.asarray, (mat, idx, cw, cv)))
    want = np.asarray(solve_cg([part], lam_vec, jnp.asarray(a0), n_steps=3,
                               mxu_bf16=True))
    got = _twin(torch.as_tensor(mat).to(torch.bfloat16), idx, cw, cv,
                np.diag(np.ones(K, np.float32)), None, None, a0, 3, length)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _args(K=8, R=4, L=6, S=10, mat_dtype=torch.float32):
    return dict(mat=torch.zeros(S, K, dtype=mat_dtype),
                idx=torch.zeros(R, L, dtype=torch.int32),
                cw=torch.zeros(R, L), cv=torch.zeros(R, L),
                gfix=torch.eye(K), lam_row=None, r0=None,
                a0=torch.zeros(R, K), length=torch.zeros(R, dtype=torch.int32))


@pytest.mark.parametrize("change,match", [
    (dict(mat=torch.zeros(10, 8, dtype=torch.float64)), "mat must be"),
    (dict(mat=torch.zeros(10, 12), gfix=torch.eye(12),
          a0=torch.zeros(4, 12)), "multiple of 8"),
    (dict(mat=torch.zeros(10, 264), gfix=torch.eye(264),
          a0=torch.zeros(4, 264)), "multiple of 8"),
    (dict(idx=torch.zeros(4, 6, dtype=torch.int64)), "idx must be"),
    (dict(cw=torch.zeros(4, 5)), "cw must be"),
    (dict(cv=torch.zeros(4, 6, dtype=torch.bfloat16)), "cv must be"),
    (dict(gfix=torch.eye(16)), "gfix must be"),
    (dict(lam_row=torch.zeros(3, 8)), "lam_row must be"),
    (dict(r0=torch.zeros(4, 8, dtype=torch.float64)), "r0 must be"),
    (dict(a0=torch.zeros(4, 8).T.contiguous().T), "contiguous"),
    (dict(idx=torch.zeros(0, 6, dtype=torch.int32), cw=torch.zeros(0, 6),
          cv=torch.zeros(0, 6), a0=torch.zeros(0, 8)), "empty bucket"),
    (dict(length=torch.zeros(4, dtype=torch.int64)), "length must be"),
    (dict(length=torch.zeros(5, dtype=torch.int32)), "length must be"),
], ids=["mat-dtype", "K-12", "K-264", "idx-dtype", "cw-shape", "cv-dtype",
        "gfix-shape", "lam_row-shape", "r0-dtype", "non-contiguous",
        "empty", "length-dtype", "length-shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    kw = _args()
    kw.update(change)
    before = sparse_cg.bucket_cg.launches
    with pytest.raises(ValueError, match=match):
        sparse_cg.bucket_cg(**kw, n_steps=3)
    assert sparse_cg.bucket_cg.launches == before


def test_cpu_runs_the_twin_and_counts_no_launch():
    before = sparse_cg.bucket_cg.launches
    for dt in (torch.float32, torch.bfloat16):
        out = sparse_cg.bucket_cg(**_args(mat_dtype=dt), n_steps=2)
        assert out.dtype == torch.float32 and out.shape == (4, 8)
    assert sparse_cg.bucket_cg.launches == before == 0
