"""cmfrec_torch.ops.rowsolve against cmfrec_tpu.ops.rowsolve on the same
numpy inputs, in f32.  Tolerance: the same f32 arithmetic in another
summation order, max |difference| <= 2e-5 * max |JAX result| (every case
reads below 2e-6 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmfrec_torch.ops import rowsolve
from cmfrec_tpu.ops import rowsolve as jax_rowsolve

REL_TOL = 2e-5


def _parts(rng, n_parts, R=48, L=12, K=8):
    """n_parts random sparse parts of one bucket (second part: side-info
    shaped, fewer slots)."""
    out = []
    for i in range(n_parts):
        S, Li = (90, L) if i == 0 else (30, L // 2)
        mat = (rng.normal(size=(S, K)) / np.sqrt(K)).astype(np.float32)
        idx = rng.integers(0, S, size=(R, Li)).astype(np.int32)
        length = rng.integers(0, Li + 1, size=R)
        msk = (np.arange(Li)[None, :] < length[:, None]).astype(np.float32)
        cw = (rng.uniform(0.5, 3.0, size=(R, Li)) * msk).astype(np.float32)
        cv = (rng.normal(size=(R, Li)) * msk).astype(np.float32)
        out.append((mat, idx, cw, cv))
    return out


def _both(parts):
    return ([rowsolve.SparsePart(*map(torch.as_tensor, p)) for p in parts],
            [jax_rowsolve.SparsePart(*map(jnp.asarray, p)) for p in parts])


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())


def _extras(rng, R, K, lam_mult, G0, r0):
    lm = (rng.integers(1, 20, R).astype(np.float32) if lam_mult else None)
    B = rng.normal(size=(K, K)).astype(np.float32)
    g0 = (B @ B.T / K).astype(np.float32) if G0 else None
    rr = rng.normal(size=(R, K)).astype(np.float32) if r0 else None
    return lm, g0, rr


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("extras", [(False, False, False), (True, True, True)],
                         ids=["plain", "lam_mult-G0-r0"])
def test_assemble_and_solve_chol(rng, n_parts, extras):
    parts = _parts(rng, n_parts)
    R, K = parts[0][1].shape[0], parts[0][0].shape[1]
    lam = np.full(K, 0.7, np.float32)
    lm, g0, rr = _extras(rng, R, K, *extras)
    tp, jp = _both(parts)
    G, rhs = rowsolve.assemble_system(tp, torch.as_tensor(lam), _t(lm),
                                      _t(g0), _t(rr))
    Gj, rhsj = jax_rowsolve.assemble_system(jp, jnp.asarray(lam), _j(lm),
                                            _j(g0), _j(rr))
    _close(G, Gj)
    _close(rhs, rhsj)
    _close(rowsolve.solve_chol(G, rhs), jax_rowsolve.solve_chol(Gj, rhsj))


def test_solve_shared_chol(rng):
    K, R = 8, 40
    B = rng.normal(size=(K + 3, K)).astype(np.float32)
    G = (B.T @ B + np.eye(K)).astype(np.float32)
    rhs = rng.normal(size=(R, K)).astype(np.float32)
    _close(rowsolve.solve_shared_chol(torch.as_tensor(G),
                                      torch.as_tensor(rhs)),
           jax_rowsolve.solve_shared_chol(jnp.asarray(G), jnp.asarray(rhs)))


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("extras", [(False, False, False), (True, True, True),
                                    (False, True, False)],
                         ids=["plain", "lam_mult-G0-r0", "G0"])
@pytest.mark.parametrize("jacobi", [False, True])
def test_solve_cg(rng, n_parts, extras, jacobi):
    parts = _parts(rng, n_parts)
    R, K = parts[0][1].shape[0], parts[0][0].shape[1]
    lam = np.full(K, 1.3, np.float32)
    lm, g0, rr = _extras(rng, R, K, *extras)
    a0 = (0.1 * rng.normal(size=(R, K))).astype(np.float32)
    tp, jp = _both(parts)
    got = rowsolve.solve_cg(tp, torch.as_tensor(lam), torch.as_tensor(a0),
                            n_steps=3, lam_mult=_t(lm), G0=_t(g0), r0=_t(rr),
                            jacobi=jacobi)
    want = jax_rowsolve.solve_cg(jp, jnp.asarray(lam), jnp.asarray(a0),
                                 n_steps=3, lam_mult=_j(lm), G0=_j(g0),
                                 r0=_j(rr), jacobi=jacobi)
    _close(got, want)


def test_cg_skips_and_freezes_rows():
    """A row already at its solution is skipped (bitwise unchanged); a row
    whose residual falls below the freeze tolerance stops moving."""
    K = 4
    G = torch.eye(K) * 2.0
    rhs = torch.tensor([[2.0, 4.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0]])
    a0 = torch.tensor([[1.0, 2.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    a = rowsolve.cg_iterations(lambda v: v @ G, rhs, a0, n_steps=5)
    assert torch.equal(a[0], a0[0])
    torch.testing.assert_close(a[1], torch.full((K,), 0.5), rtol=0, atol=1e-7)


def test_length_mask():
    got = rowsolve.length_mask(torch.tensor([0, 2, 5]), 4)
    want = jax_rowsolve.length_mask(jnp.asarray([0, 2, 5], jnp.int32), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
