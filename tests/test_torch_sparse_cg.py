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


def _args(K=8, R=4, L=6, S=10, mat_dtype=torch.float32, device="cpu"):
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return dict(mat=z(S, K, dtype=mat_dtype), idx=z(R, L, dtype=torch.int32),
                cw=z(R, L), cv=z(R, L), gfix=z(K, K), lam_row=None, r0=None,
                a0=z(R, K), length=z(R, dtype=torch.int32))


@pytest.mark.parametrize("change,match", [
    (dict(mat=torch.zeros(10, 8, dtype=torch.float64)), "mat must be"),
    (dict(mat=torch.zeros(10, 12), gfix=torch.eye(12),
          a0=torch.zeros(4, 12)), "multiple of 8"),
    # off the CPU and off a card (here tensors without data): K=264 is no
    # longer refused (a block a row loops over K), but no kernel runs there
    (_args(K=264, device="meta"), "no kernel for device meta"),
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


@pytest.mark.parametrize("implicit", [False, True])
def test_twin_takes_k_beyond_the_kernel(rng, implicit):
    """Fault P1: the twin at K=264 (k=260 implicit), past the card kernel's
    256, against the Pallas kernel in interpret mode.  Each dot sums 264
    products of rows with |m|^2 ~ 264: atol 1e-5 (1.3e-6 measured)."""
    mat, idx, cw, cv, length = make_bucket(rng, R=16, L=8, S=40, K=264,
                                           implicit=implicit)
    K, R = mat.shape[1], idx.shape[0]
    a0 = (0.05 * rng.normal(size=(R, K))).astype(np.float32)
    gfix = (mat.T @ mat if implicit else np.zeros((K, K), np.float32)
            ) + np.diag(np.full(K, 1.2, np.float32))
    ms = jnp.take(jnp.asarray(mat), jnp.asarray(idx), axis=0)
    pallas = np.asarray(jax_sparse_cg.bucket_cg(
        ms, jnp.asarray(cw), jnp.asarray(cv), jnp.asarray(gfix), None, None,
        jnp.asarray(a0), n_steps=3, interpret=True))
    got = _twin(mat, idx, cw, cv, gfix, None, None, a0, 3, length)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_cpu_runs_the_twin_and_counts_no_launch():
    before = sparse_cg.bucket_cg.launches
    for dt in (torch.float32, torch.bfloat16):
        out = sparse_cg.bucket_cg(**_args(mat_dtype=dt), n_steps=2)
        assert out.dtype == torch.float32 and out.shape == (4, 8)
    assert sparse_cg.bucket_cg.launches == before == 0


# K3's launch planner (pure Python; the card supplies only its SM count)
# what an H100 reports: SMs, opt-in shared memory a block (bytes)
H100 = (132, 227 * 1024)
LASTFM_BUCKETS = [  # (R, L) of the LastFM-shaped layout, both sides
    (40, 3400), (400, 912), (1496, 376), (3752, 216), (7688, 144),
    (13360, 104), (21304, 80), (20208, 64), (34392, 56), (61784, 48),
    (99928, 40), (95040, 32), (40, 31592), (88, 14048), (184, 6632),
    (392, 3240), (744, 1640), (1536, 904), (3032, 504), (6672, 296),
    (12680, 176), (26760, 112), (43672, 72), (64392, 48)]


@pytest.mark.parametrize("K,esz", [(8, 2), (56, 2), (56, 4), (136, 2),
                                   (256, 4)])
@pytest.mark.parametrize("R,L", LASTFM_BUCKETS + [(1, 1), (3, 31600)])
def test_k3_plan_fits_a_block_and_covers_the_row(R, L, K, esz):
    plan = sparse_cg.k3_plan(R, L, K, esz, *H100)
    assert plan["smem"] <= sparse_cg.BLOCK_SMEM
    assert plan["smem"] == sparse_cg.smem_bytes(
        K, esz, 8 if plan["warp_rows"] else 1,
        1 if plan["warp_rows"] else plan["threads"] // 32, plan["stage_slots"])
    assert 1 <= plan["cluster"] <= sparse_cg.MAX_CLUSTER
    assert plan["threads"] in (128, 256)
    assert 0 <= plan["stage_slots"] <= -(-L // plan["cluster"])
    if L <= sparse_cg.NARROW_L:
        assert plan["cls"] == "narrow" and plan["warp_rows"]
        assert plan["cluster"] == 1 and plan["threads"] == 256
    else:
        assert plan["cls"] == ("wide" if plan["cluster"] > 1 else "middle")


def test_k3_plan_classes_at_the_lastfm_shape():
    """K=56 bf16 on 132 SMs: the narrow buckets take a warp a row and stage
    whole rows; the few-row wide buckets take clusters that fill the card;
    the rest a block a row."""
    plans = {(R, L): sparse_cg.k3_plan(R, L, 56, 2, *H100)
             for R, L in LASTFM_BUCKETS}
    assert plans[95040, 32]["cls"] == "narrow"
    assert plans[95040, 32]["stage_slots"] == 32
    assert plans[40, 31592]["cls"] == "wide"
    assert plans[40, 31592]["cluster"] == sparse_cg.MAX_CLUSTER
    assert plans[40, 3400]["cluster"] * 40 >= 2 * 132
    assert plans[12680, 176]["cls"] == "middle"
    assert plans[12680, 176]["stage_slots"] == 176
    # a middle row one slot past the stage budget moves to two blocks a row
    last = plans[1536, 904]["stage_slots"]
    assert sparse_cg.k3_plan(600, last, 56, 2, *H100)["cls"] == "middle"
    assert sparse_cg.k3_plan(600, last + 1, 56, 2, *H100)["cluster"] == 2
