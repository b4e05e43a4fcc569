"""work.py's counts against values worked out by hand on small shapes."""

import pytest

import work


def test_bound_takes_the_larger():
    # 3.35e9 B at 3.35e12 B/s = 1 ms; 67e9 f32 ops at 67e12 = 1 ms
    assert work.bound(3.35e9, {}) == pytest.approx(1e-3)
    assert work.bound(0, {"f32": 67e9}) == pytest.approx(1e-3)
    assert work.bound(3.35e9, {"f32": 134e9}) == pytest.approx(2e-3)
    # operations of two types add: 989e9 bf16 + 67e9 f32 = 1 ms + 1 ms
    assert work.bound(0, {"bf16": 989e9, "f32": 67e9}) == pytest.approx(2e-3)


def test_k1_launch():
    Q = {"shape": (128, 64), "dtype": "torch.bfloat16", "itemsize": 2}
    Be = {"shape": (64, 64), "dtype": "torch.bfloat16", "itemsize": 2}
    W = {"shape": (128, 64), "dtype": "torch.int8", "itemsize": 1}
    nbytes, ops = work.k1_launch(Q, Be, W, nnz=100, K=51)
    # Q 16384 B + Be 8192 + W 8192 + out 128 x 64 x 4 = 32768
    assert nbytes == 16384 + 8192 + 8192 + 32768
    assert ops == {"bf16": 4 * 100 * 51}


def test_explicit_fit_ops():
    # k = 1 (K = 2), 2 iterations, 1 CG step, finalize: one CG iteration
    # of 2 half-steps at nnz (2K + 2 x 4K) = 20 an entry in the bulk
    # type, then the finalize at nnz (K(K+1) + 2K) = 10 an entry a side
    # and (m + n) (K^3/3 + 2K^2) = 5 x (8/3 + 8) in the final type
    got = work.explicit_fit_ops(nnz=10, m=2, n=3, k=1, niter=2, steps=1,
                                finalize=True, bulk="bf16", final="f32")
    assert got == pytest.approx({"bf16": 2 * 10 * 20,
                                 "f32": 2 * 10 * 10 + 5 * (8 / 3 + 8)})
    assert work.explicit_fit_ops(10, 2, 3, 1, 2, 1, False, "bf16",
                                 "f32") == {"bf16": 4 * 10 * 20}
    same = work.explicit_fit_ops(10, 2, 3, 1, 2, 1, True, "f32", "f32")
    assert same == pytest.approx({"f32": sum(got.values())})
