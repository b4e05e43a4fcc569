"""K1 with f32 operands on row lists (ops/masked_matmul.py:
masked_gram_matvec_rows, row_lists, takes_rows) on the CPU, where the op
runs its plain twin, and the dense-masked engine's choice between it and
the dense K1.

Tolerances, as max|out - ref| <= tol * max|ref| for the ops and as max
abs difference for the fits:
  * the op against masked_gram_matvec_ref: the same f32 products summed
    in another order, 1e-5 (test_torch_masked_matmul.py's f32 limit);
  * fits on the row lists against the same fits on the dense K1, and
    against cmfrec_tpu's fit_explicit_dense_pallas: only the f32 K1's
    summation order differs, so test_torch_dense_fit.py's limits (f32 5e-5,
    bf16 bulk iterations 5e-4).
"""

import numpy as np
import pytest
import torch

from cmfrec_tpu.solvers.dense_pallas import fit_explicit_dense_pallas
from cmfrec_torch.convert import init_from_arrays
from cmfrec_torch.ops import masked_matmul as mm
from cmfrec_torch.solvers import dense_masked
from cmfrec_torch.solvers.dense_masked import (
    _setup,
    fit_collective_dense_masked,
    fit_explicit_dense_masked,
    padded_dims,
)

TOL_OP = 1e-5
TOL_F32, TOL_BF16 = 5e-5, 5e-4


def _rel(out, ref):
    return ((out - ref).abs().max() / ref.abs().max()).item()


def _mask(rng, R, S, layout):
    """A 0/1 [R, S] mask: ~5% of the cells, or with rows 0 and 5 empty and
    row 3 full (longer than a ROW_CHUNK where S allows)."""
    mask = rng.uniform(size=(R, S)) < 0.05
    if layout == "empty_and_full":
        mask[[0, 5]] = False
        mask[3] = True
    return mask


def _weights(rng, mask, w):
    if w == "int8":
        return torch.from_numpy(mask.astype(np.int8))
    wts = rng.uniform(0.5, 2.0, size=mask.shape)
    wts[rng.uniform(size=mask.shape) < 0.2] = 0.0  # observed with weight 0
    return torch.from_numpy((mask * wts).astype(np.float32))


@pytest.mark.parametrize("layout", ["random", "empty_and_full"])
@pytest.mark.parametrize("K", [64, 128])
@pytest.mark.parametrize("w", ["int8", "f32"])
def test_rows_twin_matches_dense_twin(w, K, layout):
    rng = np.random.default_rng(K + len(layout))
    R, S = 192, 320
    W = _weights(rng, _mask(rng, R, S, layout), w)
    Q = torch.from_numpy(rng.normal(size=(R, K)).astype(np.float32))
    Be = torch.from_numpy(rng.normal(size=(S, K)).astype(np.float32))
    lists = mm.row_lists(W, int((W != 0).sum()) + 7)
    out = mm.masked_gram_matvec_rows(Q, Be, lists)
    assert out.dtype == torch.float32 and tuple(out.shape) == (R, K)
    ref = mm.masked_gram_matvec_ref(Q, Be, W)
    assert _rel(out, ref) <= TOL_OP
    empty = (W != 0).sum(dim=1) == 0
    if layout == "empty_and_full":
        assert empty[[0, 5]].all()
    assert (out[empty] == 0).all()
    oracle = ((Q.double() @ Be.double().T) * W.double()) @ Be.double()
    assert _rel(out.double(), oracle) <= TOL_OP
    assert mm.masked_gram_matvec_rows.launches == 0  # CPU tensors: the twin


def _coo_with_duplicates(rng, m, n, nnz):
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    dup = rng.integers(0, nnz, nnz // 10)  # every tenth entry repeated
    rows, cols = np.concatenate([rows, rows[dup]]), np.concatenate([cols,
                                                                    cols[dup]])
    return rows, cols


@pytest.mark.parametrize("side", ["W", "WT"])
@pytest.mark.parametrize("w", ["int8", "f32"])
def test_row_lists_are_the_nonzeros(w, side):
    """The lists of the dense form's W and WT, built from COO with
    duplicated pairs (one entry of the dense form each), against
    torch.nonzero; the chunk table splits each row into ROW_CHUNK
    entries."""
    rng = np.random.default_rng(11)
    L = 2 * mm.ROW_CHUNK + 100  # three chunks, the last ragged
    m, n = L + 164, L + 100
    rows, cols = _coo_with_duplicates(rng, m, n, 2 * L + 3000)
    # a row and a column of three chunks each
    rows[:L], cols[:L] = 7, np.arange(L)
    rows[L:2 * L], cols[L:2 * L] = np.arange(L), 9
    m_pad, n_pad, _ = padded_dims(m, n, 4)
    wts = (None if w == "int8" else
           torch.from_numpy(rng.uniform(0.5, 2.0, rows.size)
                            .astype(np.float32)))
    _, W, _, WT, _, _ = _setup(torch.from_numpy(rows), torch.from_numpy(cols),
                               torch.ones(rows.size), wts, m_pad, n_pad)
    Wd = W if side == "W" else WT
    lists = mm.row_lists(Wd, rows.size)
    nz = Wd.nonzero()
    assert nz.shape[0] < rows.size  # the duplicates were folded
    R = Wd.shape[0]
    counts = torch.bincount(nz[:, 0], minlength=R)
    assert lists.offsets.dtype == torch.int32 and lists.ids.dtype == torch.int32
    assert torch.equal(lists.offsets.long(),
                       torch.cat([torch.zeros(1, dtype=torch.long),
                                  torch.cumsum(counts, 0)]))
    assert lists.ids.shape[0] == rows.size
    used = nz.shape[0]
    assert torch.equal(lists.ids[:used].long(), nz[:, 1])
    if w == "int8":
        assert lists.weights is None
    else:
        assert torch.equal(lists.weights[:used], Wd[nz[:, 0], nz[:, 1]])
    nch = -(-counts // mm.ROW_CHUNK)
    assert int(nch.max()) >= 3
    assert torch.equal(lists.chunk_offsets.long()[1:], torch.cumsum(nch, 0))
    n_chunks = int(nch.sum())
    assert torch.equal(lists.chunk_rows[:n_chunks].long(),
                       torch.repeat_interleave(torch.arange(R), nch))
    assert (lists.chunk_rows[n_chunks:] == R).all()
    assert lists.chunk_rows.shape[0] >= rows.size // mm.ROW_CHUNK + R


def test_row_lists_refuse_too_few_entries():
    W = torch.zeros(64, 64, dtype=torch.int8)
    W[3, :10] = 1
    with pytest.raises(ValueError, match="more than entries=9"):
        mm.row_lists(W, 9)


def _t(shape, dtype, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


def _lists(R, device="cpu"):
    return mm.row_lists(_t((R, 64), torch.int8), 4)._replace(
        offsets=_t((R + 1,), torch.int32, device))


@pytest.mark.parametrize("args,match", [
    ((_t((64, 64), torch.bfloat16), _t((64, 64), torch.bfloat16),
      _lists(64)), "float32"),
    ((_t((64, 64), torch.float32), _t((64, 128), torch.float32), _lists(64)),
     "one width"),
    ((_t((64, 32), torch.float32), _t((64, 32), torch.float32), _lists(64)),
     "one width"),
    ((_t((64, 64), torch.float32), _t((64, 64), torch.float32), _lists(32)),
     "lists hold 32 rows"),
    ((_t((64, 64), torch.float32), _t((64, 64), torch.float32),
      _lists(64, "meta")), "several devices"),
    ((_t((64, 64), torch.float32, "meta"), _t((64, 64), torch.float32, "meta"),
      mm.RowList(*(None if t is None else t.to("meta")
                   for t in _lists(64)))), "no kernel for device meta"),
    ((_t((64, 128), torch.float32)[:, ::2], _t((64, 64), torch.float32),
      _lists(64)), "contiguous"),
])
def test_rows_op_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        mm.masked_gram_matvec_rows(*args)


@pytest.mark.parametrize("W,match", [
    (_t((64, 64), torch.bfloat16), "int8 mask or float32"),
    (_t((64, 96), torch.int8), "multiple of 64"),
    (_t((64, 128), torch.int8)[:, ::2], "contiguous"),
])
def test_row_lists_reject(W, match):
    with pytest.raises(ValueError, match=match):
        mm.row_lists(W, 10)


@pytest.mark.parametrize("entries,R,S,K,takes", [
    (9_500_051, 69_888, 10_688, 64, True),  # ML10M's shape, 1.27%
    (9_500_051, 69_888, 10_688, 256, True),
    (9_500_051, 69_888, 10_688, 320, False),  # past the row-list kernel
    (int(0.5 * 69_888 * 10_688), 69_888, 10_688, 64, False),  # dense data
    (2 ** 31, 200_000, 100_000, 64, False),  # past int32 offsets
])
def test_takes_rows(entries, R, S, K, takes):
    assert mm.takes_rows(entries, R, S, K) is takes


class _Spy:
    """Counts the engine's calls of the dense K1 and the row-list K1, by
    the operands' type."""

    def __init__(self, monkeypatch):
        self.calls = {"dense": [], "rows": []}
        for key, name in (("dense", "masked_gram_matvec"),
                          ("rows", "masked_gram_matvec_rows")):
            fn = getattr(dense_masked, name)

            def spy(Q, Be, W, _fn=fn, _key=key):
                self.calls[_key].append(Q.dtype)
                return _fn(Q, Be, W)

            monkeypatch.setattr(dense_masked, name, spy)


def _sparse_data(seed=5, m=300, n=200, nnz=2500, weighted=False, k=6):
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, m * n, nnz))
    ro, co = pairs // n, pairs % n
    A0, B0 = rng.normal(size=(m, 3)), rng.normal(size=(n, 3))
    vals = np.round(2 * ((A0 @ B0.T)[ro, co] + 3
                         + 0.3 * rng.normal(size=ro.size))) / 2
    wts = (np.round(rng.uniform(0.5, 2.0, size=ro.size) * 8) / 8
           if weighted else None)
    init = dict(A=0.3 * rng.normal(size=(m, k)), B=0.3 * rng.normal(size=(n, k)),
                biasA=0.1 * rng.normal(size=m), biasB=0.1 * rng.normal(size=n))
    init = {key: v.astype(np.float32) for key, v in init.items()}
    return ro, co, vals, wts, init, m, n


def _fit(ro, co, vals, wts, init, m, n, k=6, **kw):
    common = dict(weights=wts, k=k, lam6=np.full(6, 0.5), niter=3,
                  max_cg_steps=3, finalize_chol=True, finalize_steps=16,
                  user_bias=True, item_bias=True,
                  glob_mean=float(np.mean(vals)), scale_lam=True,
                  scale_bias_const=False, seed=3, verbose=False,
                  device="cpu", init=init_from_arrays(init, "cpu"))
    common.update(kw)
    return fit_explicit_dense_masked(ro, co, vals, m, n, **common)


@pytest.mark.parametrize("density", ["sparse", "dense"])
def test_density_rule_chooses_the_op(monkeypatch, density):
    """The polish's f32 K1 takes the row lists below ROWS_MAX_DENSITY
    (2,500 draws over 320 x 256 cells, ~3%) and the dense kernel above it
    (the same data with the crossover at 0); the bf16 iterations take the
    dense kernel either way."""
    if density == "dense":
        monkeypatch.setattr(mm, "ROWS_MAX_DENSITY", 0.0)
    spy = _Spy(monkeypatch)
    ro, co, vals, wts, init, m, n = _sparse_data()
    _fit(ro, co, vals, wts, init, m, n, niter=3)
    bulk = 2 * 2 * (1 + 3)  # two bf16 iterations
    polish = 2 * (1 + 16)
    f32 = torch.float32
    if density == "sparse":
        assert spy.calls["rows"] == [f32] * polish
        assert spy.calls["dense"] == [torch.bfloat16] * bulk
    else:
        assert spy.calls["rows"] == []
        assert spy.calls["dense"] == [torch.bfloat16] * bulk + [f32] * polish


def test_implicit_engine_keeps_the_dense_op(monkeypatch):
    """The implicit dense-masked engine runs its f32 K1 on the dense form,
    whatever the density."""
    spy = _Spy(monkeypatch)
    ro, co, vals, _, _, m, n = _sparse_data()
    dense_masked.fit_implicit_dense_masked(
        ro, co, np.abs(vals) + 1.0, m, n, k=6, lam6=np.full(6, 1.0), niter=2,
        max_cg_steps=3, finalize_steps=4, finalize_chol=True, alpha=1.0,
        w_main_multiplier=1.0, seed=1, verbose=False, device="cpu")
    assert spy.calls["rows"] == []
    assert torch.float32 in spy.calls["dense"]


CASES = {
    # two bf16 iterations, then the f32 polish on the lists
    "polish": (dict(niter=3), False, TOL_BF16),
    # niter=1 with the polish: f32 alone
    "one_f32_iteration": (dict(niter=1), False, TOL_F32),
    "exact_mode": (dict(niter=2, exact=True), False, TOL_F32),
    "weighted_exact": (dict(niter=2, exact=True), True, TOL_F32),
    "weighted_polish": (dict(niter=2), True, TOL_BF16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_on_row_lists_matches_the_dense_op(monkeypatch, case):
    """An explicit fit whose f32 K1 takes the row lists against the same
    fit on the dense K1 (the crossover set to 0), from one init."""
    kw, weighted, tol = CASES[case]
    spy = _Spy(monkeypatch)
    data = _sparse_data(weighted=weighted)
    on_rows = _fit(*data, **kw)
    assert spy.calls["rows"]
    monkeypatch.setattr(mm, "ROWS_MAX_DENSITY", 0.0)
    on_dense = _fit(*data, **kw)
    for key in ("A", "B", "biasA", "biasB"):
        np.testing.assert_allclose(on_rows[key].numpy(),
                                   on_dense[key].numpy(), rtol=0, atol=tol,
                                   err_msg=key)


def test_collective_fit_on_row_lists_matches_the_dense_op(monkeypatch):
    """The collective explicit engine (dense side information: G0 and R0
    added outside K1) on the row lists against the dense K1, one f32
    iteration."""
    spy = _Spy(monkeypatch)
    ro, co, vals, _, init, m, n = _sparse_data(seed=8)
    rng = np.random.default_rng(8)
    U = rng.normal(size=(m, 5)).astype(np.float32)
    U -= U.mean(axis=0)

    def fit():
        return fit_collective_dense_masked(
            ro, co, vals, m, n, U_dense=U, I_dense=None, weights=None, k=6,
            lam6=np.full(6, 0.5), w_user=1.0, w_item=1.0, niter=1,
            max_cg_steps=3, finalize_chol=True, finalize_steps=16,
            user_bias=True, item_bias=True, glob_mean=float(np.mean(vals)),
            scale_lam=True, seed=3, verbose=False, device="cpu",
            init=init_from_arrays(init, "cpu"))

    on_rows = fit()
    assert len(spy.calls["rows"]) == 2 * 17
    monkeypatch.setattr(mm, "ROWS_MAX_DENSITY", 0.0)
    on_dense = fit()
    for key in ("A", "B", "biasA", "biasB", "C"):
        np.testing.assert_allclose(on_rows[key].numpy(),
                                   on_dense[key].numpy(), rtol=0,
                                   atol=TOL_F32, err_msg=key)


def test_fit_on_row_lists_matches_pallas(monkeypatch):
    """One f32 iteration on the row lists against cmfrec_tpu's dense-masked
    fit (Pallas kernels in interpret mode) on sparse data, from one init."""
    spy = _Spy(monkeypatch)
    m, n, k = 64, 48, 4
    ro, co, vals, _, init, _, _ = _sparse_data(seed=9, m=m, n=n, nnz=200, k=k)
    common = dict(weights=None, k=k, lam6=np.full(6, 0.5), niter=1,
                  max_cg_steps=3, finalize_chol=True, finalize_steps=16,
                  user_bias=True, item_bias=True,
                  glob_mean=float(np.mean(vals)), scale_lam=False,
                  scale_bias_const=False, seed=3, verbose=False)
    rj = fit_explicit_dense_pallas(ro, co, vals, m, n, biasA0=None,
                                   biasB0=None, dtype=np.float32,
                                   interpret=True, init=init, **common)
    rt = fit_explicit_dense_masked(ro, co, vals, m, n, device="cpu",
                                   init=init_from_arrays(init, "cpu"),
                                   **common)
    assert len(spy.calls["rows"]) == 2 * 17
    for key in ("A", "B", "biasA", "biasB"):
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(rj[key]),
                                   rtol=0, atol=TOL_F32, err_msg=key)
