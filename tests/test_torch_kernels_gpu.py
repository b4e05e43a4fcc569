"""cmfrec_torch's CUDA kernels against their plain twins, on the card.

Skipped without a CUDA device.  On a machine with one (and without JAX):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q

Tolerances, as max|kernel - twin| <= tol * max|twin|: f32 operands differ
by summation order only, 1e-5 at these sizes; bf16 operands also flip
single bf16 roundings of T*W (2**-8 relative each), 1e-3.  The bucket CG
(K3) runs 3 CG steps on top of its sums, which carries a summation-order
difference further: K3_REL_TOL.  The K1 probes: those that round T*W
or T to bf16 as K1 does 1e-3; dot1 (f32 row sums of T, which cancel) 1e-4
of max|twin|; the W stream exact on a 0/1 mask, 1e-5 on bf16 weights (f32
summation order).  The coordinate-descent kernel (csrc/cd_solve.cu)
against rowsolve.solve_cd: CD_REL_TOL, the same sweeps over sums in
another order (the iteration contracts, so the roundings do not grow).
"""

import numpy as np
import pytest
import torch

from cmfrec_torch.ops import _cuda, coord_descent, k1_probes
from cmfrec_torch.ops import masked_matmul as mm
from cmfrec_torch.ops import rowsolve, sparse_cg
from cmfrec_torch.solvers import drivers

pytestmark = pytest.mark.gpu
REL_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}
K3_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
CD_REL_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(dev, R, S, K, op, wdt, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    Q = torch.randn(R, K, device=dev, generator=g).to(op)
    Be = torch.randn(S, K, device=dev, generator=g).to(op)
    mask = torch.rand(R, S, device=dev, generator=g) < 0.3
    W = (mask.to(torch.int8) if wdt == torch.int8 else
         (mask * (0.5 + 1.5 * torch.rand(R, S, device=dev, generator=g))
          ).to(wdt))
    X = (torch.randint(1, 11, (R, S), device=dev, generator=g) / 2).to(
        torch.bfloat16)
    mb = torch.randn(S, device=dev, generator=g)
    return Q, Be, W.contiguous(), X, mb


def _rel(out, ref):
    return ((out - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("K", [64, 128, 256, 320, 384, 448, 512, 576,
                               1024])
@pytest.mark.parametrize("wdt", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", [torch.bfloat16, torch.float32])
def test_kernels_match_twins(cuda, op, wdt, K):
    """Past K = 256 K1 runs a wide configuration (5-6 bf16, 7-8 f32: Q held
    whole where it fits, else streamed), in the column chunks, and with
    the shared memory, that masked_matmul's model of the choice reckons
    (wide_variant, wide_col_chunk, wide_smem); K2 with bf16 operands its
    wide configuration (3-4, rhs_wide_variant, rhs_col_chunk,
    rhs_wide_smem), with f32 operands 64 columns a block.  R = 192: a
    ragged last 128-row block."""
    R, S = 192, 320
    rplan = mm.rhs_plan(R, S, K, op, wdt, cuda)
    if K > mm.TILED_MAX_K and op == torch.bfloat16:
        assert rplan["variant"] == mm.rhs_wide_variant(
            K, wdt, _cuda.optin_smem(cuda))
        assert rplan["col_chunk"] == mm.rhs_col_chunk(K)
        assert rplan["smem"] == mm.rhs_wide_smem(rplan["variant"], K, wdt)
        assert len(rplan["cols"]) == -(-K // (mm.TILE * mm.RHS_WIDE_TILES))
    else:
        assert rplan["variant"] <= 2 and rplan["col_chunk"] == mm.TILE
    plan = mm.gram_plan(R, S, K, op, wdt, cuda)
    if K > mm.TILED_MAX_K:
        assert plan["variant"] == mm.wide_variant(K, op, wdt,
                                                  _cuda.optin_smem(cuda))
        assert plan["col_chunk"] == mm.wide_col_chunk(K, plan["variant"])
        assert plan["smem"] == mm.wide_smem(plan["variant"], K, wdt)
        most = mm.WIDE_CONFIGS[plan["variant"]][3]
        assert len(plan["cols"]) == -(-K // (mm.TILE * most))
    else:
        assert plan["variant"] <= 4 and plan["col_chunk"] == mm.TILE
    Q, Be, W, X, mb = _inputs(cuda, R, S, K, op, wdt)
    n_gram, n_rhs = mm.masked_gram_matvec.launches, mm.masked_rhs.launches
    out = mm.masked_gram_matvec(Q, Be, W)
    out2 = mm.masked_rhs(X, W, mb, Be)
    torch.cuda.synchronize()
    assert mm.masked_gram_matvec.launches == n_gram + 1
    assert mm.masked_rhs.launches == n_rhs + 1
    assert _rel(out, mm.masked_gram_matvec_ref(Q, Be, W)) <= REL_TOL[op]
    assert _rel(out2, mm.masked_rhs_ref(X, W, mb, Be)) <= REL_TOL[op]


@pytest.mark.parametrize("K", [64, 128, 192, 256, 320, 384, 448, 576,
                               1024])
@pytest.mark.parametrize("wdt", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", [torch.bfloat16, torch.float32])
def test_k1_split_s_matches_twin(cuda, monkeypatch, op, wdt, K):
    """K1 over 192 rows (a ragged last 128-row block): S smaller than one
    chunk, S in two full chunks and a ragged third (the planner's chunk
    forced), and S as the planner splits it; each twice, bitwise equal (no
    atomics)."""
    R = 192
    s_tile = mm.gram_plan(R, 64, K, op, wdt, cuda)["s_tile"]
    chunk = 2 * s_tile
    planner = mm.split_chunk
    for S, ch in ((64, 2 * chunk), (2 * chunk + 64, chunk),
                  (2 * chunk + 64, None)):
        monkeypatch.setattr(mm, "split_chunk", planner if ch is None else
                            lambda *a, **kw: ch)
        chunks = mm.gram_plan(R, S, K, op, wdt, cuda)["chunks"]
        assert ch is None or chunks == -(-S // ch)
        Q, Be, W, _, _ = _inputs(cuda, R, S, K, op, wdt, seed=S)
        before = mm.masked_gram_matvec.launches
        out = mm.masked_gram_matvec(Q, Be, W)
        again = mm.masked_gram_matvec(Q, Be, W)
        torch.cuda.synchronize()
        assert mm.masked_gram_matvec.launches == before + 2
        assert torch.isfinite(out).all()
        assert _rel(out, mm.masked_gram_matvec_ref(Q, Be, W)) <= REL_TOL[op]
        assert torch.equal(out, again)


@pytest.mark.parametrize("K", [64, 128, 192, 256, 320, 1024])
@pytest.mark.parametrize("wdt", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", [torch.bfloat16, torch.float32])
def test_k2_split_s_matches_twin(cuda, monkeypatch, op, wdt, K):
    """K2 as K1's split test: 192 rows (a ragged 128-row block), S under one
    chunk, two chunks and a ragged third (the chunk forced), and S as the
    planner splits it; each twice, bitwise equal."""
    R = 192
    s_tile = mm.rhs_plan(R, 64, K, op, wdt, cuda)["s_tile"]
    chunk = 2 * s_tile
    planner = mm.split_chunk
    for S, ch in ((64, 2 * chunk), (2 * chunk + 64, chunk),
                  (2 * chunk + 64, None)):
        monkeypatch.setattr(mm, "split_chunk", planner if ch is None else
                            lambda *a, **kw: ch)
        chunks = mm.rhs_plan(R, S, K, op, wdt, cuda)["chunks"]
        assert ch is None or chunks == -(-S // ch)
        _, Be, W, X, mb = _inputs(cuda, R, S, K, op, wdt, seed=S)
        before = mm.masked_rhs.launches
        out = mm.masked_rhs(X, W, mb, Be)
        again = mm.masked_rhs(X, W, mb, Be)
        torch.cuda.synchronize()
        assert mm.masked_rhs.launches == before + 2
        assert torch.isfinite(out).all()
        assert _rel(out, mm.masked_rhs_ref(X, W, mb, Be)) <= REL_TOL[op]
        assert torch.equal(out, again)


@pytest.mark.parametrize("K", [320, 384, 576, 1024])
@pytest.mark.parametrize("wdt", [torch.int8, torch.float32, torch.bfloat16])
def test_k2_wide_ragged_rows_and_split_s(cuda, monkeypatch, wdt, K):
    """The bf16 K2 past 256 (rhs_bf16_wide_kernel) on 320 rows (two full
    128-row blocks and a ragged one of 64) in its column chunks (one at K =
    320, two at 384 and 576, four at 1024), with S in two full chunks and a
    ragged third (the chunk forced) and in one chunk: each call twice,
    bitwise equal (no atomics), against the twin."""
    R, op = 320, torch.bfloat16
    s_tile = mm.rhs_plan(R, 64, K, op, wdt, cuda)["s_tile"]
    chunk = 2 * s_tile
    for S, ch in ((2 * chunk + 64, chunk), (2 * chunk + 64, 4 * chunk)):
        monkeypatch.setattr(mm, "split_chunk", lambda *a, **kw: ch)
        plan = mm.rhs_plan(R, S, K, op, wdt, cuda)
        assert plan["variant"] in mm.RHS_WIDE_CONFIGS
        assert plan["chunks"] == -(-S // ch)
        _, Be, W, X, mb = _inputs(cuda, R, S, K, op, wdt, seed=K + S)
        before = mm.masked_rhs.launches
        out = mm.masked_rhs(X, W, mb, Be)
        again = mm.masked_rhs(X, W, mb, Be)
        torch.cuda.synchronize()
        assert mm.masked_rhs.launches == before + 2
        assert torch.isfinite(out).all()
        assert _rel(out, mm.masked_rhs_ref(X, W, mb, Be)) <= REL_TOL[op]
        assert torch.equal(out, again)


def test_k2_splits_the_flagship_b_side(cuda):
    """The flagship fit's B side (84 row blocks of 128 for 132 SMs) is split
    into several chunks in both operand types."""
    for op in (torch.bfloat16, torch.float32):
        plan = mm.rhs_plan(10688, 69888, 64, op, torch.int8, cuda)
        assert plan["chunks"] > 1 and plan["per_sm"] >= 1


def test_k1_bf16_ring_keeps_two_blocks_an_sm(cuda):
    """The flagship's bf16 K1 (K=64, int8 mask) gets the three-stage ring
    of 128-wide tiles with two blocks resident an SM."""
    plan = mm.gram_plan(69888, 10688, 64, torch.bfloat16, torch.int8, cuda)
    assert (plan["variant"], plan["s_tile"]) == (0, 128)
    assert plan["per_sm"] >= 2


def test_misaligned_operand_raises(cuda):
    R, S, K = 64, 64, 64
    Q, Be, W, _, _ = _inputs(cuda, R, S, K, torch.bfloat16, torch.int8)
    buf = torch.zeros(R * K + 1, dtype=torch.bfloat16, device=cuda)
    Qm = buf[1:].view(R, K)
    Qm.copy_(Q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mm.masked_gram_matvec(Qm, Be, W)


def _power_law_mask(dev, R, S, nnz, seed):
    """A 0/1 [R, S] int8 mask with ML10M's skew, scaled down: rows drawn on
    a power law of exponent 0.55, columns 0.8 (benchmark/traffic/ml10m.json),
    so the first columns hold most rows; row 7 and column 9 full."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(n, exponent):
        p = 1.0 / torch.arange(1, n + 1, device=dev,
                               dtype=torch.float64) ** exponent
        cdf = torch.cumsum(p / p.sum(), 0)
        u = torch.rand(nnz, device=dev, dtype=torch.float64, generator=g)
        return torch.searchsorted(cdf, u).clamp_(max=n - 1)

    W = torch.zeros(R, S, dtype=torch.int8, device=dev)
    W[draw(R, 0.55), draw(S, 0.8)] = 1
    W[7] = 1
    W[:, 9] = 1
    return W


@pytest.mark.parametrize("side", ["W", "WT"])
@pytest.mark.parametrize("wdt", [torch.int8, torch.float32])
@pytest.mark.parametrize("K", [64, 128, 192, 256])
def test_k1_rows_matches_dense_k1_and_twin(cuda, K, wdt, side):
    """The row-list K1 (csrc/masked_rows.cu) on a power-law mask (~0.3%;
    a full row and column of three ROW_CHUNKs, the last ragged, on each
    side) against the dense f32 K1 and its twin: the same f32 products
    summed in another order, REL_TOL; the lists built on the card equal
    the CPU's; two calls give the same bits."""
    R, S = 2 * mm.ROW_CHUNK + 512, 2 * mm.ROW_CHUNK + 256
    W = _power_law_mask(cuda, R, S, 60000, seed=K)
    if wdt == torch.float32:
        g = torch.Generator(device=cuda).manual_seed(1)
        W = W * (0.5 + 1.5 * torch.rand(R, S, device=cuda, generator=g))
    if side == "WT":
        W = W.t().contiguous()
    R, S = W.shape
    entries = int((W != 0).sum())
    lists = mm.row_lists(W, entries + 100)
    cpu = mm.row_lists(W.cpu(), entries + 100)
    for got, want in zip(lists, cpu):
        if want is not None:
            assert torch.equal(got.cpu()[:entries], want[:entries])
    assert (lists.chunk_offsets[1:] - lists.chunk_offsets[:-1]).max() >= 3
    g = torch.Generator(device=cuda).manual_seed(2)
    Q = torch.randn(R, K, device=cuda, generator=g)
    Be = torch.randn(S, K, device=cuda, generator=g)
    before = mm.masked_gram_matvec_rows.launches
    out = mm.masked_gram_matvec_rows(Q, Be, lists)
    again = mm.masked_gram_matvec_rows(Q, Be, lists)
    torch.cuda.synchronize()
    assert mm.masked_gram_matvec_rows.launches == before + 2
    assert torch.equal(out, again)
    assert _rel(out, mm.masked_gram_matvec(Q, Be, W)) <= REL_TOL[torch.float32]
    assert _rel(out, mm.masked_gram_matvec_rows_ref(Q, Be, lists)) <= \
        REL_TOL[torch.float32]
    empty = (W != 0).sum(dim=1) == 0
    assert (out[empty] == 0).all()


def test_k1_rows_raises(cuda):
    R, S, K = 64, 128, 64
    Q, Be, W, _, _ = _inputs(cuda, R, S, K, torch.float32, torch.int8)
    lists = mm.row_lists(W, int(W.sum()))
    with pytest.raises(ValueError, match="several devices"):
        mm.masked_gram_matvec_rows(Q.cpu(), Be, lists)
    with pytest.raises(ValueError, match="several devices"):
        mm.masked_gram_matvec_rows(Q, Be, mm.row_lists(W.cpu(),
                                                        int(W.sum())))
    buf = torch.zeros(R * K + 1, dtype=torch.float32, device=cuda)
    Qm = buf[1:].view(R, K)
    Qm.copy_(Q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mm.masked_gram_matvec_rows(Qm, Be, lists)
    wide = torch.zeros(R, 320, device=cuda)
    with pytest.raises(ValueError, match="K=320 past 256"):
        mm.masked_gram_matvec_rows(wide, torch.zeros(S, 320, device=cuda),
                                   lists)
    Wb = torch.zeros(R * S + 1, dtype=torch.int8, device=cuda)[1:].view(R, S)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mm.row_lists(Wb, 10)


@pytest.mark.parametrize("use_cg", [True, False])
def test_fit_on_row_lists_card_matches_cpu(cuda, use_cg):
    """A sparse explicit fit (~2.5% of the cells), whose f32 K1 takes the
    row lists on the card and on the CPU, card against CPU from one init:
    5e-4, as test_fit_on_card_matches_cpu."""
    rng = np.random.default_rng(5)
    m, n, k = 600, 400, 6
    pairs = np.unique(rng.integers(0, m * n, 6000))
    rows, cols = pairs // n, pairs % n
    vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
    init = dict(A=0.3 * rng.normal(size=(m, k)), B=0.3 * rng.normal(size=(n, k)))
    kw = dict(k=k, lambda_=0.5, niter=4, use_cg=use_cg, scale_lam=True,
              init={key: v.astype(np.float32) for key, v in init.items()})
    before = mm.masked_gram_matvec_rows.launches
    on_card = drivers.fit_explicit_als(rows, cols, vals, m, n, device=cuda,
                                       **kw)
    launched = mm.masked_gram_matvec_rows.launches - before
    assert launched == 2 * 17 if use_cg else launched > 0
    on_cpu = drivers.fit_explicit_als(rows, cols, vals, m, n, device="cpu",
                                      **kw)
    for key in ("A", "B", "biasA", "biasB"):
        np.testing.assert_allclose(on_card[key].cpu().numpy(),
                                   on_cpu[key].numpy(), rtol=0, atol=5e-4,
                                   err_msg=key)


PROBE_TOL = {"k1": 1e-3, "dots": 1e-3, "dot1": 1e-4, "w": 1e-5}


@pytest.mark.parametrize("K", [64, 128, 256])
@pytest.mark.parametrize("probe", k1_probes.PROBES, ids=lambda p: p.name)
def test_k1_probes_match_plain(cuda, probe, K):
    """Every probe of P1-P3 against its plain version; R=192 leaves the
    128-row blocks (vbig) a ragged last block, S=320 the W-stream tiles and
    the part chunks (also 128 wide here) a narrow last one."""
    R, S = 192, 320
    Q, Be, W, _, _ = _inputs(cuda, R, S, K, torch.bfloat16, probe.w_dtype)
    counts = [w.launches for w in k1_probes.WRAPPERS]
    out = probe.kernel(Q, Be, W)
    torch.cuda.synchronize()
    assert sum(w.launches for w in k1_probes.WRAPPERS) == sum(counts) + 1
    ref = probe.plain(Q, Be, W)
    tol = 0.0 if probe.work == "w" and W.dtype == torch.int8 else \
        PROBE_TOL[probe.work]
    assert tuple(out.shape) == (R, K) and torch.isfinite(out).all()
    assert _rel(out, ref) <= tol
    if probe.name == "p_part":
        for chunk in (128, 64):
            assert _rel(k1_probes.part(Q, Be, W, chunk=chunk),
                        k1_probes.part_ref(Q, Be, W, chunk=chunk)) <= tol
        # up to summation order, K1's own twin
        assert _rel(ref, mm.masked_gram_matvec_ref(Q, Be, W)) <= 1e-5


def test_k1_probes_reject(cuda):
    R, S, K = 64, 128, 64
    Q, Be, W, _, _ = _inputs(cuda, R, S, K, torch.bfloat16, torch.int8)
    with pytest.raises(ValueError, match="W must be int8"):
        k1_probes.dots(Q, Be, W.float())
    with pytest.raises(ValueError, match="W must be int8"):
        k1_probes.w_stream(W.float(), K)
    with pytest.raises(ValueError, match="bfloat16 Q and Be"):
        k1_probes.sel(Q.float(), Be.float(), W)
    buf = torch.zeros(R * S + 1, dtype=torch.int8, device=cuda)
    Wm = buf[1:].view(R, S)
    Wm.copy_(W)
    with pytest.raises(ValueError, match="16-byte aligned"):
        k1_probes.part(Q, Be, Wm)
    with pytest.raises(ValueError, match="16-byte aligned"):
        k1_probes.w_stream(Wm, K)


@pytest.mark.parametrize("use_cg", [True, False])
def test_fit_on_card_matches_cpu(cuda, use_cg):
    """The whole engine on the card against the same fit on the CPU twins,
    from one init: bf16 bulk iterations may flip single roundings, 5e-4."""
    rng = np.random.default_rng(3)
    m, n, k = 150, 90, 6
    pairs = np.unique(rng.integers(0, m * n, 3000))
    rows, cols = pairs // n, pairs % n
    vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
    init = dict(A=0.3 * rng.normal(size=(m, k)), B=0.3 * rng.normal(size=(n, k)))
    kw = dict(k=k, lambda_=0.5, niter=4, use_cg=use_cg, scale_lam=True,
              init={key: v.astype(np.float32) for key, v in init.items()})
    on_card = drivers.fit_explicit_als(rows, cols, vals, m, n, device=cuda,
                                       **kw)
    on_cpu = drivers.fit_explicit_als(rows, cols, vals, m, n, device="cpu",
                                      **kw)
    for key in ("A", "B", "biasA", "biasB"):
        assert on_card[key].device.type == "cuda"
        np.testing.assert_allclose(on_card[key].cpu().numpy(),
                                   on_cpu[key].numpy(), rtol=0, atol=5e-4,
                                   err_msg=key)


def _card_and_cpu(fit, keys, **kw):
    """``fit`` on the card and on the CPU from one init; the results'
    ``keys`` side by side as numpy arrays."""
    on_card = fit(device="cuda", **kw)
    on_cpu = fit(device="cpu", **kw)
    for key in keys:
        assert on_card[key].device.type == "cuda", key
        yield key, on_card[key].cpu().numpy(), on_cpu[key].numpy()


def _small_side_data(seed=4, m=150, n=90, k=6):
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, m * n, 3000))
    rows, cols = pairs // n, pairs % n
    vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
    U, I = rng.normal(size=(m, 5)), rng.normal(size=(n, 4))
    init = {key: (0.3 * rng.normal(size=(d, k))).astype(np.float32)
            for key, d in (("A", m), ("B", n))}
    return rows, cols, vals, m, n, U, I, init


@pytest.mark.parametrize("use_cg", [True, False])
def test_collective_fit_on_card_matches_cpu(cuda, use_cg):
    """The collective explicit fit (dense U and I, implicit features) on the
    card against the CPU from one init.  The CG case runs one bf16
    iteration and the f32 polish: in the bf16 iteration the card rounds the
    implicit-features products' factors to bf16, as on the TPU, and the CPU
    does not (the JAX package's CPU path), which the polish brings within
    5e-4."""
    from cmfrec_torch.solvers import collective

    rows, cols, vals, m, n, U, I, init = _small_side_data()
    kw = dict(side_U=(None, None, None, m, 5, True, U),
              side_I=(None, None, None, n, 4, True, I),
              add_implicit_features=True, k=6, lambda_=0.5, scale_lam=True,
              niter=2 if use_cg else 3, use_cg=use_cg, init=init)
    for key, card, cpu in _card_and_cpu(
            lambda **a: collective.fit_collective_explicit_als(
                rows, cols, vals, m, n, **a),
            ("A", "B", "biasA", "biasB", "C", "D", "Ai", "Bi"), **kw):
        np.testing.assert_allclose(card, cpu, rtol=0, atol=5e-4, err_msg=key)


@pytest.mark.parametrize("use_cg", [True, False])
def test_implicit_dense_fit_on_card_matches_cpu(cuda, use_cg):
    """WRMF on the dense engine (engine="dense"), card against CPU: one bf16
    CG iteration, or three exact-mode iterations."""
    rows, cols, vals, m, n, _, _, init = _small_side_data()
    kw = dict(k=6, lambda_=2.0, alpha=0.5, niter=1 if use_cg else 3,
              use_cg=use_cg, engine="dense", init=init)
    before = mm.masked_gram_matvec.launches
    for key, card, cpu in _card_and_cpu(
            lambda **a: drivers.fit_implicit_als(rows, cols, vals + 0.5, m, n,
                                                 **a), ("A", "B"), **kw):
        np.testing.assert_allclose(card, cpu, rtol=0, atol=5e-4, err_msg=key)
    assert mm.masked_gram_matvec.launches > before


@pytest.mark.parametrize("use_cg", [True, False])
def test_collective_implicit_fit_on_card_matches_cpu(cuda, use_cg):
    from cmfrec_torch.solvers import collective

    rows, cols, vals, m, n, U, I, init = _small_side_data()
    kw = dict(side_U=(None, None, None, m, 5, True, U),
              side_I=(None, None, None, n, 4, True, I), k=6, lambda_=2.0,
              alpha=0.5, niter=1 if use_cg else 3, use_cg=use_cg, init=init)
    for key, card, cpu in _card_and_cpu(
            lambda **a: collective.fit_collective_implicit_als(
                rows, cols, vals + 0.5, m, n, **a), ("A", "B", "C", "D"),
            **kw):
        np.testing.assert_allclose(card, cpu, rtol=0, atol=5e-4, err_msg=key)


@pytest.mark.parametrize("route", ["dense", "bucketed"])
def test_collective_fit_past_k_256_on_card_matches_cpu(cuda, route):
    """The collective explicit fit at k = 300 through its kernels, card
    against CPU from one init: dense U and I on the dense-masked route
    (K = 320: K1's wide kernel and K2), or a sparse U and a binary I under
    NA_as_zero_item on the bucketed route (K = 304: K3, a block a row).
    The tolerances of the k = 6 and k = 8 tests of the same routes.  No
    implicit features: their products' factors are rounded to bf16 on the
    card and not on the CPU (test_collective_fit_on_card_matches_cpu), so
    both sides here do the same arithmetic up to the order of sums."""
    import scipy.sparse as spm

    from cmfrec_torch.solvers import collective

    k = 300
    if route == "dense":
        rows, cols, vals, m, n, U, I, _ = _small_side_data()
        rng = np.random.default_rng(30)
        init = {key: (0.3 * rng.normal(size=(d, k))).astype(np.float32)
                for key, d in (("A", m), ("B", n))}
        kw = dict(side_U=(None, None, None, m, 5, True, U),
                  side_I=(None, None, None, n, 4, True, I), k=k,
                  lambda_=0.5, scale_lam=True, niter=2, use_cg=True,
                  init=init)
        keys, atol = ("A", "B", "biasA", "biasB", "C", "D"), 5e-4
        counters = (mm.masked_gram_matvec, mm.masked_rhs)
    else:
        rng = np.random.default_rng(31)
        m, n, p, q = 300, 200, 40, 6
        pairs = np.unique(rng.integers(0, m * n, 6000))
        rows, cols = pairs // n, pairs % n
        vals = rng.normal(3, 1, rows.size)
        U = spm.random(m + 20, p, density=0.1, random_state=1, format="coo")
        I = (spm.random(n, q, density=0.4, random_state=2, format="coo") > 0
             ).astype(np.float64).tocoo()
        init = {key: 0.3 * rng.normal(size=(d, k)) for key, d in
                (("A", m + 20), ("B", n), ("C", p), ("D", q))}
        kw = dict(side_U=(U.row, U.col, U.data, m + 20, p, False, None),
                  side_I=(I.row, I.col, I.data, n, q, False, None), k=k,
                  niter=2, lambda_=0.5, use_cg=True, NA_as_zero_item=True,
                  scale_lam=True, init=init)
        keys, atol = ("A", "B", "C", "D", "biasA", "biasB"), 1e-4
        counters = (sparse_cg.bucket_cg,)
    before = [c.launches for c in counters]
    card = collective.fit_collective_explicit_als(rows, cols, vals, m, n,
                                                  device="cuda", **kw)
    assert all(c.launches > b for c, b in zip(counters, before))
    cpu = collective.fit_collective_explicit_als(rows, cols, vals, m, n,
                                                 device="cpu", **kw)
    assert card["A"].shape[1] == k
    for key in keys:
        np.testing.assert_allclose(card[key].cpu().numpy(), cpu[key].numpy(),
                                   rtol=0, atol=atol, err_msg=key)


def _bucket(dev, R, L, S, K, op, explicit, seed=0):
    """A random bucket: implicit coefficients with a Gram base, or explicit
    ones with a per-row lambda and a rhs base (the scale_lam/NA-as-zero
    variant)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mat = (torch.randn(S, K, device=dev, generator=g) / K ** 0.5).to(op)
    idx = torch.randint(0, S, (R, L), device=dev, generator=g,
                        dtype=torch.int32)
    length = torch.randint(0, L + 1, (R,), device=dev, generator=g,
                           dtype=torch.int32)
    msk = (torch.arange(L, device=dev)[None, :] < length[:, None]).float()
    a0 = 0.1 * torch.randn(R, K, device=dev, generator=g)
    if explicit:
        cw = msk
        cv = torch.randn(R, L, device=dev, generator=g) * msk
        gfix = torch.zeros(K, K, device=dev)
        lam_row = 0.4 * (1 + length.float())[:, None].expand(R, K).contiguous()
        r0 = torch.randn(R, K, device=dev, generator=g)
    else:
        x = 1 + 9 * torch.rand(R, L, device=dev, generator=g)
        cw, cv = 0.7 * x * msk, (1 + 0.7 * x) * msk
        matf = mat.float()
        gfix = matf.T @ matf + 1.3 * torch.eye(K, device=dev)
        lam_row = r0 = None
    return (mat, idx, cw, cv, gfix, lam_row, r0, a0), length


@pytest.mark.parametrize("K", [8, 56, 64, 136, 256, 264, 304, 320, 512,
                               1024, 1032])
@pytest.mark.parametrize("op", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("L", [40, 700, 5000])
def test_bucket_cg_matches_twin(cuda, K, op, explicit, L):
    """Staged (L=40) and re-gathered rows (700, 5000), 4/8/16 warps; past
    K = 256 the rows design up to K = 1024 (narrow rows a warp each, 8 rows
    a block; 99 rows, so the last block holds fewer) and the loop design
    past it (a block a row), two calls bitwise equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    R = 24 if L == 5000 else (99 if K > sparse_cg.TILED_MAX_K else 96)
    args, length = _bucket(cuda, R, L, 3 * L + 50, K, op, explicit)
    plan = sparse_cg.plan_for(R, L, K, op, cuda)
    assert plan["k_loop"] == (K > sparse_cg.TILED_MAX_K)
    if plan["k_loop"]:
        rows = plan.get("rows", 0)  # the rows design's rows a block
        assert (rows > 0) == (K <= sparse_cg.ROWS_MAX_K)
        assert plan["warp_rows"] == (rows > 0 and L <= 128)
    before = sparse_cg.bucket_cg.launches
    out = sparse_cg.bucket_cg(*args, n_steps=3, length=length)
    torch.cuda.synchronize()
    assert sparse_cg.bucket_cg.launches == before + 1
    if plan["k_loop"]:
        assert torch.equal(out, sparse_cg.bucket_cg(*args, n_steps=3,
                                                    length=length))
    ref = sparse_cg.bucket_cg_ref(*args, n_steps=3)
    assert torch.isfinite(out).all()
    assert _rel(out, ref) <= K3_REL_TOL[op]
    # with every row at full length the kernel walks the zero-coefficient
    # padding too
    full = torch.full_like(length, L)
    assert _rel(sparse_cg.bucket_cg(*args, n_steps=3, length=full),
                ref) <= K3_REL_TOL[op]


# K3's bucket classes at their boundaries (k3_plan at K=56 on a card of 132
# SMs): (R, L, K, the class expected)
K3_CLASSES = [
    (8 * 37 + 3, 128, 56, "narrow"),   # widest narrow rows; a ragged block
    (300, 1, 56, "narrow"),            # one slot a row
    (600, 129, 56, "middle"),          # narrowest middle rows
    (600, 762, 56, "middle"),          # the stage budget's last slot
    (600, 763, 56, "wide"),            # one slot past it: two blocks a row
    (3, 31600, 56, "wide"),            # a few LastFM-widest rows, 8 blocks
    (40, 3000, 256, "wide"),           # K=256: gfix read through L1
    # past K=256, the rows design: a warp a row, 8 rows a block
    (2000, 128, 304, "narrow"),
    (8 * 37 + 3, 40, 1024, "narrow"),  # K=1024, a ragged last block
    (601, 300, 264, "middle"),         # 4 rows a block of 2 warps each
    (600, 762, 304, "middle"),         # 2 rows a block, partly staged
    (130, 400, 512, "middle"),         # few rows: 1 row a block of 2 warps
    (3, 31600, 1024, "wide"),          # K=1024: 8 blocks a row
    # past K=1024, the loop design: a block or cluster a row
    (2000, 100, 1032, "middle"),
    (3, 31600, 1032, "wide"),
]


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("op", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", K3_CLASSES, ids=lambda c: f"{c[3]}-{c[0]}x{c[1]}-K{c[2]}")
def test_bucket_cg_classes(cuda, case, op, explicit):
    """Each bucket class against the twin, with rows of zero length; two
    calls give the same bits (no atomics, clusters add in rank order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    R, L, K, cls = case
    args, length = _bucket(cuda, R, L, min(3 * L + 50, 200000), K, op, explicit,
                           seed=L)
    length[::7] = 0  # rows of zero length carry no coefficients
    args[2][::7] = 0.0
    args[3][::7] = 0.0
    if op == torch.bfloat16:
        assert sparse_cg.plan_for(R, L, K, op, cuda)["cls"] == cls
    before = sparse_cg.bucket_cg.launches
    out = sparse_cg.bucket_cg(*args, n_steps=3, length=length)
    again = sparse_cg.bucket_cg(*args, n_steps=3, length=length)
    torch.cuda.synchronize()
    assert sparse_cg.bucket_cg.launches == before + 2
    ref = sparse_cg.bucket_cg_ref(*args, n_steps=3)
    assert torch.isfinite(out).all()
    assert _rel(out, ref) <= K3_REL_TOL[op]
    assert torch.equal(out, again)


@pytest.mark.parametrize("L", [40, 300])
@pytest.mark.parametrize("op", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K", [264, 304, 1024])
def test_bucket_cg_rows_skip_and_freeze(cuda, K, op, L):
    """The rows design with rows that skip (zero length, a0 = 0: r.r = 0)
    and rows that freeze at different steps inside one block (gfix = 1.3 I:
    a row of n slots has n + 1 distinct eigenvalues, so CG ends after n + 1
    steps), beside full rows, in blocks whose last one is ragged (37 narrow
    rows, 531 middle ones: enough for 4 rows a block), with and without
    lam_row/r0: against the twin, and two launches bitwise equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    R = 37 if L <= 128 else 531
    g = torch.Generator(device=cuda).manual_seed(K + L)
    args, length = _bucket(cuda, R, L, 3 * L + 50, K, op, False, seed=K + L)
    mat, idx, cw, cv, gfix, lam_row, r0, a0 = args
    length[0::6] = 0           # skip: no slots and a0 = 0
    a0[0::6] = 0.0
    length[1::6] = 0           # freeze after one step (A = 1.3 I)
    length[2::6] = 1           # after two
    length[3::6] = 2           # after three
    msk = (torch.arange(L, device=cuda)[None, :] < length[:, None]).float()
    cw, cv = cw * msk, cv * msk
    gfix = 1.3 * torch.eye(K, device=cuda)
    plan = sparse_cg.plan_for(R, L, K, op, cuda)
    assert plan["rows"] > 1 and R % plan["rows"]
    for extra in (False, True):
        lam_row = (0.4 * (1 + length.float())[:, None].expand(R, K)
                   .contiguous() if extra else None)
        r0 = torch.randn(R, K, device=cuda, generator=g) if extra else None
        if extra:
            r0[0::6] = 0.0
        call = (mat, idx, cw, cv, gfix, lam_row, r0, a0)
        out = sparse_cg.bucket_cg(*call, n_steps=3, length=length)
        again = sparse_cg.bucket_cg(*call, n_steps=3, length=length)
        ref = sparse_cg.bucket_cg_ref(*call, n_steps=3)
        torch.cuda.synchronize()
        assert torch.isfinite(out).all()
        assert _rel(out, ref) <= K3_REL_TOL[op]
        assert torch.equal(out, again)
        assert torch.equal(out[0::6], a0[0::6])  # skipped rows keep a0


def _serving_models(implicit, devices=("cuda", "cpu"), seed=15, m=300,
                    n=200, k=12, p=9):
    """The same fitted arrays as a model on each of ``devices`` (side info
    C with column means, built precomputes)."""
    from cmfrec_torch.models.cmf import CMF, CMF_implicit

    rng = np.random.default_rng(seed)
    A, B, C, ub, ib = ((s * rng.normal(size=shape)).astype(np.float32)
                       for s, shape in ((0.5, (m, k)), (0.5, (n, k)),
                                        (0.4, (p, k)), (0.3, m), (0.3, n)))
    models = []
    for dev in devices:
        if implicit:
            model = CMF_implicit.from_model_matrices(
                A, B, lambda_=2.0, alpha=2.0, precompute=False, device=dev)
        else:
            model = CMF.from_model_matrices(
                A, B, glob_mean=3.0, user_bias=ub, item_bias=ib,
                lambda_=1.5, scale_lam=True, precompute=False, device=dev)
        model.C_, model.U_colmeans_ = C, np.linspace(-1, 1, p)
        models.append(model.force_precompute_for_predictions())
    return models, rng


@pytest.mark.parametrize("route", ["padded", "grouped"])
@pytest.mark.parametrize("implicit", [False, True])
def test_warm_serving_on_card_matches_cpu(cuda, implicit, route):
    """factors_multiple (X, X and U, U alone) on the card against the same
    model on the CPU: f32 sums in another order, 1e-5 of max|a|."""
    import scipy.sparse as sp

    from cmfrec_torch.models import cmf as tcmf

    (card, cpu), rng = _serving_models(implicit)
    R = 40 if route == "padded" else 600
    deg = np.minimum((rng.pareto(1.0, R) * 4).astype(np.int64) + 1, 200)
    rows = np.repeat(np.arange(R), deg)
    cols = np.concatenate([rng.choice(200, d, replace=False) for d in deg])
    X = sp.coo_matrix((1.0 + rng.poisson(3.0, rows.size), (rows, cols)),
                      shape=(R, 200))
    assert tcmf._route_grouped(X.row, R) == (route == "grouped")
    U = rng.normal(size=(R, 9))
    for kw in (dict(X=X), dict(X=X, U=U), dict(U=U)):
        a, b = (model.factors_multiple(**kw) for model in (card, cpu))
        if not implicit:
            a, b = (model.factors_multiple(**kw, return_bias=True)[0]
                    for model in (card, cpu))
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert card._device_cache["warm:extB"][2].device.type == "cuda"


def test_warm_gram_card_matches_f64(cuda):
    """The warm Gram of the serving path on the card is a true f32 product
    (TF32 would be ~1e-3 off): against f64, 1e-5 of max|G|."""
    from cmfrec_torch.config import resolve_device
    from cmfrec_torch.ops import rowsolve

    resolve_device("cuda")  # as every serving call does
    g = torch.Generator(device=cuda).manual_seed(16)
    R, L, S, K = 64, 700, 5000, 56
    mat = torch.randn(S, K, device=cuda, generator=g)
    idx = torch.randint(0, S, (R, L), device=cuda, generator=g,
                        dtype=torch.int32)
    cw = torch.rand(R, L, device=cuda, generator=g)
    cv = torch.randn(R, L, device=cuda, generator=g)
    lam = torch.full((K,), 0.5, device=cuda)
    G, rhs = rowsolve.assemble_system(
        [rowsolve.SparsePart(mat, idx, cw, cv)], lam)
    part64 = rowsolve.SparsePart(mat.double().cpu(), idx.long().cpu(),
                                 cw.double().cpu(), cv.double().cpu())
    G64 = torch.einsum("rlk,rlm->rkm",
                       rowsolve.gather_rows(part64.mat, part64.idx)
                       * part64.cw[..., None],
                       rowsolve.gather_rows(part64.mat, part64.idx))
    G64 = G64 + torch.diag(lam.double().cpu())
    rhs64 = rowsolve.part_rhs(part64)
    assert ((G.cpu().double() - G64).abs().max() / G64.abs().max()) <= 1e-5
    assert ((rhs.cpu().double() - rhs64).abs().max()
            / rhs64.abs().max()) <= 1e-5


def _stacked_bucket(dev, R, Ls, K, seed):
    """Three sparse parts of one bucket over their own opposing matrices (the
    X, side-info and implicit-features parts of a collective row system),
    with ragged lengths and empty rows, and their slot map."""
    from cmfrec_torch.ops import rowsolve
    from cmfrec_torch.solvers import als

    g = torch.Generator(device=dev).manual_seed(seed)
    parts, sparse = [], []
    for S, L in zip((900, 150, 900), Ls):
        mat = torch.randn(S, K, device=dev, generator=g) / K ** 0.5
        length = torch.randint(0, L + 1, (R,), device=dev, generator=g,
                               dtype=torch.int32)
        length[:3] = 0
        idx = torch.randint(0, S, (R, L), device=dev, generator=g,
                            dtype=torch.int32)
        mask = rowsolve.length_mask(length, L).float()
        cw = torch.rand(R, L, device=dev, generator=g) * mask
        cv = torch.randn(R, L, device=dev, generator=g) * mask
        parts.append(als.PartData(idx=idx, val=cv, length=length, wgt=None,
                                  opp=mat, opp_bias=None, w=1.0, alpha=None,
                                  mu=None))
        sparse.append(rowsolve.SparsePart(mat, idx, cw, cv))
    st = als.stack_slots(tuple(parts))
    return parts, sparse, st, g


@pytest.mark.parametrize("K", [8, 56, 136, 264, 1024])
@pytest.mark.parametrize("Ls", [(24, 8, 24), (600, 16, 600), (3000, 64, 8)],
                         ids=["narrow", "middle", "wide"])
def test_bucket_cg_stacked_parts_match_separate_parts(cuda, K, Ls):
    """K3 over the stacked parts of one bucket (the collective route's CG
    with several parts) against the plain solve_cg over the separate parts,
    and against K3's twin on the same stacked part."""
    from cmfrec_torch.ops import rowsolve
    from cmfrec_torch.solvers import als

    R = 40
    parts, sparse, st, g = _stacked_bucket(cuda, R, Ls, K, seed=K)
    mat = torch.cat([p.opp for p in parts])
    sp = als.stacked_part(sparse, mat, st)
    lam = torch.rand(K, device=cuda, generator=g) + 0.5
    mult = torch.rand(R, device=cuda, generator=g) * 5 + 1
    lam_row = (lam[None, :] * mult[:, None]).contiguous()
    G0 = torch.randn(K, K, device=cuda, generator=g)
    G0 = (G0 @ G0.T / K).contiguous()
    r0 = torch.randn(R, K, device=cuda, generator=g)
    a0 = torch.randn(R, K, device=cuda, generator=g)
    got = sparse_cg.bucket_cg(mat, sp.idx, sp.cw, sp.cv, G0, lam_row, r0, a0,
                              n_steps=3, length=st.length)
    separate = rowsolve.solve_cg(sparse, lam, a0, 3, lam_mult=mult, G0=G0,
                                 r0=r0)
    twin = sparse_cg.bucket_cg_ref(mat, sp.idx, sp.cw, sp.cv, G0, lam_row,
                                   r0, a0, n_steps=3)
    assert _rel(got, separate) <= K3_REL_TOL[torch.float32]
    assert _rel(got, twin) <= K3_REL_TOL[torch.float32]
    assert _rel(separate, a0) > 10 * K3_REL_TOL[torch.float32]


@pytest.mark.parametrize("use_cg", [True, False])
def test_bucketed_collective_fit_on_card_matches_cpu(cuda, use_cg):
    """The bucketed collective route (sparse U with side-only users, I
    under NA_as_zero_item, implicit features) on the card, its CG through
    K3 over stacked parts, against the same fit on the CPU from one init."""
    import scipy.sparse as spm

    from cmfrec_torch.solvers import collective

    rng = np.random.default_rng(3)
    m, n, p, q, k = 300, 200, 40, 6, 8
    pairs = np.unique(rng.integers(0, m * n, 6000))
    rows, cols = pairs // n, pairs % n
    vals = rng.normal(3, 1, rows.size)
    U = spm.random(m + 20, p, density=0.1, random_state=1, format="coo")
    I = (spm.random(n, q, density=0.4, random_state=2, format="coo") > 0
         ).astype(np.float64).tocoo()
    side_U = (U.row, U.col, U.data, m + 20, p, False, None)
    side_I = (I.row, I.col, I.data, n, q, False, None)
    init = {"A": rng.normal(size=(m + 20, k)), "B": rng.normal(size=(n, k)),
            "C": rng.normal(size=(p, k)), "D": rng.normal(size=(q, k)),
            "Ai": rng.normal(size=(m + 20, k)), "Bi": rng.normal(size=(n, k)),
            "biasA": rng.normal(size=m + 20), "biasB": rng.normal(size=n)}
    init = {key: 0.3 * v for key, v in init.items()}
    kw = dict(side_U=side_U, side_I=side_I, k=k, niter=3, lambda_=0.5,
              use_cg=use_cg, NA_as_zero_item=True, add_implicit_features=True,
              scale_lam=True, init=init)
    before = sparse_cg.bucket_cg.launches
    card = collective.fit_collective_explicit_als(rows, cols, vals, m, n,
                                                  device="cuda", **kw)
    assert (sparse_cg.bucket_cg.launches > before) == use_cg
    cpu = collective.fit_collective_explicit_als(rows, cols, vals, m, n,
                                                 device="cpu", **kw)
    for key in ("A", "B", "C", "D", "Ai", "Bi", "biasA", "biasB"):
        np.testing.assert_allclose(card[key].cpu().numpy(), cpu[key].numpy(),
                                   rtol=0, atol=1e-4, err_msg=key)


# --------------------------------------------------------------------- #
# the L-BFGS family, MostPopular and the offsets serving (plain torch on  #
# the card; no CUDA kernel of their own)                                 #
# --------------------------------------------------------------------- #


def _lbfgs_problem(dtype, device, seed=5):
    from cmfrec_torch.solvers import lbfgs

    rng = np.random.default_rng(seed)
    m, n, k = 300, 200, 8
    pairs = np.unique(rng.integers(0, m * n, 6000))
    rows, cols = pairs // n, pairs % n
    vals = rng.normal(3, 1, rows.size)
    U = rng.normal(size=(m, 12))
    r, c = np.nonzero(rng.uniform(size=(n, 10)) < 0.3)
    side_I = (r, c, np.ones(r.size), n, 10, False, None)
    Ib = (rng.uniform(size=(n, 5)) < 0.4).astype(np.float64)
    prob = lbfgs.CollectiveProblem(
        rows, cols, vals, m, n, k=k, k_user=2, k_main=1, lambda_=2.0,
        side_U=(None, None, None, m, 12, True, U), side_I=side_I,
        side_Ib=(None, None, None, n, 5, True, Ib), w_user=0.7,
        weights=rng.uniform(0.5, 2, rows.size), dtype=dtype, device=device)
    init = {key: v.cpu().numpy() for key, v in
            lbfgs.CollectiveProblem.init_params(prob, 1).items()}
    return prob, init, (rows, cols, vals, m, n)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_lbfgs_objective_on_card_matches_cpu(cuda, dtype, tol):
    prob_cpu, init, _ = _lbfgs_problem(dtype, "cpu")
    prob_card, _, _ = _lbfgs_problem(dtype, "cuda")
    vc, gc = prob_cpu.value_and_grad(prob_cpu.init_params(1, init))
    vd, gd = prob_card.value_and_grad(prob_card.init_params(1, init))
    assert abs(float(vd) - float(vc)) <= tol * abs(float(vc))
    for key in gc:
        assert _rel(gd[key].cpu(), gc[key]) <= tol, key


def test_lbfgs_fit_on_card_matches_cpu(cuda):
    """A small collective L-BFGS fit with binary side info, float64, card
    against CPU from one init: the same iterations, parameters within
    1e-8 of max|param| (summation order only)."""
    from cmfrec_torch.solvers import lbfgs

    _, init, args = _lbfgs_problem(np.float64, "cpu")
    prob, _, _ = _lbfgs_problem(np.float64, "cpu")
    kw = dict(k=8, k_user=2, k_main=1, lambda_=2.0, w_user=0.7,
              side_U=prob_side(prob, "U"), side_Ib=prob_side(prob, "Ib"),
              dtype=np.float64, maxiter=30,
              init={key: v for key, v in init.items() if key != "D"})
    card = lbfgs.fit_collective_explicit_lbfgs(*args, device="cuda", **kw)
    cpu = lbfgs.fit_collective_explicit_lbfgs(*args, device="cpu", **kw)
    assert card["niter"] == cpu["niter"]
    assert card["host_syncs"] > 30
    for key in ("A", "B", "C", "Db", "biasA", "biasB"):
        np.testing.assert_allclose(card[key], cpu[key], rtol=0,
                                   atol=1e-8 * np.abs(cpu[key]).max(),
                                   err_msg=key)


def prob_side(prob, name):
    """A dense side of a CollectiveProblem back in the ingested form."""
    M = prob.sides[name][2].cpu().numpy()
    return (None, None, None, M.shape[0], M.shape[1], True, M)


@pytest.mark.parametrize("kw", [dict(user_bias=True),
                                dict(NA_as_zero=True, user_bias=True),
                                dict(implicit=True)],
                         ids=["user_bias", "na_as_zero", "implicit"])
def test_most_popular_on_card_matches_cpu(cuda, kw):
    import scipy.sparse as spm

    import cmfrec_torch

    rng = np.random.default_rng(7)
    X = spm.random(400, 300, density=0.05, random_state=3, format="coo")
    X.data = np.round(10 * X.data) / 2 + 0.5
    card = cmfrec_torch.MostPopular(**kw, device="cuda").fit(X)
    cpu = cmfrec_torch.MostPopular(**kw, device="cpu").fit(X)
    np.testing.assert_allclose(card.item_bias_, cpu.item_bias_, rtol=1e-12,
                               atol=0)
    if cpu.user_bias_ is not None:
        np.testing.assert_allclose(card.user_bias_, cpu.user_bias_,
                                   rtol=1e-12, atol=0)
    users, items = rng.integers(0, 400, 50), rng.integers(0, 300, 50)
    np.testing.assert_allclose(card.predict(users, items),
                               cpu.predict(users, items), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(card.topN(n=10, exclude=[1, 2]),
                                  cpu.topN(n=10, exclude=[1, 2]))


@pytest.mark.parametrize("branch", ["ridge", "exact", "implicit"])
def test_offsets_serving_on_card_matches_cpu(cuda, branch, tmp_path):
    """offsets_warm_batch's three branches on the card against a CPU copy
    of one model (save/load), f32: 1e-4 of max|a|."""
    import scipy.sparse as spm

    import cmfrec_torch
    from cmfrec_torch.solvers import warm

    rng = np.random.default_rng(8)
    m, n = 300, 200
    X = spm.random(m, n, density=0.08, random_state=4, format="coo")
    X.data = np.round(10 * X.data) / 2 + 0.5
    U = rng.normal(size=(m, 7))
    I = rng.normal(size=(n, 6))
    if branch == "implicit":
        model = cmfrec_torch.OMF_implicit(k=8, niter=3, use_float=True,
                                          device="cuda").fit(X, U=U)
    else:
        model = cmfrec_torch.OMF_explicit(
            k=8, k_sec=2 if branch == "exact" else 0, maxiter=60,
            use_float=True, device="cuda").fit(X, U=U, I=I)
    path = str(tmp_path / "omf.npz")
    model.save(path)
    twin = type(model).load(path, device="cpu")
    twin.force_precompute_for_predictions()
    R, L = 64, 12
    idx = rng.integers(0, n, size=(R, L))
    vals = np.round(2 * (3 + rng.normal(size=(R, L)))) / 2
    lengths = rng.integers(0, L + 1, R)
    base = (model.factors_cold_multiple(U[:R]).astype(np.float64)
            if branch == "exact" else None)
    kw = dict(base=base, implicit=branch == "implicit", alpha=1.0)
    got = warm.offsets_warm_batch(model, idx, vals, lengths, **kw)
    want = warm.offsets_warm_batch(twin, idx, vals, lengths, **kw)
    assert _rel(torch.as_tensor(got), torch.as_tensor(want)) <= 1e-4


# --------------------------------------------------------------------- #
# float64 and Jacobi PCG: plain torch on the card, no kernel             #
# --------------------------------------------------------------------- #

PLAIN_FITS = {
    "explicit-f64-dense": ("explicit", dict(dtype=np.float64)),
    "explicit-f64-sparse": ("explicit", dict(dtype=np.float64,
                                             engine="sparse")),
    "explicit-pcg-dense": ("explicit", dict(precondition_cg=True)),
    "explicit-pcg-sparse": ("explicit", dict(precondition_cg=True,
                                             engine="sparse")),
    "implicit-f64": ("implicit", dict(dtype=np.float64)),
    "implicit-pcg": ("implicit", dict(precondition_cg=True)),
    "collective-f64": ("collective", dict(dtype=np.float64)),
}


@pytest.mark.parametrize("case", list(PLAIN_FITS))
def test_plain_fits_launch_no_kernel(cuda, case, monkeypatch):
    """float64 and Jacobi-PCG fits on the card launch K1, K2 and K3 0 times
    and equal the same fit on the CPU from one init: float64 1e-10, f32 PCG
    on the plain dense engine 1e-4 (true f32 products); f32 PCG on the
    bucketed engine takes bf16 opposing rows on the card (as the JAX
    package's on the TPU), and the CPU fit it is held against is made to
    take them too: K3_REL_TOL's bf16 limit for three CG steps on bf16 rows
    (f32 sums in another order flip single bf16 roundings; readings
    1e-3 .. 2e-3 after three iterations)."""
    from cmfrec_torch.solvers import collective

    fit, kw = PLAIN_FITS[case]
    rng = np.random.default_rng(9)
    m, n, k = 300, 200, 8
    pairs = np.unique(rng.integers(0, m * n, 6000))
    rows, cols = pairs // n, pairs % n
    vals = np.round(2 * (3 + rng.normal(size=rows.size))) / 2
    init = {"A": 0.3 * rng.normal(size=(m, k)),
            "B": 0.3 * rng.normal(size=(n, k))}
    common = dict(k=k, niter=3, lambda_=1.0, init=init, **kw)
    if fit == "implicit":
        call, vals = drivers.fit_implicit_als, np.abs(vals) + 1.0
    elif fit == "collective":
        U = rng.normal(size=(m, 5))
        init["C"] = 0.3 * rng.normal(size=(5, k))
        common["side_U"] = (None, None, None, m, 5, True, U)
        call = collective.fit_collective_explicit_als
    else:
        call = drivers.fit_explicit_als
    ops = (mm.masked_gram_matvec, mm.masked_rhs, sparse_cg.bucket_cg)
    before = [op.launches for op in ops]
    got = call(rows, cols, vals, m, n, device="cuda", **common)
    assert [op.launches for op in ops] == before
    f64 = kw.get("dtype") == np.float64
    bf16_rows = not f64 and (kw.get("engine") == "sparse"
                             or fit == "implicit")
    if bf16_rows:
        monkeypatch.setattr(drivers, "_bf16_rows",
                            lambda dev, method, tdt: method == "cg")
    want = call(rows, cols, vals, m, n, device="cpu", **common)
    tol = 1e-10 if f64 else (K3_REL_TOL[torch.bfloat16] if bf16_rows
                              else 1e-4)
    for key in init:
        assert got[key].dtype == (torch.float64 if f64 else torch.float32)
        assert _rel(got[key].cpu(), want[key]) <= tol, key


def test_kernel_wrappers_raise_on_float64(cuda):
    """K1-K3's wrappers refuse a float64 tensor on the card; they never
    hand it to their plain twins."""
    Q, Be, W, X, mb = _inputs(cuda, 64, 64, 64, torch.float32,
                              torch.int8)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        mm.masked_gram_matvec(Q.double(), Be.double(), W)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        mm.masked_rhs(X, W, mb, Be.double())
    R, L, K = 8, 16, 64
    idx = torch.zeros(R, L, dtype=torch.int32, device=cuda)
    f = torch.zeros(R, L, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        sparse_cg.bucket_cg(
            Be.double(), idx, f, f, torch.eye(K, dtype=torch.float64,
                                              device=cuda), None, None,
            torch.zeros(R, K, dtype=torch.float64, device=cuda), n_steps=3,
            length=torch.full((R,), L, dtype=torch.int32, device=cuda))


def test_float64_factors_warm_card_matches_cpu(cuda, tmp_path):
    """A float64 model's warm factors on the card equal the CPU copy's
    within 1e-10 of max|a|, in float64."""
    import scipy.sparse as spm

    import cmfrec_torch

    rng = np.random.default_rng(10)
    m, n = 300, 200
    X = spm.random(m, n, density=0.08, random_state=5, format="coo")
    X.data = np.round(10 * X.data) / 2 + 0.5
    U = rng.normal(size=(m, 6))
    model = cmfrec_torch.CMF(k=8, niter=3, lambda_=2.0, use_float=False,
                             device="cuda").fit(X, U=U)
    path = str(tmp_path / "f64.npz")
    model.save(path)
    twin = cmfrec_torch.CMF.load(path, device="cpu")
    twin.force_precompute_for_predictions()
    cols, xv = np.array([2, 5, 9, 40]), np.array([3.5, 1.0, 4.5, 2.0])
    pairs = [(model.factors_warm(X_col=cols, X_val=xv, U=U[0]),
              twin.factors_warm(X_col=cols, X_val=xv, U=U[0])),
             (model.factors_multiple(X=X.tocsr()[:40]),
              twin.factors_multiple(X=X.tocsr()[:40]))]
    for got, want in pairs:
        assert got.dtype == np.float64
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


def _cd_problem(dev, R, K, dtype, seed=0):
    """R positive definite K x K systems of ridge form, rhs and l1 of both
    shapes, on the card in ``dtype``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Mt = torch.randn(R, K + 8, K, device=dev, generator=g,
                     dtype=torch.float64) / (K + 8) ** 0.5
    G = Mt.transpose(1, 2) @ Mt + 0.1 * torch.eye(K, device=dev,
                                                  dtype=torch.float64)
    rhs = torch.randn(R, K, device=dev, generator=g, dtype=torch.float64)
    l1 = {"K": 0.05 * torch.rand(K, device=dev, generator=g,
                                 dtype=torch.float64),
          "RK": 0.05 * torch.rand(R, K, device=dev, generator=g,
                                  dtype=torch.float64)}
    return (G.to(dtype), rhs.to(dtype),
            {key: v.to(dtype) for key, v in l1.items()})


@pytest.mark.parametrize("max_steps", [0, 1, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [8, 56, 64, 65, 128, 200, 264, 300])
def test_cd_solve_matches_twin(cuda, K, dtype, max_steps):
    """The CD kernel against rowsolve.solve_cd on the card: K up to 128
    staged (1-32 lanes a row, K = 65 padded), past it streamed; R = 333
    (not a multiple of the rows a block), l1 of both shapes, nonneg and the
    soft threshold, no sweep at all; each launch counted once."""
    R = 333
    G, rhs, l1 = _cd_problem(cuda, R, K, dtype)
    for nonneg, shape in ((True, "K"), (False, "RK")):
        want, want_sweeps = rowsolve.solve_cd(G, rhs, l1[shape], nonneg,
                                              max_steps, return_sweeps=True)
        n0 = coord_descent.solve_cd.launches
        out, sweeps = coord_descent.solve_cd(G, rhs, l1[shape], nonneg=nonneg,
                                             max_steps=max_steps,
                                             return_sweeps=True)
        torch.cuda.synchronize()
        assert coord_descent.solve_cd.launches == n0 + 1
        assert out.dtype == dtype and torch.isfinite(out).all()
        if max_steps == 0:
            assert not out.any() and not sweeps.any()
            continue
        assert _rel(out, want) <= CD_REL_TOL[dtype], (nonneg, shape)
        assert int(sweeps.min()) >= 1 and int(sweeps.max()) <= max_steps
        if max_steps == 1 or dtype == torch.float64:
            # f32 rows that settle within f32 resolution stop at whichever
            # sweep their roundings first fall to tol
            assert (sweeps == want_sweeps).float().mean() >= (
                1.0 if max_steps == 1 else 0.99)
        if nonneg:
            assert float(out.min()) >= 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [8, 56, 65, 128, 300])
def test_cd_solve_shared_g_matches_twin(cuda, K, dtype):
    """One G for every row, passed with row stride 0 (the dense C/D update
    of the collective fits; staged once a block up to K = 128), against the
    twin on the expanded copy, nonneg and the soft threshold."""
    R = 333
    G, rhs, l1 = _cd_problem(cuda, R, K, dtype, seed=1)
    shared = G[0].expand(R, K, K)
    for nonneg in (True, False):
        want = rowsolve.solve_cd(shared.contiguous(), rhs, l1["K"], nonneg,
                                 100)
        out = coord_descent.solve_cd(shared, rhs, l1["K"], nonneg=nonneg,
                                     max_steps=100)
        assert _rel(out, want) <= CD_REL_TOL[dtype], nonneg


@pytest.mark.parametrize("shared_g", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [8, 56, 64, 65, 200])
def test_cd_plan(cuda, K, dtype, shared_g):
    """The CD kernel's launch: G staged up to STAGED_MAX_K, four coordinates
    a lane on the fewest lanes that cover K, whole rows a warp, the block
    within the opt-in shared memory and resident on the card; the launch a
    solve takes is the one reported, before and after it."""
    plan = coord_descent.plan(K, shared_g, dtype)
    assert plan["staged"] == (K <= coord_descent.STAGED_MAX_K)
    assert plan["blocks_per_sm"] >= 1
    assert plan["smem"] <= _cuda.optin_smem(cuda)
    G, rhs, l1 = _cd_problem(cuda, 40, K, dtype)
    if shared_g:
        G = G[0].expand(40, K, K)
    coord_descent.solve_cd(G, rhs, l1["K"], nonneg=True, max_steps=3)
    assert coord_descent.plan(K, shared_g, dtype) == plan
    assert not plan["scratch"]
    if plan["staged"]:
        assert 4 * plan["lanes"] >= K > 2 * plan["lanes"] or plan["lanes"] == 1
        assert plan["rows_per_block"] == plan["warps"] * 32 // plan["lanes"]
    else:
        assert plan["rows_per_block"] == plan["warps"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cd_scratch_matches_shared_memory(cuda, monkeypatch, dtype):
    """Fault P6: the streamed path's scratch configuration (the vectors in
    device memory), forced at K = 200 by a plan for a 4,096-byte opt-in,
    gives the bits of the shared-memory one; 10,000 rows, more than the
    resident warps, so that warps walk several rows."""
    K, R = 200, 10000
    G, rhs, l1 = _cd_problem(cuda, R, K, dtype, seed=2)
    want, want_sweeps = coord_descent.solve_cd(
        G, rhs, l1["RK"], nonneg=False, max_steps=8, return_sweeps=True)
    shared = coord_descent.plan(K, False, dtype)
    assert not shared["scratch"] and shared["smem"] > 0
    monkeypatch.setattr(_cuda, "optin_smem", lambda device: 4096)
    plan = coord_descent.plan(K, False, dtype)
    assert plan["scratch"] and plan["smem"] == 0
    assert plan == dict(coord_descent.stream_plan(
        K, G.element_size(), 4096), staged=False, lanes=32,
        rows_per_block=plan["warps"], blocks_per_sm=plan["blocks_per_sm"])
    assert R > plan["blocks_per_sm"] * _cuda.sm_count(cuda) * plan["warps"]
    n0 = coord_descent.solve_cd.launches
    got, sweeps = coord_descent.solve_cd(G, rhs, l1["RK"], nonneg=False,
                                         max_steps=8, return_sweeps=True)
    torch.cuda.synchronize()
    assert coord_descent.solve_cd.launches == n0 + 1
    assert torch.equal(got, want) and torch.equal(sweeps, want_sweeps)


def test_cd_solve_past_the_shared_memory_matches_twin(cuda):
    """Fault P6: K = 4,848 in float64, past what a warp's six K-vectors
    leave of the opt-in shared memory, runs the kernel (the scratch
    configuration) and matches the twin: 4 rows, 2 sweeps."""
    K, R = 4848, 4
    plan = coord_descent.plan(K, False, torch.float64)
    assert plan["scratch"]
    G, rhs, l1 = _cd_problem(cuda, R, K, torch.float64, seed=3)
    want = rowsolve.solve_cd(G, rhs, l1["K"], True, 2)
    n0 = coord_descent.solve_cd.launches
    got = coord_descent.solve_cd(G, rhs, l1["K"], nonneg=True, max_steps=2)
    torch.cuda.synchronize()
    assert coord_descent.solve_cd.launches == n0 + 1
    assert _rel(got, want) <= CD_REL_TOL[torch.float64]


def test_cd_solve_refuses_what_it_does_not_take(cuda):
    """The wrapper raises on the card; it never hands a tensor to the twin
    there."""
    G, rhs, l1 = _cd_problem(cuda, 16, 8, torch.float32)
    with pytest.raises(ValueError, match="float32 or float64"):
        coord_descent.solve_cd(G.half(), rhs.half(), l1["K"].half(),
                               nonneg=True, max_steps=3)
    with pytest.raises(ValueError, match="contiguous"):
        coord_descent.solve_cd(G.transpose(1, 2), rhs, l1["K"], nonneg=True,
                               max_steps=3)
    with pytest.raises(ValueError, match="several devices"):
        coord_descent.solve_cd(G, rhs.cpu(), l1["K"], nonneg=True,
                               max_steps=3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["nonneg", "l1", "collective"])
def test_cd_fit_on_card_matches_cpu(cuda, case, dtype):
    """nonneg and l1 fits on the card launch the CD kernel (never K1-K3)
    and equal the same fit on the CPU from one init: float64 1e-10, float32
    1e-4 (the CD sums in another order over three iterations); factors and
    biases under nonneg >= 0."""
    from cmfrec_torch.solvers import collective

    rng = np.random.default_rng(11)
    m, n, k = 300, 200, 8
    pairs = np.unique(rng.integers(0, m * n, 6000))
    rows, cols = pairs // n, pairs % n
    # ratings of rank 4 (the l1 fit keeps some factors: on noise alone it
    # zeroes them all)
    At, Bt = rng.normal(size=(m, 4)), rng.normal(size=(n, 4))
    vals = 3 + (At[rows] * Bt[cols]).sum(1) + 0.3 * rng.normal(size=rows.size)
    init = {"A": np.abs(0.3 * rng.normal(size=(m, k))),
            "B": np.abs(0.3 * rng.normal(size=(n, k)))}
    common = dict(k=k, niter=3, lambda_=1.0, init=init, dtype=dtype)
    call = drivers.fit_explicit_als
    if case == "nonneg":
        common.update(nonneg=True, center=False)
    elif case == "l1":
        # without CG: with it the card assembles the systems from bf16
        # rows, as the JAX package does on a TPU (phase 28b of
        # chip_smoke.py runs that)
        common.update(l1_lambda=0.05, lambda_=0.1, scale_lam=True,
                      use_cg=False)
    else:
        U = np.abs(rng.normal(size=(m, 5)))
        init["C"] = np.abs(0.3 * rng.normal(size=(5, k)))
        common.update(side_U=(None, None, None, m, 5, True, U), nonneg=True,
                      nonneg_C=True, center=False)
        call = collective.fit_collective_explicit_als
    ops = (mm.masked_gram_matvec, mm.masked_rhs, sparse_cg.bucket_cg)
    before = [op.launches for op in ops]
    cd0 = coord_descent.solve_cd.launches
    got = call(rows, cols, vals, m, n, device="cuda", **common)
    torch.cuda.synchronize()
    assert [op.launches for op in ops] == before
    assert coord_descent.solve_cd.launches > cd0
    want = call(rows, cols, vals, m, n, device="cpu", **common)
    tol = 1e-10 if dtype == np.float64 else 1e-4
    for key in init:
        assert float(want[key].abs().max()) > 0, key
        assert _rel(got[key].cpu(), want[key]) <= tol, key
        if common.get("nonneg"):
            assert float(got[key].min()) >= 0.0, key


@pytest.mark.parametrize("implicit", [False, True])
def test_cd_serving_on_card_matches_cpu(cuda, implicit):
    """A nonneg model's warm and cold factors on the card (the CD kernel)
    against its CPU copy: 1e-4 of max|a| in f32, factors >= 0."""
    import scipy.sparse as spm

    import cmfrec_torch
    from cmfrec_torch.convert import cmf_from_arrays

    rng = np.random.default_rng(12)
    m, n = 300, 200
    X = spm.random(m, n, density=0.08, random_state=6, format="coo")
    X.data = np.round(10 * X.data) / 2 + 0.5
    U = np.abs(rng.normal(size=(m, 6)))
    cls = cmfrec_torch.CMF_implicit if implicit else cmfrec_torch.CMF
    kw = {} if implicit else dict(center=False)
    card = cls(k=8, niter=2, nonneg=True, nonneg_C=True, device="cuda",
               **kw).fit(X, U=U)
    cpu = cmf_from_arrays(
        A=card.A_, B=card.B_, C=card.C_, user_bias=card.user_bias_,
        item_bias=card.item_bias_, glob_mean=card.glob_mean_,
        U_colmeans=card.U_colmeans_,
        w_main_multiplier=getattr(card, "w_main_multiplier_", 1.0),
        params={key: v for key, v in card.get_params().items()
                if key != "device"}, cls=cls, device="cpu")
    cpu.force_precompute_for_predictions()
    n0 = coord_descent.solve_cd.launches
    for call in (lambda mdl: mdl.factors_multiple(X=X.tocsr()[:40]),
                 lambda mdl: mdl.factors_cold(U=U[3])):
        got, want = call(card), call(cpu)
        assert got.min() >= 0.0
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert coord_descent.solve_cd.launches == n0 + 2
