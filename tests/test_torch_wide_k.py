"""K past 256 on the card's kernel routes, on the CPU: the launch planners of
K1/K2 (gram_plan, rhs_plan; K1's and K2's wide configurations as masked_matmul
models the card's choice: wide_variant, wide_col_chunk, wide_smem;
rhs_wide_variant, rhs_col_chunk, rhs_wide_smem) and K3
(k3_plan) past 256 and unchanged up to it, the column-chunked composition of K1 and K2 in plain torch against the
twins and cmfrec_tpu's Pallas kernels in interpret mode, and the drivers
reaching their engines at k = 300 with a card stood in (no K check is left
before them).  The kernels themselves are held against their twins at
K = 264-1024 by tests/test_torch_kernels_gpu.py on a card.

Tolerances, as max|out - ref| <= tol * max|ref|: the chunked composition
against the twin is the same f32 arithmetic on the same columns, 1e-5
for f32 operands (bitwise in practice); against the Pallas kernels as
tests/test_torch_masked_matmul.py: f32 1e-5, bf16 1e-3 (flipped bf16
roundings of T*W)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmfrec_torch.ops import coord_descent, sparse_cg
from cmfrec_torch.ops import masked_matmul as mm
from cmfrec_torch.solvers import collective, dense_masked, drivers
from cmfrec_tpu.ops import masked_matmul as jmm

TOL = {"f32": 1e-5, "bf16": 1e-3}
# geometries a card would report up to K = 256 (configuration, row tile, S
# tile, blocks an SM, SMs, output columns a block, shared memory a block):
# the flagship's bf16 K1 and K2 on 132 SMs (the shared memory theirs at K =
# 64 on an int8 W)
GEO = {"gram": (0, 128, 128, 2, 132, 64, 114688),
       "rhs": (0, 128, 64, 2, 132, 64, 99072),
       # the f32 K2 (rhs_f32_tile8_kernel) on an int8 W, at any K
       "rhs_f32": (2, 128, 64, 1, 132, 64, 115200)}
# what an H100 reports: SMs, opt-in shared memory a block (bytes)
H100 = (132, 227 * 1024)
W_OF = {code: dtype for dtype, code in mm.W_TYPES.items()}


def _card_geometry(op, index, K, op_f32, w_type):
    """What an H100's geometry query would give: GEO up to K = 256, past it
    K1's and K2's wide configurations as masked_matmul models them (one
    block an SM), and the f32 K2's 64 columns a block."""
    if K <= mm.TILED_MAX_K:
        return GEO[op]
    if op == "rhs" and op_f32:
        return GEO["rhs_f32"]
    if op == "rhs":
        variant = mm.rhs_wide_variant(K, W_OF[w_type], H100[1])
        return (variant, 128, 64, 1, H100[0], mm.rhs_col_chunk(K),
                mm.rhs_wide_smem(variant, K, W_OF[w_type]))
    op_dtype = torch.float32 if op_f32 else torch.bfloat16
    variant = mm.wide_variant(K, op_dtype, W_OF[w_type], H100[1])
    return (variant, 64 if op_f32 else 128, 32 if op_f32 else 64, 1, H100[0],
            mm.wide_col_chunk(K, variant),
            mm.wide_smem(variant, K, W_OF[w_type]))


@pytest.fixture
def fake_geometry(monkeypatch):
    monkeypatch.setattr(mm, "_geometry", _card_geometry)


# The plans of the tree before K past 256 was taken, K1 and K2 alike at
# these geometries: {(K, R, S): (chunk, chunks)}
PINNED = {(64, 69888, 10688): (2688, 4), (64, 10688, 69888): (3200, 22),
          (128, 69888, 10688): (5376, 2), (128, 10688, 69888): (6400, 11),
          (256, 69888, 10688): (5376, 2), (256, 10688, 69888): (9984, 7)}


@pytest.mark.parametrize("op", ["gram", "rhs"])
@pytest.mark.parametrize("K", [64, 128, 256])
def test_plans_up_to_256_are_unchanged(fake_geometry, op, K):
    planner = mm.gram_plan if op == "gram" else mm.rhs_plan
    for R, S in ((69888, 10688), (10688, 69888)):
        plan = planner(R, S, K, torch.bfloat16, torch.int8, "cuda:0")
        variant, row_tile, s_tile, per_sm, sms = GEO[op][:5]
        chunk, chunks = PINNED[K, R, S]
        assert {key: plan[key] for key in ("variant", "row_tile", "s_tile",
                                            "per_sm", "sms", "chunk",
                                            "chunks")} == dict(
            variant=variant, row_tile=row_tile, s_tile=s_tile,
            per_sm=per_sm, sms=sms, chunk=chunk, chunks=chunks)
        # the blocks' 64 output columns, gridDim.y = K / 64 as before
        assert plan["col_chunk"] == mm.TILE
        assert plan["cols"] == tuple((c, mm.TILE) for c in range(0, K, 64))


WIDE_K = [320, 384, 448, 512, 576, 1024]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("op", ["gram", "rhs"])
@pytest.mark.parametrize("K", WIDE_K)
def test_plans_past_256_cover_k_once_in_chunks(fake_geometry, op, K, dtype):
    planner = mm.gram_plan if op == "gram" else mm.rhs_plan
    plan = planner(69888, 10688, K, dtype, torch.int8, "cuda:0")
    covered = np.zeros(K, int)
    most = (64 * mm.WIDE_CONFIGS[plan["variant"]][3] if op == "gram"
            else 64 * mm.RHS_WIDE_TILES if dtype == torch.bfloat16 else 64)
    for c0, width in plan["cols"]:
        assert 0 < width <= most and width % 64 == 0 and c0 % 64 == 0
        covered[c0:c0 + width] += 1
    assert (covered == 1).all()
    if op == "gram":  # the wide K1: the fewest chunks its registers allow
        assert len(plan["cols"]) == -(-K // most)
        assert plan["col_chunk"] == mm.wide_col_chunk(K, plan["variant"])
        assert plan["variant"] in mm.WIDE_CONFIGS
        assert mm.WIDE_CONFIGS[plan["variant"]][0] == dtype
    elif dtype == torch.bfloat16:  # the wide K2: the fewest its registers allow
        assert len(plan["cols"]) == -(-K // most)
        assert plan["col_chunk"] == mm.rhs_col_chunk(K)
        assert plan["variant"] in mm.RHS_WIDE_CONFIGS
    else:  # the f32 K2's blocks own 64 columns at any K
        assert plan["col_chunk"] == 64 and len(plan["cols"]) == K // 64
    assert plan["chunks"] * plan["chunk"] >= 10688
    assert plan["chunk"] % plan["s_tile"] == 0


def test_wide_col_chunk_splits_evenly():
    """K = 320 in one chunk in the configurations that take it (the scores
    computed once); past that the fewest chunks the registers allow, as
    even as whole tiles allow."""
    for variant in (5, 7, 8):
        assert mm.wide_col_chunk(320, variant) == 320
    assert mm.wide_col_chunk(320, 6) == 192  # 192 + 128, not 256 + 64
    assert mm.wide_col_chunk(384, 5) == 192  # 192 + 192, not 320 + 64
    assert mm.wide_col_chunk(384, 7) == 384
    assert mm.wide_col_chunk(448, 6) == 256  # 256 + 192
    assert mm.wide_col_chunk(576, 6) == 192  # three of 192
    assert mm.wide_col_chunk(576, 7) == 320  # 320 + 256
    assert mm.wide_col_chunk(1024, 6) == 256
    assert mm.wide_col_chunk(1024, 8) == 512


# K1's wide configuration by K and W type (int8, bf16, f32) on an H100
# (232,448 B a block): bf16 operands 5 (Q and whole-K Be tiles held), 6 (Q
# streamed with the K chunks); f32 operands 7 (held), 8 (streamed)
WIDE_PINNED = {
    320: {"bf16": (5, 5, 5), "f32": (7, 7, 7)},
    384: {"bf16": (5, 5, 6), "f32": (7, 7, 8)},
    448: {"bf16": (6, 6, 6), "f32": (8, 8, 8)},
    512: {"bf16": (6, 6, 6), "f32": (8, 8, 8)},
    576: {"bf16": (6, 6, 6), "f32": (8, 8, 8)},
    1024: {"bf16": (6, 6, 6), "f32": (8, 8, 8)}}


@pytest.mark.parametrize("w", [torch.int8, torch.bfloat16, torch.float32],
                         ids=["int8", "bf16", "f32"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("K", WIDE_K)
def test_wide_configuration_fits_the_card(K, dtype, w):
    """The configuration K1 takes past 256, its shared memory within an
    H100's opt-in 232,448 B, and at K = 320 at most two column chunks in
    bf16 and one in f32."""
    variant = mm.wide_variant(K, dtype, w, 232448)
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    assert variant == WIDE_PINNED[K][name][
        (torch.int8, torch.bfloat16, torch.float32).index(w)]
    assert mm.wide_smem(variant, K, w) <= 232448
    # the configurations tried before it do not fit
    for earlier in mm.WIDE_CONFIGS:
        if mm.WIDE_CONFIGS[earlier][0] == dtype and earlier < variant:
            assert mm.wide_smem(earlier, K, w) > 232448
    chunks = len(mm.col_chunks(K, mm.wide_col_chunk(K, variant)))
    if K == 320:
        assert chunks <= (2 if dtype == torch.bfloat16 else 1)


# K2's wide configuration past 256 (bf16 operands) on an H100 (232,448 B a
# block): {K: (output columns a block, the column chunks, {W type:
# (configuration: 3 three ring stages, 4 two; shared memory a block)})}
RHS_WIDE_PINNED = {
    320: (320, (320,), {"int8": (3, 200728), "bf16": (3, 225304),
                        "f32": (4, 183312)}),
    384: (192, (192, 192), {"int8": (3, 151576), "bf16": (3, 176152),
                            "f32": (3, 225304)}),
    576: (320, (320, 256), {"int8": (3, 200728), "bf16": (3, 225304),
                            "f32": (4, 183312)}),
    1024: (256, (256,) * 4, {"int8": (3, 176152), "bf16": (3, 200728),
                             "f32": (4, 166928)})}


@pytest.mark.parametrize("w", [torch.int8, torch.bfloat16, torch.float32],
                         ids=["int8", "bf16", "f32"])
@pytest.mark.parametrize("K", list(RHS_WIDE_PINNED))
def test_rhs_wide_configuration_fits_the_card(K, w):
    """The bf16 K2 past 256: a block owns the fewest even chunks of at most
    five 64-column tiles (K = 320 in one), and the ring takes three stages
    where they fit an H100's opt-in 232,448 B, else two."""
    nc, chunks, by_w = RHS_WIDE_PINNED[K]
    variant, smem = by_w[{torch.int8: "int8", torch.bfloat16: "bf16",
                          torch.float32: "f32"}[w]]
    assert mm.rhs_col_chunk(K) == nc
    assert tuple(wd for _, wd in mm.col_chunks(K, nc)) == chunks
    assert mm.rhs_wide_variant(K, w, 232448) == variant
    assert mm.rhs_wide_smem(variant, K, w) == smem <= 232448
    for earlier in mm.RHS_WIDE_CONFIGS:
        if earlier < variant:
            assert mm.rhs_wide_smem(earlier, K, w) > 232448


def _masked(t, W, bf16):
    """T * W as the twin forms it (masked_gram_matvec_ref)."""
    if bf16 and W.dtype == torch.bfloat16:
        t = t.to(torch.bfloat16).float()
    t = t * W.float()
    return t.to(torch.bfloat16).float() if bf16 else t


def _gram_by_chunks(Q, Be, W):
    """K1 as the wide kernel composes it: full-K scores, then each output
    column chunk's product with its own columns of Be."""
    K = Be.shape[1]
    bf16 = Be.dtype == torch.bfloat16
    P = _masked(Q.float() @ Be.float().T, W, bf16)
    out = torch.empty(Q.shape[0], K)
    variant = mm.wide_variant(K, Be.dtype, W.dtype, 232448)
    for c0, width in mm.col_chunks(K, mm.wide_col_chunk(K, variant)):
        out[:, c0:c0 + width] = P @ Be[:, c0:c0 + width].float()
    return out


def _rhs_by_chunks(X, W, mb, Be):
    """K2 as its kernels compose it: each output column chunk from its
    columns of Be (past 256 with bf16 operands the wide chunks, else 64)."""
    K = Be.shape[1]
    wide = K > mm.TILED_MAX_K and Be.dtype == torch.bfloat16
    out = torch.empty(X.shape[0], K)
    for c0, width in mm.col_chunks(K, mm.rhs_col_chunk(K) if wide
                                   else mm.TILE):
        out[:, c0:c0 + width] = mm.masked_rhs_ref(
            X, W, mb, Be[:, c0:c0 + width].contiguous())
    return out


def _rel(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("w", ["int8", "bf16"])
@pytest.mark.parametrize("op", ["f32", "bf16"])
def test_chunked_composition_matches_twin_and_pallas(op, w):
    """K = 320 (k = 300 on the dense engine): the chunked K1 and K2 against
    the twins and against the Pallas kernels in interpret mode."""
    R, S, K = jmm.BLOCK_R, 1024, 320
    rng = np.random.default_rng(14)
    Qn = rng.normal(size=(R, K)).astype(np.float32)
    Ben = rng.normal(size=(S, K)).astype(np.float32)
    mask = rng.uniform(size=(R, S)) < 0.3
    Wn = (mask.astype(np.int8) if w == "int8" else
          (mask * rng.uniform(0.5, 2.0, size=(R, S))).astype(np.float32))
    Xn = (np.round(rng.uniform(1, 10, size=(R, S))) / 2).astype(np.float32)
    mbn = rng.normal(size=S).astype(np.float32)
    tdt = torch.bfloat16 if op == "bf16" else torch.float32
    jdt = jnp.bfloat16 if op == "bf16" else jnp.float32
    Q, Be = torch.from_numpy(Qn).to(tdt), torch.from_numpy(Ben).to(tdt)
    W = torch.from_numpy(Wn)
    Wj = jnp.asarray(Wn)
    if w == "bf16":
        W = W.to(torch.bfloat16)
        Wj = jnp.asarray(W.float().numpy(), jnp.bfloat16)
    X = torch.from_numpy(Xn).to(torch.bfloat16)
    mb = torch.from_numpy(mbn)

    gram = _gram_by_chunks(Q, Be, W)
    assert _rel(gram, mm.masked_gram_matvec_ref(Q, Be, W)) <= 1e-5
    pallas = jmm.masked_gram_matvec(jnp.asarray(Qn, jdt), jnp.asarray(Ben, jdt),
                                    Wj, block_s=1024, interpret=True)
    assert _rel(gram, pallas) <= TOL[op]

    rhs = _rhs_by_chunks(X, W, mb, Be)
    assert _rel(rhs, mm.masked_rhs_ref(X, W, mb, Be)) <= 1e-5
    pallas = jmm.masked_rhs(jnp.asarray(Xn, jnp.bfloat16), Wj,
                            jnp.asarray(mbn), jnp.asarray(Ben, jdt),
                            block_s=1024, interpret=True)
    assert _rel(rhs, pallas) <= TOL[op]


@pytest.mark.parametrize("w", ["int8", "bf16"])
@pytest.mark.parametrize("op", ["f32", "bf16"])
def test_rhs_two_chunk_composition_matches_twin_and_pallas(op, w):
    """K = 576, two column chunks of the bf16 K2 (320 + 256; f32 nine of
    64): the chunked K2 against its twin (the same f32 arithmetic on the
    same columns, 1e-5) and against the Pallas kernel in interpret mode
    (TOL: f32 1e-5; bf16 1e-3, though V's rounding is elementwise and only
    the f32 sum order differs)."""
    R, S, K = jmm.BLOCK_R, 512, 576
    rng = np.random.default_rng(16)
    Ben = rng.normal(size=(S, K)).astype(np.float32)
    mask = rng.uniform(size=(R, S)) < 0.3
    Wn = (mask.astype(np.int8) if w == "int8" else
          (mask * rng.uniform(0.5, 2.0, size=(R, S))).astype(np.float32))
    Xn = (np.round(rng.uniform(1, 10, size=(R, S))) / 2).astype(np.float32)
    mbn = rng.normal(size=S).astype(np.float32)
    tdt = torch.bfloat16 if op == "bf16" else torch.float32
    jdt = jnp.bfloat16 if op == "bf16" else jnp.float32
    Be = torch.from_numpy(Ben).to(tdt)
    W = torch.from_numpy(Wn)
    Wj = jnp.asarray(Wn)
    if w == "bf16":
        W = W.to(torch.bfloat16)
        Wj = jnp.asarray(W.float().numpy(), jnp.bfloat16)
    X = torch.from_numpy(Xn).to(torch.bfloat16)
    mb = torch.from_numpy(mbn)
    if op == "bf16":
        assert len(mm.col_chunks(K, mm.rhs_col_chunk(K))) == 2
    rhs = _rhs_by_chunks(X, W, mb, Be)
    assert _rel(rhs, mm.masked_rhs_ref(X, W, mb, Be)) <= 1e-5
    pallas = jmm.masked_rhs(jnp.asarray(Xn, jnp.bfloat16), Wj,
                            jnp.asarray(mbn), jnp.asarray(Ben, jdt),
                            block_s=S, interpret=True)
    assert _rel(rhs, pallas) <= TOL[op]


# K3's plans of the tree before K past 256 was taken (K <= 256)
K3_PINNED = {
    (95040, 32, 56, 2): dict(cls="narrow", threads=256, warp_rows=True,
                             cluster=1, stage_slots=32, smem=61184),
    (12680, 176, 56, 2): dict(cls="middle", threads=128, warp_rows=False,
                              cluster=1, stage_slots=176, smem=36672),
    (40, 31592, 56, 2): dict(cls="wide", threads=256, warp_rows=False,
                             cluster=8, stage_slots=762, smem=106448),
    (1536, 904, 56, 2): dict(cls="middle", threads=256, warp_rows=False,
                             cluster=1, stage_slots=762, smem=106448),
    (40, 3000, 256, 4): dict(cls="wide", threads=128, warp_rows=False,
                             cluster=8, stage_slots=87, smem=105952),
    (61784, 48, 256, 2): dict(cls="narrow", threads=256, warp_rows=True,
                              cluster=1, stage_slots=5, smem=103680),
    (99928, 40, 8, 4): dict(cls="narrow", threads=256, warp_rows=True,
                            cluster=1, stage_slots=40, smem=15360),
}


@pytest.mark.parametrize("case", list(K3_PINNED), ids=str)
def test_k3_plans_up_to_256_are_unchanged(case):
    assert sparse_cg.k3_plan(*case, *H100) == dict(K3_PINNED[case],
                                                 k_loop=False)


# the LastFM-shaped buckets of both sides (R, L), as test_torch_sparse_cg.py
LASTFM_BUCKETS = [
    (40, 3400), (400, 912), (1496, 376), (3752, 216), (7688, 144),
    (13360, 104), (21304, 80), (20208, 64), (34392, 56), (61784, 48),
    (99928, 40), (95040, 32), (40, 31592), (88, 14048), (184, 6632),
    (392, 3240), (744, 1640), (1536, 904), (3032, 504), (6672, 296),
    (12680, 176), (26760, 112), (43672, 72), (64392, 48)]


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("K", [264, 304, 512, 1024])
def test_k3_plans_past_256_loop_over_k(K, esz):
    """Past 256, up to ROWS_MAX_K, the rows design: narrow rows a warp each,
    8 rows a block; wider rows a team of warps, several rows a block (a
    cluster one); within the opt-in shared memory, its stage within the
    row's range."""
    for R, L in LASTFM_BUCKETS + [(1, 1), (3, 31600)]:
        plan = sparse_cg.k3_plan(R, L, K, esz, *H100)
        assert plan["k_loop"] and plan["rows"] in (1, 2, 4, 8)
        assert plan["warp_rows"] == (L <= sparse_cg.NARROW_L)
        if L <= sparse_cg.NARROW_L:
            assert plan["cls"] == "narrow"
            assert plan["rows"] == 8 and plan["threads"] == 256
        else:
            assert plan["cls"] == ("wide" if plan["cluster"] > 1
                                   else "middle")
            assert plan["rows"] == 1 or plan["cluster"] == 1
            assert plan["threads"] // 32 // plan["rows"] in (2, 4, 8)
        assert plan["threads"] % (32 * plan["rows"]) == 0
        assert plan["smem"] <= H100[1]
        assert plan["smem"] == sparse_cg.rows_smem_bytes(
            K, esz, plan["rows"], plan["threads"] // 32, plan["stage_slots"],
            plan["cluster"])
        assert 0 <= plan["stage_slots"] <= -(-L // plan["cluster"])
    sparse_cg.check_k(K, esz, H100[1])


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("K", [1032, 2048])
def test_k3_plans_past_1024_keep_the_loop_design(K, esz):
    """Past ROWS_MAX_K the loop design: a block (or cluster) a row, narrow
    rows too, whose warps loop over K, within the opt-in shared memory."""
    for R, L in LASTFM_BUCKETS + [(1, 1), (3, 31600)]:
        plan = sparse_cg.k3_plan(R, L, K, esz, *H100)
        assert plan == sparse_cg.block_plan(R, L, K, esz, *H100)
        assert plan["k_loop"] and not plan["warp_rows"] and "rows" not in plan
        assert plan["cls"] == ("wide" if plan["cluster"] > 1 else "middle")
        assert plan["threads"] in (128, 256)
        assert plan["smem"] <= H100[1]
        assert plan["smem"] == sparse_cg.smem_bytes(
            K, esz, 1, plan["threads"] // 32, plan["stage_slots"])
        assert 0 <= plan["stage_slots"] <= -(-L // plan["cluster"])


@pytest.mark.parametrize("K", [264, 304, 1024])
def test_k3_rows_plans_of_a_bucket_prefix(K):
    """chip_smoke.py phase 30 holds each A bucket's first 2,048 rows with
    the plan of the whole bucket: the rows design gives both the same plan.
    Fewer rows than a block an SM's worth take fewer rows a block."""
    for R, L in LASTFM_BUCKETS[:12]:
        assert (sparse_cg.k3_plan(min(R, 2048), L, K, 2, *H100)
                == sparse_cg.k3_plan(R, L, K, 2, *H100))
    few = sparse_cg.k3_plan(130, 400, K, 2, *H100)
    assert few["cls"] == "middle" and few["cluster"] == 1
    assert few["rows"] == 1 and few["threads"] == 64
    assert sparse_cg.k3_plan(2 * 132, 400, K, 2, *H100)["rows"] == 2


def test_k3_limit_names_the_shared_memory():
    sparse_cg.check_k(3600, 2, H100[1])
    with pytest.raises(ValueError, match=r"K=3640 needs 233088 bytes of "
                                         r"shared memory"):
        sparse_cg.check_k(3640, 2, H100[1])


def test_cd_limit_names_the_shared_memory():
    """The CD kernel stages G up to STAGED_MAX_K whatever the type; past it
    the streamed path keeps a row's six K-vectors in shared memory while
    one warp's fit the opt-in shared memory, and past that (K = 4,842 in
    float64, 9,685 in float32 on an H100) in a scratch in device memory:
    no K raises."""
    optin = H100[1]
    for K, esz in ((4842, 8), (9685, 4)):
        plan = coord_descent.stream_plan(K, esz, optin)
        assert not plan["scratch"] and plan["warps"] == 1
        assert plan["smem"] == 6 * K * esz <= optin
        past = coord_descent.stream_plan(K + 1, esz, optin)
        assert past == dict(warps=coord_descent.STREAM_WARPS, scratch=True,
                            smem=0)
        assert 6 * (K + 1) * esz > optin
    # K = 200 (f32): 8 warps in shared memory; a small opt-in forces the
    # scratch (the card test holds the two configurations bitwise equal)
    assert coord_descent.stream_plan(200, 4, optin) == dict(
        warps=8, scratch=False, smem=8 * 4800)
    assert coord_descent.stream_plan(200, 4, 4096)["scratch"]
    assert coord_descent.stream_plan(4848, 8, optin)["scratch"]


# an opt-in shared memory that puts K3's limit between K = 256 and 264:
# a row's CG vectors take 64 K + 128 bytes
P6_OPTIN = 64 * 256 + 128


@pytest.mark.parametrize("optin,routed", [(P6_OPTIN, True),
                                          (64 * 264 + 128, False)],
                         ids=["past-limit", "within-limit"])
def test_k3_past_its_limit_takes_solve_cg(monkeypatch, optin, routed):
    """Fault P6 on a card stood in: past K3's shared-memory limit (here at K
    = 264, an opt-in of 16,512 B) a bucketed CMF_implicit fit at k = 260
    runs rowsolve.solve_cg, never the bucket-CG op, and matches cmfrec_tpu
    (tolerance of test_torch_bucketed_fit.py); within the limit the op runs
    every CG bucket."""
    from cmfrec_torch.convert import init_from_arrays
    from cmfrec_torch.ops import _cuda, rowsolve
    from cmfrec_torch.solvers import als
    from cmfrec_tpu.solvers import drivers as jax_drivers

    monkeypatch.setattr(als, "_on_card", lambda device: True)
    monkeypatch.setattr(_cuda, "optin_smem", lambda device: optin)
    assert sparse_cg.k_fits(256, P6_OPTIN)
    assert not sparse_cg.k_fits(264, P6_OPTIN)
    calls = {"bucket_cg": 0, "solve_cg": 0}

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*args, **kw):
            calls[name] += 1
            return real(*args, **kw)
        monkeypatch.setattr(module, name, wrapped)

    spy(sparse_cg, "bucket_cg")
    spy(rowsolve, "solve_cg")
    m, n, k = 60, 40, 260
    rng = np.random.default_rng(2)
    pairs = np.unique(rng.integers(0, m * n, 700))
    rows, cols = pairs // n, pairs % n
    vals = rng.uniform(1, 10, rows.size)
    init = {key: (0.3 * rng.normal(size=(d, k))).astype(np.float32)
            for key, d in (("A", m), ("B", n))}
    common = dict(k=k, lambda_=0.9, alpha=2.0, niter=2, seed=3)
    rj = jax_drivers.fit_implicit_als(rows, cols, vals, m, n, init=init,
                                      dtype=np.float32, **common)
    rt = drivers.fit_implicit_als(rows, cols, vals, m, n, device="cpu",
                                  init=init_from_arrays(init, "cpu"),
                                  **common)
    if routed:
        assert calls["bucket_cg"] == 0 and calls["solve_cg"] > 0
    else:
        assert calls["bucket_cg"] > 0 and calls["solve_cg"] == 0
    for key in ("A", "B"):
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(rj[key]),
                                   rtol=0, atol=5e-5, err_msg=key)


class _Reached(Exception):
    pass


def _small_fit_data(seed=9, m=40, n=30):
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, m * n, 300))
    rows, cols = (pairs // n).astype(np.int32), (pairs % n).astype(np.int32)
    vals = (1 + rng.integers(0, 5, rows.size)).astype(np.float64)
    return rows, cols, vals, m, n


@pytest.mark.parametrize("fit", ["explicit", "implicit", "implicit-dense",
                                 "collective"])
def test_fits_reach_their_engines_at_k_300_on_a_card(fit, monkeypatch):
    """A card stood in: k = 300 (K = 320 on the dense engines, 304 on the
    bucketed implicit one) goes to the engine of its route, which runs the
    kernels; nothing raises on K before it."""
    cuda = torch.device("cuda")
    monkeypatch.setattr(drivers, "resolve_device", lambda device: cuda)
    monkeypatch.setattr(collective, "resolve_device", lambda device: cuda)
    monkeypatch.setattr(drivers, "_dense_budget", lambda dev: 1 << 40)
    reached = {}

    def engine(name):
        def stub(*args, **kw):
            reached.update(name=name, k=kw.get("k"), device=kw.get("device"))
            raise _Reached
        return stub

    for name in ("fit_explicit_dense_masked", "fit_implicit_dense_masked",
                 "_build_pair"):
        monkeypatch.setattr(drivers, name, engine(name))
    monkeypatch.setattr(collective, "fit_collective_dense_masked",
                        engine("fit_collective_dense_masked"))
    rows, cols, vals, m, n = _small_fit_data()
    k = 300
    with pytest.raises(_Reached):
        if fit == "explicit":
            drivers.fit_explicit_als(rows, cols, vals, m, n, k=k)
        elif fit == "implicit":
            drivers.fit_implicit_als(rows, cols, vals, m, n, k=k)
        elif fit == "implicit-dense":
            drivers.fit_implicit_als(rows, cols, vals, m, n, k=k,
                                     engine="dense")
        else:
            U = np.random.default_rng(3).normal(size=(m, 4))
            collective.fit_collective_explicit_als(
                rows, cols, vals, m, n, side_U=(None, None, None, m, 4, True,
                                                U), k=k)
    want = {"explicit": ("fit_explicit_dense_masked", 320),
            "implicit": ("_build_pair", 304),
            "implicit-dense": ("fit_implicit_dense_masked", 320),
            "collective": ("fit_collective_dense_masked", 320)}[fit]
    assert reached["name"] == want[0]
    if fit == "implicit":  # the bucketed engine pads k to a multiple of 8
        assert drivers._round_up(k, 8) == want[1]
    else:
        assert reached["k"] == k
        assert dense_masked.padded_dims(
            m, n, k, bias_col=fit != "implicit-dense")[2] == want[1]
