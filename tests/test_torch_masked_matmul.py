"""cmfrec_torch masked-Gram ops (CPU path = the plain twins) against the
cmfrec_tpu Pallas kernels run in interpret mode, and a float64 oracle.

Tolerances, as max|out - ref| <= tol * max|ref|:
  * f32 operands: 1e-5 -- the same f32 products, summed in another order.
  * bf16 operands: the rounding of T*W to bf16 can flip by one bf16 ulp
    (2**-8 relative) on single entries when T's f32 sum differs in its last
    bits, ~2e-4 of max|ref| per flip at these sizes, so against JAX 1e-3;
    against the unrounded float64 oracle the rounding itself shows
    (~8e-4 measured), 3e-3.  A bf16 W adds T's own rounding before the
    multiply (masked_matmul.py:94), within the same limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmfrec_tpu.ops import masked_matmul as jmm
from cmfrec_torch.ops import masked_matmul as tmm

K = 64
TOL_JAX = {"f32": 1e-5, "bf16": 1e-3}
TOL_F64 = {"f32": 1e-5, "bf16": 3e-3}


def _rel_err(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _operands(seed, R, S, op, w, K=K):
    """Numpy inputs, the torch tensors and the JAX arrays built from them."""
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(R, K)).astype(np.float32)
    Be = rng.normal(size=(S, K)).astype(np.float32)
    mask = rng.uniform(size=(R, S)) < 0.3
    if w == "int8":
        Wn = mask.astype(np.int8)
    else:
        Wn = (mask * rng.uniform(0.5, 2.0, size=(R, S))).astype(np.float32)
    Wt = torch.from_numpy(Wn)
    Wj = jnp.asarray(Wn)
    if w == "bf16":  # the weights rounded to bf16, as both frameworks see them
        Wt = Wt.to(torch.bfloat16)
        Wn = Wt.float().numpy()
        Wj = jnp.asarray(Wn, jnp.bfloat16)
    tdt = torch.bfloat16 if op == "bf16" else torch.float32
    jdt = jnp.bfloat16 if op == "bf16" else jnp.float32
    Qt, Bet = torch.from_numpy(Q).to(tdt), torch.from_numpy(Be).to(tdt)
    # the rounded operands, exactly as both frameworks see them
    Q64, Be64 = Qt.double().numpy(), Bet.double().numpy()
    return (Qt, Bet, Wt, jnp.asarray(Q, jdt), jnp.asarray(Be, jdt), Wj, Q64,
            Be64, Wn, rng)


@pytest.mark.parametrize("S", [1024, 2048])
@pytest.mark.parametrize("w", ["int8", "f32", "bf16"])
@pytest.mark.parametrize("op", ["bf16", "f32"])
def test_masked_gram_matvec_twin_matches_pallas(op, w, S):
    R = jmm.BLOCK_R
    Qt, Bet, Wt, Qj, Bej, Wj, Q64, Be64, Wn, _ = _operands(1, R, S, op, w)
    out = tmm.masked_gram_matvec(Qt, Bet, Wt)
    assert out.dtype == torch.float32 and tuple(out.shape) == (R, K)
    ref_j = jmm.masked_gram_matvec(Qj, Bej, Wj, block_s=1024, interpret=True)
    assert _rel_err(out.numpy(), ref_j) <= TOL_JAX[op]
    ref_64 = ((Q64 @ Be64.T) * Wn) @ Be64
    assert _rel_err(out.numpy(), ref_64) <= TOL_F64[op]
    assert tmm.masked_gram_matvec.launches == 0  # CPU tensors: the twin


@pytest.mark.parametrize("S", [1024, 2048])
@pytest.mark.parametrize("w", ["int8", "f32", "bf16"])
@pytest.mark.parametrize("op", ["bf16", "f32"])
def test_masked_rhs_twin_matches_pallas(op, w, S):
    R = jmm.BLOCK_R
    _, Bet, Wt, _, Bej, Wj, _, Be64, Wn, rng = _operands(2, R, S, op, w)
    X = (np.round(rng.uniform(1, 10, size=(R, S))) / 2).astype(np.float32)
    mb = rng.normal(size=S).astype(np.float32)
    out = tmm.masked_rhs(torch.from_numpy(X).to(torch.bfloat16), Wt,
                         torch.from_numpy(mb), Bet)
    assert out.dtype == torch.float32 and tuple(out.shape) == (R, K)
    ref_j = jmm.masked_rhs(jnp.asarray(X, jnp.bfloat16), Wj, jnp.asarray(mb),
                           Bej, block_s=1024, interpret=True)
    assert _rel_err(out.numpy(), ref_j) <= TOL_JAX[op]
    ref_64 = ((X.astype(np.float64) - mb[None, :]) * Wn) @ Be64
    assert _rel_err(out.numpy(), ref_64) <= TOL_F64[op]
    assert tmm.masked_rhs.launches == 0


@pytest.mark.parametrize("op", ["bf16", "f32"])
def test_twins_take_k_beyond_the_kernels(op):
    """Fault P1: the twins at K=320 (k=300 in the dense engine), past the
    card kernels' 256, against the Pallas kernels; tolerances as above."""
    R, S, K320 = jmm.BLOCK_R, 1024, 320
    Qt, Bet, Wt, Qj, Bej, Wj, _, _, _, rng = _operands(3, R, S, op, "int8",
                                                       K=K320)
    out = tmm.masked_gram_matvec(Qt, Bet, Wt)
    assert tuple(out.shape) == (R, K320)
    ref_j = jmm.masked_gram_matvec(Qj, Bej, Wj, block_s=1024, interpret=True)
    assert _rel_err(out.numpy(), ref_j) <= TOL_JAX[op]
    X = (np.round(rng.uniform(1, 10, size=(R, S))) / 2).astype(np.float32)
    mb = rng.normal(size=S).astype(np.float32)
    out = tmm.masked_rhs(torch.from_numpy(X).to(torch.bfloat16), Wt,
                         torch.from_numpy(mb), Bet)
    ref_j = jmm.masked_rhs(jnp.asarray(X, jnp.bfloat16), Wj, jnp.asarray(mb),
                           Bej, block_s=1024, interpret=True)
    assert _rel_err(out.numpy(), ref_j) <= TOL_JAX[op]


def _t(shape, dtype, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8


@pytest.mark.parametrize("args,match", [
    ((_t((64, 64), torch.float16), _t((64, 64), torch.float16),
      _t((64, 64), i8)), "bfloat16 or float32"),
    ((_t((64, 64), bf), _t((64, 64), bf), _t((64, 64), torch.float16)),
     "W must be"),
    ((_t((64, 64), bf), _t((64, 64), f32), _t((64, 64), i8)), "one dtype"),
    ((_t((96, 64), bf), _t((64, 64), bf), _t((96, 64), i8)), "multiples"),
    ((_t((64, 64), bf), _t((100, 64), bf), _t((64, 100), i8)), "multiples"),
    ((_t((64, 32), bf), _t((64, 32), bf), _t((64, 64), i8)), "K=32"),
    # off the CPU and off a card (here a tensor without data): K=320 is no
    # longer refused (the wide K1 takes it), but no kernel runs there
    ((_t((64, 320), f32, "meta"), _t((64, 320), f32, "meta"),
      _t((64, 64), i8, "meta")), "K=320"),
    ((_t((64, 64), bf), _t((64, 64), bf), _t((64, 128), i8)), "W has shape"),
    ((_t((64, 64), bf), _t((64, 64), bf), _t((64, 128), i8)[:, ::2]),
     "W has shape|contiguous"),
])
def test_masked_gram_matvec_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        tmm.masked_gram_matvec(*args)


@pytest.mark.parametrize("args,match", [
    ((_t((64, 64), f32), _t((64, 64), i8), _t(64, f32), _t((64, 64), bf)),
     "X must be bfloat16"),
    ((_t((64, 64), bf), _t((64, 64), i8), _t(64, bf), _t((64, 64), bf)),
     "mb must be"),
    ((_t((64, 64), bf), _t((64, 64), i8), _t(64, f32), _t((128, 64), bf)),
     "Be has 128 rows"),
    ((_t((64, 64), bf), _t((64, 64), torch.int32), _t(64, f32),
      _t((64, 64), bf)), "W must be"),
])
def test_masked_rhs_rejects(args, match):
    with pytest.raises(ValueError, match=match):
        tmm.masked_rhs(*args)


# K1's split-S planner (pure Python; the card only supplies its inputs)
PLANS = [  # R, S, SMs, row tile, S tile, resident blocks a SM, column blocks
    (69888, 10688, 132, 128, 128, 2, 1),  # the flagship fit, bf16, side A
    (10688, 69888, 132, 128, 128, 2, 1),  # ... side B
    (69888, 10688, 132, 64, 64, 2, 1),    # f32, side A
    (10688, 69888, 132, 64, 64, 2, 1),    # f32, side B
    (64, 320, 132, 64, 64, 2, 4),         # one row block, K = 256
    (64, 64, 132, 128, 128, 1, 1),        # S under one tile
    (4096, 1 << 17, 114, 128, 64, 3, 2),  # another card
]


def _chunks(S, chunk):
    return [(c0, min(S, c0 + chunk)) for c0 in range(0, S, chunk)]


@pytest.mark.parametrize("plan", PLANS)
def test_split_chunk_covers_s_once_in_whole_tiles(plan):
    R, S, sms, row_tile, s_tile, per_sm, col_blocks = plan
    chunk = tmm.split_chunk(R, S, sms, row_tile=row_tile, s_tile=s_tile,
                            per_sm=per_sm, col_blocks=col_blocks)
    assert chunk > 0 and chunk % s_tile == 0
    spans = _chunks(S, chunk)
    assert all(b > a for a, b in spans)  # no empty chunk
    covered = np.zeros(S, np.int64)
    for a, b in spans:
        covered[a:b] += 1
    assert (covered == 1).all()


def test_split_chunk_keeps_one_chunk_where_rows_fill_the_card():
    # 528 row blocks are exactly 4 waves of 132 SMs: splitting gains nothing
    S = 84 * 128
    assert tmm.split_chunk(528 * 128, S, 132, row_tile=128, s_tile=128,
                           per_sm=1) >= S
    # and with far more row blocks than waves
    assert tmm.split_chunk(20000 * 64, 4096, 132, row_tile=64, s_tile=64,
                           per_sm=2) >= 4096


def test_split_chunk_splits_few_row_blocks_into_full_waves():
    # the flagship fit's B side in bf16: 84 row blocks for 132 SMs
    R, S = 10688, 69888
    chunk = tmm.split_chunk(R, S, 132, row_tile=128, s_tile=128, per_sm=1)
    chunks = len(_chunks(S, chunk))
    assert chunks * 84 >= tmm.WAVES * 132  # at least WAVES waves of blocks
    assert (chunks * 84) % 132 == 0  # ... and no part-filled last wave
    assert S % chunk  # the last chunk is ragged here
    # one 64-row block takes one chunk a tile
    assert tmm.split_chunk(64, 320, 132, row_tile=64, s_tile=64,
                           per_sm=2) == 64


def test_split_chunk_splits_a_part_filled_last_wave():
    # the A side: 546 row blocks are 4.14 waves of 132; two chunks make
    # 8.27 waves, which lose less to the last one
    assert tmm.split_chunk(69888, 10688, 132, row_tile=128, s_tile=128,
                           per_sm=1) == 42 * 128


def test_split_chunk_splits_k2_at_the_flagship_b_side():
    # K2's bf16 configuration: 128-row blocks, 64-wide S tiles, two an SM;
    # the B side's 84 row blocks split into chunks that fill the card
    R, S = 10688, 69888
    chunk = tmm.split_chunk(R, S, 132, row_tile=128, s_tile=64, per_sm=2)
    chunks = len(_chunks(S, chunk))
    assert chunk % 64 == 0 and chunks * 84 >= tmm.WAVES * 2 * 132
