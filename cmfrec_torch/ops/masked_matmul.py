"""Fused masked-Gram ops of the dense-masked ALS engine
(port of cmfrec_tpu/ops/masked_matmul.py).

Every CG step of a dense-masked half-iteration is

    out = ((Q @ Be^T) * W) @ Be          # [R,K],[S,K],[R,S] -> [R,K] f32

and its right-hand side is ((X - mb[None, :]) * W) @ Be.  On a CUDA tensor
each op launches its hand-written Hopper kernel (csrc/masked_matmul.cu),
which keeps the [R, S] intermediate out of device memory; on a CPU tensor it
runs its plain torch twin.  There is no fallback from one to the other.

Operands: Q/Be bf16 (bulk iterations) or f32 (polish, exact mode); W an
int8 0/1 mask, bf16 or f32 weights; X the raw ratings in bf16; mb f32.  With
bf16 operands T*W is formed in f32 and rounded to bf16 once, as on the TPU;
a bf16 W meets T already rounded to bf16 (the TPU's bf16 multiply).  The
f32 K1 and K2 widen any W to f32.
R, S and K must be multiples of TILE (the engine pads to them).  Every
kernel takes any such K: K1's tiled kernels hold full-K tiles and own 64
output columns up to TILED_MAX_K, and past it K1 runs a wide configuration
(bf16 on wgmma, f32 on register-tiled FMA) whose blocks own as many output
columns as their registers hold (:func:`wide_col_chunk`: all of K = 320,
so the scores are computed once) and hold Q whole where it fits, else
stream the scores' K in chunks.  With bf16 operands the rounding of T*W
follows T summed in order in f32, as the twin sums it (the kernel sums T
again in order where the tensor cores' T lies near a rounding midpoint).
K2's blocks own 64 output columns up to TILED_MAX_K and with f32 operands
at any K; past it with bf16 operands they own as many as their registers
hold (:func:`rhs_col_chunk`: all of K = 320), so X and W are read once and
V = (X - mb) * W formed once an S tile (:func:`rhs_wide_variant`,
:func:`rhs_wide_smem` model the choice).

When a kernel's row blocks alone would not fill the card, K1 and K2 split
S into chunks over the grid (:func:`split_chunk` picks the chunk from R, S,
the card's SM count and the kernel's resident blocks a SM), each chunk
writes partial [R, K] sums to scratch, and a second kernel adds them in
chunk order: no atomics, so two calls on the same inputs give the same
bits.

K1 with f32 operands also has a form for sparse systems,
:func:`masked_gram_matvec_rows` (csrc/masked_rows.cu): the same product
walked over each row's observed entries, from the row lists of W that
:func:`row_lists` builds on the device once a fit.  The dense f32 K1 does
4 R S K operations whatever W holds; the lists cost a gather of one Be row
an entry.  :func:`takes_rows` is the rule that chooses between them: W's
density under ROWS_MAX_DENSITY, where the two kernels cost the same on the
card.
"""

from __future__ import annotations

import ctypes
import warnings
from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from . import _cuda

TILE = 64
# K1's tiled kernels take K up to this; past it, the wide configurations
TILED_MAX_K = 256
# K1's wide configurations, numbered as cmf_gram_geometry numbers them and in
# the order it tries them: (operand type, Q held whole, ring stages of K
# chunks (0: whole-K Be tiles, two stages), output tiles of TILE columns a
# block at most: the accumulators take 32 registers a tile in bf16, 16 in f32)
WIDE_CONFIGS = {5: (torch.bfloat16, True, 0, 5),
                6: (torch.bfloat16, False, 4, 4),
                7: (torch.float32, True, 0, 8),
                8: (torch.float32, False, 2, 8)}
# K2's wide configurations past TILED_MAX_K (bf16 operands only), numbered as
# cmf_rhs_geometry numbers them and in the order it tries them: ring stages
RHS_WIDE_CONFIGS = {3: 3, 4: 2}
# output tiles of TILE columns a block of them owns at most (32 accumulator
# registers a tile)
RHS_WIDE_TILES = 5
# split_chunk: the fewest waves of resident blocks it aims the grid at
WAVES = 4

# the row-list K1 (masked_gram_matvec_rows): entries a chunk (a warp's work;
# a longer row is split into chunks whose partial sums are added in order).
# At ML10M's shape (int8 mask; NVIDIA H100 80GB HBM3, 700 W) a call read
# 0.236 / 0.295 ms (A / B side) at 2048, 0.238 / 0.299 at 1024, 0.250 /
# 0.323 at 512, 0.254 / 0.347 at 256, 0.235 / 0.311 at 4096
ROW_CHUNK = 2048
# its density rule (takes_rows): W's observed entries / (R S) under this.
# At ML10M's A and B sides (K = 64, int8 mask; NVIDIA H100 80GB HBM3, 700
# W) the row lists read 21.5 and 24.3 ms x the density, the dense f32 K1
# 4.73 and 4.64 ms at any density: they cost the same at 22.1% and 19.1%
# (scripts/time_k1_rows_torch.py, 512 entries a chunk: ML10M's mask with
# cells added uniformly to 10, 15 and 20%; 256 a chunk: 21.4% and 18.7%)
ROWS_MAX_DENSITY = 0.18

_OPERAND_DTYPES = (torch.bfloat16, torch.float32)
# W's dtype -> the kernels' W-type code
W_TYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}


def row_chunks(R: int, S: int, max_elems: int = 1 << 26):
    """Row slices of an [R, S] array holding at most ~max_elems entries each
    (bounds the f32 intermediates of the plain versions)."""
    step = max(1, max_elems // max(S, 1))
    for r0 in range(0, R, step):
        yield slice(r0, min(R, r0 + step))


def masked_gram_matvec_ref(Q, Be, W):
    """Plain torch twin of :func:`masked_gram_matvec` (f32 products; with
    bf16 operands the same single bf16 rounding of T*W, and with a bf16 W
    T's rounding before the multiply)."""
    bf16 = Be.dtype == torch.bfloat16
    Bef = Be.float()
    out = torch.empty(Q.shape[0], Be.shape[1], dtype=torch.float32,
                      device=Q.device)
    for sl in row_chunks(Q.shape[0], Be.shape[0]):
        t = Q[sl].float() @ Bef.T
        if bf16 and W.dtype == torch.bfloat16:
            t = t.to(torch.bfloat16).float()
        t = t * W[sl].float()
        if bf16:
            t = t.to(torch.bfloat16).float()
        out[sl] = t @ Bef
    return out


def masked_rhs_ref(X, W, mb, Be):
    """Plain torch twin of :func:`masked_rhs`."""
    Bef = Be.float()
    mbf = mb.float()[None, :]
    out = torch.empty(X.shape[0], Be.shape[1], dtype=torch.float32,
                      device=X.device)
    for sl in row_chunks(X.shape[0], X.shape[1]):
        v = (X[sl].float() - mbf) * W[sl].float()
        if Be.dtype == torch.bfloat16:
            v = v.to(torch.bfloat16).float()
        out[sl] = v @ Bef
    return out


def _validate(name, R, S, Be, W, tensors):
    K = Be.shape[1]
    if Be.dtype not in _OPERAND_DTYPES:
        raise ValueError(f"{name}: operands must be bfloat16 or float32, "
                         f"got {Be.dtype}")
    if W.dtype not in W_TYPES:
        raise ValueError(f"{name}: W must be int8 (0/1 mask), bfloat16 or "
                         f"float32 weights, got {W.dtype}")
    if tuple(W.shape) != (R, S):
        raise ValueError(f"{name}: W has shape {tuple(W.shape)}, "
                         f"expected {(R, S)}")
    if R % TILE or S % TILE:
        raise ValueError(f"{name}: R={R} and S={S} must be multiples of "
                         f"{TILE} (pad the dense form)")
    if K % TILE or K <= 0:
        raise ValueError(f"{name}: K={K} must be a positive multiple of "
                         f"{TILE}")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return K, devices.pop()


def col_chunks(K, width):
    """The output column chunks a kernel's blocks own, (start, width) in
    order: `width` columns each, the last narrower, covering [0, K) once."""
    return tuple((c0, min(width, K - c0)) for c0 in range(0, K, width))


def _col_chunk(K, most):
    """The fewest chunks of at most `most` tiles covering K, as even as
    whole TILEs allow: the columns of one (csrc/masked_matmul.cu:
    wide_col_chunk)."""
    tiles = K // TILE
    chunks = -(-tiles // most)
    return -(-tiles // chunks) * TILE


def wide_col_chunk(K, variant):
    """The output columns a block of K1's wide configuration `variant` owns,
    as the card's geometry query reckons them (csrc/masked_matmul.cu:
    col_chunk_of): the fewest chunks of at most its tiles, as even as whole
    TILEs allow (K = 320: one chunk; K = 1024: 4 x 256 bf16, 2 x 512 f32)."""
    return _col_chunk(K, WIDE_CONFIGS[variant][3])


def rhs_col_chunk(K):
    """The output columns a block of K2's wide configurations owns past
    TILED_MAX_K (col_chunk_of): at most RHS_WIDE_TILES tiles (K = 320 and
    576's first chunk 320, K = 384 2 x 192, K = 1024 4 x 256)."""
    return _col_chunk(K, RHS_WIDE_TILES)


def rhs_wide_smem(variant, K, w_dtype):
    """The shared memory a block of K2's wide configuration `variant` takes
    at K, in bytes, as the card's geometry query reckons it
    (rhs_bf16_wide_smem): 1 KB to align the tiles to 1024 B, and its ring
    stages, each the 64-wide S tile's Be columns of the block's chunk (8 KB
    a 64-column tile, bf16), X's and W's [128, 64] tiles and a 1 KB slot of
    mb's 64 entries, with an 8-byte barrier."""
    wsz = torch.empty((), dtype=w_dtype).element_size()
    stage = rhs_col_chunk(K) // 64 * 8192 + 128 * 64 * (2 + wsz) + 1024
    return 1024 + RHS_WIDE_CONFIGS[variant] * (stage + 8)


def rhs_wide_variant(K, w_dtype, optin):
    """K2's configuration at K (> TILED_MAX_K) with bf16 operands on a card
    that lets a block opt in to `optin` bytes of shared memory, as the
    card's geometry query picks it: three stages where they fit, else two."""
    return next((v for v in RHS_WIDE_CONFIGS
                 if rhs_wide_smem(v, K, w_dtype) <= optin),
                list(RHS_WIDE_CONFIGS)[-1])


# the padding of a W tile row in the f32 wide kernel, in entries (WPad)
_W_PAD = {torch.int8: 16, torch.bfloat16: 8, torch.float32: 8}


def wide_smem(variant, K, w_dtype):
    """The shared memory a block of K1's wide configuration `variant` takes
    at K, in bytes, as the card's geometry query reckons it
    (gram_bf16_whole_smem, gram_bf16_wide_smem, gram_f32_wide_smem): Q held
    whole (bf16 128 rows, f32 64 rows of K + 4) and two stages of a whole-K
    Be tile (bf16 64 rows, f32 32); or a ring of K chunks (64 wide: bf16 a
    128-row Q and a 64-row Be chunk; f32 a 64-row Q and a 32-row Be chunk,
    rows padded to 68) and two buffers of the S tile's Be columns of the
    block's chunk; two W tiles; and f32's two transposed T buffers (the
    quarters' sums; P in the first)."""
    op_dtype, q_whole, stages, _ = WIDE_CONFIGS[variant]
    nc = wide_col_chunk(K, variant)
    wsz = torch.empty((), dtype=w_dtype).element_size()
    if op_dtype == torch.bfloat16:
        if q_whole:
            return 128 * K * 2 + 2 * (64 * K * 2 + 128 * 64 * wsz)
        return (stages * (128 * 64 * 2 + 64 * 64 * 2)
                + 2 * (64 * nc * 2 + 128 * 64 * wsz))
    rest = 2 * 64 * (32 + _W_PAD[w_dtype]) * wsz + 2 * 32 * 68 * 4
    if q_whole:
        return (64 + 2 * 32) * (K + 4) * 4 + rest
    return stages * (64 + 32) * 68 * 4 + 2 * 32 * nc * 4 + rest


def wide_variant(K, op_dtype, w_dtype, optin):
    """K1's wide configuration at K (> TILED_MAX_K) on a card that lets a
    block opt in to `optin` bytes of shared memory, as the card's geometry
    query picks it: the first of the operand type's that fits (each keeps
    one block an SM), else its last."""
    ours = [v for v, c in WIDE_CONFIGS.items() if c[0] == op_dtype]
    return next((v for v in ours if wide_smem(v, K, w_dtype) <= optin),
                ours[-1])


def _kernel_device(name, device, K):
    """Raise unless `device` is a card (CPU tensors take the twin before)."""
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device} (K={K}; "
                         "CUDA tensors launch the kernel, CPU tensors run "
                         "the twin)")


def _stream_for(tensors, device):
    """The current CUDA stream, after the checks only a launch needs."""
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("kernel operands must be 16-byte aligned")
    return torch.cuda.current_stream(device).cuda_stream


@lru_cache(maxsize=None)
def split_chunk(R, S, sms, *, row_tile, s_tile, per_sm, col_blocks=1):
    """K1's (and K2's) S chunk: a multiple of `s_tile` covering S in
    ceil(S / chunk) chunks over the grid.

    The grid has R / row_tile row blocks (times `col_blocks`) per chunk,
    and the card runs sms * per_sm blocks at a time, so a grid of n chunks
    of `per` S tiles takes about ceil(blocks / slots) waves of `per` tiles
    each.  Of lo to 2 * lo chunks (lo: the fewest that make WAVES waves of
    blocks, at least 1) this returns the one with the shortest such time,
    and of equal times the fewest chunks: one chunk where the row blocks
    already fill the card evenly, more where a part-filled last wave (or
    too few row blocks) would leave SMs idle."""
    tiles = -(-S // s_tile)
    row_blocks = -(-R // row_tile) * col_blocks
    slots = sms * per_sm
    lo = max(1, -(-WAVES * slots // row_blocks))
    best_cost, best_per = None, tiles
    for chunks in range(min(lo, tiles), min(2 * lo, tiles) + 1):
        per = -(-tiles // chunks)  # tiles a chunk
        blocks = row_blocks * -(-tiles // per)
        cost = -(-blocks // slots) * per  # waves x tiles a block
        if best_cost is None or cost < best_cost:
            best_cost, best_per = cost, per
    return best_per * s_tile


@lru_cache(maxsize=None)
def _geometry(op, device_index, K, op_f32, w_type):
    """(configuration, row tile, S tile, resident blocks a SM, SM count,
    output columns a block, shared memory a block) of K1's (op "gram") or
    K2's (op "rhs") kernel on the card, as its launcher picks it (once: this
    also sets the kernel's shared-memory limit on the device)."""
    geo = (ctypes.c_int * 6)()
    query = (_cuda.lib().cmf_gram_geometry if op == "gram"
             else _cuda.lib().cmf_rhs_geometry)
    with torch.cuda.device(device_index):
        err = query(K, op_f32, w_type, geo)
    _cuda.check(err, f"{op} geometry")
    props = torch.cuda.get_device_properties(device_index)
    return (geo[0], geo[1], geo[2], max(1, geo[3]),
            props.multi_processor_count, geo[4], geo[5])


def _plan(op, R, S, K, op_dtype, w_dtype, device):
    device = torch.device(device)
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    variant, row_tile, s_tile, per_sm, sms, width, smem = _geometry(
        op, index, K, int(op_dtype == torch.float32), W_TYPES[w_dtype])
    cols = col_chunks(K, width)
    chunk = split_chunk(R, S, sms, row_tile=row_tile, s_tile=s_tile,
                        per_sm=per_sm, col_blocks=len(cols))
    return dict(variant=variant, row_tile=row_tile, s_tile=s_tile,
                per_sm=per_sm, sms=sms, chunk=chunk, chunks=-(-S // chunk),
                col_chunk=width, cols=cols, smem=smem)


def gram_plan(R, S, K, op_dtype, w_dtype, device):
    """K1's launch plan on a card: its kernel configuration and tiles,
    resident blocks a SM, the SM count, the S chunk :func:`split_chunk`
    picks, the output column chunks its blocks own (64 wide up to
    TILED_MAX_K, else :func:`wide_col_chunk`) and the shared memory a
    block takes (past TILED_MAX_K :func:`wide_variant` and
    :func:`wide_smem` model the choice)."""
    return _plan("gram", R, S, K, op_dtype, w_dtype, device)


def rhs_plan(R, S, K, op_dtype, w_dtype, device):
    """K2's launch plan on a card, as :func:`gram_plan` gives K1's: its
    blocks own 64 output columns up to TILED_MAX_K and with f32 operands,
    past it with bf16 operands :func:`rhs_col_chunk` (the configuration and
    shared memory as :func:`rhs_wide_variant` and :func:`rhs_wide_smem`
    model them)."""
    return _plan("rhs", R, S, K, op_dtype, w_dtype, device)


def _launch_split(fn, plan, ptrs, R, S, K, w_dtype, device, stream):
    """One K1 or K2 call over plan["chunks"] chunks of S (partial sums in
    scratch, added in chunk order by the same C call) with the plan's
    column chunk; returns out and the call's CUDA error code."""
    out = torch.empty(R, K, dtype=torch.float32, device=device)
    part = (torch.empty(plan["chunks"], R, K, dtype=torch.float32,
                        device=device) if plan["chunks"] > 1 else out)
    return out, fn(*ptrs, out.data_ptr(), part.data_ptr(), R, S, K,
                   plan["chunk"], plan["col_chunk"], plan["variant"],
                   W_TYPES[w_dtype], stream)


def masked_gram_matvec(Q, Be, W):
    """((Q @ Be^T) * W) @ Be, fused.  Q:[R,K] Be:[S,K] W:[R,S] -> [R,K] f32."""
    R, S = Q.shape[0], Be.shape[0]
    if Q.dtype != Be.dtype or Q.shape[1] != Be.shape[1]:
        raise ValueError("masked_gram_matvec: Q and Be need one dtype and "
                         f"width, got {Q.dtype}{tuple(Q.shape)} and "
                         f"{Be.dtype}{tuple(Be.shape)}")
    K, device = _validate("masked_gram_matvec", R, S, Be, W, (Q, Be, W))
    if device.type == "cpu":
        return masked_gram_matvec_ref(Q, Be, W)
    _kernel_device("masked_gram_matvec", device, K)
    with torch.cuda.device(device):
        stream = _stream_for((Q, Be, W), device)
        plan = gram_plan(R, S, K, Be.dtype, W.dtype, device)
        out, err = _launch_split(
            _cuda.lib().cmf_masked_gram_matvec, plan,
            (Q.data_ptr(), Be.data_ptr(), W.data_ptr()), R, S, K, W.dtype,
            device, stream)
    _cuda.check(err, "masked_gram_matvec")
    masked_gram_matvec.launches += 1
    return out


masked_gram_matvec.launches = 0


def masked_rhs(X, W, mb, Be):
    """((X - mb[None, :]) * W) @ Be, fused.  X:[R,S] bf16, W:[R,S], mb:[S]
    f32, Be:[S,K] -> [R,K] f32."""
    R, S = X.shape
    if X.dtype != torch.bfloat16:
        raise ValueError(f"masked_rhs: X must be bfloat16, got {X.dtype}")
    if mb.dtype != torch.float32 or tuple(mb.shape) != (S,):
        raise ValueError(f"masked_rhs: mb must be float32 of shape {(S,)}, "
                         f"got {mb.dtype}{tuple(mb.shape)}")
    if Be.shape[0] != S:
        raise ValueError(f"masked_rhs: Be has {Be.shape[0]} rows, X has {S} "
                         "columns")
    K, device = _validate("masked_rhs", R, S, Be, W, (X, W, mb, Be))
    if device.type == "cpu":
        return masked_rhs_ref(X, W, mb, Be)
    _kernel_device("masked_rhs", device, K)
    out = rhs_launch(X, W, mb, Be, rhs_plan(R, S, K, Be.dtype, W.dtype,
                                            device))
    masked_rhs.launches += 1
    return out


def rhs_launch(X, W, mb, Be, plan, kernels=None):
    """One K2 call on validated CUDA operands with `plan` (a
    :func:`rhs_plan`), from the ops' library, or from `kernels`, a library
    of :func:`_cuda.probe_libs` (scripts/time_k2_wide_torch.py: the result
    is then not K2's), whose geometry query is asked first so that its
    kernels' shared-memory limit is set.  Counts no launch:
    :func:`masked_rhs` is the op."""
    (R, S), K, device = X.shape, Be.shape[1], X.device
    with torch.cuda.device(device):
        stream = _stream_for((X, W, mb, Be), device)
        if kernels is not None:
            geo = (ctypes.c_int * 6)()
            _cuda.check(kernels.cmf_rhs_geometry(
                K, int(Be.dtype == torch.float32), W_TYPES[W.dtype], geo),
                "rhs geometry")
        out, err = _launch_split(
            (_cuda.lib() if kernels is None else kernels).cmf_masked_rhs,
            plan, (X.data_ptr(), W.data_ptr(), mb.data_ptr(), Be.data_ptr()),
            R, S, K, W.dtype, device, stream)
    _cuda.check(err, "masked_rhs")
    return out


masked_rhs.launches = 0


class RowList(NamedTuple):
    """The row lists of a W [R, S] for :func:`masked_gram_matvec_rows`:
    row r's entries are ``ids[offsets[r]:offsets[r + 1]]`` (column ids in
    column order, int32) with ``weights`` at the same places (f32, or None
    for an int8 mask); ``ids`` has ``entries`` slots, the first
    ``offsets[R]`` used.  The chunk table splits each row into chunks of
    ROW_CHUNK entries: ``chunk_offsets`` [R + 1] a row's first chunk,
    ``chunk_rows`` [slots] a chunk's row (R past the last)."""

    offsets: torch.Tensor
    ids: torch.Tensor
    weights: Optional[torch.Tensor]
    chunk_offsets: torch.Tensor
    chunk_rows: torch.Tensor


def takes_rows(entries, R, S, K):
    """The density rule: whether K1 with f32 operands on a W [R, S] of
    ``entries`` observed entries takes the row lists
    (:func:`masked_gram_matvec_rows`) rather than the dense kernel.  Up to
    TILED_MAX_K only, as the row-list kernel; the lists' offsets are
    int32."""
    return (K <= TILED_MAX_K and entries < 2 ** 31 - 1
            and entries < ROWS_MAX_DENSITY * R * S)


def _chunk_slots(entries, R):
    """Chunk slots enough for any W of at most ``entries`` nonzero entries
    over R rows: a row of n entries takes ceil(n / ROW_CHUNK) chunks, fewer
    than n / ROW_CHUNK + 1."""
    return entries // ROW_CHUNK + R + 1


def _row_lists_ref(W, entries):
    """Plain torch twin of :func:`row_lists`."""
    R = W.shape[0]
    dev = W.device
    counts = torch.empty(R, dtype=torch.int64, device=dev)
    ids, wts = [], []
    for sl in row_chunks(*W.shape):
        nz = W[sl] != 0
        counts[sl] = nz.sum(dim=1)
        ids.append(nz.nonzero()[:, 1])
        if W.dtype == torch.float32:
            wts.append(W[sl][nz])
    n = int(counts.sum())
    if n > entries:
        raise ValueError(f"row_lists: W has {n} nonzero entries, more than "
                         f"entries={entries}")
    offsets = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    ids_all = torch.zeros(entries, dtype=torch.int32, device=dev)
    ids_all[:n] = torch.cat(ids).to(torch.int32)
    weights = None
    if W.dtype == torch.float32:
        weights = torch.zeros(entries, dtype=torch.float32, device=dev)
        weights[:n] = torch.cat(wts)
    nch = -(-counts // ROW_CHUNK)
    chunk_offsets = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    chunk_offsets[1:] = torch.cumsum(nch, 0)
    chunk_rows = torch.full((_chunk_slots(entries, R),), R, dtype=torch.int32,
                            device=dev)
    used = int(chunk_offsets[-1])
    chunk_rows[:used] = torch.repeat_interleave(
        torch.arange(R, dtype=torch.int32, device=dev), nch)
    return RowList(offsets.to(torch.int32), ids_all, weights,
                   chunk_offsets.to(torch.int32), chunk_rows)


def row_lists(W, entries):
    """The row lists of W's nonzero entries (:class:`RowList`), W [R, S] an
    int8 0/1 mask or f32 weights.  ``entries`` bounds W's nonzero entries
    (the fit's entry count, which the host knows): the lists are sized from
    it, so that building them on a card waits for nothing there.  A
    duplicated (row, column) pair is one entry of the dense form, so it is
    one entry here.  On a card a count pass, a scan and a fill
    (csrc/masked_rows.cu); on the CPU the twin."""
    if W.dtype not in (torch.int8, torch.float32) or W.dim() != 2:
        raise ValueError("row_lists: W must be a 2-d int8 mask or float32 "
                         f"weights, got {W.dtype}{tuple(W.shape)}")
    R, S = W.shape
    if S % TILE or not W.is_contiguous():
        raise ValueError(f"row_lists: W must be contiguous with S={S} a "
                         f"multiple of {TILE}")
    if not 0 <= entries < 2 ** 31 - 1:
        raise ValueError(f"row_lists: entries={entries} out of int32 range")
    entries = max(int(entries), 1)
    if W.device.type == "cpu":
        return _row_lists_ref(W, entries)
    dev = W.device
    i32 = dict(dtype=torch.int32, device=dev)
    slots = _chunk_slots(entries, R)
    lists = RowList(
        torch.empty(R + 1, **i32), torch.empty(entries, **i32),
        (torch.empty(entries, dtype=torch.float32, device=dev)
         if W.dtype == torch.float32 else None),
        torch.empty(R + 1, **i32), torch.full((slots,), R, **i32))
    with torch.cuda.device(dev):
        stream = _stream_for((W,), dev)
        err = _cuda.lib().cmf_rowlist_build(
            W.data_ptr(), R, S, W_TYPES[W.dtype], ROW_CHUNK,
            lists.offsets.data_ptr(), lists.chunk_offsets.data_ptr(),
            lists.ids.data_ptr(),
            0 if lists.weights is None else lists.weights.data_ptr(),
            lists.chunk_rows.data_ptr(), slots, entries, stream)
    _cuda.check(err, "row_lists")
    return lists


def masked_gram_matvec_rows_ref(Q, Be, rows):
    """Plain torch twin of :func:`masked_gram_matvec_rows`: each entry's dot
    Q[r] . Be[s] (sampled on the lists' pattern), times its weight, and the
    Be rows summed by row with those coefficients, in entry order (a
    weighted embedding bag a row).  Two calls a product, whatever the
    entries: no [entries, K] temporaries, few parallel regions."""
    R, K = Q.shape
    off = rows.offsets.long()
    n = int(off[-1])
    if n == 0:
        return torch.zeros(R, K, dtype=torch.float32, device=Q.device)
    ids = rows.ids[:n].long()
    with warnings.catch_warnings():  # sparse CSR's "beta state" notice
        warnings.simplefilter("ignore", UserWarning)
        pattern = torch.sparse_csr_tensor(
            off, ids, torch.ones(n, dtype=torch.float32, device=Q.device),
            size=(R, Be.shape[0]), check_invariants=False)
    d = torch.sparse.sampled_addmm(pattern, Q, Be.T, beta=0.0).values()
    if rows.weights is not None:
        d = d * rows.weights[:n]
    return torch.nn.functional.embedding_bag(ids, Be, off[:-1], mode="sum",
                                             per_sample_weights=d)


def masked_gram_matvec_rows(Q, Be, rows):
    """K1 with f32 operands from W's row lists: out[r] = sum over row r's
    entries s of w_rs (Q[r] . Be[s]) Be[s], which is
    :func:`masked_gram_matvec` (Q, Be, W) for the W that ``rows`` (a
    :class:`RowList` of :func:`row_lists`) was built from.  Q:[R,K]
    Be:[S,K] float32 -> [R,K] float32.  On a card K <= TILED_MAX_K
    (:func:`takes_rows` keeps wider systems on the dense kernel)."""
    R = Q.shape[0]
    if Q.dtype != torch.float32 or Be.dtype != torch.float32:
        raise ValueError("masked_gram_matvec_rows: Q and Be must be float32, "
                         f"got {Q.dtype} and {Be.dtype}")
    K = Q.shape[1]
    if Be.dim() != 2 or Be.shape[1] != K or K % TILE or K <= 0:
        raise ValueError("masked_gram_matvec_rows: Q and Be need one width, "
                         f"a positive multiple of {TILE}, got "
                         f"{tuple(Q.shape)} and {tuple(Be.shape)}")
    if tuple(rows.offsets.shape) != (R + 1,):
        raise ValueError("masked_gram_matvec_rows: the lists hold "
                         f"{rows.offsets.shape[0] - 1} rows, Q has {R}")
    tensors = (Q, Be, *(t for t in rows if t is not None))
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("masked_gram_matvec_rows: tensors on several "
                         f"devices {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("masked_gram_matvec_rows: tensors must be "
                         "contiguous")
    device = devices.pop()
    if device.type == "cpu":
        return masked_gram_matvec_rows_ref(Q, Be, rows)
    _kernel_device("masked_gram_matvec_rows", device, K)
    if K > TILED_MAX_K:
        raise ValueError(f"masked_gram_matvec_rows: K={K} past "
                         f"{TILED_MAX_K} takes the dense kernel")
    slots = rows.chunk_rows.shape[0]
    with torch.cuda.device(device):
        stream = _stream_for((Q, Be), device)
        out = torch.empty(R, K, dtype=torch.float32, device=device)
        part = torch.empty(slots, K, dtype=torch.float32, device=device)
        err = _cuda.lib().cmf_gram_rows(
            Q.data_ptr(), Be.data_ptr(), rows.offsets.data_ptr(),
            rows.ids.data_ptr(),
            0 if rows.weights is None else rows.weights.data_ptr(),
            rows.chunk_offsets.data_ptr(), rows.chunk_rows.data_ptr(),
            out.data_ptr(), part.data_ptr(), R, K, slots, ROW_CHUNK,
            rows.ids.shape[0], stream)
    _cuda.check(err, "masked_gram_matvec_rows")
    masked_gram_matvec_rows.launches += 1
    return out


masked_gram_matvec_rows.launches = 0
