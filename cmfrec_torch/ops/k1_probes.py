"""Probes of K1's time on the card (port of the TPU probes of the Pallas K1
body: scripts/sweep_kernel_probe2.py, sweep_kernel_variants.py and
sweep_kernel_probe3.py).

Each gram probe is the first design of K1's bf16 kernel
(csrc/masked_gram.cuh), whole or with one piece changed, launched from
csrc/k1_probes.cu:

    full   that design of K1 whole (p_full, v0; vw16 with a bf16 W): the
           yardstick of the production K1 (masked_matmul.masked_gram_matvec)
    dots   both products, no W tile loaded, T rounded to bf16   (p_dots)
    dot1   the first product only, T's row sums broadcast over K (p_dot1)
    wsum   the W tiles only, as K1 copies them, row sums over K (p_wsum)
    sel    the mask as a select, W != 0 ? T : 0                 (vsel)
    bft    T rounded to bf16 before the multiply by W           (vbf; with
           warps=8, 128-row blocks: vbig)
    part   K1 with S split into chunks over the grid, partial sums to
           [R, S/chunk, K], summed by torch.sum                 (p_part)

and w_stream is the W stream alone at a chosen (rows, columns) tile
(make_wsum).  Q and Be are bf16, W an int8 0/1 mask or bf16 weights, with
K1's shape rules.  On a CUDA tensor each wrapper launches its kernel and
counts the launch; on a CPU tensor it runs its plain version.  There is
no fallback between the two.

Hopper has no bf16-accumulating mma for bf16 operands, so where the TPU's
vbf asked its first product for a bf16 result, bft rounds T to bf16 after
the f32 product: a change of rounding order, not of accumulator type.
"""

from __future__ import annotations

from collections import namedtuple
from functools import partial

import torch

from . import _cuda
from . import masked_matmul as mm

BODIES = {"full": 0, "dots": 1, "dot1": 2, "wsum": 3, "sel": 4, "bft": 5,
          "part": 6}
WARPS = (4, 8)  # 8 warps: bft only
PART_CHUNK = 4096
# the probes measure K1's first design, whose tiles take K up to this
PROBE_MAX_K = 256
# the (rows, columns) tiles cmf_w_stream is built for; (64, 64) is K1's
W_STREAM_TILES = ((64, 64), (128, 64), (512, 64), (64, 256), (256, 256),
                  (16, 2048))
_PROBE_W = (torch.int8, torch.bfloat16)


def _rows(R, K, S, device, fill):
    """out[R, K] f32 filled by row slices (bounds the [R, S] intermediates)."""
    out = torch.empty(R, K, dtype=torch.float32, device=device)
    for sl in mm.row_chunks(R, S):
        out[sl] = fill(sl)
    return out


def _rb(x):
    return x.to(torch.bfloat16).float()


def dots_ref(Q, Be, W):
    """Plain version of :func:`dots`: round(Q Be^T) Be."""
    Bef = Be.float()
    return _rows(Q.shape[0], Be.shape[1], Be.shape[0], Q.device,
                 lambda sl: _rb(Q[sl].float() @ Bef.T) @ Bef)


def dot1_ref(Q, Be, W):
    """Plain version of :func:`dot1`: the row sums of Q Be^T, over K."""
    Bef = Be.float()
    K = Be.shape[1]
    return _rows(Q.shape[0], K, Be.shape[0], Q.device,
                 lambda sl: (Q[sl].float() @ Bef.T).sum(1, keepdim=True)
                 .expand(-1, K))


def w_stream_ref(W, K):
    """Plain version of :func:`w_stream`: W's row sums, over K."""
    return W.float().sum(1, keepdim=True).expand(-1, K).contiguous()


def wsum_ref(Q, Be, W):
    """Plain version of :func:`wsum`."""
    return w_stream_ref(W, Be.shape[1])


def sel_ref(Q, Be, W):
    """Plain version of :func:`sel`: (W != 0 ? round(Q Be^T) : 0) Be."""
    Bef = Be.float()
    return _rows(Q.shape[0], Be.shape[1], Be.shape[0], Q.device,
                 lambda sl: torch.where(W[sl] != 0, _rb(Q[sl].float() @ Bef.T),
                                        0.0) @ Bef)


def bft_ref(Q, Be, W):
    """Plain version of :func:`bft`: round(round(Q Be^T) * W) Be."""
    Bef = Be.float()
    return _rows(Q.shape[0], Be.shape[1], Be.shape[0], Q.device,
                 lambda sl: _rb(_rb(Q[sl].float() @ Bef.T) * _rb(W[sl].float()))
                 @ Bef)


def part_ref(Q, Be, W, chunk=PART_CHUNK):
    """Plain version of :func:`part`: K1's twin over each S chunk, the
    partial sums stacked to [R, S/chunk, K] and summed."""
    parts = [mm.masked_gram_matvec_ref(Q, Be[c0:c0 + chunk],
                                       W[:, c0:c0 + chunk])
             for c0 in range(0, Be.shape[0], chunk)]
    return torch.stack(parts, dim=1).sum(dim=1)


def _check(name, Q, Be, W, warps=4, chunk=None):
    """K1's checks with the probes' own: bf16 Q/Be, W int8 or bf16."""
    R, S = Q.shape[0], Be.shape[0]
    if Q.dtype != torch.bfloat16 or Be.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the probes take bfloat16 Q and Be, got "
                         f"{Q.dtype} and {Be.dtype}")
    if Q.shape[1] != Be.shape[1]:
        raise ValueError(f"{name}: Q and Be need one width, got "
                         f"{tuple(Q.shape)} and {tuple(Be.shape)}")
    if W.dtype not in _PROBE_W:
        raise ValueError(f"{name}: W must be int8 (0/1 mask) or bfloat16 "
                         f"weights, got {W.dtype}")
    if warps not in WARPS or (warps == 8 and name != "bft"):
        raise ValueError(f"{name}: warps={warps}; 4, or 8 for bft")
    if chunk is not None and (chunk <= 0 or chunk % mm.TILE):
        raise ValueError(f"{name}: chunk={chunk} must be a positive "
                         f"multiple of {mm.TILE}")
    return mm._validate(name, R, S, Be, W, (Q, Be, W))


def _launch(name, Q, Be, W, K, device, warps=4, chunk=PART_CHUNK):
    R, S = Q.shape[0], Be.shape[0]
    parts = -(-S // chunk) if name == "part" else 1
    if K > PROBE_MAX_K:
        raise ValueError(f"{name}: K={K} exceeds the probes' {PROBE_MAX_K} "
                         "(K1's first design; the plain version on the CPU "
                         "takes any K)")
    with torch.cuda.device(device):
        stream = mm._stream_for((Q, Be, W), device)
        out = torch.empty(R, parts, K, dtype=torch.float32, device=device)
        err = _cuda.lib().cmf_k1_probe(
            Q.data_ptr(), Be.data_ptr(), W.data_ptr(), out.data_ptr(), R, S,
            K, mm.W_TYPES[W.dtype], BODIES[name], warps, chunk, stream)
    _cuda.check(err, f"k1 probe {name}")
    return out


def _gram_probe(name, ref):
    def probe(Q, Be, W):
        K, device = _check(name, Q, Be, W)
        if device.type == "cpu":
            return ref(Q, Be, W)
        out = _launch(name, Q, Be, W, K, device)[:, 0]
        probe.launches += 1
        return out

    probe.__name__ = name
    probe.__doc__ = f"The {name} probe of K1 (plain version: {ref.__name__})."
    probe.launches = 0
    return probe


full = _gram_probe("full", mm.masked_gram_matvec_ref)
dots = _gram_probe("dots", dots_ref)
dot1 = _gram_probe("dot1", dot1_ref)
wsum = _gram_probe("wsum", wsum_ref)
sel = _gram_probe("sel", sel_ref)


def bft(Q, Be, W, warps=4):
    """The bft probe (vbf), in 64-row blocks of 4 warps as K1 or, with
    warps=8, in 128-row blocks (vbig; R need not be a multiple of 128)."""
    K, device = _check("bft", Q, Be, W, warps=warps)
    if device.type == "cpu":
        return bft_ref(Q, Be, W)
    out = _launch("bft", Q, Be, W, K, device, warps=warps)[:, 0]
    bft.launches += 1
    return out


bft.launches = 0


def part(Q, Be, W, chunk=PART_CHUNK):
    """The p_part probe: K1 with S split into `chunk`-wide pieces over the
    grid; the [R, ceil(S / chunk), K] partial sums are summed by torch.sum."""
    K, device = _check("part", Q, Be, W, chunk=chunk)
    if device.type == "cpu":
        return part_ref(Q, Be, W, chunk)
    out = _launch("part", Q, Be, W, K, device, chunk=chunk).sum(dim=1)
    part.launches += 1
    return out


part.launches = 0


def w_stream(W, K, tile=(64, 64)):
    """W's row sums broadcast over [R, K], W streamed in `tile` =
    (rows, columns) tiles (one of W_STREAM_TILES)."""
    if W.dtype not in _PROBE_W:
        raise ValueError(f"w_stream: W must be int8 (0/1 mask) or bfloat16 "
                         f"weights, got {W.dtype}")
    if tuple(tile) not in W_STREAM_TILES:
        raise ValueError(f"w_stream: tile {tuple(tile)} is not built; "
                         f"one of {W_STREAM_TILES}")
    if W.dim() != 2 or W.shape[0] % mm.TILE or W.shape[1] % mm.TILE:
        raise ValueError(f"w_stream: W of shape {tuple(W.shape)} must be 2-D "
                         f"with both sides multiples of {mm.TILE}")
    if not (isinstance(K, int) and K > 0):
        raise ValueError(f"w_stream: K={K} must be a positive int")
    if not W.is_contiguous():
        raise ValueError("w_stream: W must be contiguous")
    if W.device.type == "cpu":
        return w_stream_ref(W, K)
    R, S = W.shape
    with torch.cuda.device(W.device):
        stream = mm._stream_for((W,), W.device)
        out = torch.empty(R, K, dtype=torch.float32, device=W.device)
        err = _cuda.lib().cmf_w_stream(W.data_ptr(), out.data_ptr(), R, S, K,
                                       mm.W_TYPES[W.dtype], tile[0], tile[1],
                                       stream)
    _cuda.check(err, "w_stream")
    w_stream.launches += 1
    return out


w_stream.launches = 0

WRAPPERS = (full, dots, dot1, wsum, sel, bft, part, w_stream)

# One probe under its TPU script's name: the row of the kernel table it
# belongs to, the kernel and its plain version (both called as f(Q, Be, W)),
# W's dtype, and the work model: "k1" (K1's inputs and operations), "dots"
# (no W), "dot1" (no W, one product and a row sum) or "w" (W alone, a sum).
Probe = namedtuple("Probe", "row name kernel plain w_dtype work")


def _stream(tile):
    return (lambda Q, Be, W: w_stream(W, Q.shape[1], tile),
            lambda Q, Be, W: w_stream_ref(W, Q.shape[1]))


i8, bf = torch.int8, torch.bfloat16
K1 = (full, mm.masked_gram_matvec_ref)
PROBES = (
    Probe("p1", "p_full", *K1, i8, "k1"),
    Probe("p1", "p_dots", dots, dots_ref, i8, "dots"),
    Probe("p1", "p_dot1", dot1, dot1_ref, i8, "dot1"),
    Probe("p1", "p_wsum", wsum, wsum_ref, i8, "w"),
    Probe("p1", "p_part", part, part_ref, i8, "k1"),
    Probe("p2", "v0_int8", *K1, i8, "k1"),
    Probe("p2", "vbf_int8", bft, bft_ref, i8, "k1"),
    Probe("p2", "vsel_int8", sel, sel_ref, i8, "k1"),
    Probe("p2", "vw16_bf16", *K1, bf, "k1"),
    Probe("p2", "vbf_bf16", bft, bft_ref, bf, "k1"),
    Probe("p2", "vbig_int8", partial(bft, warps=8), bft_ref, i8, "k1"),
    Probe("p2", "vbig_bf16", partial(bft, warps=8), bft_ref, bf, "k1"),
    *(Probe("p3", f"wsum_{r}x{c}", *_stream((r, c)), i8, "w")
      for r, c in W_STREAM_TILES),
    Probe("p3", "wsum_bf16", *_stream((64, 64)), bf, "w"),
)


def work(probe, R, S, K, w_size):
    """(bytes, {operand type: operations}) a probe needs at least: each
    input read once, each output written once."""
    out = R * K * 4
    if probe.work == "w":
        return R * S * w_size + out, {"f32": R * S}
    qb = (R + S) * K * 2
    if probe.work == "dots":
        return qb + out, {"bf16": 4 * R * S * K}
    if probe.work == "dot1":
        return qb + out, {"bf16": 2 * R * S * K, "f32": R * S}
    return qb + R * S * w_size + out, {"bf16": 4 * R * S * K}
