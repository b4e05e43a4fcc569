"""Batched coordinate descent of the nonneg and l1 solves (the op behind
rowsolve.solve_cd on a card).

For every row r it minimises 0.5 a^T G_r a - rhs_r^T a + l1_r^T |a| from
a = 0 (under ``nonneg`` subject to a >= 0) by cyclic sweeps, as
cmfrec_tpu/ops/rowsolve.py::solve_cd (:279), which is XLA code, not a
Pallas kernel.  On a CUDA tensor the op launches the hand-written kernel in
csrc/cd_solve.cu (up to STAGED_MAX_K the row's G staged in shared memory
once a solve and its coordinates in the registers of 1-32 lanes; past it a
warp a row streaming G, the row's six K-vectors in shared memory or, where
they do not fit the opt-in shared memory, in a scratch in device memory:
:func:`stream_plan`); on a CPU tensor it runs its plain twin
rowsolve.solve_cd.  There is no fallback from one to the other.

Operands: G [R, K, K] with unit strides within a row's matrix and row
stride K*K, or 0 (``G1.expand(R, K, K)``: one G shared by every row);
rhs [R, K] contiguous; l1 [K] or [R, K] contiguous; all float32 or all
float64, on one device.  Any K, on the CPU and on a card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .rowsolve import solve_cd as solve_cd_ref

_DTYPES = (torch.float32, torch.float64)
# the kernel stages a row's G in shared memory up to this K
STAGED_MAX_K = 128
# warps a block of the streamed path (csrc/cd_solve.cu: kStreamWarps)
STREAM_WARPS = 8


def stream_plan(K, esz, optin):
    """The streamed path's launch past STAGED_MAX_K, as csrc/cd_solve.cu
    works it out: up to STREAM_WARPS warps a block, as many as ``optin``
    bytes of shared memory hold the six K-vectors (of ``esz`` bytes) of;
    where they do not hold one warp's, STREAM_WARPS warps with the vectors
    in a scratch in device memory and no shared memory."""
    row = 6 * K * esz
    warps = STREAM_WARPS
    while warps > 1 and warps * row > optin:
        warps //= 2
    scratch = warps * row > optin
    if scratch:
        warps = STREAM_WARPS
    return dict(warps=warps, scratch=scratch, smem=0 if scratch else warps * row)


def _validate(G, rhs, l1, max_steps):
    if rhs.dtype not in _DTYPES or rhs.dim() != 2:
        raise ValueError("solve_cd: rhs must be a 2-D float32 or float64 "
                         f"tensor, got {rhs.dtype}{tuple(rhs.shape)}")
    R, K = rhs.shape
    if R == 0 or K == 0:
        raise ValueError(f"solve_cd: empty system {(R, K)}")
    if G.dtype != rhs.dtype or tuple(G.shape) != (R, K, K):
        raise ValueError(f"solve_cd: G must be {rhs.dtype} of shape "
                         f"{(R, K, K)}, got {G.dtype}{tuple(G.shape)}")
    if G.stride()[1:] != (K, 1) or G.stride(0) not in (K * K, 0):
        raise ValueError("solve_cd: G must be contiguous, or one [K, K] "
                         f"matrix expanded over the rows; strides "
                         f"{G.stride()}")
    if l1.dtype != rhs.dtype or tuple(l1.shape) not in ((K,), (R, K)):
        raise ValueError(f"solve_cd: l1 must be {rhs.dtype} of shape {(K,)} "
                         f"or {(R, K)}, got {l1.dtype}{tuple(l1.shape)}")
    if int(max_steps) != max_steps or max_steps < 0:
        raise ValueError("solve_cd: max_steps must be an integer >= 0, "
                         f"got {max_steps!r}")
    devices = {t.device for t in (G, rhs, l1)}
    if len(devices) != 1:
        raise ValueError(f"solve_cd: tensors on several devices {devices}")
    if not (rhs.is_contiguous() and l1.is_contiguous()):
        raise ValueError("solve_cd: rhs and l1 must be contiguous")
    return R, K, devices.pop()


def plan(K, shared_g, dtype, device_index=0):
    """The launch the kernel takes at width K on a card (``shared_g``: G of
    row stride 0) within the card's opt-in shared memory
    (``_cuda.optin_smem``), as the library keeps it once worked out: whether
    it stages G, lanes a row, warps and rows a block, resident blocks an SM,
    shared memory a block, and whether the streamed vectors live in a
    scratch in device memory."""
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device_index):
        err = _cuda.lib().cmf_cd_plan(K, int(shared_g),
                                      int(dtype == torch.float64),
                                      _cuda.optin_smem(device_index), out)
    _cuda.check(err, "solve_cd plan")
    keys = ("staged", "lanes", "warps", "rows_per_block", "blocks_per_sm",
            "smem", "scratch")
    return dict(zip(keys, (bool(out[0]), *out[1:6], bool(out[6]))))


def solve_cd(G, rhs, l1, *, nonneg: bool, max_steps: int, tol: float = 1e-9,
             return_sweeps: bool = False):
    """Coordinate descent over every row from a = 0; returns a [R, K] in
    rhs's dtype, with ``return_sweeps`` also the sweeps each row ran
    (int32 [R])."""
    R, K, device = _validate(G, rhs, l1, max_steps)
    if device.type == "cpu":
        return solve_cd_ref(G, rhs, l1, nonneg, int(max_steps), tol=tol,
                            return_sweeps=return_sweeps)
    if device.type != "cuda":
        raise ValueError(f"solve_cd: no kernel for device {device}")
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        pl = plan(K, G.stride(0) == 0, rhs.dtype, index)
        scratch, slots = None, 0
        if pl["scratch"]:  # rows in flight: the resident warps, at most R
            w = pl["warps"]
            slots = min(-(-R // w), pl["blocks_per_sm"] * _cuda.sm_count(index)) * w
            scratch = torch.empty(slots, 6, K, dtype=rhs.dtype, device=device)
        out = torch.empty(R, K, dtype=rhs.dtype, device=device)
        sweeps = (torch.empty(R, dtype=torch.int32, device=device)
                  if return_sweeps else None)
        err = _cuda.lib().cmf_cd_solve(
            G.data_ptr(), G.stride(0), rhs.data_ptr(), l1.data_ptr(),
            K if l1.dim() == 2 else 0, out.data_ptr(),
            None if sweeps is None else sweeps.data_ptr(),
            None if scratch is None else scratch.data_ptr(), slots, R, K,
            int(bool(nonneg)), int(max_steps), float(tol),
            int(rhs.dtype == torch.float64), _cuda.optin_smem(index), stream)
    _cuda.check(err, "solve_cd")
    solve_cd.launches += 1
    return (out, sweeps) if return_sweeps else out


solve_cd.launches = 0
