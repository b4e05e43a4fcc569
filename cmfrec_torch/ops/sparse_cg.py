"""Fused bucket CG of the bucketed engine (port of
cmfrec_tpu/ops/sparse_cg.py::bucket_cg and ::bucket_cg_packed).

For every padded row r of one bucket it runs warm-started truncated CG on

    (gfix + diag(lam_row_r) + sum_l cw[r,l] m_l m_l^T) a_r
        = r0_r + sum_l cv[r,l] m_l,        m_l = mat[idx[r, l]]

from a0_r for ``n_steps`` steps, with the two-tolerance stop of
rowsolve.cg_iterations (skip at 1e-12, freeze at 1e-8).  On a CUDA tensor
the op launches the hand-written kernel K3 (csrc/sparse_cg.cu), which
gathers the opposing rows itself and keeps each row's CG state on chip
across the rhs build and every step; on a CPU tensor it runs its plain
twin :func:`bucket_cg_ref`.  There is no fallback from one to the other.

Operands: mat [S, K] bf16 (CG bulk iterations on a card) or f32; idx
[R, L] int32 with values in [0, S) (not checked: the kernel would read out
of bounds); cw/cv [R, L] f32, zero on padding slots; gfix [K, K] f32
symmetric; lam_row and r0 optional [R, K] f32; a0 [R, K] f32; length
[R] int32, the real slots of each row (slots beyond it must carry
cw = cv = 0: the kernel skips them, which is exact).  K is a multiple of 8
up to 256.  With a bf16 ``mat`` the rounding points are those of
rowsolve._part_matvec: v, t = (m . v) * cw and cv are rounded to bf16,
products are exact and sums f32.
"""

from __future__ import annotations

import torch

from . import _cuda
from .rowsolve import _part_matvec, _round, _widen, cg_iterations, gather_rows

MAX_K = 256
_MAT_DTYPES = (torch.bfloat16, torch.float32)


def bucket_cg_ref(mat, idx, cw, cv, gfix, lam_row, r0, a0, *, n_steps):
    """Plain torch twin of :func:`bucket_cg` (it needs no ``length``: the
    padding slots carry zero coefficients)."""
    ms = gather_rows(mat, idx)
    msf = _widen(ms)

    def matvec(v):
        out = _part_matvec(msf, cw, v, ms.dtype) + v @ gfix
        return out if lam_row is None else out + v * lam_row

    rhs = torch.einsum("rlk,rl->rk", msf, _round(cv, ms.dtype))
    if r0 is not None:
        rhs = rhs + r0
    return cg_iterations(matvec, rhs, a0, n_steps)


def _validate(mat, idx, cw, cv, gfix, lam_row, r0, a0, length, n_steps):
    if mat.dtype not in _MAT_DTYPES or mat.dim() != 2:
        raise ValueError("bucket_cg: mat must be a 2-D bfloat16 or float32 "
                         f"tensor, got {mat.dtype}{tuple(mat.shape)}")
    K = mat.shape[1]
    if K % 8 or not 0 < K <= MAX_K:
        raise ValueError(f"bucket_cg: K={K} must be a multiple of 8 in "
                         f"[8, {MAX_K}]")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError("bucket_cg: idx must be a 2-D int32 tensor, got "
                         f"{idx.dtype}{tuple(idx.shape)}")
    R, L = idx.shape
    if R == 0 or L == 0:
        raise ValueError(f"bucket_cg: empty bucket {(R, L)}")
    want = {"cw": (cw, (R, L)), "cv": (cv, (R, L)), "gfix": (gfix, (K, K)),
            "lam_row": (lam_row, (R, K)), "r0": (r0, (R, K)),
            "a0": (a0, (R, K))}
    for name, (t, shape) in want.items():
        if t is None and name in ("lam_row", "r0"):
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"bucket_cg: {name} must be float32 of shape "
                             f"{shape}, got {t.dtype}{tuple(t.shape)}")
    if length.dtype != torch.int32 or tuple(length.shape) != (R,):
        raise ValueError("bucket_cg: length must be int32 of shape "
                         f"{(R,)}, got {length.dtype}{tuple(length.shape)}")
    if int(n_steps) != n_steps or n_steps < 0:
        raise ValueError(f"bucket_cg: n_steps must be an integer >= 0, "
                         f"got {n_steps!r}")
    tensors = [t for t in (mat, idx, cw, cv, gfix, lam_row, r0, a0, length)
               if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"bucket_cg: tensors on several devices {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bucket_cg: tensors must be contiguous")
    return R, L, K, devices.pop(), tensors


def bucket_cg(mat, idx, cw, cv, gfix, lam_row, r0, a0, *, n_steps, length):
    """Warm-started truncated CG over one bucket; returns [R, K] f32."""
    R, L, K, device, tensors = _validate(mat, idx, cw, cv, gfix, lam_row, r0,
                                         a0, length, n_steps)
    if device.type == "cpu":
        return bucket_cg_ref(mat, idx, cw, cv, gfix, lam_row, r0, a0,
                             n_steps=n_steps)
    if device.type != "cuda":
        raise ValueError(f"bucket_cg: no kernel for device {device}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("bucket_cg: kernel operands must be 16-byte aligned")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        out = torch.empty(R, K, dtype=torch.float32, device=device)
        err = _cuda.lib().cmf_bucket_cg(
            mat.data_ptr(), idx.data_ptr(), cw.data_ptr(), cv.data_ptr(),
            gfix.data_ptr(), ptr(lam_row), ptr(r0), a0.data_ptr(),
            length.data_ptr(), out.data_ptr(), R, L, K, int(n_steps),
            int(mat.dtype == torch.float32), stream)
    _cuda.check(err, "bucket_cg")
    bucket_cg.launches += 1
    return out


bucket_cg.launches = 0
