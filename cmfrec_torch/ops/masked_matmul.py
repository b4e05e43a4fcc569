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
R and S must be multiples of TILE (the engine pads to it), K a multiple of
TILE up to MAX_K (the kernels' shared-memory tiles).
"""

from __future__ import annotations

import torch

from . import _cuda

TILE = 64
MAX_K = 256

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
    if K % TILE or not 0 < K <= MAX_K:
        raise ValueError(f"{name}: K={K} must be a multiple of {TILE} "
                         f"in [{TILE}, {MAX_K}]")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    return K, devices.pop()


def _stream_for(tensors, device):
    """The current CUDA stream, after the checks only a launch needs."""
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("kernel operands must be 16-byte aligned")
    return torch.cuda.current_stream(device).cuda_stream


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
    with torch.cuda.device(device):
        stream = _stream_for((Q, Be, W), device)
        out = torch.empty(R, K, dtype=torch.float32, device=device)
        err = _cuda.lib().cmf_masked_gram_matvec(
            Q.data_ptr(), Be.data_ptr(), W.data_ptr(), out.data_ptr(),
            R, S, K, int(Be.dtype == torch.float32), W_TYPES[W.dtype],
            stream)
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
    with torch.cuda.device(device):
        stream = _stream_for((X, W, mb, Be), device)
        out = torch.empty(R, K, dtype=torch.float32, device=device)
        err = _cuda.lib().cmf_masked_rhs(
            X.data_ptr(), W.data_ptr(), mb.data_ptr(), Be.data_ptr(),
            out.data_ptr(), R, S, K, int(Be.dtype == torch.float32),
            W_TYPES[W.dtype], stream)
    _cuda.check(err, "masked_rhs")
    masked_rhs.launches += 1
    return out


masked_rhs.launches = 0
