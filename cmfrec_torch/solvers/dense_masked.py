"""Dense-masked explicit ALS on the fused masked-Gram kernels.

Port of the explicit half of cmfrec_tpu/solvers/dense_pallas.py
(fit_explicit_dense_pallas and its helpers).  The ratings X (bf16, raw) and
the observation mask or weights W are held as padded dense [m, n] arrays in
both orientations; every half-step solves the per-row ridge systems of
upstream cmfrec src/common.c:2742 optimizeA for all rows at once by
truncated CG whose operator and right-hand side are the kernels of
ops/masked_matmul.py.

Numerics: X stays uncentered in bf16 (half-point rating grids are exact),
with the global mean and opposing bias folded into the f32 ``mb`` vector of
the rhs kernel.  Factors are f32 and rounded to bf16 only at the kernels'
inputs.  The final ``finalize_chol`` iteration runs more CG steps with f32
operands, landing on the f32 fixed point as the reference's final Cholesky
does (upstream cmfrec src/collective.c:8336-8340).  Exact mode (use_cg=False)
runs every half-step's CG in f32 to the per-row freeze.

The port runs eagerly: one Python loop step per iteration, no dispatch
batching.  Dropped TPU workarounds: chunked uploads, the x64 trace guards,
pad_dim's TPU block sizes (the kernels' own 64-wide tile is used) and the
int32 flat index.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import should_handle_interrupt
from ..ops.masked_matmul import TILE, masked_gram_matvec, masked_rhs, row_chunks


def _round_up(x, mult):
    return -(-x // mult) * mult


def padded_dims(m: int, n: int, k: int) -> tuple[int, int, int]:
    """(m_pad, n_pad, Kp): the dense form's padded sizes."""
    return (max(_round_up(m, TILE), TILE), max(_round_up(n, TILE), TILE),
            max(_round_up(k + 1, TILE), TILE))


def _setup(rows, cols, vals, wvals, m_pad, n_pad):
    """Scatter COO -> padded dense [m_pad, n_pad] bf16 X and int8 mask (or
    f32 weights) W, both orientations, plus f32 row/column counts.  Duplicate
    (row, col) pairs keep one entry, as on the TPU engine."""
    flat = rows * n_pad + cols  # int64: no 2**31 limit on m_pad * n_pad
    dev = rows.device
    X = torch.zeros(m_pad * n_pad, dtype=torch.bfloat16, device=dev)
    X[flat] = vals.to(torch.bfloat16)
    X = X.view(m_pad, n_pad)
    if wvals is not None:
        W = torch.zeros(m_pad * n_pad, dtype=torch.float32, device=dev)
        W[flat] = wvals
    else:
        W = torch.zeros(m_pad * n_pad, dtype=torch.int8, device=dev)
        W[flat] = 1
    W = W.view(m_pad, n_pad)
    cnt_A = W.sum(dim=1, dtype=torch.float32)
    cnt_B = W.sum(dim=0, dtype=torch.float32)
    return X, W, X.t().contiguous(), W.t().contiguous(), cnt_A, cnt_B


def _cg(P, rhs, matvec, n_steps, dyn_stop=False):
    """Truncated CG with per-row early freeze (masked step size).

    Two-tolerance stopping matching the reference
    (upstream cmfrec src/common.c:1147,1181): rows whose initial residual is
    <= 1e-12 are skipped; a live row stops once its post-step residual falls
    <= 1e-8.  Frozen rows are exact no-ops (alpha = 0).

    dyn_stop=True (exact mode) adds the relative freeze floor
    max(1e-8, (1e-6*|rhs_r|)^2) -- the absolute target is unreachable in f32
    for rows with a large rhs -- and leaves the loop once every row is
    frozen, which gives the fixed-step result without its wasted matvecs.
    That exit reads ``live.any()`` on the host: one device sync per step."""
    r = rhs - matvec(P)
    rs = torch.sum(r * r, dim=-1)
    live = rs > 1e-12
    if dyn_stop:
        tol = torch.clamp(1e-12 * torch.sum(rhs * rhs, dim=-1), min=1e-8)
    else:
        tol = 1e-8
    a, p = P, r
    for _ in range(n_steps):
        if dyn_stop and not bool(live.any()):
            break
        Ap = matvec(p)
        denom = torch.sum(p * Ap, dim=-1)
        alpha = torch.where(live, rs / torch.where(denom == 0, 1.0, denom), 0.0)
        a = a + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        rs_new = torch.sum(r * r, dim=-1)
        live = live & (rs_new > tol)
        beta = torch.where(live, rs_new / torch.where(rs == 0, 1.0, rs), 0.0)
        p = torch.where(live[:, None], r + beta[:, None] * p, p)
        rs = torch.where(live, rs_new, rs)
    return a


def _half_step(P, X, W, Be, mb, lam_row, live, *, n_steps, compute_dtype,
               dyn_stop=False):
    """One side's update: solve (Be^T diag(W_r) Be + lam_r) a_r = rhs_r for
    all rows r at once by fused-kernel CG."""
    Bek = Be.to(compute_dtype)
    rhs = masked_rhs(X, W, mb, Bek)

    def matvec(v):
        return masked_gram_matvec(v.to(compute_dtype), Bek, W) + v * lam_row

    a = _cg(P, rhs, matvec, n_steps, dyn_stop=dyn_stop)
    return torch.where(live[:, None], a, 0.0)


def _half_step_na0(X, Be, mb, live_opp, lam_diag):
    """NA-as-zero (unweighted) half-step: every column participates with
    value 0 at missing entries, so the Gram is shared across rows and the
    update is one closed-form solve (the reference's optimizeA case 3,
    upstream cmfrec src/common.c:3118):
        (Be_live^T Be_live + diag(lam)) a_r = (X @ Be)_r - mb @ Be_live
    """
    Bl = torch.where(live_opp[:, None], Be, 0.0)
    G = Bl.T @ Bl + torch.diag(lam_diag)
    rhs = torch.empty(X.shape[0], Bl.shape[1], dtype=torch.float32,
                      device=X.device)
    for sl in row_chunks(*X.shape):
        rhs[sl] = X[sl].float() @ Bl
    rhs -= (mb @ Bl)[None, :]
    L = torch.linalg.cholesky(G)
    y = torch.linalg.solve_triangular(L, rhs.T, upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True).T


def _iteration(A, B, X, W, XT, WT, lam_row_A, lam_row_B, live_A, live_B, mu,
               *, k, user_bias, item_bias, n_steps, compute, na0=False,
               dyn_stop=False):
    """One full ALS iteration: B half-step then A half-step (the reference's
    in-iteration order, upstream cmfrec src/collective.c:8614 "Updating B"
    before :8802 "Updating A")."""
    cdt = torch.bfloat16 if compute == "bf16" else torch.float32
    # bias-column trick (upstream cmfrec src/common.c:561-565): the opposing
    # side's bias coordinate is a column of ones (or zeros without a bias),
    # and its bias values fold into the rhs offset mb
    Ae = A.clone()
    Ae[:, k] = 1.0 if item_bias else 0.0
    mbB = torch.full((A.shape[0],), mu, dtype=torch.float32, device=A.device)
    if user_bias:
        mbB = mbB + A[:, k]
    if na0:
        # lam_row_* is the shared [Kp] diagonal in this mode
        B = torch.where(live_B[:, None],
                        _half_step_na0(XT, Ae, mbB, live_A, lam_row_B), 0.0)
    else:
        B = _half_step(B, XT, WT, Ae, mbB, lam_row_B, live_B,
                       n_steps=n_steps, compute_dtype=cdt, dyn_stop=dyn_stop)
    Be = B.clone()
    Be[:, k] = 1.0 if user_bias else 0.0
    mbA = torch.full((B.shape[0],), mu, dtype=torch.float32, device=B.device)
    if item_bias:
        mbA = mbA + B[:, k]
    if na0:
        A = torch.where(live_A[:, None],
                        _half_step_na0(X, Be, mbA, live_B, lam_row_A), 0.0)
    else:
        A = _half_step(A, X, W, Be, mbA, lam_row_A, live_A,
                       n_steps=n_steps, compute_dtype=cdt, dyn_stop=dyn_stop)
    return A, B


def _init_factors(gen, live, bias0, shape, coord, seed_bias):
    """Random factors scaled by 1/sqrt(k), zero on padding coordinates and
    dead rows, with the bias coordinate seeded from bias0 (or zero)."""
    scale = float(1.0 / np.sqrt(max(coord, 1)))
    M = scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=live.device)
    coord_pad = torch.arange(shape[1], device=live.device) > coord
    M = torch.where(coord_pad[None, :] | ~live[:, None], 0.0, M)
    M[:, coord] = bias0 if seed_bias else 0.0
    return M


def _device_bias_init(X, W, cnt_A, cnt_B, mu, lam_user, lam_item, scale_lam,
                      user_bias, item_bias):
    """Iterated alternating closed-form bias init from the dense forms (the
    reference's initialize_biases_twosided, upstream cmfrec src/common.c:4410):
    5 alternating full re-solves when both biases are on (items first), one
    pass otherwise.  Row chunks bound the f32 temporaries."""
    m_pad, n_pad = X.shape
    chunks = list(row_chunks(m_pad, n_pad))

    def wf(sl):
        return W[sl].float()

    sB0 = torch.zeros(n_pad, dtype=torch.float32, device=X.device)
    sA0 = torch.empty(m_pad, dtype=torch.float32, device=X.device)
    for sl in chunks:
        xw = X[sl].float() * wf(sl)
        sB0 += xw.sum(dim=0)
        sA0[sl] = xw.sum(dim=1)
    sB0 -= mu * cnt_B
    sA0 -= mu * cnt_A
    denomB = cnt_B + lam_item * (torch.clamp(cnt_B, min=1.0) if scale_lam else 1.0)
    denomA = cnt_A + lam_user * (torch.clamp(cnt_A, min=1.0) if scale_lam else 1.0)
    biasA = torch.zeros(m_pad, dtype=torch.float32, device=X.device)
    biasB = torch.zeros(n_pad, dtype=torch.float32, device=X.device)
    for _ in range(5 if (user_bias and item_bias) else 1):
        if item_bias:
            sB = sB0.clone()
            for sl in chunks:
                sB -= biasA[sl] @ wf(sl)
            biasB = torch.where(denomB > 0,
                                sB / torch.where(denomB > 0, denomB, 1.0), 0.0)
        if user_bias:
            sA = torch.empty_like(sA0)
            for sl in chunks:
                sA[sl] = sA0[sl] - wf(sl) @ biasB
            biasA = torch.where(denomA > 0,
                                sA / torch.where(denomA > 0, denomA, 1.0), 0.0)
    return biasA, biasB


def _exact_cap(k_sys):
    """Step cap for exact mode: twice the Krylov bound (CG on an SPD system
    of dimension d terminates in d steps in exact arithmetic; f32 rounding
    delays that, so allow 2d + 4).  The per-row freeze and the all-frozen
    exit mean typical data pays far fewer steps."""
    return 2 * k_sys + 4


def fit_explicit_dense_masked(
    rows, cols, vals_raw, m, n, *, weights,
    k, lam6, niter, max_cg_steps, finalize_chol, finalize_steps,
    user_bias, item_bias, glob_mean, scale_lam, scale_bias_const,
    seed, verbose, device, init=None, na_as_zero=False, ckpt=None,
    exact=False,
) -> dict:
    """Fit explicit ALS on the dense-masked engine.  Returns A [m,k], B [n,k],
    biasA/biasB (or None), glob_mean and k; tensors stay on ``device``."""
    m_pad, n_pad, Kp = padded_dims(m, n, k)
    weighted = weights is not None
    dev = torch.device(device)

    def upload(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype)).to(dev)

    X, W, XT, WT, cnt_A, cnt_B = _setup(
        upload(rows, np.int64), upload(cols, np.int64),
        upload(vals_raw, np.float32),
        upload(weights, np.float32) if weighted else None, m_pad, n_pad)
    if na_as_zero:
        # every real row/column participates (missing entries are zeros)
        live_A = torch.arange(m_pad, device=dev) < m
        live_B = torch.arange(n_pad, device=dev) < n
    else:
        live_A = cnt_A > 0
        live_B = cnt_B > 0

    mu = float(np.float32(glob_mean))
    if user_bias or item_bias:
        bA, bB = _device_bias_init(X, W, cnt_A, cnt_B, mu, float(lam6[0]),
                                   float(lam6[1]), scale_lam, user_bias,
                                   item_bias)
    else:
        bA = torch.zeros(m_pad, device=dev)
        bB = torch.zeros(n_pad, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    A = _init_factors(gen, live_A, bA, (m_pad, Kp), k, user_bias)
    B = _init_factors(gen, live_B, bB, (n_pad, Kp), k, item_bias)
    if init is not None:
        # warm restart (the reference's reset_values=False,
        # upstream cmfrec src/cmfrec.h:1858): continue from given factors
        def given(key):
            return torch.as_tensor(init[key], dtype=torch.float32, device=dev)

        if init.get("A") is not None:
            A[:m, :k] = given("A")
        if init.get("B") is not None:
            B[:n, :k] = given("B")
        if user_bias and init.get("biasA") is not None:
            A[:m, k] = given("biasA")
        if item_bias and init.get("biasB") is not None:
            B[:n, k] = given("biasB")

    def lam_row_for(lam_f, lam_bias, has_bias, cnt, count_avg):
        v = np.ones(Kp, np.float32)
        v[:k] = lam_f
        v[k] = lam_bias if has_bias else 1.0
        vec = torch.as_tensor(v, device=dev)
        if not scale_lam:
            return vec[None, :]
        lam_row = vec[None, :] * torch.clamp(cnt, min=1.0)[:, None]
        if scale_bias_const and has_bias:
            lam_row[:, k] = lam_bias * count_avg
        return lam_row

    count_avg_A = count_avg_B = 1.0
    if scale_lam:
        tot = float(np.sum(weights)) if weighted else float(len(rows))
        count_avg_A = tot / max(m, 1)
        count_avg_B = tot / max(n, 1)
    if na_as_zero:
        # shared [Kp] diagonal: under NA-as-zero every row sees the full
        # column count, so the scaled lambda is row-independent
        def lam_diag_for(lam_f, lam_bias, has_bias, n_opp, count_avg):
            v = np.ones(Kp, np.float32)
            v[:k] = lam_f * (n_opp if scale_lam else 1.0)
            if has_bias:
                v[k] = lam_bias * (
                    count_avg if (scale_lam and scale_bias_const)
                    else (n_opp if scale_lam else 1.0))
            return torch.as_tensor(v, device=dev)

        lam_row_A = lam_diag_for(lam6[2], lam6[0], user_bias, n, count_avg_A)
        lam_row_B = lam_diag_for(lam6[3], lam6[1], item_bias, m, count_avg_B)
    else:
        lam_row_A = lam_row_for(lam6[2], lam6[0], user_bias, cnt_A,
                                count_avg_A)
        lam_row_B = lam_row_for(lam6[3], lam6[1], item_bias, cnt_B,
                                count_avg_B)

    statics = dict(k=k, user_bias=user_bias, item_bias=item_bias,
                   na0=na_as_zero)
    args = (X, W, XT, WT, lam_row_A, lam_row_B, live_A, live_B, mu)

    def _state():
        # checkpoint layout == return layout (1:1 with init=)
        return {
            "A": A[:m, :k],
            "B": B[:n, :k],
            "biasA": A[:m, k] if user_bias else None,
            "biasB": B[:n, k] if item_bias else None,
        }

    def _host_state():
        return {key: None if v is None else v.cpu().numpy()
                for key, v in _state().items()}

    def _fence():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # Exact mode (use_cg=False in fit_explicit_als): every half-step's CG runs in
    # f32 to the per-row freeze under the Krylov step cap with the
    # all-frozen exit -- the per-row systems solved to the f32 fixed point.
    exact = exact and not na_as_zero
    if exact:
        bulk_steps = polish_steps = _exact_cap(k + 1)
        bulk_compute = "f32"
        do_polish = False
    else:
        bulk_steps, polish_steps = max_cg_steps, finalize_steps
        bulk_compute = "bf16"
        # NA-as-zero solves are exact closed forms: no f32 polish needed
        do_polish = finalize_chol and not na_as_zero and niter > 0
    n_bulk = niter - 1 if do_polish else niter
    try:
        for it in range(1, n_bulk + 1):
            t0 = time.time()
            A, B = _iteration(A, B, *args, n_steps=bulk_steps,
                              compute=bulk_compute, dyn_stop=exact, **statics)
            if verbose:
                _fence()
                print(f"iter {it}/{niter} [masked-{bulk_compute}] "
                      f"{time.time() - t0:.3f}s")
            if ckpt is not None:
                ckpt.maybe_save(it, _host_state)
        if do_polish:
            t0 = time.time()
            A, B = _iteration(A, B, *args, n_steps=polish_steps,
                              compute="f32", dyn_stop=exact, **statics)
            if verbose:
                _fence()
                print(f"iter {niter}/{niter} [masked-f32*] "
                      f"{time.time() - t0:.3f}s")
    except KeyboardInterrupt:
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")

    out = _state()
    out.update({"glob_mean": float(glob_mean), "k": k})
    return out
