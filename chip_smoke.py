#!/usr/bin/env python3
"""Smoke run of cmfrec_torch on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own line(s):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: compiles the CUDA kernels from cmfrec_torch/csrc/ for sm_90a,
     and prints ptxas's registers and spills for K1's, K2's and K3's kernels;
  3. kernels: each variant of masked_gram_matvec (K1) and masked_rhs (K2)
     against its plain torch twin on the card, at both orientations of the
     flagship fit (X/W built from the ML10M-shaped data; W as the int8 mask,
     f32 weights and those weights in bf16), with errors, CUDA-event times
     and each one's split-S plan; the bf16 K1 on the int8 mask and on the bf16
     weights is also timed against the first design of K1 (the k1_probes
     p_full kernel) on the same inputs, in turns (old, new, new, old);
  4. fit: the flagship explicit ALS-CG fit through the public CMF entry point
     (k=50, lambda 0.05, scale_lam, 15 iterations, CG 3, f32 polish), with its
     kernel launch counts, held-out RMSE against the global-mean baseline;
  5. serving: predict on the held-out pairs and topN for a few users;
  6. bucket CG: the bucket_cg kernel (K3) against its plain torch twin on
     the real bucket layout of the LastFM-shaped implicit fit
     (bench_implicit.make_lastfm_shaped, its train split): every bucket of
     both sides with implicit coefficients and a bf16 opposing matrix, the
     widest, middle and narrowest of each side also in f32, and one explicit
     case with a per-row lambda and a rhs base; each case's bucket class,
     cluster size and staged slots (sparse_cg.k3_plan), errors, how far its
     steps move their start, and CUDA-event times;
  7. the implicit WRMF fit through the public CMF_implicit entry point (k=50,
     lambda 5, alpha 1, 15 iterations, CG 3) on that data, with its K3
     launch count, P@10 / MAP@10 against the popularity baseline on 2,000
     held-out users, and topN for a few users;
  8. the explicit fit of phase 4 on the bucketed engine (engine="sparse"),
     with its K3 launch count and held-out RMSE;
  9. K1's probes (ops/k1_probes.py, the port of the TPU probes P1-P3):
     each against its plain version at both sides of phase 3's W, with
     errors and CUDA-event times; then the probe sweep
     (scripts/sweep_k1_probes_torch.py), with its launch counts;
 10. the collective fits on phase 4's data and split, through CMF: (a) the
     flagship configuration with implicit features (w_implicit 0.5; the C
     reference's "CG + implicit features" row, bench.py:217-228), held-out
     RMSE and launches K1 146 / K2 30; (b) the same with use_cg=False
     (exact mode), RMSE and K2 30, K1 printed (its all-frozen exit makes it
     depend on the data);
 11. the flagship configuration with dense side info U [M, 32] and I
     [N, 32] from a seeded generator: RMSE, C_/D_ [32, 50] finite, the
     column means stored, launches K1 146 / K2 30;
 12. the implicit WRMF configuration of phase 7 on implicit pairs drawn
     with preference structure at ML10M's shape and number of pairs
     (make_preference_data, 20% held out): the dense engine
     (fit_implicit_als(engine="dense"), launches K1 120 / K2 30 / K3 0)
     against CMF_implicit, whose engine="auto" must keep to the bucketed
     engine (K3 only): P@10 of both on 2,000 held-out users, above the
     popularity ranking's and within 0.01 of each other;
 13. the collective implicit fit: phase 12's configuration with phase 11's
     U through CMF_implicit, launches K1 120 / K2 30, C_ finite, P@10 above
     popularity and within 0.01 of phase 12's dense fit.
 14. the bucketed collective route, explicit: phase 4's data and
     configuration through CMF.fit(X, U=, I=), U user tags at the shape of
     MovieLens 10M's tags.dat (a sparse [M + 2,000, 15,000] matrix of tag
     counts, 4,009 rated users and 2,000 side-only users, Zipf-like tags)
     and I item genres at the shape of its movies.dat (a one-hot
     [N, 20], 1-6 genres an item, NA_as_zero_item), from seeded
     generators: the route, warm fit seconds and peak memory, held-out
     RMSE, C_/D_ and the side-only users' rows, K3 launches by side; then
     K3 over the stacked parts of the fit's real A buckets (X + tags) and
     over its C buckets against rowsolve.solve_cg over the separate parts,
     with each A bucket's CUDA-event time beside K3 on its X part alone;
 15. the bucketed collective route, implicit: phase 7's WRMF through
     CMF_implicit.fit(X, U=) with U one-hot user profiles at the shape of
     Last.fm-360K's usersha1-profile.tsv (gender, age bucket, country;
     15% of users without a profile) under NA_as_zero_user: P@10 against
     phase 7's, K3 launches;
 16. the other bucketed branches on phase 4's data at 3 iterations: k
     splits (8/8/8) with phase 14's U and I, w_main 0.5 with seeded
     weights, implicit features with those weights, NA_as_zero with I,
     and a warm restart through the driver from phase 14's factors: each
     fit's route, K3 launches and finite factors.

Serving new users (solvers/warm.py; no hand-written kernel: gathers,
batched Grams and batched Cholesky), each on the model of the phase it
follows, with K1, K2 and K3 launched 0 times:
  5b. explicit warm serving on phase 4's model: 8,192 training users
     (bench_serving.py's Q_WARM) folded in from their training ratings by
     factors_multiple (the degree-grouped route), users/s of the second
     call; factors_warm and topN_warm(exclude=seen) for 8 users, median
     ms; predict_warm_multiple and transform (256 users, dense rows with
     NaNs) against the numpy formula; 256 users on the card against a
     CPU copy of the model (save/load); the fold-in RMSE on the users'
     held-out ratings (<= 0.7408, within 0.005 of the fitted rows');
  7b. implicit warm serving on phase 7's model: the 2,000 held-out users
     folded in from their training plays (the grouped implicit route),
     users/s; P@10 of the fold-in factors (>= 0.0839, within 0.01 of
     phase 7's); 256 users card against CPU;
 11b. cold serving on phase 11's model: factors_multiple(U=), factors_cold,
     topN_cold and predict_cold_multiple on 2,000 U rows (TransCtCinvCt),
     factors_warm with U on a fully observed row (BeTBeChol), and
     item_factors_cold, predict_new and topN_new on 256 I rows, against
     their numpy closed forms and the CPU copy; users/s.
 14b. serving on phase 14's model: factors_cold of the 2,000 side-only
     users' tag rows as U_col/U_val, topN_cold, factors_warm with ratings
     and a tag row, predict for the side-only users, against their numpy
     closed forms and the CPU copy.

Each fit phase, and phase 9's sweep, sets every kernel's launch count to 0
just before it and reads the counts just after; phases 10-16 print each
fit's seconds (14-15 of a warm fit, after a first one) and peak device
memory.  The line before the last is
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero; so does a machine without a CUDA
device, or a directory without the package.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np

M, N = 69878, 10677  # ML10M's shape (bench.make_ml10m_shaped)
ML10M_NNZ = 10_000_054  # bench.make_ml10m_shaped's nnz
FIT = dict(k=50, lambda_=0.05, scale_lam=True, niter=15, use_cg=True,
           max_cg_steps=3, finalize_chol=True, user_bias=True,
           item_bias=True, center=True)
# JAX package's held-out RMSE on the same data (BENCH_r05.json) plus 0.01
# for a different random init
RMSE_BOUND = 0.73078 + 0.01
# K1 = 14 bulk iterations x 2 half-steps x (1 + 3 CG steps)
#      + the polish's 2 x (1 + 16);  K2 = one per half-step
EXPECTED_LAUNCHES = {"masked_gram_matvec": 14 * 2 * 4 + 2 * 17,
                     "masked_rhs": 15 * 2, "bucket_cg": 0}
# max|kernel - twin| / max|twin|, set about 7x above the largest readings at
# these shapes (1.4e-4 bf16, 6.5e-6 f32, NVIDIA H100): f32 differs by
# summation order only; bf16 also flips a few roundings of T*W to bf16
REL_TOL = {"bf16": 1e-3, "f32": 5e-5}
REPLACES = {"masked_gram_matvec": "cmfrec_tpu/ops/masked_matmul.py:87",
            "masked_rhs": "cmfrec_tpu/ops/masked_matmul.py:108",
            "bucket_cg": "cmfrec_tpu/ops/sparse_cg.py:52"}
SOURCES = {"masked_gram_matvec": "cmfrec_torch/csrc/masked_matmul.cu",
           "masked_rhs": "cmfrec_torch/csrc/masked_matmul.cu",
           "bucket_cg": "cmfrec_torch/csrc/sparse_cg.cu"}
# NVIDIA H100 SXM data sheet: HBM bytes/s; dense bf16 tensor-core and plain
# f32 operations/s.  An operation is costed by its operands' type: a bf16 x
# bf16 product summed in f32 at the bf16 rate, whatever unit the kernel uses.
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}

# Phase 9, max|kernel - plain| / max|plain| by the probe's work model
# (k1_probes.Probe.work): bodies equal to K1's (p_full, p_part, v*) take
# K1's limit; the W stream sums a 0/1 mask (int8 or bf16) exactly.  The
# others about 7x above the largest readings at these shapes (NVIDIA H100):
# p_dots 1.8e-4 (T's bf16 roundings flip, as in K1), p_dot1 2.4e-6 (f32
# summation order of T's row sums)
PROBE_REL_TOL = {"k1": REL_TOL["bf16"], "dots": 1.3e-3, "dot1": 2e-5,
                 "w": 0.0}
PROBE_REPLACES = {"p1": "scripts/sweep_kernel_probe2.py:72",
                  "p_part": "scripts/sweep_kernel_probe2.py:95",
                  "p2": "scripts/sweep_kernel_variants.py:78",
                  "p3": "scripts/sweep_kernel_probe3.py:96"}
# each row's headline variant: its first that is not K1 itself
PROBE_HEADLINE = {"p1": "p_dots", "p2": "vbf_int8", "p3": "wsum_64x64"}
# each row's wrappers in ops/k1_probes.py (p_full, v0 and vw16: full)
PROBE_WRAPPERS = {"p1": ("full", "dots", "dot1", "wsum", "part"),
                  "p2": ("bft", "sel"), "p3": ("w_stream",)}
# each kernel's CUDA kernels (csrc/masked_matmul.cu, csrc/sparse_cg.cu), for
# the ptxas report and the {"kernels": ...} rows
CUDA_KERNELS = {
    "masked_gram_matvec": ("gram_bf16_wgmma_kernel", "gram_f32_tile8_kernel",
                           "gram_f32_ring_kernel", "sum_chunks_kernel"),
    "masked_rhs": ("rhs_bf16_wgmma_kernel", "rhs_f32_tile8_kernel",
                   "sum_chunks_kernel"),
    "bucket_cg": ("bucket_cg_kernel",),
}
PTXAS_KERNELS = tuple(dict.fromkeys(k for ks in CUDA_KERNELS.values()
                                    for k in ks))
PROBE_SWEEP_REPS = 2

# phases 10-13 (on phase 4's data and split)
COLLECTIVE_FIT = dict(FIT, add_implicit_features=True, w_implicit=0.5)
# the JAX package's held-out RMSE of the "CG + implicit features" and
# "Cholesky + implicit features" rows on the same data (BENCH_r05.json,
# cg_implicit_feat_rmse and chol_implicit_feat_rmse) plus 0.01
RMSE_BOUND_CG_IMPLICIT_FEAT = 0.73073 + 0.01
RMSE_BOUND_CHOL_IMPLICIT_FEAT = 0.7308 + 0.01
SIDE_P = 32  # columns of phase 11's U and I
# the dense implicit engine: 15 iterations x 2 half-steps x (1 + 3 CG steps)
EXPECTED_DENSE_IMPLICIT = {"masked_gram_matvec": 15 * 2 * 4,
                           "masked_rhs": 15 * 2, "bucket_cg": 0}
RANK_USERS = 2000  # held-out users of phases 12-13
# |P@10 - phase 12's dense P@10| of phase 12's bucketed fit and phase 13's
P10_ENGINE_TOL = 0.01
# phases 12-13's data: implicit pairs at ML10M's shape and number of pairs
# with preference structure (make_preference_data), 20% held out.  With
# random side info the collective fit's P@10 moves off the plain fit's by
# +0.017 at k_true 4, +0.003 at 8 and -0.014 at 16 (NVIDIA H100 80GB HBM3;
# scripts/time_implicit_engines_torch.py --k-true 4 8 16); 8 keeps phase
# 13 inside P10_ENGINE_TOL
PREF = dict(k_true=8, nnz=10_000_054, seed=7)
PREF_HELDOUT = 0.2

LFM_M, LFM_N = 359347, 160168  # LastFM-360K's shape (bench_implicit.py:30)
IMPLICIT_FIT = dict(k=50, lambda_=5.0, alpha=1.0, niter=15, use_cg=True,
                    max_cg_steps=3)
# The JAX package's P@10 on the same data and split (BENCH_r05.json,
# extra.implicit) less 0.01 for a different random init
P10_BOUND = 0.09387 - 0.01
K3_STEPS = IMPLICIT_FIT["max_cg_steps"]
# max|kernel - twin| / max|twin| for K3 by (coefficients, op), set 7-8x
# above the largest readings over the LastFM-shaped buckets (NVIDIA H100;
# see check_bucket_cg): log plays 1.4e-4 bf16, 2.8e-5 f32; raw plays one
# step in 2.5e-4 f32; explicit 2.4e-7.  Summation order only, and in bf16
# flipped roundings of t = (m . v) * cw
K3_REL_TOL = {("implicit-log", "bf16"): 1e-3, ("implicit-log", "f32"): 2e-4,
              ("implicit", "f32"): 2e-3, ("explicit", "bf16"): 2e-6,
              ("explicit", "f32"): 2e-6}
# each case's 3 steps must move their start by at least this many limits
# (max|twin - start| / max|twin|), and stopping one step short must miss
# the limit, so a kernel that skipped or botched its steps could not pass
K3_MOVE_FACTOR = 10

# serving (phases 5b, 7b, 11b)
SERVE_USERS = 8192  # bench_serving.py's Q_WARM, a warm-factors batch
SERVE_CHECK = 256  # users held card against CPU, and transform's rows
SERVE_TOPN = 8
COLD_ROWS = 2000  # phase 11b's U rows
FOLDIN_RMSE_TOL = 0.005  # |fold-in RMSE - fitted rows' RMSE|
FOLDIN_P10_TOL = 0.01  # |fold-in P@10 - phase 7's P@10|
# max|card - CPU| / max|CPU| of the served factors (the same f32 solves,
# summed in another order), by phase, about 7x above the readings (NVIDIA
# H100 80GB HBM3): 5b 1.2e-6 (factors_warm against the batch; card against
# CPU 5.6e-7), 7b 1.35e-5 (raw LastFM plays up to 7e6 as confidences),
# 11b 1.7e-6
SERVE_CPU_TOL = {"5b": 1e-5, "7b": 1e-4, "11b": 1.2e-5}
# max|port - numpy f64 closed form| / max|closed form| of phase 11b's f32
# solves: readings <= 2.3e-5 (item_factors_cold, a Cholesky of the
# swapped model's D^T D system), the others <= 1.3e-6
SERVE_ORACLE_TOL = 1.5e-4
# |predict_warm_multiple or transform - the numpy formula| (ratings ~3.5):
# readings <= 1.1e-6
SERVE_PRED_TOL = 1e-5


def bound(nbytes, ops):
    """The least time the card could take: (ms, "bytes" | "operations").
    ``ops`` maps an operand type to the operations done on it."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = sum(n / PEAK_OPS[op] for op, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(log, names=PTXAS_KERNELS):
    """[(kernel, registers, spill store bytes, spill load bytes)] for the
    entries of nvcc's -Xptxas -v log whose name holds one of `names`."""
    rows, fn, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and any(n in fn for n in names):
            rows.append((fn, int(m.group(1)), *spill))
            fn = None
    try:  # readable names where binutils is there
        readable = subprocess.run(
            ["c++filt"], input="\n".join(r[0] for r in rows),
            capture_output=True, text=True, check=True).stdout.split("\n")
        rows = [(re.sub(r"^void |\(.*$", "",
                        n.replace("(anonymous namespace)::", "")), *r[1:])
                for n, r in zip(readable, rows)]
    except (OSError, subprocess.CalledProcessError):
        pass
    return rows


def _timed(fn, reps):
    """Mean milliseconds per call over `reps` calls, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def flagship_dense(rows, cols, vals, weights):
    """The flagship fit's padded dense X and W on the card, both sides:
    (K, {side: (R, S, X, int8 mask, f32 weights)})."""
    import torch

    from cmfrec_torch.solvers.dense_masked import _setup, padded_dims

    m_pad, n_pad, Kp = padded_dims(M, N, FIT["k"])
    up = {key: torch.as_tensor(a).to("cuda") for key, a in
          (("r", rows), ("c", cols), ("v", vals.astype(np.float32)),
           ("w", weights.astype(np.float32)))}
    X, W8, XT, W8T, _, _ = _setup(up["r"], up["c"], up["v"], None, m_pad, n_pad)
    _, Wf, _, WfT, _, _ = _setup(up["r"], up["c"], up["v"], up["w"], m_pad,
                                 n_pad)
    return Kp, {"A": (m_pad, n_pad, X, W8, Wf), "B": (n_pad, m_pad, XT, W8T, WfT)}


def check_kernels(rows, cols, vals, weights):
    """Phase 3: every kernel variant against its twin at the flagship shapes."""
    import torch

    from cmfrec_torch.ops import k1_probes
    from cmfrec_torch.ops import masked_matmul as mm

    Kp, sides = flagship_dense(rows, cols, vals, weights)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"masked_gram_matvec": [], "masked_rhs": []}
    for side, (R, S, Xs, W8s, Wfs) in sides.items():
        Q = torch.randn(R, Kp, device=dev, generator=gen) / 8
        Be = torch.randn(S, Kp, device=dev, generator=gen) / 8
        mb = 3.5 + torch.randn(S, device=dev, generator=gen) / 2
        Wbs = Wfs.to(torch.bfloat16)
        for op, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            Qo, Beo = Q.to(dt), Be.to(dt)
            for wname, Wv in (("int8", W8s), ("f32", Wfs), ("bf16", Wbs)):
                cases = {
                    "masked_gram_matvec": (mm.masked_gram_matvec,
                                           mm.masked_gram_matvec_ref,
                                           (Qo, Beo, Wv)),
                    "masked_rhs": (mm.masked_rhs, mm.masked_rhs_ref,
                                   (Xs, Wv, mb, Beo)),
                }
                for name, (kern, twin, args) in cases.items():
                    out, ref = kern(*args), twin(*args)
                    torch.cuda.synchronize()
                    err = (out - ref).abs().max().item()
                    rel = err / ref.abs().max().item()
                    ms = _timed(lambda: kern(*args), 5)
                    plain_ms = _timed(lambda: twin(*args), 3)
                    ok = bool(np.isfinite(rel)) and rel <= REL_TOL[op]
                    esz, wsz = (2 if op == "bf16" else 4), Wv.element_size()
                    if name == "masked_gram_matvec":
                        nbytes = (R + S) * Kp * esz + R * S * wsz + R * Kp * 4
                        ops = 4 * R * S * Kp
                    else:
                        nbytes = (R * S * (2 + wsz) + S * 4 + S * Kp * esz
                                  + R * Kp * 4)
                        ops = 2 * R * S * Kp
                    b_ms, b_by = bound(nbytes, {op: ops})
                    extra, note = {}, ""
                    planner = (mm.gram_plan if name == "masked_gram_matvec"
                               else mm.rhs_plan)
                    plan = planner(R, S, Kp, dt, Wv.dtype, dev)
                    extra["plan"] = plan
                    note = (f" split: chunk={plan['chunk']} "
                            f"({plan['chunks']} chunks; configuration "
                            f"{plan['variant']}, S tile "
                            f"{plan['s_tile']}, {plan['row_tile']}-row "
                            f"blocks, {plan['per_sm']} an SM)")
                    if name == "masked_gram_matvec":
                        if op == "bf16" and wname != "f32":
                            # the first design of K1 on the same inputs, in
                            # turns: old, new, new, old
                            turns = [_timed(lambda: f(*args), 5) for f in
                                     (k1_probes.full, kern, kern,
                                      k1_probes.full)]
                            ms = (turns[1] + turns[2]) / 2
                            extra.update(p_full_ms=(turns[0] + turns[3]) / 2,
                                         turns=turns)
                            shown = " ".join(f"{t:.3f}" for t in turns)
                            note += (f" p_full_ms={extra['p_full_ms']:.3f} "
                                     f"(turns {shown})")
                    print(f"kernel {name} side={side} R={R} S={S} K={Kp} "
                          f"op={op} W={wname}: max_abs_err={err:.3e} "
                          f"rel={rel:.3e} (tol {REL_TOL[op]:.0e}) "
                          f"ms={ms:.3f} plain_ms={plain_ms:.3f} "
                          f"bound_ms={b_ms:.4f} ({b_by}){note} "
                          f"{'ok' if ok else 'MISMATCH'}", flush=True)
                    if not ok:
                        raise AssertionError(f"{name} disagrees with its twin")
                    results[name].append(dict(
                        side=side, R=R, S=S, K=Kp, op=op, W=wname,
                        max_abs_err=err, rel_err=rel, ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        **extra))
                    del out, ref
        del Wbs
    return results


def check_k1_probes(rows, cols, vals, weights):
    """Phase 9: every K1 probe against its plain version at both sides of
    phase 3's W (Q/Be as there, in bf16; the int8 mask, and the mask in
    bf16 for the bf16-W probes).  Returns the probe records by row and
    torch.sum's time over the int8 mask by side."""
    import torch

    from cmfrec_torch.ops import k1_probes

    Kp, sides = flagship_dense(rows, cols, vals, weights)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    records = {"p1": [], "p2": [], "p3": []}
    library = {}
    for side, (R, S, _, W8s, _) in sides.items():
        Q = torch.randn(R, Kp, device=dev, generator=gen) / 8
        Be = torch.randn(S, Kp, device=dev, generator=gen) / 8
        Qb, Beb = Q.to(torch.bfloat16), Be.to(torch.bfloat16)
        Wd = {torch.int8: W8s, torch.bfloat16: W8s.to(torch.bfloat16)}
        for probe in k1_probes.PROBES:
            Wp = Wd[probe.w_dtype]
            args = (Qb, Beb, Wp)
            out, ref = probe.kernel(*args), probe.plain(*args)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            ms = _timed(lambda: probe.kernel(*args), 5)
            plain_ms = _timed(lambda: probe.plain(*args), 2)
            b_ms, b_by = bound(*k1_probes.work(probe, R, S, Kp,
                                               Wp.element_size()))
            tol = PROBE_REL_TOL[probe.work]
            ok = bool(np.isfinite(rel)) and rel <= tol
            wname = "int8" if probe.w_dtype == torch.int8 else "bf16"
            print(f"probe {probe.row} {probe.name} side={side} R={R} S={S} "
                  f"K={Kp} W={wname}: max_abs_err={err:.3e} rel={rel:.3e} "
                  f"(tol {tol:.0e}) ms={ms:.3f} plain_ms={plain_ms:.3f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                raise AssertionError(f"probe {probe.name} disagrees with its "
                                     "plain version")
            records[probe.row].append(dict(
                name=probe.name, side=side, R=R, S=S, K=Kp, W=wname,
                replaces=PROBE_REPLACES.get(probe.name,
                                            PROBE_REPLACES[probe.row]),
                max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by))
            del out, ref
        library[side] = _timed(lambda: torch.sum(W8s, dtype=torch.int32), 5)
        print(f"library torch.sum(W, dtype=int32) side={side}: "
              f"ms={library[side]:.3f}", flush=True)
        del Q, Be, Qb, Beb, Wd
    del sides
    torch.cuda.empty_cache()
    return records, library


def _bucket_case(b, mat, gfix, mode, gen):
    """K3's operands for bucket b: implicit coefficients (alpha 1) of the
    raw plays x ("implicit", the WRMF fit's) or of log x ("implicit-log",
    the fit with apply_log_transf), cw = x and cv = 1 + x, with the Gram
    base in gfix; or explicit ones with a per-row lambda and a rhs base
    (the scale_lam / NA-as-zero variant)."""
    import torch

    L = b.width
    msk = (torch.arange(L, device=mat.device)[None, :]
           < b.length[:, None]).float()
    if mode == "explicit":
        lam_row = (5.0 * torch.clamp(b.length.float(), min=1.0))[:, None]
        r0 = torch.randn(b.n_rows, mat.shape[1], device=mat.device,
                         generator=gen)
        return (msk, (b.val - 3.0) * msk, torch.zeros_like(gfix),
                lam_row.expand(-1, mat.shape[1]).contiguous(), r0)
    x = b.val if mode == "implicit" else torch.log(b.val.clamp(min=1.0))
    return x * msk, (1.0 + x) * msk, gfix, None, None


def check_bucket_cg(layouts, k_pad):
    """Phase 6: K3 against its twin on the LastFM-shaped layout.

    Cases: every bucket with log-play coefficients and a bf16 opposing
    matrix (the timed set: one iteration's 24 launches); the widest,
    middle and narrowest bucket of each side also with log-play
    coefficients in f32 and with the raw plays in f32; the A side's middle
    bucket with a per-row lambda and a rhs base, bf16 and f32.  Each case
    starts where 3 steps have far to go: from random factors, or, with the
    raw plays, after one twin step.  The raw plays (up to 7e6) make 3 CG
    steps from random factors so ill-conditioned that f32 summation order
    alone moves the result by up to 0.1 of max|x|, the twin's against f64
    as the kernel's against the twin; one step in, f32 agrees to 3e-4.  In
    bf16 the flipped roundings of t keep them apart for several steps, so
    bf16 is held on the log plays (and the raw plays in bf16 by phase 7's
    ranking quality).  Every case prints how far its steps move the start,
    the share of real rows they change, and how far a kernel one step short
    would be off.  Returns the per-case records."""
    import torch

    from cmfrec_torch.ops import sparse_cg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    k = IMPLICIT_FIT["k"]
    lam = torch.ones(k_pad, device=dev)
    lam[:k] = IMPLICIT_FIT["lambda_"]
    records = []
    for side, (bk, S) in layouts.items():
        mat = torch.randn(S, k_pad, device=dev, generator=gen) / k ** 0.5
        mat[:, k:] = 0.0
        gfix = mat.T @ mat + torch.diag(lam)
        widths = sorted(range(len(bk.buckets)),
                        key=lambda i: bk.buckets[i].width)
        chosen = {widths[0]: "narrowest", widths[len(widths) // 2]: "middle",
                  widths[-1]: "widest"}
        for i, b in enumerate(bk.buckets):
            a0 = torch.randn(b.n_rows, k_pad, device=dev, generator=gen) / 8
            a0[:, k:] = 0.0
            real = (torch.arange(b.width, device=dev)[None, :]
                    < b.length[:, None])
            slots = int(b.length.sum())
            uniq = int(torch.unique(b.idx[real]).numel())
            cases = [("implicit-log", "bf16")]
            if i in chosen:
                cases += [("implicit-log", "f32"), ("implicit", "f32")]
            if side == "A" and chosen.get(i) == "middle":
                cases += [("explicit", "bf16"), ("explicit", "f32")]
            for mode, op in cases:
                cw, cv, gf, lam_row, r0 = (
                    None if t is None else t.contiguous() for t in
                    _bucket_case(b, mat, gfix, mode, gen))
                start = a0 if mode != "implicit" else sparse_cg.bucket_cg_ref(
                    mat, b.idx, cw, cv, gf, lam_row, r0, a0, n_steps=1)
                matx = mat.to(torch.bfloat16 if op == "bf16" else
                              torch.float32)
                args = (matx, b.idx, cw, cv, gf, lam_row, r0, start)
                out = sparse_cg.bucket_cg(*args, n_steps=K3_STEPS,
                                          length=b.length)
                ref = sparse_cg.bucket_cg_ref(*args, n_steps=K3_STEPS)
                torch.cuda.synchronize()
                top = ref.abs().max().item()
                err = (out - ref).abs().max().item()
                rel = err / top
                # how far the steps take the start, and the share of real
                # rows they change (a skipped row stays at its start)
                moved = (ref - start).abs().max().item() / top
                live = ((ref - start)[:b.n_real].abs().amax(1) > 0
                        ).float().mean().item()
                # what stopping one step early would cost
                short = (sparse_cg.bucket_cg_ref(*args, n_steps=K3_STEPS - 1)
                         - ref).abs().max().item() / top
                plan = sparse_cg.plan_for(b.n_rows, b.width, k_pad,
                                          matx.dtype, dev)
                ms = _timed(lambda: sparse_cg.bucket_cg(
                    *args, n_steps=K3_STEPS, length=b.length), 5)
                plain_ms = _timed(lambda: sparse_cg.bucket_cg_ref(
                    *args, n_steps=K3_STEPS), 2)
                # each input read once, the output written once: the rows
                # of mat the bucket references, idx/cw/cv of its real slots,
                # the [R, K] and [K, K] operands; operations: the rhs (2K a
                # slot) and 1 + n_steps matvecs (4K a slot, 2K^2 a row).
                # The slot products take mat's type (v, t and cv meet m_l
                # rounded to it); the gfix products are f32.
                nbytes = (uniq * k_pad * matx.element_size() + slots * 12
                          + b.n_rows * (4 + 8 * k_pad
                                        + (8 * k_pad if r0 is not None else 0))
                          + 4 * k_pad * k_pad)
                ops = {op: slots * (2 * k_pad + (1 + K3_STEPS) * 4 * k_pad)}
                ops["f32"] = (ops.get("f32", 0)
                              + b.n_rows * (1 + K3_STEPS) * 2 * k_pad * k_pad)
                b_ms, b_by = bound(nbytes, ops)
                tol = K3_REL_TOL[mode, op]
                ok = (bool(np.isfinite(rel)) and rel <= tol
                      and moved >= K3_MOVE_FACTOR * tol and short > tol
                      and live >= 0.5)
                exact = ""
                if op == "f32":
                    # both f32 results against the same CG in f64: how far
                    # each one's summation order carries it
                    ref64 = sparse_cg.bucket_cg_ref(
                        *(a.double() if a is not None and a.is_floating_point()
                          else a for a in args), n_steps=K3_STEPS)
                    top64 = ref64.abs().max().item()
                    exact = (f" vs f64: kernel "
                             f"{(out - ref64).abs().max().item() / top64:.3e} "
                             f"twin {(ref - ref64).abs().max().item() / top64:.3e}")
                    del ref64
                print(f"kernel bucket_cg side={side} bucket={i} "
                      f"({chosen.get(i, '-')}) R={b.n_rows} L={b.width} "
                      f"slots={slots} K={k_pad} op={op} {mode} "
                      f"class={plan['cls']} cluster={plan['cluster']} "
                      f"threads={plan['threads']} "
                      f"stage_slots={plan['stage_slots']}: "
                      f"max_abs_err={err:.3e} rel={rel:.3e} (tol {tol:.0e})"
                      f"{exact} moved={moved:.3e} (min "
                      f"{K3_MOVE_FACTOR * tol:.0e}) live={live:.3f} "
                      f"one_step_short={short:.3e} ms={ms:.3f} "
                      f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.4f} "
                      f"({b_by}) {'ok' if ok else 'MISMATCH'}", flush=True)
                if not ok:
                    raise AssertionError("bucket_cg disagrees with its twin, "
                                         "or the case checks too little")
                records.append(dict(
                    side=side, bucket=i, R=b.n_rows, L=b.width, slots=slots,
                    K=k_pad, op=op, mode=mode, max_abs_err=err, rel_err=rel,
                    moved=moved, live=live, one_step_short=short, ms=ms,
                    plain_ms=plain_ms, bytes=nbytes, ops=ops, bound_ms=b_ms,
                    bound_by=b_by, plan=plan))
                del out, ref, args
        del mat
        torch.cuda.empty_cache()
    return records


def ranking_quality(A, B, tr_r, tr_c, te_r, te_c, test_users, n):
    """P@10, MAP@10 and the popularity P@10 with bench_implicit.py's
    protocol (:82-151): one matmul and top-k on the card, train items masked
    out, held-out items of each test user as the relevant set."""
    import collections

    import torch

    dev = A.device
    u_index = np.full(max(int(tr_r.max()), int(te_r.max())) + 1, -1, np.int64)
    u_index[test_users] = np.arange(len(test_users))
    sel = u_index[tr_r] >= 0
    tru = torch.as_tensor(u_index[tr_r[sel]], device=dev)
    trc = torch.as_tensor(tr_c[sel], device=dev)

    def top10(scores):
        scores[tru, trc] = -torch.inf
        return torch.topk(scores, 10, dim=1).indices.cpu().numpy()

    top = top10(A[torch.as_tensor(test_users, device=dev)] @ B.T)
    pop = torch.bincount(torch.as_tensor(tr_c, device=dev), minlength=n)
    top_pop = top10(pop.float()[None, :].repeat(len(test_users), 1))
    heldout = collections.defaultdict(set)
    sel = u_index[te_r] >= 0
    for u, c in zip(u_index[te_r[sel]], te_c[sel]):
        heldout[int(u)].add(int(c))

    def p_at_k(topmat):
        hits, aps = [], []
        for r in range(len(test_users)):
            hs = heldout.get(r)
            if not hs:
                continue
            rel = [int(c) in hs for c in topmat[r]]
            hits.append(sum(rel) / min(10, len(hs)))
            num_hit, ap = 0, 0.0
            for i, rv in enumerate(rel):
                if rv:
                    num_hit += 1
                    ap += num_hit / (i + 1)
            aps.append(ap / min(10, len(hs)))
        return float(np.mean(hits)), float(np.mean(aps))

    p10, map10 = p_at_k(top)
    return p10, map10, p_at_k(top_pop)[0]


def make_preference_data(m=M, n=N, *, k_true, nnz, seed, device="cuda"):
    """Implicit-feedback pairs with preference structure, drawn on
    ``device`` from a seed: P(u sees i) = sigmoid(a_u . b_i + user and item
    offsets - c), with standard normal a, b of width k_true, offsets
    N(0, 0.5^2) and N(0, 1), and c set (by bisection on 4,096 rows) so that
    about ``nnz`` pairs are drawn; plays 1 + Poisson(3).  A ranking that
    only knows popularity (the item offsets) stays below one that learns
    a and b.  Returns numpy (rows, cols, vals) in row order."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def randn(*shape, sd=1.0):
        return sd * torch.randn(shape, generator=gen, device=device)

    A, B = randn(m, k_true), randn(n, k_true)
    ou, oi = randn(m, sd=0.5), randn(n)

    def logits(sl):
        return A[sl] @ B.T + ou[sl, None] + oi[None, :]

    sample = logits(slice(0, min(m, 4096)))
    lo, hi = -50.0, 50.0
    for _ in range(60):
        c = (lo + hi) / 2
        if float(torch.sigmoid(sample - c).mean()) * m * n > nnz:
            lo = c
        else:
            hi = c
    rows, cols = [], []
    step = max(1, (1 << 26) // n)
    for r0 in range(0, m, step):
        sl = slice(r0, min(m, r0 + step))
        p = torch.sigmoid(logits(sl) - c)
        hit = torch.rand(p.shape, generator=gen, device=device) < p
        r, cc = torch.nonzero(hit, as_tuple=True)
        rows.append(r + r0)
        cols.append(cc)
    rows, cols = torch.cat(rows), torch.cat(cols)
    vals = 1.0 + torch.poisson(torch.full((rows.numel(),), 3.0,
                                          device=device), generator=gen)
    return (rows.cpu().numpy().astype(np.int64),
            cols.cpu().numpy().astype(np.int64),
            vals.cpu().numpy().astype(np.float64))


def n_chunks(ids, n_rows):
    """Buckets of one side of the bucketed engine's layout."""
    from cmfrec_torch.data.shards import plan_layout

    counts = np.bincount(ids, minlength=n_rows)
    return len(plan_layout(counts, np.argsort(-counts, kind="stable"),
                           n_rows)[0])


def _reset_launches(ops):
    for op in ops.values():
        op.launches = 0


def _read_launches(ops):
    return {name: op.launches for name, op in ops.items()}


def _fit_phase(ops, fit):
    """fit() with every launch count set to 0 just before it: (its result,
    the launch counts just after, seconds, peak device memory in bytes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(ops)
    t0 = time.perf_counter()
    out = fit()
    torch.cuda.synchronize()
    return (out, _read_launches(ops), time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def _cpu_twin(model):
    """A copy of ``model`` on the CPU through save/load, caches built."""
    from cmfrec_torch.ops import _cuda

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _cuda.BUILD_DIR / "chip_smoke_serving.npz"
    model.save(str(path))
    try:
        twin = type(model).load(str(path), device="cpu")
    finally:
        path.unlink()
    return twin.force_precompute_for_predictions()


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def _spy(module, name, calls):
    """Wrap module.name so that each call appends to ``calls``; returns the
    function to put back."""
    real = getattr(module, name)
    setattr(module, name,
            lambda *a, **k: calls.append(name) or real(*a, **k))
    return real


def _timed_s(fn):
    """(result, host seconds) of a call that ends in a download."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _check_topn(items, scores, seen, what):
    if (len(items) != 10 or np.isin(items, seen).any()
            or not np.all(np.isfinite(scores)) or np.any(np.diff(scores) > 0)):
        raise AssertionError(f"{what} is wrong: {items}")


def _new_user_coo(users, rows, cols, vals, m, n):
    """The ratings of ``users`` (of m) as a new-user COO matrix, row i
    holding users[i]'s; and the local row of each user id (-1 else)."""
    import scipy.sparse as sp

    local = np.full(m, -1, np.int64)
    local[users] = np.arange(len(users))
    sel = local[rows] >= 0
    X = sp.coo_matrix((vals[sel], (local[rows[sel]], cols[sel])),
                      shape=(len(users), n))
    return X, local


def serve_explicit(ops, model, rows, cols, vals, test):
    """Phase 5b on phase 4's model; returns its launch counts."""
    from cmfrec_torch.models import cmf as tcmf
    from cmfrec_torch.solvers import warm

    tr = ~test
    users = np.sort(np.random.default_rng(21).choice(
        np.unique(rows[tr]), SERVE_USERS, replace=False))
    X, local = _new_user_coo(users, rows[tr], cols[tr], vals[tr], M, N)
    if not tcmf._route_grouped(X.row, SERVE_USERS):
        raise AssertionError("phase 5b: the batch would not take the "
                             "degree-grouped route")
    calls = []
    real = _spy(warm, "factors_explicit_grouped", calls)
    _reset_launches(ops)
    try:
        model.factors_multiple(X=X)
        (a, bias), s = _timed_s(lambda: model.factors_multiple(
            X=X, return_bias=True))
    finally:
        warm.factors_explicit_grouped = real
    if calls != ["factors_explicit_grouped"] * 2 or not np.isfinite(a).all():
        raise AssertionError(f"phase 5b: factors_multiple took {calls}")
    B = model.B_.astype(np.float64)
    ib = model.item_bias_.astype(np.float64)

    def formula(ai, bi, items):
        return model.glob_mean_ + bi + ib[items] + np.sum(
            ai.astype(np.float64) * B[items], axis=1)

    # factors_warm and topN_warm(exclude=seen) for a few users
    topn_ms, warm_err = [], 0.0
    for u in users[:SERVE_TOPN]:
        sel = tr & (rows == u)
        seen, xv = cols[sel], vals[sel]
        aw, bw = model.factors_warm(X_col=seen, X_val=xv, return_bias=True)
        warm_err = max(warm_err, _rel(np.append(aw, bw),
                                      np.append(a[local[u]], bias[local[u]])))
        t0 = time.perf_counter()
        items, scores = model.topN_warm(n=10, X_col=seen, X_val=xv,
                                        exclude=seen, output_score=True)
        topn_ms.append((time.perf_counter() - t0) * 1e3)
        _check_topn(items, scores, seen, f"phase 5b: topN_warm of user {u}")
        np.testing.assert_allclose(
            scores, formula(np.broadcast_to(aw, (10, aw.size)), bw, items),
            rtol=0, atol=1e-4, err_msg="phase 5b: topN_warm scores")
    # predict_warm_multiple: each user's first training item
    first = np.zeros(SERVE_USERS, np.int64)
    first[X.row[::-1]] = X.col[::-1]
    p = model.predict_warm_multiple(X, first)
    pw_err = float(np.abs(p - formula(a, bias, first)).max())
    # transform: 256 users' dense rows, NaN where unrated
    Xd = np.full((SERVE_CHECK, N), np.nan)
    few = X.row < SERVE_CHECK
    Xd[X.row[few], X.col[few]] = X.data[few]
    out = model.transform(Xd)
    obs = ~np.isnan(Xd)
    r_, c_ = np.nonzero(~obs)
    tf_err = float(np.abs(out[r_, c_] - formula(a[r_], bias[r_], c_)).max())
    if not (np.isfinite(out).all() and np.array_equal(out[obs], Xd[obs])):
        raise AssertionError("phase 5b: transform changed an observed entry")
    # (i) 256 users on the card against the same call on the CPU
    X256 = X.tocsr()[:SERVE_CHECK].tocoo()
    card = np.column_stack(model.factors_multiple(X=X256, return_bias=True))
    cpu = np.column_stack(_cpu_twin(model).factors_multiple(
        X=X256, return_bias=True))
    cpu_err = _rel(card, cpu)
    # (ii) the fold-in RMSE on the users' held-out ratings
    sel = test & (local[rows] >= 0)
    li = local[rows[sel]]
    rmse_fold = float(np.sqrt(np.mean(
        (formula(a[li], bias[li], cols[sel]) - vals[sel]) ** 2)))
    rmse_fit = float(np.sqrt(np.mean(
        (model.predict(rows[sel], cols[sel]) - vals[sel]) ** 2)))
    launches = _read_launches(ops)
    print(f"phase 5b explicit warm serving: {SERVE_USERS} users, "
          f"{X.nnz} ratings, factors_multiple (grouped) {s:.3f} s = "
          f"{SERVE_USERS / s:.0f} users/s; factors_warm vs the batch "
          f"{warm_err:.2e}; topN_warm(n=10, exclude=seen) median "
          f"{np.median(topn_ms):.2f} ms; predict_warm_multiple |p - formula| "
          f"{pw_err:.2e}, transform {tf_err:.2e} (tol {SERVE_PRED_TOL:.0e}); "
          f"card vs CPU {cpu_err:.2e} (limit {SERVE_CPU_TOL['5b']:.1e}); "
          f"fold-in RMSE "
          f"{rmse_fold:.5f} on {int(sel.sum())} held-out ratings (bound "
          f"{RMSE_BOUND:.5f}; fitted rows {rmse_fit:.5f}, tol "
          f"{FOLDIN_RMSE_TOL}); launches {launches}", flush=True)
    if any(launches.values()):
        raise AssertionError("phase 5b: serving launched a fit kernel")
    if not (warm_err <= SERVE_CPU_TOL["5b"] and pw_err <= SERVE_PRED_TOL
            and tf_err <= SERVE_PRED_TOL and cpu_err <= SERVE_CPU_TOL["5b"]):
        raise AssertionError("phase 5b: served factors disagree")
    if not (rmse_fold <= RMSE_BOUND
            and abs(rmse_fold - rmse_fit) <= FOLDIN_RMSE_TOL):
        raise AssertionError("phase 5b: fold-in RMSE out of bounds")
    return launches


def serve_implicit(ops, imodel, p10, tr_r, tr_c, tr_v, te_r, te_c,
                   test_users):
    """Phase 7b on phase 7's model; returns its launch counts."""
    import torch

    from cmfrec_torch.models import cmf as tcmf
    from cmfrec_torch.solvers import warm

    X, _ = _new_user_coo(test_users, tr_r, tr_c, tr_v, LFM_M, LFM_N)
    if not tcmf._route_grouped(X.row, len(test_users)):
        raise AssertionError("phase 7b: the batch would not take the "
                             "degree-grouped route")
    calls = []
    real = _spy(warm, "factors_implicit_grouped", calls)
    _reset_launches(ops)
    try:
        imodel.factors_multiple(X=X)
        a, s = _timed_s(lambda: imodel.factors_multiple(X=X))
    finally:
        warm.factors_implicit_grouped = real
    if calls != ["factors_implicit_grouped"] * 2 or not np.isfinite(a).all():
        raise AssertionError(f"phase 7b: factors_multiple took {calls}")
    Ad, Bd = imodel._device_x_factors()
    A_fold = Ad.clone()
    A_fold[torch.as_tensor(test_users, device=Ad.device)] = torch.as_tensor(
        a, device=Ad.device)
    p10_fold = ranking_quality(A_fold, Bd, tr_r, tr_c, te_r, te_c,
                               test_users, LFM_N)[0]
    X256 = X.tocsr()[:SERVE_CHECK].tocoo()
    cpu_err = _rel(imodel.factors_multiple(X=X256),
                   _cpu_twin(imodel).factors_multiple(X=X256))
    launches = _read_launches(ops)
    print(f"phase 7b implicit warm serving: {len(test_users)} held-out "
          f"users, {X.nnz} plays, factors_multiple (grouped) {s:.3f} s = "
          f"{len(test_users) / s:.0f} users/s; fold-in P@10 {p10_fold:.5f} "
          f"(bound {P10_BOUND:.5f}; fitted rows {p10:.5f}, tol "
          f"{FOLDIN_P10_TOL}); card vs CPU {cpu_err:.2e} (limit "
          f"{SERVE_CPU_TOL['7b']:.1e}); launches {launches}", flush=True)
    if any(launches.values()):
        raise AssertionError("phase 7b: serving launched a fit kernel")
    if cpu_err > SERVE_CPU_TOL["7b"]:
        raise AssertionError("phase 7b: card and CPU disagree")
    if not (p10_fold >= P10_BOUND and abs(p10_fold - p10) <= FOLDIN_P10_TOL):
        raise AssertionError("phase 7b: fold-in P@10 out of bounds")
    return launches, p10_fold


def _cold_closed_form(Cf, colmeans, S, w, lam):
    """numpy f64: (w C^T C + lam I)^-1 w C^T (s - colmeans) for each row s."""
    C = Cf.astype(np.float64)
    T = np.linalg.solve(w * C.T @ C + lam * np.eye(C.shape[1]), w * C.T)
    return (S - colmeans[None, :]) @ T.T


def serve_cold(ops, model, U, I):
    """Phase 11b on phase 11's model (dense U and I); returns its launch
    counts."""
    lam = float(model.lambda_)  # phase 11 fits one scalar lambda
    # scale_lam implies scale_lam_sideinfo: cold solves scale lambda by the
    # side-info column count
    if not model.scale_lam_sideinfo:
        raise AssertionError("phase 11b: the model should scale lambda by "
                             "the side-info column count")
    rng = np.random.default_rng(22)
    users = rng.choice(M, COLD_ROWS, replace=False)
    Us = U[users]
    _reset_launches(ops)
    model.factors_multiple(U=Us)
    a, s = _timed_s(lambda: model.factors_multiple(U=Us))
    a_np = _cold_closed_form(model.C_, model.U_colmeans_, Us, model.w_user,
                             lam * SIDE_P)
    errs = {"factors_multiple": _rel(a, a_np)}
    errs["factors_cold"] = max(_rel(model.factors_cold(U=Us[i]), a_np[i])
                               for i in range(4))
    B = model.B_.astype(np.float64)
    ib = model.item_bias_.astype(np.float64)
    items = rng.integers(0, N, COLD_ROWS)
    p_np = model.glob_mean_ + ib[items] + np.sum(a_np * B[items], axis=1)
    errs["predict_cold_multiple"] = _rel(
        model.predict_cold_multiple(items, U=Us), p_np)
    topn = 0.0
    for i in range(4):
        got, scores = model.topN_cold(n=10, U=Us[i], output_score=True)
        want = model.glob_mean_ + ib + B @ a_np[i]
        _check_topn(got, scores, [], "phase 11b: topN_cold")
        topn = max(topn, _rel(scores, want[got]),
                   float(np.sort(want)[-10] - scores.min()) / np.abs(want).max())
    errs["topN_cold"] = topn
    # factors_warm with U on a fully observed row: the BeTBeChol path
    x = 3.5 + 0.5 * rng.normal(size=N)
    stats = model.__dict__.setdefault("_cache_stats", {})
    before = stats.get("bechol", 0)
    aw, bw = model.factors_warm(X=x, U=Us[0], return_bias=True)
    if stats.get("bechol", 0) != before + 1:
        raise AssertionError("phase 11b: factors_warm did not take BeTBeChol")
    ext = np.column_stack([B, np.ones(N)])
    Ce = np.column_stack([model.C_.astype(np.float64), np.zeros(SIDE_P)])
    # one scalar lambda on every coordinate, the bias's too, times the
    # row's multiplier: its N ratings and SIDE_P side-info entries
    G = (model.w_main * ext.T @ ext + model.w_user * Ce.T @ Ce
         + lam * (N + SIDE_P) * np.eye(model.k + 1))
    rhs = (model.w_main * ext.T @ (x - model.glob_mean_ - ib)
           + model.w_user * Ce.T @ (Us[0] - model.U_colmeans_))
    sol = np.linalg.solve(G, rhs)
    errs["factors_warm (BeTBeChol)"] = _rel(np.append(aw, bw), sol)
    # new items from their side info
    new_items = I[rng.choice(N, SERVE_CHECK, replace=False)]
    b_np = _cold_closed_form(model.D_, model.I_colmeans_, new_items,
                             model.w_item, lam * SIDE_P)
    errs["item_factors_cold"] = _rel(model.item_factors_cold(I=new_items[0]),
                                     b_np[0])
    A = model.A_.astype(np.float64)
    ub = model.user_bias_.astype(np.float64)
    us = users[:SERVE_CHECK]
    pn = model.glob_mean_ + ub[us] + np.sum(A[us] * b_np, axis=1)
    errs["predict_new"] = _rel(model.predict_new(us, I=new_items), pn)
    got, scores = model.topN_new(int(us[0]), I=new_items, n=10,
                                 output_score=True)
    want = model.glob_mean_ + ub[us[0]] + b_np @ A[us[0]]
    errs["topN_new"] = max(_rel(scores, want[got]),
                           float(np.sort(want)[-10] - scores.min())
                           / np.abs(want).max())
    # the same calls on the CPU copy
    twin = _cpu_twin(model)
    cpu_err = max(
        _rel(model.factors_multiple(U=Us[:SERVE_CHECK]),
             twin.factors_multiple(U=Us[:SERVE_CHECK])),
        _rel(np.append(aw, bw), np.append(*twin.factors_warm(
            X=x, U=Us[0], return_bias=True))),
        _rel(model.predict_new(us, I=new_items),
             twin.predict_new(us, I=new_items)))
    launches = _read_launches(ops)
    shown = ", ".join(f"{key} {v:.2e}" for key, v in errs.items())
    print(f"phase 11b cold serving: {COLD_ROWS} U rows, factors_multiple(U=) "
          f"{s:.4f} s = {COLD_ROWS / s:.0f} users/s; against the numpy "
          f"closed forms (tol {SERVE_ORACLE_TOL:.1e}): {shown}; card vs CPU "
          f"{cpu_err:.2e} (limit {SERVE_CPU_TOL['11b']:.1e}); launches "
          f"{launches}",
          flush=True)
    if any(launches.values()):
        raise AssertionError("phase 11b: serving launched a fit kernel")
    if (max(errs.values()) > SERVE_ORACLE_TOL
            or cpu_err > SERVE_CPU_TOL["11b"]):
        raise AssertionError("phase 11b: cold serving disagrees")
    return launches


def collective_phases(ops, rows, cols, vals, test):
    """Phases 10-13; returns each fit's launch counts by phase."""
    import torch

    import cmfrec_torch

    tr = ~test
    train = (rows[tr], cols[tr], vals[tr], M, N)
    base = float(np.sqrt(np.mean((vals[tr].mean() - vals[test]) ** 2)))
    paths = {}

    def rmse_of(model):
        pred = model.predict(rows[test], cols[test])
        if not np.all(np.isfinite(pred)):
            raise AssertionError("non-finite predictions")
        return float(np.sqrt(np.mean((pred - vals[test]) ** 2)))

    # 10. the flagship configuration with implicit features, CG and exact
    for tag, kw, bound_ in (
            ("10a", {}, RMSE_BOUND_CG_IMPLICIT_FEAT),
            ("10b", {"use_cg": False}, RMSE_BOUND_CHOL_IMPLICIT_FEAT)):
        model, launches, s, peak = _fit_phase(ops, lambda: cmfrec_torch.CMF(
            **{**COLLECTIVE_FIT, **kw}, device="cuda").fit_triplets(*train))
        rmse = rmse_of(model)
        want = dict(EXPECTED_LAUNCHES)
        if tag == "10b":  # the all-frozen exit sets K1's count
            want["masked_gram_matvec"] = launches["masked_gram_matvec"]
        print(f"phase {tag} implicit features (use_cg={model.use_cg}): "
              f"{s:.3f} s, peak device memory {peak / 2**30:.2f} GiB, "
              f"held-out RMSE {rmse:.5f} (bound {bound_:.5f}, global-mean "
              f"baseline {base:.5f}), Ai_ {model.Ai_.shape} Bi_ "
              f"{model.Bi_.shape}, launches {launches} (expected {want})",
              flush=True)
        if launches != want or launches["masked_gram_matvec"] <= 30:
            raise AssertionError(f"phase {tag} did not run the expected "
                                 "kernel launches")
        if not (rmse <= bound_ and np.isfinite(model.Ai_).all()
                and np.isfinite(model.Bi_).all()):
            raise AssertionError(f"phase {tag}: RMSE out of bounds")
        paths[tag] = launches
        del model
        torch.cuda.empty_cache()

    # 11. dense side info
    U = np.random.default_rng(11).normal(size=(M, SIDE_P))
    I = np.random.default_rng(12).normal(size=(N, SIDE_P))
    model, launches, s, peak = _fit_phase(ops, lambda: cmfrec_torch.CMF(
        **FIT, device="cuda").fit_triplets(*train, U=U, I=I))
    rmse = rmse_of(model)
    shapes = (model.C_.shape, model.D_.shape, model.U_colmeans_.shape,
              model.I_colmeans_.shape)
    print(f"phase 11 side info U {U.shape} I {I.shape}: {s:.3f} s, peak "
          f"device memory {peak / 2**30:.2f} GiB, held-out RMSE {rmse:.5f} "
          f"(bound {RMSE_BOUND:.5f}), C_ D_ colmeans {shapes}, launches "
          f"{launches} (expected {EXPECTED_LAUNCHES})", flush=True)
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError("phase 11 did not run the expected launches")
    if not (rmse <= RMSE_BOUND and rmse < base
            and shapes == ((SIDE_P, FIT["k"]), (SIDE_P, FIT["k"]),
                           (SIDE_P,), (SIDE_P,))
            and np.isfinite(model.C_).all() and np.isfinite(model.D_).all()):
        raise AssertionError("phase 11: RMSE or side factors out of bounds")
    paths["11"] = launches
    # 11b. cold serving: new users and new items from side info
    paths["11b"] = serve_cold(ops, model, U, I)
    del model
    torch.cuda.empty_cache()

    paths.update(implicit_phases(ops, U))
    return paths


def implicit_phases(ops, U):
    """Phases 12-13 on make_preference_data's pairs; returns each fit's
    launch counts by phase."""
    import torch

    import cmfrec_torch
    from cmfrec_torch.solvers import drivers

    t0 = time.perf_counter()
    rows, cols, vals = make_preference_data(**PREF)
    test = np.random.default_rng(8).uniform(size=rows.size) < PREF_HELDOUT
    tr = ~test
    train = (rows[tr], cols[tr], vals[tr], M, N)
    te_r, te_c = rows[test], cols[test]
    users = np.random.default_rng(5).choice(np.unique(te_r), RANK_USERS,
                                            replace=False)
    print(f"data: {M} x {N} implicit with preference structure, train "
          f"{int(tr.sum())}, held out {int(test.sum())}, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    quality, paths = {}, {}

    def ranking(A, B):
        return ranking_quality(A, B, rows[tr], cols[tr], te_r, te_c, users, N)

    # 12. the dense engine, against the bucketed engine that CMF_implicit's
    # engine="auto" takes on the same data
    res, launches, s, peak = _fit_phase(
        ops, lambda: drivers.fit_implicit_als(*train, engine="dense",
                                              device="cuda", **IMPLICIT_FIT))
    quality["dense"] = ranking(res["A"], res["B"])
    del res
    torch.cuda.empty_cache()
    print(f"phase 12 dense implicit: {s:.3f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB, P@10 {quality['dense'][0]:.5f}, MAP@10 "
          f"{quality['dense'][1]:.5f}, launches {launches} (expected "
          f"{EXPECTED_DENSE_IMPLICIT})", flush=True)
    if launches != EXPECTED_DENSE_IMPLICIT:
        raise AssertionError("phase 12: engine='dense' did not run the "
                             "expected launches")
    paths["12"] = launches
    imodel, blaunches, s, peak = _fit_phase(
        ops, lambda: cmfrec_torch.CMF_implicit(
            **IMPLICIT_FIT, device="cuda").fit_triplets(*train))
    quality["bucketed"] = ranking(*imodel._device_x_factors())
    del imodel
    torch.cuda.empty_cache()
    want = {"masked_gram_matvec": 0, "masked_rhs": 0,
            "bucket_cg": IMPLICIT_FIT["niter"] * (n_chunks(rows[tr], M)
                                                  + n_chunks(cols[tr], N))}
    print(f"phase 12 bucketed implicit (CMF_implicit, engine 'auto'): "
          f"{s:.3f} s, peak device memory {peak / 2**30:.2f} GiB, P@10 "
          f"{quality['bucketed'][0]:.5f}, MAP@10 "
          f"{quality['bucketed'][1]:.5f}, launches {blaunches} (expected "
          f"{want}); popularity P@10 {quality['dense'][2]:.5f}", flush=True)
    if blaunches != want:
        raise AssertionError("phase 12: CMF_implicit did not take the "
                             "bucketed engine")
    paths["12 bucketed"] = blaunches

    # 13. collective implicit, with phase 11's U
    cmodel, launches, s, peak = _fit_phase(
        ops, lambda: cmfrec_torch.CMF_implicit(
            **IMPLICIT_FIT, device="cuda").fit_triplets(*train, U=U))
    quality["collective"] = ranking(*cmodel._device_x_factors())
    print(f"phase 13 collective implicit U {U.shape}: {s:.3f} s, peak device "
          f"memory {peak / 2**30:.2f} GiB, P@10 "
          f"{quality['collective'][0]:.5f}, C_ {cmodel.C_.shape}, launches "
          f"{launches} (expected {EXPECTED_DENSE_IMPLICIT})", flush=True)
    if launches != EXPECTED_DENSE_IMPLICIT:
        raise AssertionError("phase 13 did not run the expected launches")
    if not np.isfinite(cmodel.C_).all():
        raise AssertionError("phase 13: non-finite C_")
    paths["13"] = launches
    del cmodel
    torch.cuda.empty_cache()
    p_dense, p_pop = quality["dense"][0], quality["dense"][2]
    for name, (p10, _, _) in quality.items():
        if not (p10 > p_pop and abs(p10 - p_dense) <= P10_ENGINE_TOL):
            raise AssertionError(f"phases 12-13: the {name} fit's P@10 "
                                 f"{p10:.5f} is out of bounds (dense "
                                 f"{p_dense:.5f}, popularity {p_pop:.5f})")
    return paths



# --------------------------------------------------------------------- #
# phases 14-16: the bucketed collective route                           #
# --------------------------------------------------------------------- #

# phase 14's side info, at the shape of MovieLens 10M (the synthetic
# ratings have none; drawn from a seeded generator, not downloaded):
# tags.dat's vocabulary, the 4,009 users who tagged (about 24 tag
# applications each), and movies.dat's genres (1-6 an item)
TAG_P = 15000
TAG_USERS = 4009
TAG_MEAN = 24
SIDE_ONLY_USERS = 2000  # users with tags and no ratings (m_u > m)
GENRES = 20
GENRE_COUNT_P = (0.35, 0.33, 0.19, 0.09, 0.03, 0.01)  # 1-6 genres an item
# phase 15's: Last.fm-360K's usersha1-profile.tsv as a one-hot of gender
# (2), age bucket (8) and country (239); 15% of users carry no field
PROFILE_FIELDS = (2, 8, 239)
NO_PROFILE = 0.15
# max|K3 over the stacked parts - rowsolve.solve_cg over the separate
# parts| / max|a| of phase 14's multi-part check (f32 summation order)
MULTIPART_TOL = 1e-4
DEPTH_16 = 3  # phase 16's iterations


def make_user_tags(seed=14):
    """U [M + SIDE_ONLY_USERS, TAG_P]: tag-application counts (1-10, mostly
    1) of TAG_USERS rated users and SIDE_ONLY_USERS users without ratings,
    tags drawn Zipf-like over the vocabulary, missing entries missing."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    taggers = np.concatenate([np.sort(rng.choice(M, TAG_USERS, replace=False)),
                              M + np.arange(SIDE_ONLY_USERS)])
    counts = np.minimum(rng.geometric(1.0 / TAG_MEAN, taggers.size), TAG_P)
    zipf = 1.0 / np.arange(1, TAG_P + 1)
    tags = rng.choice(TAG_P, int(counts.sum()), p=zipf / zipf.sum())
    pairs = np.unique(np.repeat(taggers, counts) * TAG_P + tags)
    r, c = pairs // TAG_P, pairs % TAG_P
    v = np.minimum(rng.geometric(0.7, r.size), 10).astype(np.float64)
    return sp.csr_matrix((v, (r, c)), shape=(M + SIDE_ONLY_USERS, TAG_P))


def make_item_genres(seed=15):
    """I [N, GENRES]: a one-hot of 1-6 genres an item."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    n_g = rng.choice(np.arange(1, 7), N, p=GENRE_COUNT_P)
    order = np.argsort(rng.random((N, GENRES)), axis=1)
    c = order[np.arange(GENRES)[None, :] < n_g[:, None]]
    return sp.csr_matrix((np.ones(c.size), (np.repeat(np.arange(N), n_g), c)),
                         shape=(N, GENRES))


def make_profiles(seed=16):
    """U [LFM_M, sum(PROFILE_FIELDS)]: a one-hot of one value a field for
    the users with a profile (countries Zipf-like)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    users = np.nonzero(rng.random(LFM_M) >= NO_PROFILE)[0]
    g, a, c = PROFILE_FIELDS
    zipf = 1.0 / np.arange(1, c + 1)
    cols = np.stack([rng.integers(0, g, users.size),
                     g + rng.integers(0, a, users.size),
                     g + a + rng.choice(c, users.size, p=zipf / zipf.sum())],
                    axis=1).ravel()
    return sp.csr_matrix((np.ones(cols.size), (np.repeat(users, 3), cols)),
                         shape=(LFM_M, g + a + c))


def _side_tuple(S):
    """A sparse side matrix as _BaseModel._ingest_side gives it."""
    coo = S.tocoo()
    return (coo.row.astype(np.int64), coo.col.astype(np.int64),
            coo.data.astype(np.float64), S.shape[0], S.shape[1], False, None)


class _Route:
    """Records which collective route each fit takes, and the K3 launches
    of each side's half-steps (the rows of the updated side: A, B, C, D),
    those of half-steps with several sparse parts apart."""

    def __init__(self, sides):
        from cmfrec_torch.solvers import collective

        self.sides, self.bucketed, self.k3 = sides, 0, {}
        self._mod = collective
        self._real = {}

    def __enter__(self):
        from cmfrec_torch.ops import sparse_cg

        mod = self._mod

        def body(name):
            real = self._real[name] = getattr(mod, name)

            def wrapped(*a, **kw):
                self.bucketed += 1
                return real(*a, **kw)
            return wrapped

        def update_side(plan, *a, **kw):
            before = sparse_cg.bucket_cg.launches
            out = self._real["update_side"](plan, *a, **kw)
            side = self.sides[plan.bucketed.n_rows]
            if kw.get("extra_parts") is not None:
                side += " (several parts)"
            n = sparse_cg.bucket_cg.launches - before
            if n:
                self.k3[side] = self.k3.get(side, 0) + n
            return out

        for name in ("_fit_collective_explicit_bucketed",
                     "_fit_collective_implicit_bucketed"):
            setattr(mod, name, body(name))
        self._real["update_side"] = mod.update_side
        mod.update_side = update_side
        return self

    def __exit__(self, *exc):
        for name, fn in self._real.items():
            setattr(self._mod, name, fn)

    @property
    def name(self):
        return "bucketed" if self.bucketed else "dense"


def _cuda_ms(fn, reps=5):
    """Mean CUDA-event time of fn() in ms (after one warm-up call)."""
    import torch

    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_multipart(model, tr_r, tr_c, tr_v, Ucsr):
    """K3 over the stacked parts of phase 14's real A buckets (the X part
    and the tag part) and over its C buckets (the tags' single part),
    against rowsolve.solve_cg over the separate parts, on the card, from a
    seeded random start; CUDA-event times of each A bucket's stacked
    launch beside K3 on its X part alone."""
    import torch

    from cmfrec_torch.data.device_fill import (build_bucketed_pair,
                                               build_bucketed_rows)
    from cmfrec_torch.ops import rowsolve, sparse_cg
    from cmfrec_torch.solvers import als, collective, drivers

    dev = "cuda"
    k, lam = model.k, float(model.lambda_)
    K = -(-(k + 1) // 8) * 8
    m_eff = Ucsr.shape[0]
    S = collective.prepare_side(_side_tuple(Ucsr), model.center_U)
    vals_c = (tr_v - model.glob_mean_).astype(np.float32)
    RB, _ = build_bucketed_pair(tr_r, tr_c, vals_c, M, N, device=dev,
                                m_eff=m_eff)
    aligned = collective.build_aligned_parts(RB, *S.coo, S.n_ent, dev)
    opp = torch.zeros(N, K, device=dev)
    opp[:, :k] = torch.as_tensor(model.B_, device=dev)
    opp[:, k] = 1.0
    ob = torch.as_tensor(model.item_bias_, device=dev)
    Ce = torch.zeros(TAG_P, K, device=dev)
    Ce[:, :k] = torch.as_tensor(model.C_, device=dev)
    mat = torch.cat([opp, Ce])
    lam_vec = drivers._make_lam_vec(k, K, lam, lam, True, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(141)
    plain = None

    def run(parts, stacked, modes, n_totals, twin=True):
        """(K3, twin, start) for one bucket's parts, with the lambda
        multiplier of the fit (scale_lam, which implies
        scale_lam_sideinfo: every part's entries count)."""
        sparse = [als._coefficients(p, md) for p, md in zip(parts, modes)]
        mult = torch.clamp(sum(als._lam_multiplier(p, md, nt) for p, md, nt
                                   in zip(parts, modes, n_totals)), min=1.0)
        a0 = 0.1 * torch.randn(mult.shape[0], parts[0].opp.shape[1],
                               generator=gen, device=dev)
        lam_v = lam_vec[:parts[0].opp.shape[1]]
        lam_row = (lam_v[None, :] * mult[:, None]).contiguous()
        gfix = torch.zeros(lam_v.shape[0], lam_v.shape[0], device=dev)
        if stacked is None:
            sp, length = sparse[0], parts[0].length
        else:
            sp, length = als.stacked_part(sparse, *stacked), stacked[1].length

        def k3():
            return sparse_cg.bucket_cg(sp.mat, sp.idx, sp.cw, sp.cv, gfix,
                                       lam_row, None, a0, n_steps=K3_STEPS,
                                       length=length)
        nonlocal plain
        plain = (sparse, lam_v, a0, K3_STEPS, mult)
        want = rowsolve.solve_cg(*plain) if twin else None
        return k3, want, a0

    out = {"A": [], "C": []}
    err = {"A": [0.0, 0.0, 0.0], "C": [0.0, 0.0, 0.0]}  # err, max|a|, moved
    for b, (idx_s, val_s, len_s) in zip(RB.buckets, aligned):
        X = als.PartData(idx=b.idx, val=b.val, length=b.length, wgt=None,
                         opp=opp, opp_bias=ob, w=1.0, alpha=None, mu=None)
        Up = als.PartData(idx=idx_s, val=val_s, length=len_s, wgt=None,
                          opp=Ce, opp_bias=None, w=float(model.w_user),
                          alpha=None, mu=None)
        st = als.stack_slots((X, Up))
        k3, want, a0 = run((X, Up), (mat, st), ("explicit",) * 2, (N, TAG_P))
        got = k3()
        separate = plain  # the plain solve over the separate parts
        single = run((X,), None, ("explicit",), (N,), twin=False)[0]
        # the bound of phase 6's cost model (f32 slots, lam_row, no r0)
        real = rowsolve.length_mask(st.length, st.idx.shape[1])
        slots = int(st.length.sum())
        nbytes = (int(torch.unique(st.idx[real]).numel()) * K * 4
                  + slots * 12 + b.n_rows * (4 + 12 * K) + 4 * K * K)
        ops = slots * (2 * K + (1 + K3_STEPS) * 4 * K) + (
            b.n_rows * (1 + K3_STEPS) * 2 * K * K)
        e = err["A"]
        e[0] = max(e[0], float((got - want).abs().max()))
        e[1] = max(e[1], float(want.abs().max()))
        e[2] = max(e[2], float((want - a0).abs().max()))
        out["A"].append(dict(R=b.n_rows, L_x=b.width, L_u=idx_s.shape[1],
                             L_stacked=st.idx.shape[1], bytes=nbytes,
                             ops=ops,
                             ms=_cuda_ms(k3), single_ms=_cuda_ms(single),
                             plain_ms=_cuda_ms(lambda: rowsolve.solve_cg(
                                 *separate), reps=2)))
    featb = build_bucketed_rows(S.coo[1], S.coo[0], S.coo[2], TAG_P, m_eff,
                                device=dev)
    A1 = torch.zeros(m_eff, -(-k // 8) * 8, device=dev)
    A1[:, :k] = torch.as_tensor(model.A_, device=dev)
    for b in featb.buckets:
        part = als.PartData(idx=b.idx, val=b.val, length=b.length, wgt=None,
                            opp=A1, opp_bias=None, w=float(model.w_user),
                            alpha=None, mu=None)
        k3, want, a0 = run((part,), None, ("explicit",), (m_eff,))
        got = k3()
        e = err["C"]
        e[0] = max(e[0], float((got - want).abs().max()))
        e[1] = max(e[1], float(want.abs().max()))
        e[2] = max(e[2], float((want - a0).abs().max()))
        out["C"].append(dict(R=b.n_rows, L=b.width, ms=_cuda_ms(k3)))
    rel = {side: e[0] / e[1] for side, e in err.items()}
    moved = {side: e[2] / e[1] for side, e in err.items()}
    # A's stacked buckets as one set: summed times, and the bound of their
    # summed bytes and operations
    total = {key: sum(r[key] for r in out["A"])
             for key in ("ms", "single_ms", "plain_ms")}
    b_ms, b_by = bound(sum(r["bytes"] for r in out["A"]),
                       {"f32": sum(r["ops"] for r in out["A"])})
    for row in out["A"]:
        print(f"phase 14 multi-part K3: A bucket R={row['R']} L x {row['L_x']}"
              f" + tags {row['L_u']} -> stacked {row['L_stacked']}: "
              f"{row['ms']} ms (X part alone, width {row['L_x']}: "
              f"{row['single_ms']} ms)", flush=True)
    print(f"phase 14 multi-part K3, A's {len(out['A'])} stacked buckets: "
          f"{total['ms']} ms against {total['single_ms']} ms for their X "
          f"parts alone, plain solve_cg {total['plain_ms']} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    print(f"phase 14 multi-part K3 vs solve_cg over the separate parts: "
          f"max|err|/max|a| A {rel['A']:.2e}, C {rel['C']:.2e} (limit "
          f"{MULTIPART_TOL:.0e}); moved A {moved['A']:.2e} C "
          f"{moved['C']:.2e}; C buckets "
          f"{[(r['R'], r['L'], r['ms']) for r in out['C']]}", flush=True)
    if max(rel.values()) > MULTIPART_TOL:
        raise AssertionError("phase 14: K3 over stacked parts disagrees "
                             "with solve_cg over the separate parts")
    if min(moved.values()) < 10 * MULTIPART_TOL:
        raise AssertionError("phase 14: the multi-part check's steps did "
                             "not move their start")
    return dict(rel=rel, moved=moved, bound_ms=b_ms, bound_by=b_by,
                **total, A=out["A"], C=out["C"])


def _cold_sparse(Cf, cols, vals, w, lam):
    """numpy f64 cold factors of one sparse side-info row, its values
    centered: (w C_o^T C_o + lam I)^-1 w C_o^T u_o over its observed
    entries."""
    C = Cf[cols].astype(np.float64)
    G = w * C.T @ C + lam * np.eye(C.shape[1])
    return np.linalg.solve(G, w * C.T @ vals)


def serve_bucketed(ops, model, Ucsr, tr_r, tr_c, tr_v):
    """Phase 14b on phase 14's model: cold factors and topN from 2,000 tag
    rows as U_col/U_val, factors_warm with ratings and a sparse U row,
    predict for the side-only users, each against its numpy closed form
    and a CPU copy of the model; returns the launch counts."""
    lam = float(model.lambda_)
    w_u = float(model.w_user)
    # the fit centers U by each tag's mean over its observed entries, and
    # serving centers a new row's entries by the same means
    means = (np.zeros(Ucsr.shape[1]) if model.U_colmeans_ is None
             else np.asarray(model.U_colmeans_, np.float64))
    C = np.asarray(model.C_, np.float64)
    B = np.asarray(model.B_, np.float64)
    ib = np.asarray(model.item_bias_, np.float64)
    side_only = M + np.arange(SIDE_ONLY_USERS)
    rows_of = [(Ucsr.indices[Ucsr.indptr[u]:Ucsr.indptr[u + 1]],
                Ucsr.data[Ucsr.indptr[u]:Ucsr.indptr[u + 1]])
               for u in side_only]
    _reset_launches(ops)
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = np.stack([model.factors_cold(U_col=c, U_val=v) for c, v in rows_of])
    cold_s = time.perf_counter() - t0
    # scale_lam implies scale_lam_sideinfo: a cold row's lambda scales with
    # its side-info entries
    if not model.scale_lam_sideinfo:
        raise AssertionError("phase 14b: the model should scale lambda by "
                             "the side-info entries")
    want = np.stack([_cold_sparse(C, c, v - means[c], w_u, lam * c.size)
                     for c, v in rows_of])
    errs = {"factors_cold": _rel(got, want)}
    topn = 0.0
    for i in range(4):
        items, scores = model.topN_cold(n=10, U_col=rows_of[i][0],
                                        U_val=rows_of[i][1],
                                        output_score=True)
        full = model.glob_mean_ + ib + B @ want[i]
        _check_topn(items, scores, [], "phase 14b: topN_cold")
        topn = max(topn, _rel(scores, full[items]),
                   float(np.sort(full)[-10] - scores.min())
                   / np.abs(full).max())
    errs["topN_cold"] = topn
    # factors_warm: a tagging rated user's training ratings and tags
    taggers = np.unique(Ucsr.tocoo().row)
    u = int(taggers[taggers < M][0])
    sel = tr_r == u
    xc, xv = tr_c[sel], tr_v[sel]
    uc = Ucsr.indices[Ucsr.indptr[u]:Ucsr.indptr[u + 1]]
    uv = Ucsr.data[Ucsr.indptr[u]:Ucsr.indptr[u + 1]]
    aw, bw = model.factors_warm(X_col=xc, X_val=xv, U_col=uc, U_val=uv,
                                return_bias=True)
    k = model.k
    ext = np.column_stack([B[xc], np.ones(xc.size)])
    Ce = np.column_stack([C[uc], np.zeros(uc.size)])
    # one scalar lambda, the bias's too, times the row's ratings and tags
    G = (ext.T @ ext + w_u * Ce.T @ Ce
         + lam * (xc.size + uc.size) * np.eye(k + 1))
    rhs = (ext.T @ (xv - model.glob_mean_ - ib[xc])
           + w_u * Ce.T @ (uv - means[uc]))
    errs["factors_warm"] = _rel(np.append(aw, bw), np.linalg.solve(G, rhs))
    # predict for the side-only users
    rng = np.random.default_rng(141)
    items = rng.integers(0, N, side_only.size)
    A = np.asarray(model.A_, np.float64)
    ub = np.asarray(model.user_bias_, np.float64)
    p_np = (model.glob_mean_ + ub[side_only] + ib[items]
            + np.sum(A[side_only] * B[items], axis=1))
    pred = model.predict(side_only, items)
    errs["predict (side-only users)"] = _rel(pred, p_np)
    twin = _cpu_twin(model)
    cpu_err = max(
        _rel(got[:SERVE_CHECK], np.stack([
            twin.factors_cold(U_col=c, U_val=v)
            for c, v in rows_of[:SERVE_CHECK]])),
        _rel(np.append(aw, bw), np.append(*twin.factors_warm(
            X_col=xc, X_val=xv, U_col=uc, U_val=uv, return_bias=True))),
        _rel(pred, twin.predict(side_only, items)))
    launches = _read_launches(ops)
    shown = ", ".join(f"{key} {v:.2e}" for key, v in errs.items())
    print(f"phase 14b serving: factors_cold of {len(rows_of)} tag rows "
          f"(U_col/U_val) in {cold_s:.3f} s = {len(rows_of) / cold_s:.0f} "
          f"users/s; against the numpy closed forms (tol "
          f"{SERVE_ORACLE_TOL:.1e}): {shown}; card vs "
          f"CPU {cpu_err:.2e} (limit {SERVE_CPU_TOL['11b']:.1e}); launches "
          f"{launches}", flush=True)
    if any(launches.values()):
        raise AssertionError("phase 14b: serving launched a fit kernel")
    if (max(errs.values()) > SERVE_ORACLE_TOL
            or cpu_err > SERVE_CPU_TOL["11b"]):
        raise AssertionError("phase 14b: serving disagrees")
    return launches


def bucketed_collective_phases(ops, rows, cols, vals, test, lastfm, p10_7):
    """Phases 14-16; returns each fit's launch counts by phase."""
    import scipy.sparse as sp
    import torch

    import cmfrec_torch
    from cmfrec_torch.solvers import collective

    tr = ~test
    tr_r, tr_c, tr_v = rows[tr], cols[tr], vals[tr]
    base = float(np.sqrt(np.mean((tr_v.mean() - vals[test]) ** 2)))
    paths = {}

    def rmse_of(model):
        pred = model.predict(rows[test], cols[test])
        if not np.all(np.isfinite(pred)):
            raise AssertionError("non-finite predictions")
        return float(np.sqrt(np.mean((pred - vals[test]) ** 2)))

    # 14. collective explicit, bucketed: user tags with side-only users,
    # item genres under NA_as_zero_item
    t0 = time.perf_counter()
    U, I = make_user_tags(), make_item_genres()
    m_eff = U.shape[0]
    print(f"phase 14 data: U {U.shape} nnz {U.nnz} ({TAG_USERS} rated + "
          f"{SIDE_ONLY_USERS} side-only users), I {I.shape} nnz {I.nnz} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    n_b = {"A": n_chunks(tr_r, m_eff), "B": n_chunks(tr_c, N),
           "C": n_chunks(U.tocoo().col, TAG_P),
           "D": n_chunks(I.tocoo().col, GENRES)}
    sides = {M: "A", m_eff: "A", N: "B", TAG_P: "C", GENRES: "D"}
    fit14 = dict(FIT, NA_as_zero_item=True)

    def fit():
        return cmfrec_torch.CMF(**fit14, device="cuda").fit_triplets(
            tr_r, tr_c, tr_v, M, N, U=U, I=I)

    with _Route(sides) as route:
        fit()  # cold (layout built, kernels loaded)
    torch.cuda.synchronize()
    with _Route(sides) as route:
        model, launches, s, peak = _fit_phase(ops, fit)
    rmse = rmse_of(model)
    want = {"masked_gram_matvec": 0, "masked_rhs": 0,
            "bucket_cg": (FIT["niter"] - 1) * sum(n_b.values())}
    # centering U by each tag's observed mean zeroes a tag seen once (or
    # always with one count): a side-only user whose every tag is such has
    # no side information left, and its A row solves to zero
    centered = sp.csr_matrix(
        (U.data - model.U_colmeans_[U.indices], U.indices, U.indptr),
        shape=U.shape)
    informed = abs(centered[M:]).max(axis=1).toarray().ravel() > 0
    A_so = model.A_[M:][informed]
    print(f"phase 14 collective bucketed (U tags, I genres NA_as_zero_item):"
          f" route {route.name}, warm fit {s:.3f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB, held-out RMSE {rmse:.5f} (bound "
          f"{RMSE_BOUND:.5f}), C_ {model.C_.shape} D_ {model.D_.shape}, "
          f"A_ {model.A_.shape}, side-only users with a nonzero centered "
          f"tag row {A_so.shape[0]} of {SIDE_ONLY_USERS}, their rows finite "
          f"{bool(np.isfinite(A_so).all())} nonzero "
          f"{bool((np.abs(A_so).max(axis=1) > 0).all())}; K3 by side "
          f"{route.k3} (buckets {n_b}); launches {launches} (expected "
          f"{want})", flush=True)
    if route.name != "bucketed" or launches != want:
        raise AssertionError("phase 14 did not take the bucketed route with "
                             "the expected launches")
    if not (rmse <= RMSE_BOUND and model.C_.shape == (TAG_P, FIT["k"])
            and model.D_.shape == (GENRES, FIT["k"])
            and np.isfinite(model.C_).all() and np.isfinite(model.D_).all()
            and np.isfinite(model.A_).all() and A_so.shape[0] > 0
            and (np.abs(A_so).max(axis=1) > 0).all()):
        raise AssertionError("phase 14: RMSE or factors out of bounds")
    paths["14"] = launches
    multipart = check_multipart(model, tr_r, tr_c, tr_v, U)
    # 14b. serving on phase 14's model
    paths["14b"] = serve_bucketed(ops, model, U, tr_r, tr_c, tr_v)
    init = dict(A=model.A_, B=model.B_, C=model.C_, D=model.D_,
                biasA=model.user_bias_, biasB=model.item_bias_)
    del model
    torch.cuda.empty_cache()

    # 15. collective implicit, bucketed: LastFM-shaped plays with one-hot
    # profiles under NA_as_zero_user
    l_r, l_c, l_v, l_te_r, l_te_c, test_users = lastfm
    P = make_profiles()
    n_b15 = (n_chunks(l_r, LFM_M) + n_chunks(l_c, LFM_N)
             + n_chunks(P.tocoo().col, sum(PROFILE_FIELDS)))

    def ifit():
        return cmfrec_torch.CMF_implicit(
            **IMPLICIT_FIT, NA_as_zero_user=True, device="cuda"
        ).fit_triplets(l_r, l_c, l_v, LFM_M, LFM_N, U=P)

    ifit()
    torch.cuda.synchronize()
    with _Route({LFM_M: "A", LFM_N: "B", sum(PROFILE_FIELDS): "C"}) as route:
        imodel, launches, s, peak = _fit_phase(ops, ifit)
    Ad, Bd = imodel._device_x_factors()
    p10, map10, p10_pop = ranking_quality(Ad, Bd, l_r, l_c, l_te_r, l_te_c,
                                          test_users, LFM_N)
    want = {"masked_gram_matvec": 0, "masked_rhs": 0,
            "bucket_cg": IMPLICIT_FIT["niter"] * n_b15}
    print(f"phase 15 collective implicit bucketed (U profiles {P.shape} nnz "
          f"{P.nnz}, NA_as_zero_user): route {route.name}, warm fit "
          f"{s:.3f} s, peak device memory {peak / 2**30:.2f} GiB, P@10 "
          f"{p10:.5f} (bound {P10_BOUND:.5f}; phase 7 {p10_7:.5f}), MAP@10 "
          f"{map10:.5f}, popularity {p10_pop:.5f}, C_ finite "
          f"{bool(np.isfinite(imodel.C_).all())}; K3 by side {route.k3}; "
          f"launches {launches} (expected {want})", flush=True)
    if route.name != "bucketed" or launches != want:
        raise AssertionError("phase 15 did not take the bucketed route with "
                             "the expected launches")
    if not (p10 >= P10_BOUND and abs(p10 - p10_7) <= P10_ENGINE_TOL
            and np.isfinite(imodel.C_).all()):
        raise AssertionError("phase 15: P@10 out of bounds")
    paths["15"] = launches
    del imodel, Ad, Bd
    torch.cuda.empty_cache()

    # 16. the other bucketed branches at reduced depth (DEPTH_16 iterations)
    w = np.random.default_rng(16).uniform(0.5, 2.0, tr_r.size)
    short = dict(FIT, niter=DEPTH_16)
    cases = [
        ("k splits", dict(short, k_user=8, k_item=8, k_main=8),
         dict(U=U, I=I), True),
        ("w_main 0.5, weights", dict(short, w_main=0.5),
         dict(U=U, I=I, W=w), False),
        ("implicit features, weights",
         dict(short, add_implicit_features=True), dict(W=w), False),
        ("NA_as_zero", dict(short, NA_as_zero=True), dict(I=I), False),
    ]
    total = {}
    for tag, kw, data, with_rmse in cases:
        with _Route(sides) as route:
            model, launches, s, peak = _fit_phase(ops, lambda: (
                cmfrec_torch.CMF(**kw, device="cuda").fit_triplets(
                    tr_r, tr_c, tr_v, M, N, **data)))
        facs = [getattr(model, a) for a in ("A_", "B_", "C_", "D_", "Ai_",
                                            "Bi_") if getattr(model, a)
                is not None]
        finite = all(np.isfinite(f).all() for f in facs)
        rmse = rmse_of(model) if with_rmse else None
        print(f"phase 16 {tag}: route {route.name}, {s:.3f} s, K3 "
              f"{launches['bucket_cg']} by side {route.k3}, factors finite "
              f"{finite}" + ("" if rmse is None else
                             f", held-out RMSE {rmse:.5f} (global-mean "
                             f"baseline {base:.5f})"), flush=True)
        if route.name != "bucketed" or not finite or not launches[
                "bucket_cg"] or launches["masked_gram_matvec"]:
            raise AssertionError(f"phase 16 {tag}: not a finite bucketed fit")
        if with_rmse and not rmse < base:
            raise AssertionError(f"phase 16 {tag}: RMSE out of bounds")
        for key, v in launches.items():
            total[key] = total.get(key, 0) + v
        del model
    # a warm restart from phase 14's factors, through the driver
    with _Route(sides) as route:
        res, launches, s, peak = _fit_phase(
            ops, lambda: collective.fit_collective_explicit_als(
                tr_r, tr_c, tr_v, M, N, side_U=_side_tuple(U),
                side_I=_side_tuple(I), NA_as_zero_item=True, init=init,
                device="cuda", **short))
    finite = all(torch.isfinite(res[key]).all() for key in
                 ("A", "B", "C", "D", "biasA", "biasB"))
    print(f"phase 16 warm restart (init= A, B, C, D, biases of phase 14): "
          f"route {route.name}, {s:.3f} s, K3 {launches['bucket_cg']}, "
          f"factors finite {finite}", flush=True)
    if route.name != "bucketed" or not finite or not launches["bucket_cg"]:
        raise AssertionError("phase 16 warm restart: not a finite bucketed "
                             "fit")
    for key, v in launches.items():
        total[key] = total.get(key, 0) + v
    paths["16"] = total
    return paths, multipart


# --------------------------------------------------------------------- #
# phases 17-21: the L-BFGS family and the other models                   #
# --------------------------------------------------------------------- #

# phase 17: CMF(method="lbfgs") at phase 4's k and CMF's maxiter (800) and
# corr_pairs (4), with lambda 30: at CMF's default 10 the fit overfits
# (held-out RMSE 0.791 after 200 iterations, 0.848 after 800, 0.852 after
# 1600; train RMSE 0.546), at 30 it reads 0.778, at 100 0.794 (NVIDIA H100
# 80GB HBM3, 700 W; scripts/sweep_lbfgs_torch.py)
LBFGS_FIT = dict(k=50, method="lbfgs", lambda_=30.0)
# phase 18a: OMF_explicit's L-BFGS at phase 17's lambda, its maxiter
# (10,000) cut to CMF's 800
OMF_FIT = dict(k=50, method="lbfgs", lambda_=30.0, maxiter=800)
# phase 18b: the arguments of phase 4's fit that fit_offsets_als forwards
# (it forwards no scale_lam)
OMF_ALS_FIT = dict(k=50, lambda_=0.05, niter=15, use_cg=True, max_cg_steps=3,
                   finalize_chol=True, user_bias=True, item_bias=True,
                   center=True, method="als", use_float=True)
# phase 20: ContentBased at its defaults (k=20, start_with_ALS), its
# maxiter (3,000) cut to 800
CB_FIT = dict(maxiter=800)
CB_ALS_NITER = 5  # ContentBased's start_with_ALS iterations
CB_MARGIN = 0.02  # phase 20's RMSE at least this far below the baseline
ATTR_NOISE = 0.5  # sd of the noise on phases 18a and 20's attributes
NEW_GENRE_ROWS = 256  # phase 17b's cold item rows
CB_NEW_ROWS = 2000  # phase 20's new attribute rows
# the dense-engine launches of an ALS fit with CG and the f32 polish:
# (niter - 1) x 2 half-steps x (1 + 3 CG steps) + 2 x (1 + 16); K2 one a
# half-step


def dense_launches(niter):
    return {"masked_gram_matvec": (niter - 1) * 2 * 4 + 2 * 17,
            "masked_rhs": 2 * niter, "bucket_cg": 0}


NO_LAUNCHES = {"masked_gram_matvec": 0, "masked_rhs": 0, "bucket_cg": 0}
# phase 17: the card's f32 objective and gradient at the fit's result
# against the CPU's f64 evaluation; 17b: the objective alone
LBFGS_F32_TOL = 1e-4
LBFGS_F32_OBJ_TOL = 1e-5
BIN_CPU_TOL = 1e-3  # 17b: factors_bin_batch card vs CPU, of max|a|
OMF_AM_TOL = 1e-5  # 18a: Am_ against construct_Am(A_, U C_ + C_bias_)
OMF_CPU_TOL = {"18a": 1e-5, "19b": 1e-4}  # card vs CPU, of max|a|
ALS_AGREE_TOL = 1e-5  # 18b: fit_offsets_als against fit_explicit_als
P10_OMF_TOL = 0.005  # 19: |P@10 - phase 7's|
MP_BIAS_TOL = 1e-12  # 21: card vs CPU biases (f64 sums in another order)
MP_P10_TOL = 0.01  # 21: |P@10 - phase 7's popularity P@10|
# the degree groups of phase 18a's serving: rows x largest degree at most
SLOT_BUDGET = 1 << 22


def make_ml10m_attributes():
    """U [M, 13] and I [N, 13] that carry the ratings' signal: replays the
    draws of bench.make_ml10m_shaped(seed=0) (bench.py:26-54) to recover
    its true factors and biases A, B [., 12] and bA, bB, checks that the
    replay gives the cached ratings exactly, and returns U = [A | bA] and
    I = [B | bB], each with N(0, ATTR_NOISE^2) noise added.  Cached in
    build/ next to the ratings."""
    from bench import _cached, make_ml10m_shaped
    from cmfrec_torch.ops import _cuda

    path = _cuda.BUILD_DIR / "ml10m_attributes.npz"
    if path.exists():
        with np.load(path) as z:
            return z["U"], z["I"]
    rows, cols, vals = _cached(make_ml10m_shaped,
                               str(_cuda.BUILD_DIR / "ml10m_shaped.npz"))
    m, n, nnz = M, N, ML10M_NNZ
    rng = np.random.default_rng(0)
    item_p = 1.0 / np.arange(1, n + 1) ** 0.8
    item_p /= item_p.sum()
    user_p = 1.0 / np.arange(1, m + 1) ** 0.55
    user_p /= user_p.sum()
    r = rng.choice(m, size=int(nnz * 1.25), p=user_p)
    c = rng.choice(n, size=int(nnz * 1.25), p=item_p)
    pairs = np.unique(r.astype(np.int64) * n + c)
    rng.shuffle(pairs)
    pairs = pairs[:nnz]
    r, c = (pairs // n).astype(np.int64), (pairs % n).astype(np.int64)
    A = rng.normal(size=(m, 12)).astype(np.float32) * 0.35
    B = rng.normal(size=(n, 12)).astype(np.float32) * 0.35
    bA = (rng.normal(size=m) * 0.4).astype(np.float32)
    bB = (rng.normal(size=n) * 0.4).astype(np.float32)
    v = (3.5 + bA[r] + bB[c] + np.einsum("nk,nk->n", A[r], B[c])
         + 0.7 * rng.normal(size=r.size).astype(np.float32))
    v = np.clip(np.round(v * 2) / 2, 0.5, 5.0).astype(np.float64)
    if not (np.array_equal(r, rows) and np.array_equal(c, cols)
            and np.array_equal(v, vals)):
        raise AssertionError("the replay of make_ml10m_shaped does not give "
                             "the cached ratings")
    noise = np.random.default_rng(18)
    U = np.column_stack([A, bA]) + ATTR_NOISE * noise.normal(size=(m, 13))
    I = np.column_stack([B, bB]) + ATTR_NOISE * noise.normal(size=(n, 13))
    np.savez(path, U=U, I=I)
    return U, I


def _new_genre_rows(R, seed=17):
    """R one-hot genre rows, drawn as make_item_genres draws its items'."""
    rng = np.random.default_rng(seed)
    n_g = rng.choice(np.arange(1, 7), R, p=GENRE_COUNT_P)
    order = np.argsort(rng.random((R, GENRES)), axis=1)
    return (order < n_g[:, None]).astype(np.float64)


def _timed_fns(module, names, totals):
    """Wrap module.name for each name so that its host seconds add up in
    ``totals``; returns the functions to put back."""
    real = {}
    for name in names:
        fn = real[name] = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                totals[_name] = totals.get(_name, 0.0) + (
                    time.perf_counter() - t0)
        setattr(module, name, wrapped)
    return real


def _lbfgs_stats(model, what):
    """Iterations, evaluations and host syncs of an L-BFGS fit, and the
    check that its objective trace does not rise between chunks (by more
    than the approximate-Wolfe allowance, 1e-6 of |f| a step)."""
    st = model.fit_stats_
    ends = np.asarray(st["values"][24::25], np.float64)
    rise = float(np.max(np.diff(ends) / np.abs(ends[:-1]), initial=0.0))
    if rise > 25e-6 or not np.isfinite(ends).all():
        raise AssertionError(f"{what}: the objective rose between chunks by "
                             f"{rise:.2e} of |f|")
    return (f"{len(st['values'])} iterations, {st['n_evals']} evaluations, "
            f"{st['host_syncs']} host syncs, f {st['values'][0]:.6g} -> "
            f"{st['values'][-1]:.6g} (largest rise between chunks "
            f"{rise:.1e})")


def lbfgs_family_phases(ops, rows, cols, vals, test, lastfm, ctx):
    """Phases 21, 17, 17b, 18a, 18b, 19, 19b and 20; returns each one's
    launch counts.  ``ctx``: rmse_4 (phase 4's held-out RMSE), p10_7 and
    p10_pop_7 (phase 7's P@10 and its popularity baseline), p10_7b (phase
    7b's fold-in P@10), n_buckets_7 (phase 7's layout)."""
    import torch

    import cmfrec_torch
    from cmfrec_torch.solvers import drivers, lbfgs, offsets, warm

    tr = ~test
    tr_r, tr_c, tr_v = rows[tr], cols[tr], vals[tr]
    base = float(np.sqrt(np.mean((tr_v.mean() - vals[test]) ** 2)))
    l_r, l_c, l_v, l_te_r, l_te_c, test_users = lastfm
    paths = {}

    def rmse_of(model):
        pred = model.predict(rows[test], cols[test])
        if not np.all(np.isfinite(pred)):
            raise AssertionError("non-finite predictions")
        return float(np.sqrt(np.mean((pred - vals[test]) ** 2)))

    def mem(peak):
        return f"peak device memory {peak / 2**30:.2f} GiB"

    # 21. MostPopular: explicit with user biases on phase 4's split, then
    # implicit on phase 7's; each against a CPU fit
    mp, launches, s, peak = _fit_phase(ops, lambda: cmfrec_torch.MostPopular(
        user_bias=True, device="cuda").fit_triplets(tr_r, tr_c, tr_v, M, N))
    mp_cpu = cmfrec_torch.MostPopular(user_bias=True, device="cpu"
                                      ).fit_triplets(tr_r, tr_c, tr_v, M, N)
    rmse_mp = rmse_of(mp)
    mp_err = max(_rel(mp.item_bias_, mp_cpu.item_bias_),
                 _rel(mp.user_bias_, mp_cpu.user_bias_))
    ones = torch.ones(LFM_M, 1, device="cuda")

    def p10_by(bias):
        return ranking_quality(
            ones, torch.as_tensor(bias, dtype=torch.float32,
                                  device="cuda")[:, None],
            l_r, l_c, l_te_r, l_te_c, test_users, LFM_N)[0]

    # implicit, at its defaults and with apply_log_transf; each against
    # its CPU fit and against the numpy closed form's ranking
    # (src/common.c:5804-5809), the log one against popularity
    lp = {}
    for log in (False, True):
        kw = dict(implicit=True, apply_log_transf=log)
        imp, ilaunches, s_i, _ = _fit_phase(
            ops, lambda: cmfrec_torch.MostPopular(**kw, device="cuda"
                                                  ).fit_triplets(
                l_r, l_c, l_v, LFM_M, LFM_N))
        cpu_bias = cmfrec_torch.MostPopular(**kw, device="cpu").fit_triplets(
            l_r, l_c, l_v, LFM_M, LFM_N).item_bias_
        v = np.log(l_v) if log else l_v
        S = np.bincount(l_c, weights=v + 1.0, minlength=LFM_N)
        cnt = np.bincount(l_c, minlength=LFM_N)
        a, lam = float(imp.alpha), float(imp.lambda_)
        formula = a * S / (a * S + (LFM_M - cnt) + lam)
        lp[log] = dict(s=s_i, launches=ilaunches, p10=p10_by(imp.item_bias_),
                       p10_formula=p10_by(formula),
                       err=max(_rel(imp.item_bias_, cpu_bias),
                               _rel(imp.item_bias_, formula)))
    print(f"phase 21 MostPopular: explicit (user_bias) fit {s:.3f} s, "
          f"{mem(peak)}, held-out RMSE {rmse_mp:.5f} (global-mean baseline "
          f"{base:.5f}), card vs CPU biases {mp_err:.1e} (limit "
          f"{MP_BIAS_TOL:.0e}); implicit fit {lp[False]['s']:.3f} s, P@10 "
          f"{lp[False]['p10']:.5f} (the closed form's ranking "
          f"{lp[False]['p10_formula']:.5f}: raw plays, summed, rank the "
          f"few heavy listeners' items first), with apply_log_transf "
          f"{lp[True]['p10']:.5f} (phase 7's popularity "
          f"{ctx['p10_pop_7']:.5f}, tol {MP_P10_TOL}); implicit biases card "
          f"vs CPU and vs the closed form {lp[False]['err']:.1e} / "
          f"{lp[True]['err']:.1e}; launches {launches} / "
          f"{lp[False]['launches']} / {lp[True]['launches']}", flush=True)
    if launches != NO_LAUNCHES or any(v["launches"] != NO_LAUNCHES
                                      for v in lp.values()):
        raise AssertionError("phase 21 launched a fit kernel")
    if not (rmse_mp < base and mp_err <= MP_BIAS_TOL
            and all(v["err"] <= MP_BIAS_TOL
                    and abs(v["p10"] - v["p10_formula"]) <= 1e-4
                    for v in lp.values())
            and abs(lp[True]["p10"] - ctx["p10_pop_7"]) <= MP_P10_TOL):
        raise AssertionError("phase 21: MostPopular out of bounds")
    paths["21"] = {key: launches[key] + sum(v["launches"][key]
                                            for v in lp.values())
                   for key in launches}
    del ones

    # 17. CMF(method="lbfgs") on phase 4's split
    model, launches, s, peak = _fit_phase(ops, lambda: cmfrec_torch.CMF(
        **LBFGS_FIT, device="cuda").fit_triplets(tr_r, tr_c, tr_v, M, N))
    rmse = rmse_of(model)
    stats = _lbfgs_stats(model, "phase 17")
    params = {"A": model.A_, "B": model.B_, "biasA": model.user_bias_,
              "biasB": model.item_bias_}
    prob_kw = dict(k=LBFGS_FIT["k"], lambda_=model.lambda_)
    t0 = time.perf_counter()
    card = lbfgs.CollectiveProblem(tr_r, tr_c, tr_v, M, N, dtype=np.float32,
                                   device="cuda", **prob_kw)
    vd, gd = card.value_and_grad(card.init_params(1, params))
    del card
    cpu = lbfgs.CollectiveProblem(tr_r, tr_c, tr_v, M, N, dtype=np.float64,
                                  device="cpu", **prob_kw)
    vc, gc = cpu.value_and_grad(cpu.init_params(1, params))
    del cpu
    f_err = abs(float(vd) - float(vc)) / abs(float(vc))
    # the gradient as one vector, as L-BFGS uses it: ||card - CPU|| /
    # ||CPU||; and, for information, each block's max|card - CPU| /
    # max|CPU|, which near the optimum divides f32 rounding by a small
    # max|g| (1.7e-5 at lambda 10, 1.0e-4 at 30)
    diff = {key: gd[key].cpu().double() - gc[key] for key in gc}
    g_err = float(np.sqrt(sum(float(torch.sum(d * d)) for d in diff.values())
                          / sum(float(torch.sum(g * g)) for g in gc.values())))
    g_max = {key: f"{float(diff[key].abs().max() / gc[key].abs().max()):.1e}"
             for key in gc}
    del gd, gc, diff
    print(f"phase 17 CMF(method='lbfgs', k={LBFGS_FIT['k']}, lambda "
          f"{LBFGS_FIT['lambda_']}): fit {s:.3f} s, "
          f"{mem(peak)}, {stats}; held-out RMSE {rmse:.5f} (bar: phase 21's "
          f"MostPopular {rmse_mp:.5f}; phase 4's flagship {ctx['rmse_4']:.5f});"
          f" at the result the card's f32 objective vs the CPU's f64 "
          f"{f_err:.1e}, gradient {g_err:.1e} of ||g|| (limit "
          f"{LBFGS_F32_TOL:.0e}; by block, of max|g|: {g_max}; evaluated in "
          f"{time.perf_counter() - t0:.1f} s); launches {launches}",
          flush=True)
    if launches != NO_LAUNCHES:
        raise AssertionError("phase 17 launched a fit kernel")
    if not (rmse < rmse_mp and f_err <= LBFGS_F32_TOL
            and g_err <= LBFGS_F32_TOL):
        raise AssertionError("phase 17: out of bounds")
    paths["17"] = launches
    del model
    torch.cuda.empty_cache()

    # 17b. the same with binary item side info (phase 14's genres, 0/1)
    Ib = make_item_genres().toarray()
    model, launches, s, peak = _fit_phase(ops, lambda: cmfrec_torch.CMF(
        **LBFGS_FIT, device="cuda").fit_triplets(tr_r, tr_c, tr_v, M, N,
                                                 I_bin=Ib))
    rmse = rmse_of(model)
    stats = _lbfgs_stats(model, "phase 17b")
    params = {"A": model.A_, "B": model.B_, "biasA": model.user_bias_,
              "biasB": model.item_bias_, "Db": model.Db_}
    side_Ib = (None, None, None, N, GENRES, True, Ib)
    with torch.no_grad():
        vd = float(lbfgs.CollectiveProblem(
            tr_r, tr_c, tr_v, M, N, side_Ib=side_Ib, dtype=np.float32,
            device="cuda", **prob_kw).loss(
                {key: torch.as_tensor(np.asarray(v, np.float32),
                                      device="cuda")
                 for key, v in params.items()}))
        vc = float(lbfgs.CollectiveProblem(
            tr_r, tr_c, tr_v, M, N, side_Ib=side_Ib, dtype=np.float64,
            device="cpu", **prob_kw).loss(
                {key: torch.as_tensor(np.asarray(v, np.float64))
                 for key, v in params.items()}))
    f_err = abs(vd - vc) / abs(vc)
    G = _new_genre_rows(NEW_GENRE_ROWS)
    _reset_launches(ops)
    cold = dict(idx=np.zeros((NEW_GENRE_ROWS, 0), np.int64),
                vals=np.zeros((NEW_GENRE_ROWS, 0)), wgt=None,
                lengths=np.zeros(NEW_GENRE_ROWS, np.int64), U_bin=G,
                cold=True)
    sw = model.swap_users_and_items(precompute=False)
    b, s_b = _timed_s(lambda: warm.factors_bin_batch(sw, **cold))
    b_cpu = warm.factors_bin_batch(
        _cpu_twin(model).swap_users_and_items(precompute=False), **cold)
    b_err = _rel(b, b_cpu)
    one_err = _rel(model.item_factors_cold(I_bin=G[0]), b_cpu[0])
    slaunches = _read_launches(ops)
    print(f"phase 17b CMF(method='lbfgs') + I_bin genres {Ib.shape}: fit "
          f"{s:.3f} s, {mem(peak)}, {stats}; held-out RMSE {rmse:.5f} (bar "
          f"{rmse_mp:.5f}); Db_ {model.Db_.shape} finite "
          f"{bool(np.isfinite(model.Db_).all())}; objective card f32 vs CPU "
          f"f64 {f_err:.1e} (limit {LBFGS_F32_OBJ_TOL:.0e}); "
          f"factors_bin_batch of {NEW_GENRE_ROWS} new genre rows {s_b:.3f} s, "
          f"card vs CPU {b_err:.1e}, item_factors_cold of row 0 {one_err:.1e} "
          f"(limit {BIN_CPU_TOL:.0e}); launches {launches}, serving "
          f"{slaunches}", flush=True)
    if launches != NO_LAUNCHES or slaunches != NO_LAUNCHES:
        raise AssertionError("phase 17b launched a fit kernel")
    if not (model.Db_.shape == (GENRES, LBFGS_FIT["k"])
            and np.isfinite(model.Db_).all() and rmse < rmse_mp
            and f_err <= LBFGS_F32_OBJ_TOL and b_err <= BIN_CPU_TOL
            and one_err <= BIN_CPU_TOL):
        raise AssertionError("phase 17b: out of bounds")
    paths["17b"] = {key: launches[key] + slaunches[key] for key in launches}
    del model, sw
    torch.cuda.empty_cache()

    # 18a. OMF_explicit's L-BFGS with the attributes that carry signal
    t0 = time.perf_counter()
    Ua, Ia = make_ml10m_attributes()
    print(f"phase 18 data: U {Ua.shape}, I {Ia.shape} (true factors and "
          f"biases + N(0, {ATTR_NOISE}^2)) in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    omf, launches, s, peak = _fit_phase(ops, lambda: cmfrec_torch.OMF_explicit(
        **OMF_FIT, device="cuda").fit_triplets(tr_r, tr_c, tr_v, M, N, U=Ua,
                                               I=Ia))
    rmse = rmse_of(omf)
    stats = _lbfgs_stats(omf, "phase 18a")
    UC = (Ua - omf.U_colmeans_[None, :]) @ omf.C_ + omf.C_bias_
    am_err = _rel(omf.Am_, offsets.construct_Am(omf.A_, UC, 0, OMF_FIT["k"],
                                                0, 1.0))
    # phase 5b's users, in groups of similar degree
    users = np.sort(np.random.default_rng(21).choice(
        np.unique(tr_r), SERVE_USERS, replace=False))
    X, _ = _new_user_coo(users, tr_r, tr_c, tr_v, M, N)
    X = X.tocsr()
    deg = np.diff(X.indptr)
    order = np.argsort(deg, kind="stable")
    groups, start = [], 0
    while start < order.size:
        stop = start + 1
        while (stop < order.size
               and (stop + 1 - start) * deg[order[stop]] <= SLOT_BUDGET):
            stop += 1
        groups.append(order[start:stop])
        start = stop

    def dense_rows(sel):
        Xd = np.full((sel.size, N), np.nan)
        sub = X[sel].tocoo()
        Xd[sub.row, sub.col] = sub.data
        return Xd

    dense = [dense_rows(g) for g in groups]
    _reset_launches(ops)
    calls = []
    real = _spy(warm, "offsets_warm_batch", calls)
    try:
        omf.factors_warm_multiple(dense[0][:8])
        out, s_w = _timed_s(lambda: [omf.factors_warm_multiple(Xd)
                                     for Xd in dense])
    finally:
        warm.offsets_warm_batch = real
    twin = _cpu_twin(omf)
    check = dense[0][:SERVE_CHECK]
    w_err = _rel(omf.factors_warm_multiple(check),
                 twin.factors_warm_multiple(check))
    slaunches = _read_launches(ops)
    print(f"phase 18a OMF_explicit(method='lbfgs', k={OMF_FIT['k']}, maxiter "
          f"{OMF_FIT['maxiter']}, float64): fit {s:.3f} s, {mem(peak)}, "
          f"{stats}; held-out RMSE {rmse:.5f} (bar: phase 21's "
          f"{rmse_mp:.5f}); Am_ vs construct_Am(A_, U C_ + C_bias_) "
          f"{am_err:.1e} (limit {OMF_AM_TOL:.0e}); factors_warm_multiple of "
          f"phase 5b's {SERVE_USERS} users in {len(groups)} degree groups "
          f"{s_w:.3f} s = {SERVE_USERS / s_w:.0f} users/s, finite "
          f"{all(np.isfinite(a).all() for a in out)}; card vs CPU "
          f"{w_err:.1e} (limit {OMF_CPU_TOL['18a']:.0e}); launches "
          f"{launches}, serving {slaunches}", flush=True)
    if launches != NO_LAUNCHES or slaunches != NO_LAUNCHES:
        raise AssertionError("phase 18a launched a fit kernel")
    if not (rmse < rmse_mp and am_err <= OMF_AM_TOL
            and w_err <= OMF_CPU_TOL["18a"]
            and len(calls) == len(groups) + 1
            and all(np.isfinite(a).all() for a in out)):
        raise AssertionError("phase 18a: out of bounds")
    paths["18a"] = {key: launches[key] + slaunches[key] for key in launches}
    del omf, twin, out, dense
    torch.cuda.empty_cache()

    # 18b. OMF_explicit(method="als"): phase 4's arguments through the
    # public model, then fit_offsets_als against drivers.fit_explicit_als,
    # both from one init
    omf, launches, s, peak = _fit_phase(ops, lambda: cmfrec_torch.OMF_explicit(
        **OMF_ALS_FIT, device="cuda").fit_triplets(tr_r, tr_c, tr_v, M, N,
                                                   U=Ua, I=Ia))
    rmse = rmse_of(omf)
    del omf
    gen = np.random.default_rng(19)
    k = OMF_ALS_FIT["k"]
    init = {"A": (0.1 * gen.normal(size=(M, k))).astype(np.float32),
            "B": (0.1 * gen.normal(size=(N, k))).astype(np.float32)}
    als_kw = {key: OMF_ALS_FIT[key] for key in (
        "k", "lambda_", "niter", "use_cg", "max_cg_steps", "finalize_chol",
        "user_bias", "item_bias", "center")}
    res = offsets.fit_offsets_als(
        tr_r, tr_c, tr_v, M, N, side_U=(None, None, None, M, 13, True, Ua),
        side_I=(None, None, None, N, 13, True, Ia), init=init,
        device="cuda", **als_kw)
    drv = drivers.fit_explicit_als(tr_r, tr_c, tr_v, M, N, init=init,
                                   device="cuda", **als_kw)
    agree = max(_rel(res["Am"], drv["A"].cpu().numpy()),
                _rel(res["Bm"], drv["B"].cpu().numpy()))
    Ud = Ua - res["U_colmeans"][None, :]
    reg_err = _rel(res["A"], res["Am"] - Ud @ res["C"] - res["C_bias"])
    want = dense_launches(OMF_ALS_FIT["niter"])
    print(f"phase 18b OMF_explicit(method='als', phase 4's k, lambda, "
          f"niter, CG, polish): fit {s:.3f} s, {mem(peak)}, held-out RMSE "
          f"{rmse:.5f} (no bar: fit_offsets_als forwards no scale_lam); "
          f"fit_offsets_als vs fit_explicit_als from one init {agree:.1e}, "
          f"A = Am - U C - C_bias {reg_err:.1e} (limit {ALS_AGREE_TOL:.0e}); "
          f"launches {launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError("phase 18b did not run the expected launches")
    if not (agree <= ALS_AGREE_TOL and reg_err <= ALS_AGREE_TOL
            and np.isfinite(rmse)):
        raise AssertionError("phase 18b: out of bounds")
    paths["18b"] = launches
    del res, drv
    torch.cuda.empty_cache()

    # 19. OMF_implicit on phase 7's split with phase 15's profiles
    P = make_profiles()
    host = {}
    real = _timed_fns(offsets, ("densify_side", "_regress_side"), host)
    try:
        iomf, launches, s, peak = _fit_phase(
            ops, lambda: cmfrec_torch.OMF_implicit(
                **IMPLICIT_FIT, use_float=True, device="cuda").fit_triplets(
                    l_r, l_c, l_v, LFM_M, LFM_N, U=P))
    finally:
        for name, fn in real.items():
            setattr(offsets, name, fn)
    Am_d, Bm_d = iomf._device_x_factors()
    p10, map10, _ = ranking_quality(Am_d, Bm_d, l_r, l_c, l_te_r, l_te_c,
                                    test_users, LFM_N)
    want = {"masked_gram_matvec": 0, "masked_rhs": 0,
            "bucket_cg": IMPLICIT_FIT["niter"] * ctx["n_buckets_7"]}
    print(f"phase 19 OMF_implicit (phase 7's hyperparameters, U profiles "
          f"{P.shape}): fit {s:.3f} s (host: densify_side "
          f"{host.get('densify_side', 0):.3f} s, _regress_side "
          f"{host.get('_regress_side', 0):.3f} s), {mem(peak)}, P@10 "
          f"{p10:.5f} (bound {P10_BOUND:.5f}; phase 7 {ctx['p10_7']:.5f}, tol "
          f"{P10_OMF_TOL}), MAP@10 {map10:.5f}, C_ {iomf.C_.shape}; launches "
          f"{launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError("phase 19 did not run the expected launches")
    if not (p10 >= P10_BOUND and abs(p10 - ctx["p10_7"]) <= P10_OMF_TOL
            and np.isfinite(iomf.C_).all()):
        raise AssertionError("phase 19: P@10 out of bounds")
    paths["19"] = launches

    # 19b. phase 7b's held-out users through factors_warm_multiple
    Xh, _ = _new_user_coo(test_users, l_r, l_c, l_v, LFM_M, LFM_N)
    _reset_launches(ops)
    iomf.factors_warm_multiple(Xh.tocsr()[:8])
    a, s_w = _timed_s(lambda: iomf.factors_warm_multiple(Xh))
    A_fold = Am_d.clone()
    A_fold[torch.as_tensor(test_users, device="cuda")] = torch.as_tensor(
        a, dtype=A_fold.dtype, device="cuda")
    p10_fold = ranking_quality(A_fold, Bm_d, l_r, l_c, l_te_r, l_te_c,
                               test_users, LFM_N)[0]
    X256 = Xh.tocsr()[:SERVE_CHECK].tocoo()
    w_err = _rel(iomf.factors_warm_multiple(X256),
                 _cpu_twin(iomf).factors_warm_multiple(X256))
    slaunches = _read_launches(ops)
    print(f"phase 19b OMF_implicit warm serving: {len(test_users)} held-out "
          f"users, {Xh.nnz} plays, factors_warm_multiple {s_w:.3f} s = "
          f"{len(test_users) / s_w:.0f} users/s; fold-in P@10 {p10_fold:.5f} "
          f"(phase 7b {ctx['p10_7b']:.5f}, tol {FOLDIN_P10_TOL}); card vs CPU "
          f"{w_err:.1e} (limit {OMF_CPU_TOL['19b']:.0e}); launches "
          f"{slaunches}", flush=True)
    if slaunches != NO_LAUNCHES:
        raise AssertionError("phase 19b: serving launched a fit kernel")
    if not (abs(p10_fold - ctx["p10_7b"]) <= FOLDIN_P10_TOL
            and w_err <= OMF_CPU_TOL["19b"]):
        raise AssertionError("phase 19b: out of bounds")
    paths["19b"] = slaunches
    del iomf, Am_d, Bm_d, A_fold
    torch.cuda.empty_cache()

    # 20. ContentBased at its defaults (maxiter cut) on the attributes
    cb, launches, s, peak = _fit_phase(ops, lambda: cmfrec_torch.ContentBased(
        **CB_FIT, device="cuda").fit_triplets(tr_r, tr_c, tr_v, M, N, U=Ua,
                                              I=Ia))
    rmse = rmse_of(cb)
    stats = _lbfgs_stats(cb, "phase 20")
    want = dense_launches(CB_ALS_NITER)
    rng = np.random.default_rng(20)
    Un = Ua[rng.choice(M, CB_NEW_ROWS, replace=False)]
    In = Ia[rng.choice(N, CB_NEW_ROWS)]
    _reset_launches(ops)
    cb.predict_new(Un[:8], In[:8])
    pn, s_p = _timed_s(lambda: cb.predict_new(Un, In))
    t0 = time.perf_counter()
    tops = [cb.topN_new(n=10, U=u, I=Ia, output_score=True) for u in Un]
    s_t = time.perf_counter() - t0
    twin = _cpu_twin(cb)
    p_err = _rel(pn, twin.predict_new(Un, In))
    t_err = max(_rel(tops[i][1], twin.topN_new(n=10, U=Un[i], I=Ia,
                                                output_score=True)[1])
                for i in range(SERVE_TOPN))
    slaunches = _read_launches(ops)
    print(f"phase 20 ContentBased (k={cb.k}, start_with_ALS, maxiter "
          f"{CB_FIT['maxiter']}): fit {s:.3f} s, {mem(peak)}, {stats}; "
          f"held-out RMSE {rmse:.5f} (bar: baseline {base:.5f} - "
          f"{CB_MARGIN}); predict_new {CB_NEW_ROWS} pairs {s_p * 1e3:.1f} ms, "
          f"topN_new over {N} new items {CB_NEW_ROWS / s_t:.0f} users/s; "
          f"card vs CPU {max(p_err, t_err):.1e} (limit 1e-05); launches "
          f"{launches} (expected {want}), serving {slaunches}", flush=True)
    if launches != want or slaunches != NO_LAUNCHES:
        raise AssertionError("phase 20 did not run the expected launches")
    if not (rmse <= base - CB_MARGIN and p_err <= 1e-5 and t_err <= 1e-5):
        raise AssertionError("phase 20: out of bounds")
    paths["20"] = launches
    paths["20b"] = slaunches
    return paths


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import cmfrec_torch
    from bench import _cached, make_ml10m_shaped
    from bench_implicit import make_lastfm_shaped, split_heldout
    from cmfrec_torch.data.device_fill import build_bucketed_pair
    from cmfrec_torch.ops import _cuda, k1_probes, sparse_cg
    from cmfrec_torch.ops import masked_matmul as mm
    from cmfrec_torch.solvers import drivers
    from scripts.sweep_k1_probes_torch import sweep

    ops = {"masked_gram_matvec": mm.masked_gram_matvec,
           "masked_rhs": mm.masked_rhs, "bucket_cg": sparse_cg.bucket_cg}
    probe_ops = {w.__name__: w for w in k1_probes.WRAPPERS}

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path, log = _cuda.build()
    _cuda.lib()
    print(f"build: {lib_path.name} from {[str(s.name) for s in _cuda.SOURCES]}"
          f" for sm_90a in {time.perf_counter() - t0:.2f} s", flush=True)
    print(log, file=sys.stderr)
    report = ptxas_report(log)
    for fn, regs, st, ld in report:
        print(f"ptxas: {fn}: {regs} registers, spill stores {st} B, spill "
              f"loads {ld} B", flush=True)
    if not report:
        print("ptxas: no report (the library was already built)", flush=True)

    t0 = time.perf_counter()
    rows, cols, vals = _cached(make_ml10m_shaped,
                               str(_cuda.BUILD_DIR / "ml10m_shaped.npz"))
    test = np.random.default_rng(1).uniform(size=rows.size) < 0.05
    tr = ~test
    weights = np.random.default_rng(2).uniform(0.5, 2.0, size=int(tr.sum()))
    print(f"data: {M} x {N}, nnz={rows.size} (train {int(tr.sum())}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels against their plain twins
    results = check_kernels(rows[tr], cols[tr], vals[tr], weights)
    torch.cuda.empty_cache()

    # 4. the flagship fit through the public entry point
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(ops)
    _reset_launches(probe_ops)
    t0 = time.perf_counter()
    model = cmfrec_torch.CMF(**FIT, device="cuda").fit_triplets(
        rows[tr], cols[tr], vals[tr], M, N)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = _read_launches(ops)
    fit_probe_launches = _read_launches(probe_ops)
    peak = torch.cuda.max_memory_allocated()
    pred = model.predict(rows[test], cols[test])
    rmse = float(np.sqrt(np.mean((pred - vals[test]) ** 2)))
    base = float(np.sqrt(np.mean((vals[tr].mean() - vals[test]) ** 2)))
    print(f"fit: {fit_s:.3f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB, held-out RMSE {rmse:.5f} "
          f"(bound {RMSE_BOUND:.5f}, global-mean baseline {base:.5f}), "
          f"launches {launches} (expected {EXPECTED_LAUNCHES})", flush=True)
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError("the fit did not run the expected kernel launches")
    if not (np.all(np.isfinite(pred)) and rmse <= RMSE_BOUND and rmse < base):
        raise AssertionError("held-out RMSE out of bounds")

    # 5. serving
    oracle = (model.glob_mean_ + model.user_bias_[rows[test]].astype(np.float64)
              + model.item_bias_[cols[test]]
              + np.einsum("nk,nk->n", model.A_[rows[test]].astype(np.float64),
                          model.B_[cols[test]]))
    pred_err = float(np.abs(pred - oracle).max())
    t0 = time.perf_counter()
    model.predict(rows[test], cols[test])
    predict_ms = (time.perf_counter() - t0) * 1e3
    users = np.random.default_rng(3).choice(np.unique(rows[tr]), 8,
                                            replace=False)
    topn_ms = []
    for u in users:
        seen = cols[tr][rows[tr] == u]
        t0 = time.perf_counter()
        items, scores = model.topN(u, n=10, exclude=seen, output_score=True)
        topn_ms.append((time.perf_counter() - t0) * 1e3)
        if (len(items) != 10 or np.isin(items, seen).any()
                or not np.all(np.isfinite(scores))
                or np.any(np.diff(scores) > 0)):
            raise AssertionError(f"topN for user {u} is wrong: {items}")
    print(f"serving: predict {test.sum()} pairs in {predict_ms:.1f} ms, "
          f"max |predict - numpy formula| {pred_err:.2e} (tol 1e-4); "
          f"topN(n=10, exclude=seen) for {len(users)} users, median "
          f"{np.median(topn_ms):.2f} ms each", flush=True)
    if pred_err > 1e-4:
        raise AssertionError("predict disagrees with the numpy formula")

    # 5b. explicit warm serving of new users
    serving = {"5b": serve_explicit(ops, model, rows, cols, vals, test)}
    del model
    torch.cuda.empty_cache()

    # 6. K3 against its twin on the LastFM-shaped bucket layout
    t0 = time.perf_counter()
    lrows, lcols, lvals = _cached(make_lastfm_shaped,
                                  str(_cuda.BUILD_DIR / "lastfm_shaped.npz"))
    tr_r, tr_c, tr_v, te_r, te_c, test_users = split_heldout(
        lrows, lcols, lvals, LFM_M)
    del lrows, lcols, lvals
    print(f"data: {LFM_M} x {LFM_N}, train {tr_r.size}, held out "
          f"{te_r.size} of {len(test_users)} users in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    k_pad = -(-IMPLICIT_FIT["k"] // 8) * 8
    RB, CB = build_bucketed_pair(tr_r, tr_c, tr_v, LFM_M, LFM_N,
                                 device="cuda")
    n_buckets = len(RB.buckets) + len(CB.buckets)
    print(f"layout: {len(RB.buckets)} + {len(CB.buckets)} buckets, widths "
          f"A {[b.width for b in RB.buckets]} B {[b.width for b in CB.buckets]}",
          flush=True)
    k3 = check_bucket_cg({"A": (RB, LFM_N), "B": (CB, LFM_M)}, k_pad)
    del RB, CB
    torch.cuda.empty_cache()

    # 7. the implicit WRMF fit through the public entry point
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(ops)
    t0 = time.perf_counter()
    imodel = cmfrec_torch.CMF_implicit(**IMPLICIT_FIT, device="cuda")
    imodel.fit_triplets(tr_r, tr_c, tr_v, LFM_M, LFM_N)
    torch.cuda.synchronize()
    ifit_s = time.perf_counter() - t0
    ilaunches = _read_launches(ops)
    ipeak = torch.cuda.max_memory_allocated()
    want = {"masked_gram_matvec": 0, "masked_rhs": 0,
            "bucket_cg": IMPLICIT_FIT["niter"] * n_buckets}
    Ad, Bd = imodel._device_x_factors()
    p10, map10, p10_pop = ranking_quality(Ad, Bd, tr_r, tr_c, te_r, te_c,
                                          test_users, LFM_N)
    print(f"implicit fit: {ifit_s:.3f} s, peak device memory "
          f"{ipeak / 2**30:.2f} GiB, P@10 {p10:.5f} (bound {P10_BOUND:.5f}), "
          f"MAP@10 {map10:.5f}, popularity P@10 {p10_pop:.5f}, launches "
          f"{ilaunches} (expected {want})", flush=True)
    if ilaunches != want:
        raise AssertionError("the implicit fit did not run the expected "
                             "kernel launches")
    if not (np.isfinite(imodel.A_).all() and np.isfinite(imodel.B_).all()
            and p10 >= P10_BOUND and p10 >= 2 * p10_pop):
        raise AssertionError("implicit ranking quality out of bounds")
    users = np.random.default_rng(4).choice(test_users, 8, replace=False)
    for u in users:
        seen = tr_c[tr_r == u]
        items, scores = imodel.topN(u, n=10, exclude=seen, output_score=True)
        if (len(items) != 10 or np.isin(items, seen).any()
                or not np.all(np.isfinite(scores))
                or np.any(np.diff(scores) > 0)):
            raise AssertionError(f"implicit topN for user {u} is wrong")
    print(f"implicit serving: topN(n=10, exclude=seen) for {len(users)} "
          "users: ok", flush=True)
    # 7b. implicit warm serving of the held-out users
    serving["7b"], p10_fold = serve_implicit(ops, imodel, p10, tr_r, tr_c,
                                             tr_v, te_r, te_c, test_users)
    del imodel, Ad, Bd
    torch.cuda.empty_cache()

    # 8. the explicit fit of phase 4 on the bucketed engine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(ops)
    t0 = time.perf_counter()
    res = drivers.fit_explicit_als(rows[tr], cols[tr], vals[tr], M, N,
                                   engine="sparse", device="cuda", **FIT)
    torch.cuda.synchronize()
    sfit_s = time.perf_counter() - t0
    slaunches = _read_launches(ops)
    speak = torch.cuda.max_memory_allocated()
    want = {"masked_gram_matvec": 0, "masked_rhs": 0,
            "bucket_cg": (FIT["niter"] - 1) * (n_chunks(rows[tr], M)
                                              + n_chunks(cols[tr], N))}
    rt, ct = (torch.as_tensor(a[test], device="cuda") for a in (rows, cols))
    spred = (res["glob_mean"] + res["biasA"][rt] + res["biasB"][ct]
             + (res["A"][rt] * res["B"][ct]).sum(dim=1)).cpu().numpy()
    srmse = float(np.sqrt(np.mean((spred - vals[test]) ** 2)))
    print(f"explicit bucketed fit: {sfit_s:.3f} s, peak device memory "
          f"{speak / 2**30:.2f} GiB, held-out RMSE {srmse:.5f} (bound "
          f"{RMSE_BOUND:.5f}), launches {slaunches} (expected {want})",
          flush=True)
    if slaunches != want:
        raise AssertionError("the bucketed explicit fit did not run the "
                             "expected kernel launches")
    if not (np.all(np.isfinite(spred)) and srmse <= RMSE_BOUND):
        raise AssertionError("bucketed explicit RMSE out of bounds")

    # 9. K1's probes against their plain versions, then the probe sweep
    probes, library = check_k1_probes(rows[tr], cols[tr], vals[tr], weights)
    _reset_launches(probe_ops)
    t0 = time.perf_counter()
    swept = list(sweep(PROBE_SWEEP_REPS))
    plaunches = _read_launches(probe_ops)
    print(f"probe sweep: {len(swept)} records in "
          f"{time.perf_counter() - t0:.1f} s, launches {plaunches} (fit "
          f"{fit_probe_launches})", flush=True)
    if not all(plaunches.values()) or any(fit_probe_launches.values()):
        raise AssertionError("the probe sweep did not launch every probe "
                             "kernel, or the fit launched one")

    # 10-13. the collective and dense implicit fits
    paths = {"4": launches, "5b": serving["5b"], "7": ilaunches,
             "7b": serving["7b"], "8": slaunches}
    paths.update(collective_phases(ops, rows, cols, vals, test))

    # 14-16. the bucketed collective route
    bpaths, multipart = bucketed_collective_phases(
        ops, rows, cols, vals, test, (tr_r, tr_c, tr_v, te_r, te_c,
                                      test_users), p10)
    paths.update(bpaths)

    # 17-21. the L-BFGS family, the offsets models, ContentBased and
    # MostPopular
    paths.update(lbfgs_family_phases(
        ops, rows, cols, vals, test,
        (tr_r, tr_c, tr_v, te_r, te_c, test_users),
        dict(rmse_4=rmse, p10_7=p10, p10_pop_7=p10_pop, p10_7b=p10_fold,
             n_buckets_7=n_buckets)))

    kernels = []
    for name, variants in results.items():
        main_variant = next(v for v in variants if v["side"] == "A"
                            and v["op"] == "bf16" and v["W"] == "int8")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            cuda_kernels=CUDA_KERNELS[name],
            replaces=REPLACES[name], launches=launches[name],
            launches_by_phase={ph: c[name] for ph, c in paths.items()},
            max_abs_err=max(v["max_abs_err"] for v in variants),
            ms=main_variant["ms"], plain_ms=main_variant["plain_ms"],
            bound_ms=main_variant["bound_ms"],
            bound_by=main_variant["bound_by"], library_ms=None,
            variants=variants))
    # K3 at the main path's shapes: one implicit iteration's launches (every
    # bucket of both sides, bf16), summed
    main = [r for r in k3
            if r["op"] == "bf16" and r["mode"] == "implicit-log"]
    k3_bound, k3_by = bound(sum(r["bytes"] for r in main),
                            {op: sum(r["ops"][op] for r in main)
                             for op in ("bf16", "f32")})
    kernels.append(dict(
        name="bucket_cg", route="cuda", source=SOURCES["bucket_cg"],
        cuda_kernels=CUDA_KERNELS["bucket_cg"],
        replaces=REPLACES["bucket_cg"], launches=ilaunches["bucket_cg"],
        launches_by_phase={ph: c["bucket_cg"] for ph, c in paths.items()},
        max_abs_err=max(r["max_abs_err"] for r in k3),
        ms=sum(r["ms"] for r in main),
        plain_ms=sum(r["plain_ms"] for r in main), bound_ms=k3_bound,
        bound_by=k3_by, library_ms=None, variants=k3,
        multipart_check=multipart))
    # the probes: the sweep's launches (the fit's in fit_launches), times at
    # the A side of phase 9 for the row's headline variant
    for row, variants in probes.items():
        head = next(v for v in variants
                    if v["side"] == "A" and v["name"] == PROBE_HEADLINE[row])
        kernels.append(dict(
            name=f"k1_probes_{row}", route="cuda",
            source="cmfrec_torch/csrc/k1_probes.cu",
            replaces=PROBE_REPLACES[row],
            launches=sum(plaunches[w] for w in PROBE_WRAPPERS[row]),
            fit_launches=sum(fit_probe_launches[w]
                             for w in PROBE_WRAPPERS[row]),
            max_abs_err=max(v["max_abs_err"] for v in variants),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=library["A"] if row == "p3" else None,
            variants=variants))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
