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
     3b: K1 with f32 operands on the row lists (masked_gram_matvec_rows,
     csrc/masked_rows.cu) at both sides on the int8 mask and on the f32
     weights: the lists' build, errors against the dense f32 K1 and the
     twin, two calls bitwise equal, CUDA-event times beside the dense K1's;
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
     RMSE and launches K1 112, its row-list form 34 (the f32 polish) / K2
     30; (b) the same with use_cg=False (exact mode), RMSE and K2 30, K1 on
     the row lists printed (its all-frozen exit makes it depend on the
     data);
 11. the flagship configuration with dense side info U [M, 32] and I
     [N, 32] from a seeded generator: RMSE, C_/D_ [32, 50] finite, the
     column means stored, launches K1 112 + 34 on the row lists / K2 30;
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

Float64 and Jacobi PCG (no kernel of their own: the plain dense engine
solvers/dense_engine.py, the bucketed engine's plain solves, float64
serving), each printing seconds, peak device memory, the card's name and
power limit, and K1-K3 launches, which must be 0:
 22. the flagship fit in float64 (CMF(use_float=False), phase 4's
     arguments and split): the route (the plain dense engine), its
     dense-bytes estimate beside the measured peak (not below it),
     held-out RMSE (<= 0.7408, within 0.002 of phase 4's), float64 A_;
     then phase 5b's 8,192 users folded in by factors_multiple in float64:
     users/s, fold-in RMSE within 0.005 of the fitted rows', 256 users card
     against the CPU copy within 1e-9;
 23. phase 4's fit with precondition_cg=True in float32, on the auto route
     (which must be the plain dense engine) and with engine="sparse"
     (plain solves in the bucketed engine): RMSE <= 0.7408 each;
 24. the offsets models at their float64 defaults: OMF_implicit() with
     phase 19's arguments and data (P@10 within 0.005 of phase 19's
     float32 fit), OMF_explicit(method="als") with phase 18b's (RMSE
     within 0.002 of 18b's);
 25. phase 16's warm restart (phase 14's U and I and factors, 3
     iterations) in float64 on the bucketed route against the same fit in
     float32 from the same init=: held-out RMSE within 0.002, C_/D_
     finite.

Coordinate descent (nonneg, nonneg_C/D, l1_lambda; the CD kernel of
csrc/cd_solve.cu), each printing seconds, peak device memory, the card's
name and power limit, K1-K3 launches (0) and solve_cd launches against
the count the code implies, and the sweeps a row took (mean, p99, share
at max_cd_steps):
 26. phase 4's arguments with nonneg=True, center=False on the bucketed
     Cholesky/CD route: A_, B_ and the biases >= 0, held-out RMSE below
     the global mean's; one bucket of each side's last half-step (at most
     4,096 rows) through the kernel against rowsolve.solve_cd on the card
     in f32 and f64 (sweeps equal to the twin's on >= 99% of the rows),
     both timed, and the whole A half-step timed three times, printed
     beside the first design's time and the bound;
 27. phase 7's WRMF with nonneg=True: P@10 >= 2x popularity, factors >= 0;
 28. phase 11's dense U and I with nonneg, nonneg_C and nonneg_D
     (center=False): the dense C/D updates by CD with one G shared by
     every side column, C_ and D_ >= 0, and the last iteration's C and D
     solves (G of row stride 0) through the kernel against
     rowsolve.solve_cd in f32 and f64; 28b. phase 4's arguments with
     l1_lambda=0.1 (scaled by each row's count under scale_lam): the share
     of exact zeros in A_ and B_ (> 0); RMSE below the global mean's; then
     with l1_lambda=L1_KEEP, where factors stay: zeros in A_ and B_ between
     0 and 100%, RMSE below the global mean's, and one A bucket of the
     last half-step (the soft threshold with a per-row l1, its result
     part zero, part not) through the kernel against its twin;
 29. serving: phase 5b's 8,192 users folded into phase 26's model
     (users/s, factors >= 0, 256 card against the CPU copy), and 2,000 U
     rows through cold factors of phase 28's model against its CPU copy.

K past 256 (the kernels' wide paths: K1's wide configurations on wgmma
and on FMA, K2's wide kernel (bf16) and its f32 kernel at any K, K3's rows
design up to K = 1024 and its loop design past it, fault P6's routes):
 30. K1 (bf16 operands on the int8 mask and on bf16 weights, f32 operands)
     and K2 (bf16 on the int8 mask and on bf16 weights, f32) against their
     twins on the A side of phase 3's X and W at K = 320 (k = 300 on the
     dense engine) and 1024, the bf16 K2 also at 576 (two column chunks),
     and K3 against its twin on each A bucket of phase 6's layout at K =
     264 (the implicit fit's), 304 (k = 300 bucketed) and 1024 (the rows
     design) and 1032 (the loop design; phase 6's log-play case in bf16):
     the first 2,048 rows of each bucket, the plan the bucket's full rows
     take asserted to be the one checked and of the design of its K, and
     at K = 264 the widest bucket and the one of the most slots at their
     full rows; each call's launches, time, plain time, bound and plan
     (K1, K2: configuration, column chunks and shared memory); P6: a K3
     bucket at K = 3,640 through rowsolve.solve_cg (no K3 launch) against
     K3's twin, the CD kernel at K = 4,848 in float64 (its scratch
     configuration) against its twin; then CMF(k=300) on phase 4's data
     and split (the dense engine, K = 320) at the flagship's 15 iterations:
     its seconds, RMSE below the global mean's, K1's and K2's mean time a
     call by operand type, K1/K2 launches 146/30; and CMF_implicit(k=260)
     on phase 7's data (K3 at K = 264) at its 15 iterations: P@10 above
     popularity, K3 = 15 x the buckets, K3's milliseconds an iteration and
     share of the fit.

The data-parallel mesh (cmfrec_torch/parallel/; every K1-K3 and CD launch
on each rank's rows):
 31. init_distributed() makes a world of one with NCCL on a local store;
     then (a) phase 4's flagship, (b) phase 7's WRMF, (c) phase 14's
     collective bucketed fit and (d) phase 17's CMF(method="lbfgs") run
     through fit(..., mesh=make_mesh()), each after a meshless repeat of
     its phase: the mesh fit's seconds beside the repeat's and the phase's,
     its launches equal to the phase's (K1 112 + 34 / K2 30, K3 360, K3
     546, 0),
     its factors and biases bitwise equal to the phase's where the repeat
     is (else its held-out quality within the fold-in tolerances and, for
     17, its objective and gradient at the fit's start within 1e-5 of the
     meshless evaluation's, the factors' distance printed beside the
     repeat's), and the
     phase's quality bar (RMSE <= 0.7408, P@10 >= 0.0839, phase 17 below
     phase 21's MostPopular); (e) topn_sharded for 256 of phase 4's users
     against ops/predict.topn: ids and scores equal.  31b, on a machine
     with two cards or more: phase 4 on a 2-rank NCCL group (spawned, one
     process a card) against phase 4's fit: held-out RMSE within 1e-4,
     factors within 1e-2 of their max (15 bf16 iterations carry the
     reordered sums of a half share; rtol 1e-4's reading printed); on one
     card a line says it was not run.

The big-axis ring (shard_opposing_rows=True, cmfrec_torch/parallel/ring.py;
Cholesky and CD only, no kernel of its own but the CD kernel):
 32. on 31's NCCL world of one, each fit after a meshless repeat of the
     same call: (a) phase 8's flagship through drivers.fit_explicit_als(
     engine="sparse", use_cg=False, mesh=, shard_opposing_rows=True), RMSE
     <= 0.7408; (b) phase 7's WRMF through fit_implicit_als(use_cg=False),
     P@10 >= 0.0839; (c) phase 14's collective bucketed fit (CMF with U
     tags and I genres, use_cg=False, the collective driver given
     shard_opposing_rows=True), RMSE <= 0.7408; (d) phase 26's nonneg
     flagship (CMF(nonneg=True), the CD kernel's 360 launches on the
     ring-assembled systems), RMSE below the global mean's, factors >= 0,
     and the kernel against its twin on the widest A bucket of the last
     half-step.  Each line: seconds beside the repeat's ((a) also ms a
     half-step), peak memory, each side's shard bytes a rank, the parts
     ringed and gathered whole, the factors bitwise equal to the repeat's
     (else within the CPU tests' tolerance, printed), launches.  32b, on
     a machine with two cards or more: 32(a) and a 2,000,000 x 1,000,000
     fit of 8,000,000 ratings (k = 32) on 2-rank NCCL groups (and 4-rank
     ones on four cards) through the ring and through slice 7a's mesh=:
     each rank's memory at rest and at its peak (the set-up's beside the
     iterations') and its ms a half-step (32(a) beside the meshless one
     card's), the ring's RMSE within 1e-4 and arrays within 1e-2 of their
     max of 32(a)'s repeat and of 7a's big fit, whether they equal 7a's
     bit for bit, 32(a)'s set-up peak a rank beside the 1.005 GiB of every
     rank building the whole layout; then 32(a) through the ring on 2
     ranks with each process's device memory capped between its peak and
     that 1.005 GiB (scripts/ring_capped_torch.py), which must complete
     bitwise equal to the uncapped run; on one card a line says it was
     not run (alone: scripts/mesh_two_cards_torch.py --ring).

Profiling (cmfrec_torch/utils/profiling.py):
 33. phase 8's bucketed fit and phase 4's flagship at 2 iterations, each
     under CMFREC_TORCH_PROFILE=<a directory under build/>: one
     torch.profiler trace each, whose kernel events name bucket_cg_kernel
     (8) and gram_bf16_wgmma_kernel and rhs_bf16_wgmma_kernel (4), with
     their device ms; launches as expected (K3 = the buckets of both
     sides; K1/K2 42/4).

Each fit phase, and phase 9's sweep, sets every kernel's launch count to 0
just before it and reads the counts just after; phases 10-16 print each
fit's seconds (14-15 of a warm fit, after a first one) and peak device
memory.  The line before the last is
{"kernels": [...]}; the last line is {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero; so does a machine without a CUDA
device, or a directory without the package.
"""

import contextlib
import json
import pathlib
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
# K1 = 14 bulk iterations x 2 half-steps x (1 + 3 CG steps); the polish's
# 2 x (1 + 16) f32 K1 on the row lists (ML10M's 1.27% lies under
# masked_matmul.ROWS_MAX_DENSITY);  K2 = one per half-step
EXPECTED_LAUNCHES = {"solve_cd": 0, "masked_gram_matvec": 14 * 2 * 4,
                     "masked_gram_matvec_rows": 2 * 17,
                     "masked_rhs": 15 * 2, "bucket_cg": 0}
# max|kernel - twin| / max|twin|, set about 7x above the largest readings at
# these shapes (1.4e-4 bf16, 6.5e-6 f32, NVIDIA H100): f32 differs by
# summation order only; bf16 also flips a few roundings of T*W to bf16
REL_TOL = {"bf16": 1e-3, "f32": 5e-5}
REPLACES = {"masked_gram_matvec": "cmfrec_tpu/ops/masked_matmul.py:87",
            "masked_rhs": "cmfrec_tpu/ops/masked_matmul.py:108",
            "bucket_cg": "cmfrec_tpu/ops/sparse_cg.py:52",
            # XLA in the JAX package (a fori_loop in a scan), not Pallas
            "solve_cd": "cmfrec_tpu/ops/rowsolve.py:279"}
SOURCES = {"masked_gram_matvec": "cmfrec_torch/csrc/masked_matmul.cu",
           "masked_gram_matvec_rows": "cmfrec_torch/csrc/masked_rows.cu",
           "masked_rhs": "cmfrec_torch/csrc/masked_matmul.cu",
           "bucket_cg": "cmfrec_torch/csrc/sparse_cg.cu",
           "solve_cd": "cmfrec_torch/csrc/cd_solve.cu"}
# NVIDIA H100 SXM data sheet: HBM bytes/s; dense bf16 tensor-core, plain
# f32 and f64 tensor-core operations/s (full f64 precision).  An operation
# is costed by its operands' type at the fastest unit that keeps their
# precision: a bf16 x bf16 product summed in f32 at the bf16 rate, whatever
# unit the kernel uses.
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "f64": 67e12}

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
                           "gram_f32_ring_kernel", "gram_bf16_whole_kernel",
                           "gram_bf16_wide_kernel", "gram_f32_wide_kernel",
                           "sum_chunks_kernel"),
    "masked_rhs": ("rhs_bf16_wgmma_kernel", "rhs_f32_tile8_kernel",
                   "rhs_bf16_wide_kernel", "sum_chunks_kernel"),
    "masked_gram_matvec_rows": ("rowlist_gram_kernel", "rowlist_sum_kernel",
                                "rowlist_count_kernel", "rowlist_scan_kernel",
                                "rowlist_fill_kernel"),
    "bucket_cg": ("bucket_cg_kernel", "bucket_cg_rows_kernel"),
    "solve_cd": ("cd_staged_kernel", "cd_stream_kernel"),
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
EXPECTED_DENSE_IMPLICIT = {"solve_cd": 0, "masked_gram_matvec": 15 * 2 * 4,
                           "masked_gram_matvec_rows": 0,
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


def check_k1_rows(rows, cols, vals, weights):
    """Phase 3b: K1 with f32 operands on the row lists at the flagship's
    sides, int8 mask and f32 weights, against the dense f32 K1 and its
    twin; two calls bitwise equal; the lists' build time."""
    import torch

    from cmfrec_torch.ops import masked_matmul as mm

    Kp, sides = flagship_dense(rows, cols, vals, weights)
    dev = sides["A"][3].device
    gen = torch.Generator(device=dev).manual_seed(1)
    out = []
    for side, (R, S, _, W8s, Wfs) in sides.items():
        Q = torch.randn(R, Kp, device=dev, generator=gen) / 8
        Be = torch.randn(S, Kp, device=dev, generator=gen) / 8
        for wname, W in (("int8", W8s), ("f32", Wfs)):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            lists = mm.row_lists(W, rows.size)
            end.record()
            torch.cuda.synchronize()
            build_ms = start.elapsed_time(end)
            entries = int(lists.offsets[-1])
            got = mm.masked_gram_matvec_rows(Q, Be, lists)
            again = mm.masked_gram_matvec_rows(Q, Be, lists)
            dense = mm.masked_gram_matvec(Q, Be, W)
            twin = mm.masked_gram_matvec_rows_ref(Q, Be, lists)
            torch.cuda.synchronize()
            scale = dense.abs().max().item()
            err = (got - dense).abs().max().item()
            rel = err / scale
            rel_twin = (got - twin).abs().max().item() / scale
            bitwise = bool(torch.equal(got, again))
            ms = _timed(lambda: mm.masked_gram_matvec_rows(Q, Be, lists), 5)
            dense_ms = _timed(lambda: mm.masked_gram_matvec(Q, Be, W), 5)
            plain_ms = _timed(
                lambda: mm.masked_gram_matvec_rows_ref(Q, Be, lists), 2)
            # the ids (and weights), the offsets, Q, Be and out once; the
            # 4 K operations an entry at the f32 peak
            nbytes = (entries * (4 if wname == "int8" else 8) + 2 * (R + 1) * 4
                      + (2 * R + S) * Kp * 4)
            b_ms, b_by = bound(nbytes, {"f32": 4 * entries * Kp})
            ok = (rel <= REL_TOL["f32"] and rel_twin <= REL_TOL["f32"]
                  and bitwise)
            print(f"kernel masked_gram_matvec_rows side={side} R={R} S={S} "
                  f"K={Kp} op=f32 W={wname}: entries={entries} "
                  f"({100 * entries / (R * S):.3f}%, rule "
                  f"{100 * mm.ROWS_MAX_DENSITY:.0f}%), lists built in "
                  f"{build_ms:.3f} ms; max_abs_err={err:.3e} rel vs the "
                  f"dense K1 {rel:.3e}, vs the twin {rel_twin:.3e} (tol "
                  f"{REL_TOL['f32']:.0e}), bitwise {bitwise}; ms={ms:.4f} "
                  f"(the dense f32 K1 {dense_ms:.3f}) plain_ms="
                  f"{plain_ms:.3f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                raise AssertionError("masked_gram_matvec_rows disagrees")
            out.append(dict(side=side, R=R, S=S, K=Kp, op="f32", W=wname,
                            entries=entries, build_ms=build_ms,
                            max_abs_err=err, rel_err=rel,
                            rel_twin=rel_twin, ms=ms, dense_ms=dense_ms,
                            plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by))
            del lists, got, again, dense, twin
    return out


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
        k1 = "masked_gram_matvec"
        if tag == "10b":  # every K1 f32, on the row lists; the all-frozen
            # exit sets their count
            want.update({k1: 0, k1 + "_rows": launches[k1 + "_rows"]})
        print(f"phase {tag} implicit features (use_cg={model.use_cg}): "
              f"{s:.3f} s, peak device memory {peak / 2**30:.2f} GiB, "
              f"held-out RMSE {rmse:.5f} (bound {bound_:.5f}, global-mean "
              f"baseline {base:.5f}), Ai_ {model.Ai_.shape} Bi_ "
              f"{model.Bi_.shape}, launches {launches} (expected {want})",
              flush=True)
        if launches != want or launches[k1] + launches[k1 + "_rows"] <= 30:
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
    want = dict(NO_LAUNCHES, bucket_cg=IMPLICIT_FIT["niter"] * (
        n_chunks(rows[tr], M) + n_chunks(cols[tr], N)))
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


def bucketed_collective_phases(ops, rows, cols, vals, test, lastfm, p10_7,
                               refs):
    """Phases 14-16; returns each fit's launch counts by phase, and puts
    phase 14's fit into ``refs`` (phase 31)."""
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
    want = dict(NO_LAUNCHES,
                bucket_cg=(FIT["niter"] - 1) * sum(n_b.values()))
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
    refs["14"] = dict(arrays=_model_arrays(model), launches=launches,
                      seconds=s, quality=rmse, bar=RMSE_BOUND)
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
    want = dict(NO_LAUNCHES, bucket_cg=IMPLICIT_FIT["niter"] * n_b15)
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

    # 25. phase 16's warm restart in float64 against the same fit in
    # float32, from the same init=
    def restart(dtype):
        return collective.fit_collective_explicit_als(
            tr_r, tr_c, tr_v, M, N, side_U=_side_tuple(U),
            side_I=_side_tuple(I), NA_as_zero_item=True, init=init,
            dtype=dtype, device="cuda", **short)

    def rmse_res(res):
        r, c = (torch.as_tensor(a[test], device="cuda") for a in (rows, cols))
        pred = (res["glob_mean"] + res["biasA"][r] + res["biasB"][c]
                + (res["A"][r] * res["B"][c]).sum(dim=1)).cpu().numpy()
        return float(np.sqrt(np.mean((pred - vals[test]) ** 2)))

    res32 = restart(np.float32)
    rmse32 = rmse_res(res32)
    del res32
    with _Route(sides) as route:
        res, launches, s, peak = _fit_phase(ops, lambda: restart(np.float64))
    rmse64 = rmse_res(res)
    dtypes = {res[key].dtype for key in ("A", "B", "C", "D", "biasA",
                                         "biasB")}
    finite = all(torch.isfinite(res[key]).all() for key in ("C", "D"))
    print(f"phase 25 float64 collective (phase 16's warm restart, U tags, I "
          f"genres NA_as_zero_item, {DEPTH_16} iterations) on {card()}: "
          f"route {route.name}, {s:.3f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB, held-out RMSE {rmse64:.5f} (float32 from "
          f"the same init= {rmse32:.5f}, tol {RMSE_F64_TOL}), dtypes "
          f"{sorted(str(d) for d in dtypes)}, C_/D_ finite {finite}; "
          f"launches {launches} (expected {NO_LAUNCHES})", flush=True)
    if route.name != "bucketed" or launches != NO_LAUNCHES:
        raise AssertionError("phase 25 did not take the bucketed route's "
                             "plain solves")
    if not (abs(rmse64 - rmse32) <= RMSE_F64_TOL and finite
            and dtypes == {torch.float64}):
        raise AssertionError("phase 25: out of bounds")
    paths["25"] = launches
    del res
    torch.cuda.empty_cache()
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
# (niter - 1) x 2 half-steps x (1 + 3 CG steps) + 2 x (1 + 16), the
# polish's on the row lists where ``rows`` (ML10M's density, K <= 256); K2
# one a half-step


def dense_launches(niter, rows=True):
    polish = 2 * 17
    return {"solve_cd": 0,
            "masked_gram_matvec": (niter - 1) * 2 * 4 + (0 if rows else polish),
            "masked_gram_matvec_rows": polish if rows else 0,
            "masked_rhs": 2 * niter, "bucket_cg": 0}


NO_LAUNCHES = {"solve_cd": 0, "masked_gram_matvec": 0,
               "masked_gram_matvec_rows": 0, "masked_rhs": 0, "bucket_cg": 0}
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
    7b's fold-in P@10), n_buckets_7 (phase 7's layout), refs (phase 31's,
    which gets phase 17's fit)."""
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
    # fault P3: a play of 0 under apply_log_transf raises, on the card too
    zero = l_v.copy()
    zero[0] = 0.0
    try:
        cmfrec_torch.MostPopular(implicit=True, apply_log_transf=True,
                                 device="cuda").fit_triplets(
            l_r, l_c, zero, LFM_M, LFM_N)
    except ValueError as e:
        print(f"phase 21 MostPopular(apply_log_transf=True) with a 0 play: "
              f"ValueError ({e})", flush=True)
    else:
        raise AssertionError("phase 21: a 0 play under apply_log_transf did "
                             "not raise")

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
    # phase 17's bar is its own: below phase 21's MostPopular
    ctx["refs"]["17"] = dict(arrays=_model_arrays(model), launches=launches,
                             seconds=s, quality=rmse, bar=rmse_mp)
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
    Ua, Ia = ctx["attributes"] = make_ml10m_attributes()
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
    ctx["rmse_18b"] = rmse
    # phase 24 refits this driver call in float64 from the same init
    ctx["als_18b"] = dict(init=init, kw=als_kw, rmse=_offsets_rmse(
        res, rows, cols, vals, test))
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
    want = dict(NO_LAUNCHES,
                bucket_cg=IMPLICIT_FIT["niter"] * ctx["n_buckets_7"])
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
    ctx["p10_19"] = p10

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


# --------------------------------------------------------------------- #
# phases 22-25: float64 and Jacobi PCG                                   #
# --------------------------------------------------------------------- #

RMSE_F64_TOL = 0.002  # 22: |RMSE - phase 4's|; 24: - 18b's; 25: - f32's
P10_F64_TOL = 0.005  # 24: |OMF_implicit() P@10 - phase 19's|
F64_CPU_TOL = 1e-9  # 22: 256 users card vs CPU, of max|a|


def card():
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _offsets_rmse(res, rows, cols, vals, test):
    """Held-out RMSE of a fit_offsets_als result (Am, Bm, biases)."""
    r, c = rows[test], cols[test]
    pred = (res["glob_mean"] + np.sum(np.asarray(res["Am"], np.float64)[r]
                                      * res["Bm"][c], axis=1)
            + res["biasA"][r] + res["biasB"][c])
    return float(np.sqrt(np.mean((pred - vals[test]) ** 2)))


def float64_phases(ops, rows, cols, vals, test, lastfm, ctx):
    """Phases 22, 23 and 24; returns each one's launch counts.  ``ctx``:
    rmse_4, rmse_18b, als_18b, p10_19, attributes and n_buckets_7 of the
    earlier phases."""
    import torch

    import cmfrec_torch
    from cmfrec_torch.solvers import dense_engine, drivers, offsets

    tr = ~test
    tr_r, tr_c, tr_v = rows[tr], cols[tr], vals[tr]
    l_r, l_c, l_v, l_te_r, l_te_c, test_users = lastfm
    paths = {}

    def rmse_of(model):
        pred = model.predict(rows[test], cols[test])
        if not np.all(np.isfinite(pred)):
            raise AssertionError("non-finite predictions")
        return float(np.sqrt(np.mean((pred - vals[test]) ** 2)))

    def dense_route(fit):
        """fit()'s _fit_phase, and whether it ran drivers._fit_explicit_dense
        (the plain dense engine)."""
        calls = []
        real = _spy(drivers, "_fit_explicit_dense", calls)
        try:
            return _fit_phase(ops, fit), bool(calls)
        finally:
            drivers._fit_explicit_dense = real

    # 22. the flagship fit in float64, then phase 5b's users folded in
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    (model, launches, s, peak), plain = dense_route(
        lambda: cmfrec_torch.CMF(**FIT, use_float=False, device="cuda"
                                 ).fit_triplets(tr_r, tr_c, tr_v, M, N))
    used = peak - before
    estimate = dense_engine.estimate_dense_bytes(M, N, tr_r.size, FIT["k"],
                                                 8, False)
    rmse = rmse_of(model)
    users = np.sort(np.random.default_rng(21).choice(
        np.unique(tr_r), SERVE_USERS, replace=False))
    X, local = _new_user_coo(users, tr_r, tr_c, tr_v, M, N)
    _reset_launches(ops)
    model.factors_multiple(X=X)
    (a, bias), s_serve = _timed_s(lambda: model.factors_multiple(
        X=X, return_bias=True))
    sel = test & (local[rows] >= 0)
    li = local[rows[sel]]
    B = model.B_[cols[sel]]
    fold = (model.glob_mean_ + bias[li] + model.item_bias_[cols[sel]]
            + np.sum(a[li] * B, axis=1))
    rmse_fold = float(np.sqrt(np.mean((fold - vals[sel]) ** 2)))
    rmse_fit = float(np.sqrt(np.mean(
        (model.predict(rows[sel], cols[sel]) - vals[sel]) ** 2)))
    X256 = X.tocsr()[:SERVE_CHECK].tocoo()
    card_a = np.column_stack(model.factors_multiple(X=X256,
                                                    return_bias=True))
    cpu_err = _rel(card_a, np.column_stack(_cpu_twin(
        model).factors_multiple(X=X256, return_bias=True)))
    slaunches = _read_launches(ops)
    print(f"phase 22 float64 flagship (CMF(use_float=False), phase 4's "
          f"arguments) on {card()}: route "
          f"{'plain dense engine' if plain else 'other'}, fit {s:.3f} s, "
          f"peak device memory {used / 2**30:.2f} GiB above the "
          f"{before / 2**30:.2f} GiB held before it (dense-bytes estimate "
          f"{estimate / 2**30:.2f} GiB), held-out RMSE {rmse:.5f} (bound "
          f"{RMSE_BOUND:.5f}; phase 4 {ctx['rmse_4']:.5f}, tol "
          f"{RMSE_F64_TOL}), A_ {model.A_.dtype}; launches {launches} "
          f"(expected {NO_LAUNCHES})", flush=True)
    print(f"phase 22 float64 serving: {SERVE_USERS} users, {X.nnz} ratings, "
          f"factors_multiple {s_serve:.3f} s = {SERVE_USERS / s_serve:.0f} "
          f"users/s, factors {a.dtype}; fold-in RMSE {rmse_fold:.5f} on "
          f"{int(sel.sum())} held-out ratings (fitted rows {rmse_fit:.5f}, "
          f"tol {FOLDIN_RMSE_TOL}); card vs CPU {cpu_err:.2e} (limit "
          f"{F64_CPU_TOL:.0e}); launches {slaunches}", flush=True)
    if not plain or launches != NO_LAUNCHES or slaunches != NO_LAUNCHES:
        raise AssertionError("phase 22 did not take the plain dense engine "
                             "with no kernel launch")
    if not (used <= estimate and rmse <= RMSE_BOUND
            and abs(rmse - ctx["rmse_4"]) <= RMSE_F64_TOL
            and model.A_.dtype == np.float64 and a.dtype == np.float64
            and abs(rmse_fold - rmse_fit) <= FOLDIN_RMSE_TOL
            and cpu_err <= F64_CPU_TOL):
        raise AssertionError("phase 22: out of bounds")
    paths["22"] = {key: launches[key] + slaunches[key] for key in launches}
    del model, X, a, bias
    torch.cuda.empty_cache()

    # 23. Jacobi PCG in float32: the auto route, then engine="sparse"
    (model, launches, s, peak), plain = dense_route(
        lambda: cmfrec_torch.CMF(**FIT, precondition_cg=True, device="cuda"
                                 ).fit_triplets(tr_r, tr_c, tr_v, M, N))
    rmse = rmse_of(model)
    del model
    res, slaunches, s_s, speak = _fit_phase(
        ops, lambda: drivers.fit_explicit_als(
            tr_r, tr_c, tr_v, M, N, engine="sparse", precondition_cg=True,
            device="cuda", **FIT))
    rt, ct = (torch.as_tensor(x[test], device="cuda") for x in (rows, cols))
    spred = (res["glob_mean"] + res["biasA"][rt] + res["biasB"][ct]
             + (res["A"][rt] * res["B"][ct]).sum(dim=1)).cpu().numpy()
    srmse = float(np.sqrt(np.mean((spred - vals[test]) ** 2)))
    print(f"phase 23 Jacobi PCG (precondition_cg=True, float32, phase 4's "
          f"arguments) on {card()}: auto route "
          f"{'plain dense engine' if plain else 'other'} fit {s:.3f} s, peak "
          f"device memory {peak / 2**30:.2f} GiB, held-out RMSE {rmse:.5f}; "
          f"engine='sparse' fit {s_s:.3f} s, peak device memory "
          f"{speak / 2**30:.2f} GiB, held-out RMSE {srmse:.5f} (bound "
          f"{RMSE_BOUND:.5f}); launches {launches} / {slaunches} (expected "
          f"{NO_LAUNCHES})", flush=True)
    if not plain or launches != NO_LAUNCHES or slaunches != NO_LAUNCHES:
        raise AssertionError("phase 23 did not take the plain routes with "
                             "no kernel launch")
    if not (rmse <= RMSE_BOUND and np.isfinite(spred).all()
            and srmse <= RMSE_BOUND):
        raise AssertionError("phase 23: RMSE out of bounds")
    paths["23"] = {key: launches[key] + slaunches[key] for key in launches}
    del res, rt, ct
    torch.cuda.empty_cache()

    # 24. the offsets models at their float64 defaults
    P = make_profiles()
    iomf, launches, s, peak = _fit_phase(
        ops, lambda: cmfrec_torch.OMF_implicit(
            **IMPLICIT_FIT, device="cuda").fit_triplets(
                l_r, l_c, l_v, LFM_M, LFM_N, U=P))
    Am_d, Bm_d = iomf._device_x_factors()
    p10 = ranking_quality(Am_d, Bm_d, l_r, l_c, l_te_r, l_te_c, test_users,
                          LFM_N)[0]
    dt_i = (iomf.dtype_, iomf.Am_.dtype, iomf.C_.dtype)
    del iomf, Am_d, Bm_d
    torch.cuda.empty_cache()
    Ua, Ia = ctx["attributes"]
    omf, elaunches, s_e, epeak = _fit_phase(
        ops, lambda: cmfrec_torch.OMF_explicit(
            **{**OMF_ALS_FIT, "use_float": False}, device="cuda"
        ).fit_triplets(tr_r, tr_c, tr_v, M, N, U=Ua, I=Ia))
    rmse = rmse_of(omf)
    dt_e = (omf.dtype_, omf.Am_.dtype, omf.C_.dtype)
    del omf
    # 18b's configuration (lambda 0.05, unscaled) overfits: its held-out
    # RMSE moves with the random start.  The bar holds 18b's driver call
    # from its own init in float64 against the same call in float32
    als = ctx["als_18b"]
    res, rlaunches, s_r, _ = _fit_phase(ops, lambda: offsets.fit_offsets_als(
        tr_r, tr_c, tr_v, M, N, side_U=(None, None, None, M, 13, True, Ua),
        side_I=(None, None, None, N, 13, True, Ia), init=als["init"],
        dtype=np.float64, device="cuda", **als["kw"]))
    rmse_init = _offsets_rmse(res, rows, cols, vals, test)
    dt_r = res["Am"].dtype
    del res
    # and the spread of 18b's own float32 fit over another random start
    rmse_seed = rmse_of(cmfrec_torch.OMF_explicit(
        **OMF_ALS_FIT, random_state=2, device="cuda").fit_triplets(
            tr_r, tr_c, tr_v, M, N, U=Ua, I=Ia))
    print(f"phase 24 offsets models at their float64 defaults on {card()}: "
          f"OMF_implicit() fit {s:.3f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB, P@10 {p10:.5f} (phase 19's float32 "
          f"{ctx['p10_19']:.5f}, tol {P10_F64_TOL}), dtypes {dt_i}; "
          f"OMF_explicit(method='als') fit {s_e:.3f} s, peak device memory "
          f"{epeak / 2**30:.2f} GiB, held-out RMSE {rmse:.5f} (phase 18b "
          f"{ctx['rmse_18b']:.5f}; 18b's float32 fit at random_state 2 "
          f"{rmse_seed:.5f}), dtypes {dt_e}; 18b's fit_offsets_als from its "
          f"init in float64 {s_r:.3f} s, RMSE {rmse_init:.5f} (float32 "
          f"{als['rmse']:.5f}, tol {RMSE_F64_TOL}), Am {dt_r}; launches "
          f"{launches} / {elaunches} / {rlaunches} (expected {NO_LAUNCHES})",
          flush=True)
    if any(x != NO_LAUNCHES for x in (launches, elaunches, rlaunches)):
        raise AssertionError("phase 24 launched a fit kernel")
    if not (abs(p10 - ctx["p10_19"]) <= P10_F64_TOL
            and abs(rmse_init - als["rmse"]) <= RMSE_F64_TOL
            and np.isfinite(rmse) and dt_r == np.float64
            and all(np.dtype(d) == np.float64 for d in dt_i + dt_e)):
        raise AssertionError("phase 24: out of bounds")
    paths["24"] = {key: launches[key] + elaunches[key] + rlaunches[key]
                   for key in launches}
    torch.cuda.empty_cache()
    return paths


# phases 26-29: coordinate descent
NONNEG_FIT = dict(FIT, nonneg=True, center=False)
L1_FIT = dict(FIT, l1_lambda=0.1)
# an l1 penalty at which the fit keeps part of its factors: 0.1 zeroes
# them all (phase 28b's first reading), and scripts/sweep_l1_torch.py shows
# the collapse already at 0.003 (NVIDIA H100 80GB HBM3, 700 W)
L1_KEEP = 0.001
L1_KEEP_FIT = dict(FIT, l1_lambda=L1_KEEP)
CD_CHECK_ROWS = 4096  # rows of a bucket held kernel against twin
CD_REPS = 5  # CUDA-event repetitions of a kernel timing
# max|kernel - twin| / max|twin| of the CD kernel (the same sweeps over
# sums in another order; the iteration contracts), about 7x above the
# readings on phase 26's buckets (NVIDIA H100 80GB HBM3, 700 W): f32
# 1.33e-6, f64 2.60e-15
CD_REL_TOL = {"f32": 1e-5, "f64": 2e-14}
# the share of phase 26's checked rows whose sweeps equal the twin's
CD_SAME_SWEEPS = 0.99
# phase 26's A half-step through the first design of the CD kernel (a warp
# a row, G read at every coordinate), three runs of this script (NVIDIA
# H100 80GB HBM3, 700 W), printed beside the present design's
CD_FIRST_DESIGN_HALF_MS = (83.105, 83.489)
# max|card - CPU| / max|CPU| of CD-served factors (phase 29), about 6x
# above the readings (same card): warm 1.57e-5, cold 8.7e-8
CD_SERVE_TOL = 1e-4


class _CDSpy:
    """The solvers' CD op wrapped for the CD phases: every call also asks
    for the sweeps each row ran (kept on the card, read at the end), and
    the calls for which ``keep(call number, G)`` is true keep their inputs.
    The wrapper takes ops.coord_descent's place in the solver modules only,
    so the op and its launch count stay as they are."""

    def __init__(self, keep=lambda i, G: False):
        self.keep, self.kept, self.sweeps = keep, {}, []
        self.calls, self.max_steps = 0, None

    def __enter__(self):
        import types

        from cmfrec_torch.ops import coord_descent
        from cmfrec_torch.solvers import als, collective, warm

        real = coord_descent.solve_cd

        def spy(G, rhs, l1, *, nonneg, max_steps, tol=1e-9,
                return_sweeps=False):
            if self.keep(self.calls, G):
                self.kept[self.calls] = (G, rhs, l1, nonneg, max_steps)
            self.calls += 1
            out, sw = real(G, rhs, l1, nonneg=nonneg, max_steps=max_steps,
                           tol=tol, return_sweeps=True)
            self.sweeps.append(sw)
            self.max_steps = max_steps
            return (out, sw) if return_sweeps else out

        self.modules = (als, collective, warm)
        for mod in self.modules:
            mod.coord_descent = types.SimpleNamespace(solve_cd=spy)
        return self

    def __exit__(self, *exc):
        from cmfrec_torch.ops import coord_descent

        for mod in self.modules:
            mod.coord_descent = coord_descent

    def stats(self):
        return sweep_stats(self.sweeps, self.max_steps)


def sweep_stats(sweeps, max_steps):
    """The sweeps rows ran: mean, p99, share at max_steps, rows."""
    import torch

    if not sweeps:
        return dict(mean=0.0, p99=0.0, at_max=0.0, rows=0)
    sw = torch.cat(sweeps).cpu().numpy()
    return dict(mean=float(sw.mean()), p99=float(np.percentile(sw, 99)),
                at_max=float(np.mean(sw == max_steps)), rows=int(sw.size))


def _fmt_sweeps(st):
    return (f"sweeps a row mean {st['mean']:.2f}, p99 {st['p99']:.0f}, "
            f"{100 * st['at_max']:.1f}% at the cap, over {st['rows']} rows")


def _cd_work(G, rhs, l1, sweeps, dt):
    """(bytes, {type: operations}) of one CD call: G, rhs and l1 read once
    (a shared G once), the result and the sweeps written once; 2K^2
    operations a row and sweep."""
    import torch

    K = rhs.shape[1]
    esz = rhs.element_size()
    g_bytes = (K * K if G.stride(0) == 0 else G.shape[0] * K * K) * esz
    nbytes = g_bytes + 2 * rhs.numel() * esz + l1.numel() * esz \
        + sweeps.numel() * 4
    ops = 2.0 * K * K * float(sweeps.to(torch.float64).sum())
    return nbytes, {dt: ops}


def check_cd(phase, sides):
    """A phase's CD kernel against rowsolve.solve_cd on the card: for each
    side's kept call (its first CD_CHECK_ROWS rows; a G shared by the rows
    stays shared), in f32 and f64, the error, the share of exact zeros in
    the twin's result, the kernel's CUDA-event time, the twin's host-clock
    time (one call, ending in a synchronize) and the bound from the sweeps
    the rows ran.  Returns one record a side and type."""
    import torch

    from cmfrec_torch.ops import coord_descent, rowsolve

    out = []
    for side, (G, rhs, l1, nonneg, steps) in sides.items():
        R, K = min(G.shape[0], CD_CHECK_ROWS), G.shape[1]
        rhs = rhs[:R].contiguous()
        l1 = (l1[:R] if l1.dim() == 2 else l1).contiguous()
        for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
            Gd = (G[0].to(dt).expand(R, K, K) if G.stride(0) == 0
                  else G[:R].contiguous().to(dt))
            args = (Gd, rhs.to(dt), l1.to(dt))
            got, sw = coord_descent.solve_cd(*args, nonneg=nonneg,
                                             max_steps=steps,
                                             return_sweeps=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want, wsw = rowsolve.solve_cd(*args, nonneg, steps,
                                          return_sweeps=True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = float((got - want).abs().max())
            rel = err / float(want.abs().max())
            ms = _timed(lambda: coord_descent.solve_cd(
                *args, nonneg=nonneg, max_steps=steps), CD_REPS)
            nbytes, ops = _cd_work(*args, sw, name)
            b_ms, b_by = bound(nbytes, ops)
            st = sweep_stats([sw], steps)
            rec = dict(phase=phase, side=side, dtype=name, shape=[R, K],
                       shared_G=G.stride(0) == 0, l1_rows=l1.dim() == 2,
                       nonneg=bool(nonneg), max_abs_err=err, rel=rel,
                       zeros=float((want == 0).double().mean()), ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       sweeps=st,
                       same_sweeps=float((sw == wsw).float().mean()))
            out.append(rec)
            print(f"phase {phase} CD kernel side={side} {name} [{R}, {K}]"
                  f"{' G shared' if rec['shared_G'] else ''}, "
                  f"{'nonneg' if nonneg else 'soft threshold'}, l1 "
                  f"{'[R, K]' if rec['l1_rows'] else '[K]'} (max "
                  f"{float(l1.abs().max()):.4g}): max|err| {err:.3e}, rel "
                  f"{rel:.2e} (limit {CD_REL_TOL[name]:.0e}), zeros "
                  f"{100 * rec['zeros']:.1f}%, kernel {ms:.3f} ms, twin "
                  f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}); "
                  f"{_fmt_sweeps(st)}; sweeps equal to the twin's on "
                  f"{100 * rec['same_sweeps']:.1f}% of rows", flush=True)
            if not (rel <= CD_REL_TOL[name] and torch.isfinite(got).all()):
                raise AssertionError(f"phase {phase}: the CD kernel "
                                     f"disagrees with its twin on side "
                                     f"{side} {name}")
            # phase 26's rows run to the cap in the twin, f32 and f64 alike:
            # the kernel stops them at the same sweep (the few-sweep solves
            # of 28, whose f32 rows settle within f32 resolution, stop at
            # whichever sweep their roundings first reach tol)
            if phase == "26" and rec["same_sweeps"] < CD_SAME_SWEEPS:
                raise AssertionError(f"phase 26: the CD kernel's sweeps "
                                     f"equal the twin's on "
                                     f"{100 * rec['same_sweeps']:.1f}% of "
                                     f"side {side}'s rows ({name})")
            if nonneg and float(got.min()) < 0:
                raise AssertionError(f"phase {phase}: negative CD output")
    return out


def cd_phases(ops, rows, cols, vals, test, lastfm, ctx):
    """Phases 26-29; returns (each one's launch counts, the CD kernel's
    records: check_cd's and the whole A half-step)."""
    import torch

    import cmfrec_torch
    from cmfrec_torch.ops import coord_descent
    from cmfrec_torch.solvers import warm

    tr = ~test
    tr_r, tr_c, tr_v = rows[tr], cols[tr], vals[tr]
    l_r, l_c, l_v, l_te_r, l_te_c, test_users = lastfm
    base = float(np.sqrt(np.mean((tr_v.mean() - vals[test]) ** 2)))
    n_rb, n_cb = n_chunks(tr_r, M), n_chunks(tr_c, N)
    niter = FIT["niter"]
    paths = {}

    def rmse_of(model):
        pred = model.predict(rows[test], cols[test])
        if not np.all(np.isfinite(pred)):
            raise AssertionError("non-finite predictions")
        return float(np.sqrt(np.mean((pred - vals[test]) ** 2)))

    def expect(cd):
        return dict(NO_LAUNCHES, solve_cd=cd)

    # 26. the flagship with nonneg: the last iteration's calls are kept
    last = (niter - 1) * (n_cb + n_rb)
    with _CDSpy(keep=lambda i, G: i >= last) as spy:
        model, launches, s, peak = _fit_phase(
            ops, lambda: cmfrec_torch.CMF(**NONNEG_FIT, device="cuda"
                                          ).fit_triplets(tr_r, tr_c, tr_v,
                                                         M, N))
    rmse = rmse_of(model)
    want = expect(niter * (n_rb + n_cb))
    mins = {key: float(np.min(getattr(model, key))) for key in
            ("A_", "B_", "user_bias_", "item_bias_")}
    st = spy.stats()
    print(f"phase 26 nonneg flagship (phase 4's arguments, nonneg=True, "
          f"center=False) on {card()}: fit {s:.3f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB, held-out RMSE {rmse:.5f} (global-mean "
          f"baseline {base:.5f}), minima {mins}; {_fmt_sweeps(st)}; "
          f"launches {launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError("phase 26 did not run the expected launches")
    if not (rmse < base and min(mins.values()) >= 0.0
            and all(np.isfinite(getattr(model, key)).all() for key in mins)):
        raise AssertionError("phase 26: out of bounds")
    paths["26"] = launches
    kept = [spy.kept[i] for i in sorted(spy.kept)]
    kept_B, kept_A = kept[:n_cb], kept[n_cb:]

    def widest(calls):
        return max(calls, key=lambda c: c[0].shape[0])

    records = check_cd("26", {"A": widest(kept_A), "B": widest(kept_B)})

    # the whole A half-step of the last iteration, bucket by bucket (each
    # bucket's mean of two calls after a warm-up), three runs
    def half_step():
        return sum(_timed(lambda: coord_descent.solve_cd(
            G, rhs, l1, nonneg=nonneg, max_steps=steps), 2)
            for G, rhs, l1, nonneg, steps in kept_A)

    half_bytes, half_ops, half_sw = 0, 0.0, []
    for G, rhs, l1, nonneg, steps in kept_A:
        _, sw = coord_descent.solve_cd(G, rhs, l1, nonneg=nonneg,
                                       max_steps=steps, return_sweeps=True)
        nb, op = _cd_work(G, rhs, l1, sw, "f32")
        half_bytes, half_ops = half_bytes + nb, half_ops + op["f32"]
        half_sw.append(sw)
    half_bound, half_by = bound(half_bytes, {"f32": half_ops})
    runs = [half_step() for _ in range(3)]
    K = kept_A[0][1].shape[1]
    plan = coord_descent.plan(K, False, torch.float32)
    half = dict(rows=sum(c[0].shape[0] for c in kept_A), buckets=len(kept_A),
                ms=float(np.mean(runs)), runs=runs, plan=plan,
                bound_ms=half_bound, bound_by=half_by,
                sweeps=sweep_stats(half_sw, kept_A[0][4]))
    print(f"phase 26 CD kernel, the whole A half-step: {half['rows']} rows in "
          f"{half['buckets']} buckets, K={K}, f32, plan {plan}: "
          f"{' '.join(f'{t:.3f}' for t in runs)} ms (three runs; the first "
          f"design {CD_FIRST_DESIGN_HALF_MS[0]:.3f}-"
          f"{CD_FIRST_DESIGN_HALF_MS[1]:.3f} ms, not measured here), bound "
          f"{half_bound:.3f} ms ({half_by}); "
          f"{_fmt_sweeps(half['sweeps'])}", flush=True)
    del kept, kept_A, kept_B, spy
    torch.cuda.empty_cache()

    # 27. phase 7's WRMF with nonneg
    with _CDSpy() as spy:
        imodel, launches, s, peak = _fit_phase(
            ops, lambda: cmfrec_torch.CMF_implicit(
                **IMPLICIT_FIT, nonneg=True, device="cuda").fit_triplets(
                    l_r, l_c, l_v, LFM_M, LFM_N))
    Ad, Bd = imodel._device_x_factors()
    p10, map10, _ = ranking_quality(Ad, Bd, l_r, l_c, l_te_r, l_te_c,
                                    test_users, LFM_N)
    mins = (float(imodel.A_.min()), float(imodel.B_.min()))
    want = expect(IMPLICIT_FIT["niter"] * ctx["n_buckets_7"])
    print(f"phase 27 nonneg WRMF (phase 7's arguments, nonneg=True) on "
          f"{card()}: fit {s:.3f} s, peak device memory {peak / 2**30:.2f} "
          f"GiB, P@10 {p10:.5f} (phase 7 {ctx['p10_7']:.5f}, bar 2 x "
          f"popularity {2 * ctx['p10_pop_7']:.5f}), MAP@10 {map10:.5f}, "
          f"minima A_ B_ {mins}; {_fmt_sweeps(spy.stats())}; launches "
          f"{launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError("phase 27 did not run the expected launches")
    if not (p10 >= 2 * ctx["p10_pop_7"] and min(mins) >= 0.0
            and np.isfinite(imodel.A_).all() and np.isfinite(imodel.B_).all()):
        raise AssertionError("phase 27: out of bounds")
    paths["27"] = launches
    del imodel, Ad, Bd, spy
    torch.cuda.empty_cache()

    # 28. dense side info with nonneg, nonneg_C and nonneg_D
    U = np.random.default_rng(11).normal(size=(M, SIDE_P))
    I = np.random.default_rng(12).normal(size=(N, SIDE_P))
    with _CDSpy(keep=lambda i, G: G.stride(0) == 0) as spy:
        cmodel, launches, s, peak = _fit_phase(
            ops, lambda: cmfrec_torch.CMF(
                **NONNEG_FIT, nonneg_C=True, nonneg_D=True, device="cuda"
            ).fit_triplets(tr_r, tr_c, tr_v, M, N, U=U, I=I))
    rmse = rmse_of(cmodel)
    mins = {key: float(np.min(getattr(cmodel, key))) for key in
            ("A_", "B_", "C_", "D_", "user_bias_", "item_bias_")}
    # the A and B buckets, and one shared-G solve for each of C and D
    want = expect(niter * (n_rb + n_cb + 2))
    print(f"phase 28 nonneg collective (phase 11's U {U.shape} and I "
          f"{I.shape}, nonneg, nonneg_C, nonneg_D, center=False) on "
          f"{card()}: fit {s:.3f} s, peak device memory {peak / 2**30:.2f} "
          f"GiB, held-out RMSE {rmse:.5f} (global-mean baseline {base:.5f}),"
          f" C_ {cmodel.C_.shape} D_ {cmodel.D_.shape}, minima {mins}; "
          f"{_fmt_sweeps(spy.stats())}; launches {launches} (expected "
          f"{want})", flush=True)
    if launches != want:
        raise AssertionError("phase 28 did not run the expected launches")
    if not (rmse < base and min(mins.values()) >= 0.0):
        raise AssertionError("phase 28: out of bounds")
    paths["28"] = launches
    # the last iteration's C and D solves, each one G shared by the columns
    shared = [spy.kept[i] for i in sorted(spy.kept)]
    if len(shared) != 2 * niter:
        raise AssertionError(f"phase 28: {len(shared)} shared-G CD calls, "
                             f"expected {2 * niter}")
    records += check_cd("28", {"C": shared[-2], "D": shared[-1]})
    del spy, shared
    torch.cuda.empty_cache()

    # 28b. l1_lambda: the soft threshold with a per-row l1
    with _CDSpy() as spy:
        lmodel, launches, s, peak = _fit_phase(
            ops, lambda: cmfrec_torch.CMF(**L1_FIT, device="cuda"
                                          ).fit_triplets(tr_r, tr_c, tr_v,
                                                         M, N))
    rmse = rmse_of(lmodel)
    zeros = (float(np.mean(lmodel.A_ == 0)), float(np.mean(lmodel.B_ == 0)))
    want = expect(niter * (n_rb + n_cb))
    print(f"phase 28b l1_lambda=0.1 (phase 4's arguments, scale_lam) on "
          f"{card()}: fit {s:.3f} s, peak device memory {peak / 2**30:.2f} "
          f"GiB, held-out RMSE {rmse:.5f} (global-mean baseline {base:.5f}),"
          f" exact zeros in A_ {100 * zeros[0]:.1f}% B_ "
          f"{100 * zeros[1]:.1f}%; {_fmt_sweeps(spy.stats())}; launches "
          f"{launches} (expected {want})", flush=True)
    if launches != want:
        raise AssertionError("phase 28b did not run the expected launches")
    if not (rmse < base and min(zeros) > 0.0
            and np.isfinite(lmodel.A_).all()):
        raise AssertionError("phase 28b: out of bounds")
    paths["28b"] = launches
    del lmodel, spy
    torch.cuda.empty_cache()
    # 28b, second reading: an l1 at which factors stay; the last iteration's
    # calls are kept, one A bucket held against the twin
    with _CDSpy(keep=lambda i, G: i >= last) as spy:
        kmodel, klaunches, s, peak = _fit_phase(
            ops, lambda: cmfrec_torch.CMF(**L1_KEEP_FIT, device="cuda"
                                          ).fit_triplets(tr_r, tr_c, tr_v,
                                                         M, N))
    rmse = rmse_of(kmodel)
    zeros = (float(np.mean(kmodel.A_ == 0)), float(np.mean(kmodel.B_ == 0)))
    print(f"phase 28b l1_lambda={L1_KEEP} (phase 4's arguments, scale_lam) "
          f"on {card()}: fit {s:.3f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB, held-out RMSE {rmse:.5f} (global-mean "
          f"baseline {base:.5f}), exact zeros in A_ {100 * zeros[0]:.1f}% "
          f"B_ {100 * zeros[1]:.1f}%; {_fmt_sweeps(spy.stats())}; launches "
          f"{klaunches} (expected {want})", flush=True)
    if klaunches != want:
        raise AssertionError("phase 28b did not run the expected launches")
    if not (rmse < base and 0.0 < min(zeros) and max(zeros) < 1.0
            and np.isfinite(kmodel.A_).all()):
        raise AssertionError("phase 28b: out of bounds")
    kept_A = [spy.kept[i] for i in sorted(spy.kept)][n_cb:]
    l1_rec = check_cd("28b", {"A": widest(kept_A)})
    if not all(0.0 < r["zeros"] < 1.0 for r in l1_rec):
        raise AssertionError("phase 28b: the checked bucket's result is not "
                             "part zero, part nonzero")
    records += l1_rec
    paths["28b"] = {key: launches[key] + klaunches[key] for key in launches}
    del kmodel, spy, kept_A
    torch.cuda.empty_cache()

    # 29. serving the nonneg models
    users = np.sort(np.random.default_rng(21).choice(
        np.unique(tr_r), SERVE_USERS, replace=False))
    X, _ = _new_user_coo(users, tr_r, tr_c, tr_v, M, N)
    model.factors_multiple(X=X)  # warm-up: caches on the card
    torch.cuda.reset_peak_memory_stats()
    batches = []
    real = _spy(warm, "factors_explicit_batch", batches)
    try:
        _reset_launches(ops)
        with _CDSpy() as spy:
            (a, bias), s_serve = _timed_s(lambda: model.factors_multiple(
                X=X, return_bias=True))
        launches = _read_launches(ops)
    finally:
        warm.factors_explicit_batch = real
    X256 = X.tocsr()[:SERVE_CHECK].tocoo()
    card_a = np.column_stack(model.factors_multiple(X=X256,
                                                    return_bias=True))
    cpu_err = _rel(card_a, np.column_stack(_cpu_twin(
        model).factors_multiple(X=X256, return_bias=True)))
    Uc = U[:COLD_ROWS]
    _reset_launches(ops)
    cold, s_cold = _timed_s(lambda: cmodel.factors_multiple(U=Uc))
    one = cmodel.factors_cold(U=Uc[0])
    claunches = _read_launches(ops)
    peak = torch.cuda.max_memory_allocated()
    ctwin = _cpu_twin(cmodel)
    cold_err = max(_rel(cold, ctwin.factors_multiple(U=Uc)),
                   _rel(one, ctwin.factors_cold(U=Uc[0])))
    want = expect(len(batches))
    print(f"phase 29 nonneg serving on {card()}: phase 5b's {SERVE_USERS} "
          f"users into phase 26's model, {X.nnz} ratings, {len(batches)} "
          f"degree groups: factors_multiple {s_serve:.3f} s = "
          f"{SERVE_USERS / s_serve:.0f} users/s, min factor "
          f"{float(a.min()):.3g}, {SERVE_CHECK} users card vs CPU "
          f"{cpu_err:.2e} (limit {CD_SERVE_TOL:.0e}); "
          f"{_fmt_sweeps(spy.stats())}; launches {launches} (expected "
          f"{want}); cold factors of {COLD_ROWS} U rows on phase 28's model "
          f"{s_cold:.3f} s, card vs CPU {cold_err:.2e}, launches "
          f"{claunches} (expected {expect(2)}); peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    if launches != want or claunches != expect(2):
        raise AssertionError("phase 29 did not run the expected launches")
    if not (float(a.min()) >= 0.0 and float(cold.min()) >= 0.0
            and cpu_err <= CD_SERVE_TOL and cold_err <= CD_SERVE_TOL):
        raise AssertionError("phase 29: out of bounds")
    paths["29"] = {key: launches[key] + claunches[key] for key in launches}
    del model, cmodel, X, a, bias
    torch.cuda.empty_cache()
    return paths, records, half


# phase 30: K past 256.  The widths held kernel against twin: the dense
# engine's K at k = 300 (320), the bucketed one's at k = 260 (264, the
# implicit fit's) and k = 300 (304), and K = 1024; K3 also at 1032, past
# the rows design's ROWS_MAX_K, where the loop design serves buckets up to
# K3's shared-memory limit.  CMF(k=300) and
# CMF_implicit(k=260) run the flagship's and phase 7's 15 iterations
# (WIDE_FIT_NITER); K3's check is cut to an A bucket's first WIDE_K3_ROWS
# rows (the twin gathers [R, L, K] in f32), to hold the phase to about a
# minute, except at WIDE_K3_FULL_K, where the widest bucket and the one of
# the most slots are held at their full rows
WIDE_K = {"dense": (320, 1024), "bucketed": (264, 304, 1024, 1032)}
# the bf16 K2 also at a width of two column chunks of its wide kernel
# (320 + 256)
WIDE_K2_ONLY = (576,)
WIDE_FIT_NITER = 15
WIDE_K3_ROWS = 2048
WIDE_K3_FULL_K = 264
WIDE_FIT = dict(FIT, k=300)
WIDE_IMPLICIT_FIT = dict(IMPLICIT_FIT, k=260, niter=WIDE_FIT_NITER)
# fault P6: a K3 bucket past K3's shared-memory limit on an H100 (3,624)
# takes rowsolve.solve_cg; a CD solve past the streamed path's shared
# memory in float64 (4,842) keeps its vectors in a scratch.  A few rows each
P6_K3_K, P6_CD_K, P6_ROWS, P6_CD_SWEEPS = 3640, 4848, 4, 2
# the CD kernel against its twin at P6_CD_K in float64: the card tests'
# float64 limit (tests/test_torch_kernels_gpu.py CD_REL_TOL), since sums of
# 4,848 terms in another order stray further than CD_REL_TOL's K = 56 ones
P6_CD_TOL = 1e-10


class _CallEvents:
    """A function wrapped for a fit where `module` calls it by `name`: CUDA
    events around each call, by the type `label(*args)` names, read after
    the fit (no synchronisation inside it).  The function and the op's
    launch count stay."""

    def __init__(self, module, name, label):
        self.module, self.name, self.label = module, name, label

    def __enter__(self):
        import torch

        self.real, self.events = getattr(self.module, self.name), []

        def spy(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.real(*args, **kw)
            end.record()
            self.events.append((self.label(*args), start, end))
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def means(self):
        """{type: (calls, mean ms a call)}, after a synchronize."""
        by = {}
        for dt, start, end in self.events:
            by.setdefault(dt, []).append(start.elapsed_time(end))
        return {dt: (len(ms), sum(ms) / len(ms)) for dt, ms in by.items()}


def _dtype_name(t):
    return str(t.dtype).split(".")[-1]


def check_wide_kernels(rows, cols, vals, weights):
    """Phase 30's K1 and K2 against their twins at the A side of phase 3's
    dense X and W (69,888 x 10,688) at each of WIDE_K["dense"]: K1 with bf16
    operands on the int8 mask and on the bf16 weights, K1 with f32 operands,
    K2 with bf16 operands on the mask and on the weights and with f32
    operands; at WIDE_K2_ONLY the bf16 K2 alone; each call's launches, time,
    plain time, bound and plan.  Returns the records by kernel."""
    import torch

    from cmfrec_torch.ops import masked_matmul as mm

    _, sides = flagship_dense(rows, cols, vals, weights)
    R, S, Xs, W8, Wf = sides.pop("A")
    del sides
    Wb = Wf.to(torch.bfloat16)
    del Wf
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(30)
    mb = 3.5 + torch.randn(S, device=dev, generator=gen) / 2
    out = {"masked_gram_matvec": [], "masked_rhs": []}
    k2_bf16 = [("masked_rhs", "bf16", "int8"), ("masked_rhs", "bf16", "bf16")]
    for K in WIDE_K["dense"] + WIDE_K2_ONLY:
        Q = (None if K in WIDE_K2_ONLY
             else torch.randn(R, K, device=dev, generator=gen) / 8)
        Be = torch.randn(S, K, device=dev, generator=gen) / 8
        cases = k2_bf16 if K in WIDE_K2_ONLY else [
            ("masked_gram_matvec", "bf16", "int8"),
            ("masked_gram_matvec", "bf16", "bf16"),
            ("masked_gram_matvec", "f32", "int8"),
            *k2_bf16, ("masked_rhs", "f32", "int8")]
        for name, op, wname in cases:
            dt = torch.bfloat16 if op == "bf16" else torch.float32
            Wv = W8 if wname == "int8" else Wb
            Beo = Be.to(dt)
            if name == "masked_gram_matvec":
                kern, twin = mm.masked_gram_matvec, mm.masked_gram_matvec_ref
                args = (Q.to(dt), Beo, Wv)
                plan = mm.gram_plan(R, S, K, dt, Wv.dtype, dev)
            else:
                kern, twin = mm.masked_rhs, mm.masked_rhs_ref
                args = (Xs, Wv, mb, Beo)
                plan = mm.rhs_plan(R, S, K, dt, Wv.dtype, dev)
            kern.launches = 0
            got = kern(*args)
            launches = kern.launches
            ref = twin(*args)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            del got, ref
            ms = _timed(lambda: kern(*args), 2)
            plain_ms = _timed(lambda: twin(*args), 1)
            esz, wsz = (2 if op == "bf16" else 4), Wv.element_size()
            if name == "masked_gram_matvec":
                nbytes = (R + S) * K * esz + R * S * wsz + R * K * 4
                ops = 4 * R * S * K
            else:
                nbytes = R * S * (2 + wsz) + S * 4 + S * K * esz + R * K * 4
                ops = 2 * R * S * K
            b_ms, b_by = bound(nbytes, {op: ops})
            ok = bool(np.isfinite(rel)) and rel <= REL_TOL[op] and launches == 1
            print(f"phase 30 kernel {name} side=A R={R} S={S} K={K} op={op} "
                  f"W={wname}: configuration {plan['variant']}, nc "
                  f"{plan['col_chunk']}, column "
                  f"chunks {[w for _, w in plan['cols']]}, S chunk "
                  f"{plan['chunk']} ({plan['chunks']} chunks), smem "
                  f"{plan['smem']} B; "
                  f"max_abs_err={err:.3e} rel={rel:.3e} (tol "
                  f"{REL_TOL[op]:.0e}) launches={launches} ms={ms:.3f} "
                  f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                raise AssertionError(f"phase 30: {name} at K={K} disagrees "
                                     "with its twin")
            out[name].append(dict(
                side="A", R=R, S=S, K=K, op=op, W=wname, launches=launches,
                max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, plan=plan))
        del Q, Be
        torch.cuda.empty_cache()
    del Xs, W8, Wb
    torch.cuda.empty_cache()
    return out


def check_wide_bucket_cg(tr_r, tr_c, tr_v):
    """Phase 30's K3 against its twin on the A side's buckets of the
    LastFM-shaped layout at each of WIDE_K["bucketed"] (log-play
    coefficients and a bf16 opposing matrix, phase 6's main case).  Each
    bucket's first
    WIDE_K3_ROWS rows, with the plan of its full rows asserted to be the
    one checked and of its K's design (the rows design up to
    sparse_cg.ROWS_MAX_K, the loop design past it); at WIDE_K3_FULL_K the
    widest bucket and the one of the most slots at their full rows.
    Returns the records."""
    import types

    import torch

    from cmfrec_torch.data.device_fill import build_bucketed_pair
    from cmfrec_torch.ops import sparse_cg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    RB, _ = build_bucketed_pair(tr_r, tr_c, tr_v, LFM_M, LFM_N, device="cuda")
    records = []
    tol = K3_REL_TOL["implicit-log", "bf16"]
    for K in WIDE_K["bucketed"]:
        k = K - 4  # the k that pads to K (300 at 304, as the fits pad)
        lam = torch.ones(K, device=dev)
        lam[:k] = IMPLICIT_FIT["lambda_"]
        mat = torch.randn(LFM_N, K, device=dev, generator=gen) / k ** 0.5
        mat[:, k:] = 0.0
        gfix = mat.T @ mat + torch.diag(lam)
        matx = mat.to(torch.bfloat16)
        total_ms = 0.0
        whole = set()
        if K == WIDE_K3_FULL_K:
            whole = {max(range(len(RB.buckets)),
                         key=lambda j: RB.buckets[j].width),
                     max(range(len(RB.buckets)),
                         key=lambda j: RB.buckets[j].n_rows
                         * RB.buckets[j].width)}
        for i, full in enumerate(RB.buckets):
            R = full.n_rows if i in whole else min(full.n_rows, WIDE_K3_ROWS)
            plan = sparse_cg.plan_for(R, full.width, K, matx.dtype, dev)
            if plan != sparse_cg.plan_for(full.n_rows, full.width, K,
                                          matx.dtype, dev):
                raise AssertionError(f"phase 30: bucket {i}'s first {R} rows "
                                     f"at K={K} take another plan than its "
                                     f"{full.n_rows}")
            b = types.SimpleNamespace(
                width=full.width, n_rows=R, n_real=min(full.n_real, R),
                idx=full.idx[:R].contiguous(), val=full.val[:R].contiguous(),
                length=full.length[:R].contiguous())
            cw, cv, gf, lam_row, r0 = _bucket_case(b, mat, gfix,
                                                   "implicit-log", gen)
            a0 = torch.randn(R, K, device=dev, generator=gen) / 8
            a0[:, k:] = 0.0
            args = (matx, b.idx, cw.contiguous(), cv.contiguous(), gf, None,
                    None, a0)
            sparse_cg.bucket_cg.launches = 0
            got = sparse_cg.bucket_cg(*args, n_steps=K3_STEPS, length=b.length)
            launches = sparse_cg.bucket_cg.launches
            ref = sparse_cg.bucket_cg_ref(*args, n_steps=K3_STEPS)
            torch.cuda.synchronize()
            top = ref.abs().max().item()
            err = (got - ref).abs().max().item()
            rel, moved = err / top, (ref - a0).abs().max().item() / top
            del got, ref
            ms = _timed(lambda: sparse_cg.bucket_cg(
                *args, n_steps=K3_STEPS, length=b.length), 2)
            plain_ms = _timed(lambda: sparse_cg.bucket_cg_ref(
                *args, n_steps=K3_STEPS), 1)
            total_ms += ms
            real = (torch.arange(b.width, device=dev)[None, :]
                    < b.length[:, None])
            slots = int(b.length.sum())
            uniq = int(torch.unique(b.idx[real]).numel())
            nbytes = (uniq * K * 2 + slots * 12 + R * (4 + 8 * K)
                      + 4 * K * K)
            ops = {"bf16": slots * (2 * K + (1 + K3_STEPS) * 4 * K),
                   "f32": R * (1 + K3_STEPS) * 2 * K * K}
            b_ms, b_by = bound(nbytes, ops)
            rows_design = K <= sparse_cg.ROWS_MAX_K
            ok = (bool(np.isfinite(rel)) and rel <= tol and launches == 1
                  and moved >= K3_MOVE_FACTOR * tol and plan["k_loop"]
                  and ("rows" in plan) == rows_design)
            design = (f"rows a block {plan['rows']}" if "rows" in plan
                      else "loop design")
            print(f"phase 30 kernel bucket_cg side=A bucket={i} R={R} "
                  f"(of {full.n_rows}) L={b.width} slots={slots} K={K} "
                  f"op=bf16 implicit-log class={plan['cls']} {design} "
                  f"cluster={plan['cluster']} "
                  f"threads={plan['threads']} "
                  f"stage_slots={plan['stage_slots']}: max_abs_err={err:.3e} "
                  f"rel={rel:.3e} (tol {tol:.0e}) moved={moved:.3e} "
                  f"launches={launches} ms={ms:.3f} plain_ms={plain_ms:.3f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok:
                raise AssertionError(f"phase 30: bucket_cg at K={K} disagrees "
                                     "with its twin, checks too little or "
                                     "took the other design")
            records.append(dict(
                side="A", bucket=i, R=R, L=b.width, slots=slots, K=K,
                op="bf16", mode="implicit-log", launches=launches,
                max_abs_err=err, rel_err=rel, moved=moved, ms=ms,
                plain_ms=plain_ms, bytes=nbytes, ops=ops, bound_ms=b_ms,
                bound_by=b_by, plan=plan))
            del args, cw, cv, a0, b
        print(f"phase 30 kernel bucket_cg K={K}: the {len(RB.buckets)} A "
              f"buckets' rows checked in {total_ms:.3f} ms", flush=True)
        del mat, matx, gfix
        torch.cuda.empty_cache()
    del RB
    torch.cuda.empty_cache()
    return records


def check_p6(ops):
    """Fault P6 on the card: a K3 bucket at P6_K3_K (past K3's shared-memory
    limit), bf16 rows, through als.solve_bucket, the fit's call, must run
    rowsolve.solve_cg and launch no K3, and match K3's twin on the same
    operands (K3_REL_TOL of the log plays, bf16); solve_cd at P6_CD_K in
    float64 (the scratch configuration) must run its kernel and match its
    twin (P6_CD_TOL).  Prints each route's launch counts.  Returns the
    records."""
    import torch

    from cmfrec_torch.ops import _cuda, coord_descent, rowsolve, sparse_cg
    from cmfrec_torch.solvers import als

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(32)
    K, R, L, S = P6_K3_K, P6_ROWS, 64, 4096
    optin = _cuda.optin_smem(dev)
    opp = torch.randn(S, K, device=dev, generator=gen) / K ** 0.5
    length = torch.tensor([L, L // 2, 1, 0], dtype=torch.int32, device=dev)
    part = als.PartData(
        idx=torch.randint(0, S, (R, L), device=dev, generator=gen,
                          dtype=torch.int32),
        val=torch.log1p(100 * torch.rand(R, L, device=dev, generator=gen)),
        length=length, wgt=None, opp=opp.to(torch.bfloat16), opp_bias=None,
        w=1.0, alpha=1.0, mu=None)
    lam = torch.full((K,), IMPLICIT_FIT["lambda_"], device=dev)
    G0 = opp.T @ opp
    a0 = torch.randn(R, K, device=dev, generator=gen) / 8
    calls = {"solve_cg": 0}
    real = rowsolve.solve_cg

    def spy(*args, **kw):
        calls["solve_cg"] += 1
        return real(*args, **kw)

    _reset_launches(ops)
    rowsolve.solve_cg = spy
    try:
        got = als.solve_bucket(
            (part,), a0, G0, None, None, lam, None, modes=("implicit",),
            method="cg", n_steps=K3_STEPS, scale_lam=False, n_totals=(S,),
            mxu_bf16=True)
    finally:
        rowsolve.solve_cg = real
    k3_launches = _read_launches(ops)
    sp = als._coefficients(part, "implicit")
    ref = sparse_cg.bucket_cg_ref(part.opp, part.idx, sp.cw, sp.cv,
                                  G0 + torch.diag(lam), None, None, a0,
                                  n_steps=K3_STEPS)
    ref = torch.where((length > 0)[:, None], ref, 0.0)
    torch.cuda.synchronize()
    tol = K3_REL_TOL["implicit-log", "bf16"]
    top = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    k3 = dict(K=K, rows=R, takes_k3=als.takes_k3(torch.float32, False, K, dev),
              k_fits=sparse_cg.k_fits(K, optin), optin=optin,
              solve_cg_calls=calls["solve_cg"], launches=k3_launches,
              max_abs_err=err, rel_err=err / top)
    ok_k3 = (not k3["takes_k3"] and calls["solve_cg"] == 1
             and not any(k3_launches.values()) and k3["rel_err"] <= tol)
    print(f"phase 30 P6 K3 K={K} (bf16 rows, {R} rows, opt-in {optin} B): "
          f"route rowsolve.solve_cg ({calls['solve_cg']} call), launches "
          f"{k3_launches}; against K3's twin max_abs_err={err:.3e} "
          f"rel={k3['rel_err']:.3e} (tol {tol:.0e}) "
          f"{'ok' if ok_k3 else 'MISMATCH'}", flush=True)

    K = P6_CD_K
    Mt = torch.randn(R, K + 8, K, device=dev, generator=gen,
                     dtype=torch.float64) / (K + 8) ** 0.5
    G = Mt.transpose(1, 2) @ Mt + 0.1 * torch.eye(K, device=dev,
                                                  dtype=torch.float64)
    del Mt
    rhs = torch.randn(R, K, device=dev, generator=gen, dtype=torch.float64)
    l1 = torch.zeros(K, device=dev, dtype=torch.float64)
    plan = coord_descent.plan(K, False, torch.float64)
    _reset_launches(ops)
    got = coord_descent.solve_cd(G, rhs, l1, nonneg=True,
                                 max_steps=P6_CD_SWEEPS)
    cd_launches = _read_launches(ops)
    want = rowsolve.solve_cd(G, rhs, l1, True, P6_CD_SWEEPS)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    cd = dict(K=K, rows=R, sweeps=P6_CD_SWEEPS, dtype="f64", plan=plan,
              launches=cd_launches, max_abs_err=err,
              rel_err=err / want.abs().max().item())
    ok_cd = (plan["scratch"] and cd_launches["solve_cd"] == 1
             and cd["rel_err"] <= P6_CD_TOL)
    print(f"phase 30 P6 solve_cd K={K} f64 ({R} rows, {P6_CD_SWEEPS} "
          f"sweeps): plan {plan}, launches {cd_launches}; against the twin "
          f"max_abs_err={err:.3e} rel={cd['rel_err']:.3e} (tol "
          f"{P6_CD_TOL:.0e}) {'ok' if ok_cd else 'MISMATCH'}",
          flush=True)
    del G, got, want
    torch.cuda.empty_cache()
    if not (ok_k3 and ok_cd):
        raise AssertionError("phase 30: fault P6 not repaired")
    return {"bucket_cg": k3, "solve_cd": cd}


def wide_k_phases(ops, rows, cols, vals, test, weights, lastfm, ctx):
    """Phase 30: K past 256 at full width.  The kernels against their twins
    (check_wide_kernels, check_wide_bucket_cg), fault P6 (check_p6), then
    CMF(k=300) on the flagship's data and split through the dense engine (K
    = 320: K1's wide configurations, K2) and CMF_implicit(k=260) on the
    LastFM-shaped data (K = 264: K3's rows design), both at 15 iterations,
    with K1's mean time a call by operand type and K3's milliseconds an
    iteration and share of the fit from CUDA events around each call:
    held-out RMSE below the global mean's and P@10 above popularity, with
    their launches.  Returns (launch counts, kernel records)."""
    import torch

    import cmfrec_torch
    from cmfrec_torch.ops import sparse_cg
    from cmfrec_torch.solvers import dense_masked

    tr = ~test
    tr_r, tr_c, tr_v = rows[tr], cols[tr], vals[tr]
    l_r, l_c, l_v, l_te_r, l_te_c, test_users = lastfm
    records = check_wide_kernels(tr_r, tr_c, tr_v, weights)
    records["bucket_cg"] = check_wide_bucket_cg(l_r, l_c, l_v)
    records["p6"] = check_p6(ops)

    with _CallEvents(dense_masked, "masked_gram_matvec",
                     lambda Q, Be, W: _dtype_name(Be)) as k1, \
            _CallEvents(dense_masked, "masked_rhs",
                        lambda X, W, mb, Be: _dtype_name(Be)) as k2:
        model, launches, s, peak = _fit_phase(
            ops, lambda: cmfrec_torch.CMF(**WIDE_FIT, device="cuda")
            .fit_triplets(tr_r, tr_c, tr_v, M, N))
    k1_ms, k2_ms = k1.means(), k2.means()
    pred = model.predict(rows[test], cols[test])
    rmse = float(np.sqrt(np.mean((pred - vals[test]) ** 2)))
    base = float(np.sqrt(np.mean((tr_v.mean() - vals[test]) ** 2)))
    want = dense_launches(WIDE_FIT["niter"], rows=False)  # K = 320
    k1_text, k2_text = (", ".join(f"{dt} {n} calls {ms:.3f} ms a call"
                                  for dt, (n, ms) in sorted(by.items()))
                        for by in (k1_ms, k2_ms))
    print(f"phase 30 CMF(k=300) on {card()}: {WIDE_FIT['niter']} iterations "
          f"on the dense engine (K=320) in {s:.3f} s, peak device memory "
          f"{peak / 2**30:.2f} GiB, held-out RMSE {rmse:.5f} (global-mean "
          f"baseline {base:.5f}), A_ {model.A_.shape}; K1 in the fit: "
          f"{k1_text}; K2 in the fit: {k2_text}; launches {launches} "
          f"(expected {want})", flush=True)
    records["cmf_k300"] = dict(seconds=s, rmse=rmse, baseline=base,
                               k1_ms_a_call={dt: ms for dt, (_, ms)
                                             in k1_ms.items()},
                               k2_ms_a_call={dt: ms for dt, (_, ms)
                                             in k2_ms.items()},
                               launches=launches)
    if launches != want:
        raise AssertionError("phase 30: CMF(k=300) did not run the expected "
                             "launches")
    if not (np.all(np.isfinite(pred)) and rmse < base):
        raise AssertionError("phase 30: CMF(k=300) out of bounds")
    del model, pred
    torch.cuda.empty_cache()

    # K3's launches alone (sparse_cg.launch, which bucket_cg calls and counts)
    with _CallEvents(sparse_cg, "launch",
                     lambda mat, *a: _dtype_name(mat)) as k3:
        imodel, ilaunches, s, peak = _fit_phase(
            ops, lambda: cmfrec_torch.CMF_implicit(
                **WIDE_IMPLICIT_FIT, device="cuda").fit_triplets(
                    l_r, l_c, l_v, LFM_M, LFM_N))
    k3_ms = {dt: n * ms for dt, (n, ms) in k3.means().items()}
    k3_total = sum(k3_ms.values())
    Ad, Bd = imodel._device_x_factors()
    p10, map10, p10_pop = ranking_quality(Ad, Bd, l_r, l_c, l_te_r, l_te_c,
                                          test_users, LFM_N)
    want = dict(NO_LAUNCHES,
                bucket_cg=WIDE_FIT_NITER * ctx["n_buckets_7"])
    print(f"phase 30 CMF_implicit(k=260) on {card()}: {WIDE_FIT_NITER} "
          f"iterations on the bucketed engine (K=264) in {s:.3f} s, peak "
          f"device memory {peak / 2**30:.2f} GiB, P@10 {p10:.5f} (popularity "
          f"{p10_pop:.5f}; phase 7 at k=50 {ctx['p10_7']:.5f}), MAP@10 "
          f"{map10:.5f}; K3 in the fit: {k3_total:.3f} ms, "
          f"{k3_total / WIDE_FIT_NITER:.3f} ms an iteration ("
          + ", ".join(f"{dt} {ms:.3f}" for dt, ms in sorted(k3_ms.items()))
          + f"), {k3_total / 1e3 / s:.3f} of the fit's seconds; launches "
          f"{ilaunches} (expected {want})", flush=True)
    records["cmf_implicit_k260"] = dict(
        seconds=s, p10=p10, p10_pop=p10_pop, k3_ms=k3_total,
        k3_ms_an_iteration=k3_total / WIDE_FIT_NITER,
        k3_share=k3_total / 1e3 / s, launches=ilaunches)
    if ilaunches != want:
        raise AssertionError("phase 30: CMF_implicit(k=260) did not run the "
                             "expected launches")
    if not (np.isfinite(imodel.A_).all() and np.isfinite(imodel.B_).all()
            and p10 > p10_pop):
        raise AssertionError("phase 30: CMF_implicit(k=260) out of bounds")
    del imodel, Ad, Bd
    torch.cuda.empty_cache()
    paths = {key: launches[key] + ilaunches[key] for key in launches}
    return {"30": paths}, records


# phase 31: a mesh fit is held bitwise to its meshless phase where that
# phase's fit repeats bitwise (4, 7 and 14 on an NVIDIA H100).  Where it
# does not (17: the f32 L-BFGS; torch.sparse.mm of a CSR matrix on the card
# is not bitwise repeatable, and 800 iterations carry that into one of two
# basins whose factors lie ~2.2 apart, meshless fits as much as mesh ones:
# scripts/lbfgs_repeat_torch.py, NVIDIA H100 80GB HBM3, 700 W), it is held
# by its held-out quality within MESH_QUALITY_TOL of the phase's (the
# fold-in tolerances of phases 5b and 7b) and the phase's bar, its
# factors' distance printed beside the meshless repeat's; and by its
# objective and gradient at the fit's start, one evaluation through mesh=
# against the meshless one before the iterations carry the products'
# rounding into another basin: |f_mesh - f| / |f| and ||g_mesh - g|| /
# ||g|| each within MESH_LBFGS_TOL, or 10 x a second meshless evaluation's
# where that is larger
MESH_QUALITY_TOL = {"rmse": FOLDIN_RMSE_TOL, "p10": FOLDIN_P10_TOL}
MESH_LBFGS_TOL = 1e-5
# phase 31b (two or more cards): phase 4 on a 2-rank NCCL group against
# phase 4's fit.  A half share of the rows changes K1's and K2's split-S
# chunks and the bias start's sums, and 15 bf16 iterations carry the f32
# reorder: on four NVIDIA H100 80GB HBM3 (700 W) the factors part by up
# to 3.8e-3 of max|factor| while the held-out RMSE agrees to 1e-5, so
# tests/test_multidevice.py:116-119's rtol 1e-4 / atol 1e-5 (4 f32
# iterations at 128 x 96) cannot hold; printed beside the gate, which is
# the RMSE within MESH2_RMSE_TOL and every factor within MESH2_REL_TOL of
# its max|.|
MESH2_RTOL, MESH2_ATOL = 1e-4, 1e-5
MESH2_RMSE_TOL = 1e-4
MESH2_REL_TOL = 1e-2
MESH2_TIMEOUT = 600  # seconds the two ranks may take, build and data in
TOPN_USERS = 256  # phase 31(e)'s users


def _model_arrays(model):
    """A fitted model's factors and biases as host arrays (those it has)."""
    return {key: np.asarray(getattr(model, key)) for key in
            ("A_", "B_", "C_", "D_", "user_bias_", "item_bias_")
            if getattr(model, key, None) is not None}


def _max_diff(got, want):
    """max |got - want| over the arrays of ``want`` (inf where one is
    missing or of another shape)."""
    out = 0.0
    for key, w in want.items():
        g = got.get(key)
        if g is None or g.shape != w.shape:
            return float("inf")
        out = max(out, float(np.abs(g.astype(np.float64) - w).max()))
    return out


def _split_ml10m():
    """Phase 4's data and split, from the cached file (main builds it)."""
    from bench import _cached, make_ml10m_shaped
    from cmfrec_torch.ops import _cuda

    rows, cols, vals = _cached(make_ml10m_shaped,
                               str(_cuda.BUILD_DIR / "ml10m_shaped.npz"))
    test = np.random.default_rng(1).uniform(size=rows.size) < 0.05
    return rows, cols, vals, test


def _rank_31b(rank, world, address, out):
    """One rank of phase 31b: phase 4's fit on a ``world``-rank NCCL group,
    rank 0 saving the model's arrays to ``out``."""
    import torch.distributed as dist

    import cmfrec_torch
    from cmfrec_torch.parallel.mesh import init_distributed

    mesh = init_distributed(address, world, rank)
    rows, cols, vals, test = _split_ml10m()
    tr = ~test
    model = cmfrec_torch.CMF(**FIT, device="cuda").fit_triplets(
        rows[tr], cols[tr], vals[tr], M, N, mesh=mesh)
    if rank == 0:
        np.savez(out, pred=model.predict(rows[test], cols[test]),
                 **_model_arrays(model))
    dist.destroy_process_group()


def _spawn_ranks(target, world, args, what):
    """``world`` spawned processes, one a card, on a localhost NCCL
    address; raises unless every one ends with 0 within MESH2_TIMEOUT.
    Returns the seconds they took."""
    import multiprocessing
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, address) + args)
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(0.0, MESH2_TIMEOUT - (time.perf_counter() - t0)))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise AssertionError(f"{what}: ranks ended with {codes}")
    return time.perf_counter() - t0


def _off(got, arrays, vals):
    """How far rank 0's result ``got`` lies from a reference: max|got -
    ref| / max|ref| for each of the reference's ``arrays``, and the RMSE
    of got["pred"] against ``vals``."""
    rel = {key: float(np.abs(got[key] - w).max() / np.abs(w).max())
           for key, w in arrays.items()}
    return rel, float(np.sqrt(np.mean((got["pred"] - vals) ** 2)))


def two_card_phase(ref):
    """Phase 31b where the machine has two cards or more: phase 4 on a
    2-rank NCCL group (one process a card, spawned), held to phase 4's fit
    (MESH2_RMSE_TOL, MESH2_REL_TOL; MESH2_RTOL / MESH2_ATOL's reading
    printed); printed and skipped on one card."""
    import torch

    from cmfrec_torch.ops import _cuda

    if torch.cuda.device_count() < 2:
        print("phase 31b: not run, this machine has one card "
              f"({torch.cuda.device_count()}); it needs two", flush=True)
        return
    out = _cuda.BUILD_DIR / "phase31b.npz"
    wall = _spawn_ranks(_rank_31b, 2, (str(out),), "phase 31b")
    got = dict(np.load(out))
    rel, rmse = _off(got, ref["arrays"], ref["test_vals"])
    worst = max(float(np.max(np.abs(got[key] - w) - MESH2_RTOL * np.abs(w)))
                for key, w in ref["arrays"].items())
    print(f"phase 31b CMF(...).fit(X, mesh=) on 2 ranks (NCCL, "
          f"{torch.cuda.device_count()} cards: "
          f"{'; '.join(dict.fromkeys(card().splitlines()))}) in "
          f"{wall:.1f} s (spawn, data and kernels' load "
          f"in): held-out RMSE {rmse:.5f} (phase 4 {ref['quality']:.5f}, "
          f"within {MESH2_RMSE_TOL:.0e}); max|mesh - phase 4| / max|phase "
          f"4| by array {rel} (limit {MESH2_REL_TOL:.0e}); max(|mesh - "
          f"phase 4| - {MESH2_RTOL:.0e} |phase 4|) {worst:.2e} (not "
          f"gated: {MESH2_ATOL:.0e} needs the same sum order)", flush=True)
    if (max(rel.values()) > MESH2_REL_TOL
            or abs(rmse - ref["quality"]) > MESH2_RMSE_TOL):
        raise AssertionError("phase 31b: the 2-rank fit is off phase 4's")


class _IterTimer:
    """drivers._explicit_sparse_iteration timed, each call synchronized
    before and after (``its``: seconds a call), and the device memory the
    fit holds at rest read as each call starts (``rest``: bytes).  With
    ``reset_peak`` the device's peak memory so far is kept as
    ``setup_peak`` and reset at the first call, so max_memory_allocated()
    after the fit reads the iterations' peak (what the fit holds then
    included)."""

    def __init__(self, reset_peak=False):
        self.reset_peak, self.setup_peak = reset_peak, 0

    def __enter__(self):
        import torch

        from cmfrec_torch.solvers import drivers

        self.mod, self.real = drivers, drivers._explicit_sparse_iteration
        self.its, self.rest = [], []

        def timed(*a, **kw):
            torch.cuda.synchronize()
            self.rest.append(torch.cuda.memory_allocated())
            if self.reset_peak and not self.its:
                self.setup_peak = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = self.real(*a, **kw)
            torch.cuda.synchronize()
            self.its.append(time.perf_counter() - t0)
            return res

        drivers._explicit_sparse_iteration = timed
        return self

    def __exit__(self, *exc):
        self.mod._explicit_sparse_iteration = self.real

    def half_ms(self):
        """(the first iteration's ms a half-step, the median of the
        others')."""
        its = 1e3 * np.asarray(self.its) / 2
        return float(its[0]), float(np.median(its[1:]))


def _ring_big_data():
    """RING_BIG's ratings, made from seed 32: uniform (user, item) pairs
    without repeats, each rated 3.5 + a rank-8 product + N(0, 0.7^2),
    rounded to halves in [0.5, 5] as bench.make_ml10m_shaped rates."""
    m, n, nnz = RING_BIG
    rng = np.random.default_rng(32)
    pairs = np.unique(rng.integers(0, m * n, nnz + nnz // 50,
                                   dtype=np.int64))
    rng.shuffle(pairs)
    pairs = pairs[:nnz]
    r, c = pairs // n, pairs % n
    A = (0.35 * rng.standard_normal((m, 8))).astype(np.float32)
    B = (0.35 * rng.standard_normal((n, 8))).astype(np.float32)
    v = (3.5 + np.einsum("nk,nk->n", A[r], B[c])
         + 0.7 * rng.standard_normal(nnz).astype(np.float32))
    return r, c, np.clip(np.round(v * 2) / 2, 0.5, 5.0).astype(np.float64)


def _rank_32b(rank, world, address, out, ring):
    """One rank of phase 32b: 32(a)'s fit, then RING_BIG's, on a
    ``world``-rank NCCL group, through the ring (``ring``) or slice 7a's
    data-parallel mesh=.  For each (``a_``, ``big_``) every rank saves its
    seconds, its iterations' seconds (synchronized), what it holds at rest
    as each iteration starts and its peak device memory over the fit and
    over the iterations to ``out``.<rank>.npz; rank 0 also the arrays and
    predictions (32(a)'s held-out ratings, RING_BIG's first
    RING_BIG_SAMPLE)."""
    import torch
    import torch.distributed as dist

    from cmfrec_torch.parallel.mesh import init_distributed
    from cmfrec_torch.solvers import drivers

    mesh = init_distributed(address, world, rank)
    rows, cols, vals, test = _split_ml10m()
    tr = ~test
    b_r, b_c, b_v = _ring_big_data()
    sample = np.arange(RING_BIG_SAMPLE)
    cases = (("a", rows[tr], cols[tr], vals[tr], M, N, RING_FIT,
              (rows[test], cols[test])),
             ("big", b_r, b_c, b_v, RING_BIG[0], RING_BIG[1], RING_BIG_FIT,
              (b_r[sample], b_c[sample])))
    stats = {}
    for case, r, c, v, m, n, fit, (pr, pc) in cases:
        dist.barrier()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _IterTimer(reset_peak=True) as timer:
            res = drivers.fit_explicit_als(r, c, v, m, n, engine="sparse",
                                           device="cuda", mesh=mesh,
                                           shard_opposing_rows=ring, **fit)
            torch.cuda.synchronize()
        peak_iter = torch.cuda.max_memory_allocated()
        st = dict(seconds=time.perf_counter() - t0,
                  iterations=np.asarray(timer.its),
                  rest=np.asarray(timer.rest),
                  peak=max(timer.setup_peak, peak_iter),
                  setup_peak=timer.setup_peak, peak_iter=peak_iter)
        if rank == 0:
            rt, ct = (torch.as_tensor(a, device="cuda") for a in (pr, pc))
            st.update(pred=(res["glob_mean"] + res["biasA"][rt]
                            + res["biasB"][ct] + (res["A"][rt] * res["B"][
                                ct]).sum(dim=1)).cpu().numpy(),
                      **_res_arrays(res))
        stats.update({f"{case}_{key}": val for key, val in st.items()})
        del res
    np.savez(f"{out}.{rank}.npz", **stats)
    dist.destroy_process_group()


def two_card_ring_phase(ref):
    """Phase 32b where the machine has two cards or more: on 2-rank NCCL
    groups, and 4-rank ones where it has four cards, 32(a) and RING_BIG's
    fit through the ring and through slice 7a's mesh= at the same world:
    each rank's device memory at rest and at its peak and its seconds a
    half-step (its iterations' median past the first, synchronized).
    32(a)'s ring is held to 32(a)'s meshless repeat (``ref``), RING_BIG's
    to 7a's fit at the same world: the RMSE within MESH2_RMSE_TOL and
    every array within MESH2_REL_TOL of its max|.|.  Each rank's set-up
    peak is printed beside its iterations' and beside
    WHOLE_BUILD_SETUP_PEAK; after the last world the capped run on 2
    ranks (:func:`_capped_ring`).  Printed and skipped on one card."""
    import torch

    from cmfrec_torch.ops import _cuda

    cards = torch.cuda.device_count()
    worlds = [w for w in RING2_WORLDS if w <= cards]
    if not worlds:
        print("phase 32b: not run, this machine has one card "
              f"({cards}); it needs two", flush=True)
        return
    m, n, nnz = RING_BIG
    k_pad = -(-(RING_BIG_FIT["k"] + 1) // 8) * 8
    truth = _ring_big_data()[2][:RING_BIG_SAMPLE]
    for world in worlds:
        runs, wall = {}, {}
        for mode in ("ring", "mesh"):
            out = _cuda.BUILD_DIR / f"phase32b_{mode}{world}"
            wall[mode] = _spawn_ranks(
                _rank_32b, world, (str(out), mode == "ring"),
                f"phase 32b ({mode}, {world} ranks)")
            runs[mode] = [dict(np.load(f"{out}.{r}.npz"))
                          for r in range(world)]

        def of(mode, case, r=0):
            """Rank r's readings of one case."""
            return {key[len(case) + 1:]: val for key, val in
                    runs[mode][r].items() if key.startswith(case + "_")}

        def per_rank(mode, case):
            lines = []
            for r in range(world):
                st = of(mode, case, r)
                its = 1e3 * st["iterations"] / 2
                lines.append(
                    f"rank {r}: at rest {st['rest'][1:].max() / 2**30:.3f} "
                    f"GiB, peak {st['peak'] / 2**30:.3f} GiB (set-up "
                    f"{st['setup_peak'] / 2**30:.3f}, the iterations' "
                    f"{st['peak_iter'] / 2**30:.3f}), "
                    f"{np.median(its[1:]):.1f} ms a half-step (the first "
                    f"iteration's {its[0]:.1f}), fit {st['seconds']:.2f} s")
            return "; ".join(lines)

        rel, rmse = _off(of("ring", "a"), ref["arrays"], ref["test_vals"])
        same = {case: all(np.array_equal(of("ring", case)[key],
                                         of("mesh", case)[key])
                          for key in ("A", "B", "biasA", "biasB"))
                for case in ("a", "big")}
        mesh_big = of("mesh", "big")
        want = _off(mesh_big, {}, truth)[1]
        rel_big, rmse_big = _off(of("ring", "big"), {
            key: mesh_big[key] for key in ("A", "B", "biasA", "biasB")},
            truth)
        head = (f"on {world} ranks (NCCL, {cards} cards: "
                f"{'; '.join(dict.fromkeys(card().splitlines()))})")
        print(f"phase 32b(a) ring {head}: {per_rank('ring', 'a')} (both "
              f"cases spawned and done in {wall['ring']:.1f} s); slice "
              f"7a's mesh=: {per_rank('mesh', 'a')}; one card, meshless "
              f"(32(a)'s repeat): {ref['half_ms'][1]:.1f} ms a half-step "
              f"(the first iteration's {ref['half_ms'][0]:.1f}), peak "
              f"{ref['peak'] / 2**30:.3f} GiB; held-out RMSE {rmse:.5f} "
              f"(32(a)'s repeat {ref['quality']:.5f}, within "
              f"{MESH2_RMSE_TOL:.0e}); max|ring - repeat| / max|repeat| by "
              f"array {rel} (limit {MESH2_REL_TOL:.0e}); the ring's arrays "
              f"{'bitwise equal to' if same['a'] else 'not bitwise'} 7a's",
              flush=True)
        print(f"phase 32b(big) {m} x {n}, {nnz} ratings, k "
              f"{RING_BIG_FIT['k']}, {RING_BIG_FIT['niter']} iterations, "
              f"ring {head}: {per_rank('ring', 'big')}; slice 7a's mesh=: "
              f"{per_rank('mesh', 'big')}; a rank's A and B "
              f"{(m + n) * k_pad * 4 / world / 2**30:.3f} GiB under the "
              f"ring, {(m + n) * k_pad * 4 / 2**30:.3f} under 7a ((S_A + "
              f"S_B) K itemsize / D and whole); RMSE on the first "
              f"{RING_BIG_SAMPLE} ratings {rmse_big:.5f} (7a {want:.5f}, "
              f"within {MESH2_RMSE_TOL:.0e}); max|ring - 7a| / max|7a| by "
              f"array {rel_big} (limit {MESH2_REL_TOL:.0e}); "
              f"{'bitwise equal' if same['big'] else 'not bitwise'}",
              flush=True)
        print(f"phase 32b(a) set-up peak a rank, {head}: ring "
              f"{_peaks(runs['ring'], 'a')}, 7a's mesh= "
              f"{_peaks(runs['mesh'], 'a')} GiB (each rank building the "
              f"whole layout: {WHOLE_BUILD_SETUP_PEAK / 2**30:.3f})",
              flush=True)
        if (max(rel.values()) > MESH2_REL_TOL
                or abs(rmse - ref["quality"]) > MESH2_RMSE_TOL
                or max(rel_big.values()) > MESH2_REL_TOL
                or abs(rmse_big - want) > MESH2_RMSE_TOL
                or not np.isfinite(rmse_big)):
            raise AssertionError(f"phase 32b: the {world}-rank ring fit is "
                                 f"off its reference")
        if world == 2:
            capped = (runs["ring"], of("ring", "a"), head)
    _capped_ring(*capped)


def _peaks(ranks, case):
    """Each rank's set-up peak of ``case`` in GiB, comma-separated."""
    return ", ".join(f"{st[case + '_setup_peak'] / 2**30:.3f}"
                     for st in ranks)


def _capped_ring(ranks, uncapped, head):
    """32b's capped run: 32(a) through the ring on 2 ranks again, each
    process's device memory capped midway between the uncapped run's peak
    (``ranks``, each rank's readings) and WHOLE_BUILD_SETUP_PEAK, the
    set-up that building the whole layout on every rank took: it must
    complete with rank 0's arrays bitwise equal to the uncapped run's
    (``uncapped``)."""
    from cmfrec_torch.ops import _cuda
    from scripts.ring_capped_torch import capped_run, describe

    peak = max(float(st["a_peak"]) for st in ranks)
    cap = (peak + WHOLE_BUILD_SETUP_PEAK) / 2
    if cap <= peak * 1.02:
        raise AssertionError(f"phase 32b capped: the uncapped peak "
                             f"{peak / 2**30:.3f} GiB leaves no cap below "
                             f"{WHOLE_BUILD_SETUP_PEAK / 2**30:.3f}")
    records, wall = capped_run(cap, _cuda.BUILD_DIR / "phase32b_capped")
    done = all(str(st["outcome"]) == "completed" for st in records)
    same = done and all(np.array_equal(records[0][key], uncapped[key])
                        for key in ("A", "B", "biasA", "biasB"))
    print(f"phase 32b(a) capped ring {head}: each process capped at "
          f"{cap / 2**30:.3f} GiB (torch.cuda.set_per_process_memory_"
          f"fraction; the uncapped peak {peak / 2**30:.3f}, the whole "
          f"build's set-up {WHOLE_BUILD_SETUP_PEAK / 2**30:.3f}), "
          f"{wall:.1f} s: {describe(records)}; rank 0's arrays "
          f"{'bitwise equal to' if same else 'not equal to'} the uncapped "
          f"run's", flush=True)
    if not same:
        raise AssertionError("phase 32b capped: the capped ring fit did not "
                             "complete bitwise equal to the uncapped one")


def _lbfgs_start_reading(tr_r, tr_c, tr_v, lambda_, mesh):
    """31(d)'s start check: phase 17's objective (value, gradient) at its
    seeded start (CollectiveProblem.init_params(1)), through ``mesh`` and
    twice without.  Returns {"f", "g"}: (the mesh's relative difference,
    the meshless repeat's), of |f| and of ||g||."""
    import torch

    from cmfrec_torch.solvers import lbfgs

    def evaluate(mesh_):
        prob = lbfgs.CollectiveProblem(
            tr_r, tr_c, tr_v, M, N, k=LBFGS_FIT["k"], lambda_=lambda_,
            dtype=np.float32, device="cuda", mesh=mesh_)
        f, g = prob.value_and_grad(prob.init_params(1))
        return float(f), torch.cat([g[key].reshape(-1).double()
                                    for key in sorted(g)])

    f0, g0 = evaluate(None)
    f1, g1 = evaluate(None)
    fm, gm = evaluate(mesh)
    norm = float(torch.linalg.vector_norm(g0))
    out = {"f": (abs(fm - f0) / abs(f0), abs(f1 - f0) / abs(f0)),
           "g": (float(torch.linalg.vector_norm(gm - g0)) / norm,
                 float(torch.linalg.vector_norm(g1 - g0)) / norm)}
    del g0, g1, gm
    torch.cuda.empty_cache()
    return out


def mesh_phases(ops, rows, cols, vals, test, lastfm, refs):
    """Phase 31: the mesh path on the card.  A world of one on NCCL
    (init_distributed on a local store), then phases 4, 7, 14 and 17
    through the public fit(..., mesh=make_mesh()), each beside a meshless
    repeat of its phase: launches equal to the phase's, the factors
    bitwise equal to the phase's where the repeat is (else within the
    stated tolerance), the phase's quality bar; then topn_sharded against
    ops/predict.topn.  ``refs``: each phase's arrays, launches, seconds and
    quality.  Returns (the fits' launch counts by phase, the mesh, which
    phase 32 takes over)."""
    import torch
    import torch.distributed as dist

    import cmfrec_torch
    from cmfrec_torch.ops.predict import topn
    from cmfrec_torch.parallel.mesh import init_distributed
    from cmfrec_torch.parallel.topn import topn_sharded

    tr = ~test
    tr_r, tr_c, tr_v = rows[tr], cols[tr], vals[tr]
    l_r, l_c, l_v, l_te_r, l_te_c, test_users = lastfm
    t0 = time.perf_counter()
    mesh = init_distributed()
    t_init = time.perf_counter() - t0
    # NCCL makes its communicator at the first collective: take it here,
    # outside the fits' seconds
    dist.barrier()
    torch.cuda.synchronize()
    print(f"phase 31 mesh: {dist.get_backend()} world of "
          f"{dist.get_world_size()}, DeviceMesh {tuple(mesh.mesh.tolist())} "
          f"({mesh.device_type}) on {card()}: the group in {t_init:.2f} s, "
          f"NCCL's communicator (a first barrier) in "
          f"{time.perf_counter() - t0 - t_init:.2f} s", flush=True)
    U, I = make_user_tags(), make_item_genres()

    def rmse(model):
        pred = model.predict(rows[test], cols[test])
        return float(np.sqrt(np.mean((pred - vals[test]) ** 2)))

    def p10(model):
        Ad, Bd = model._device_x_factors()
        return ranking_quality(Ad, Bd, l_r, l_c, l_te_r, l_te_c, test_users,
                               LFM_N)[0]

    fits = {
        "4": (lambda mesh: cmfrec_torch.CMF(**FIT, device="cuda")
              .fit_triplets(tr_r, tr_c, tr_v, M, N, mesh=mesh), rmse),
        "7": (lambda mesh: cmfrec_torch.CMF_implicit(
            **IMPLICIT_FIT, device="cuda").fit_triplets(
            l_r, l_c, l_v, LFM_M, LFM_N, mesh=mesh), p10),
        "14": (lambda mesh: cmfrec_torch.CMF(
            **FIT, NA_as_zero_item=True, device="cuda").fit_triplets(
            tr_r, tr_c, tr_v, M, N, U=U, I=I, mesh=mesh), rmse),
        "17": (lambda mesh: cmfrec_torch.CMF(**LBFGS_FIT, device="cuda")
               .fit_triplets(tr_r, tr_c, tr_v, M, N, mesh=mesh), rmse),
    }
    paths = {}
    keep = None
    for label, (ph, (fit, quality)) in zip("abcd", fits.items()):
        ref = refs[ph]
        again, _, s_again, peak_again = _fit_phase(ops, lambda: fit(None))
        rep = _max_diff(_model_arrays(again), ref["arrays"])
        del again
        torch.cuda.empty_cache()
        model, launches, s, peak = _fit_phase(ops, lambda: fit(mesh))
        got = _max_diff(_model_arrays(model), ref["arrays"])
        q = quality(model)
        metric = "p10" if quality is p10 else "rmse"
        q_tol = 0.0 if rep == 0 else MESH_QUALITY_TOL[metric]
        bar = ref["bar"]
        good = (q >= bar if metric == "p10" else q <= bar) and (
            abs(q - ref["quality"]) <= q_tol)
        start = ""
        if ph == "17":
            t0 = time.perf_counter()
            reading = _lbfgs_start_reading(tr_r, tr_c, tr_v, model.lambda_,
                                           mesh)
            start = "; at the start " + ", ".join(
                f"{key} {got_:.2e} (limit "
                f"{max(MESH_LBFGS_TOL, 10 * rep_):.2e}; the meshless "
                f"repeat {rep_:.2e})" for key, (got_, rep_) in
                reading.items()) + (f" of |f| and ||g||, evaluated in "
                                    f"{time.perf_counter() - t0:.1f} s")
            good = good and all(got_ <= max(MESH_LBFGS_TOL, 10 * rep_)
                                for got_, rep_ in reading.values())
        print(f"phase 31({label}) phase {ph} with mesh=: {s:.3f} s (the "
              f"meshless repeat {s_again:.3f} s, phase {ph} "
              f"{ref['seconds']:.3f} s), peak device memory "
              f"{peak / 2**30:.2f} GiB (the repeat {peak_again / 2**30:.2f});"
              f" max|mesh - phase {ph}| {got:.3e} "
              f"({'limit 0: bitwise, as' if rep == 0 else 'not gated:'} "
              f"the meshless repeat's {rep:.3e}); {metric} {q:.5f} (phase "
              f"{ph} {ref['quality']:.5f}, within {q_tol}; bar {bar:.5f})"
              f"{start}; launches {launches} (phase {ph} "
              f"{ref['launches']})", flush=True)
        if launches != ref["launches"] or (rep == 0 and got > 0) or not good:
            raise AssertionError(f"phase 31({label}): the mesh fit is off "
                                 f"phase {ph}'s")
        paths[f"31({label})"] = launches
        if ph == "4":
            keep = model
        else:
            del model
        torch.cuda.empty_cache()

    # 31(e). distributed topN against the plain ranking on 31(a)'s model
    users = np.random.default_rng(31).choice(np.unique(tr_r), TOPN_USERS,
                                             replace=False)
    A, B = keep._device_x_factors()
    bias = keep._on_device("item_bias_")
    bad = 0
    t0 = time.perf_counter()
    for u in users:
        idx, s = topn_sharded(A[int(u)], B, 10, bias, mesh)
        ref_idx, ref_s = topn(A[int(u)], B, 10, bias)
        bad += int(not (np.array_equal(idx.cpu().numpy(), ref_idx)
                        and np.array_equal(s.cpu().numpy(), ref_s)))
    print(f"phase 31(e) topn_sharded for {TOPN_USERS} of phase 4's users "
          f"against ops/predict.topn: {TOPN_USERS - bad} equal in ids and "
          f"scores, {bad} not, in {time.perf_counter() - t0:.2f} s",
          flush=True)
    if bad:
        raise AssertionError("phase 31(e): topn_sharded is off topn")
    del keep, A, B, bias
    torch.cuda.empty_cache()
    return paths, mesh


# phase 32: the big-axis ring (shard_opposing_rows=True) on 31's NCCL world
# of one, each fit beside its meshless repeat.  At one rank every route's
# sums are the meshless ones (one shard holds every slot; Gram bases sum
# the rows in their original order, parallel/ring.py:row_sum), so the
# factors should equal the repeat's bit for bit; the gate is that, or
# every array within the CPU tests' tolerance (tests/test_torch_ring.py):
# |ring - repeat| <= atol + rtol |repeat|, the reading printed
RING_FIT = dict(FIT, use_cg=False)
RING_IMPLICIT_FIT = dict(IMPLICIT_FIT, use_cg=False)
RING_NONNEG_FIT = dict(NONNEG_FIT, use_cg=False)
RING_TOL = {"explicit": (1e-4, 1e-5), "implicit": (2e-3, 1e-4)}
# phase 32b (two cards or more): 32(a) on 2-rank (and 4-rank) NCCL groups
# against 32(a)'s meshless repeat, gated as 31b is: RMSE within
# MESH2_RMSE_TOL, every array within MESH2_REL_TOL of its max|.|
RING2_WORLDS = (2, 4)
# and a fit whose factor matrices are large beside its data: 2,000,000
# users x 1,000,000 items, 8,000,000 ratings drawn uniformly (4 a user, 8
# an item on average), k = 32, three Cholesky iterations; the ring held to
# 7a's mesh= at the same world (the RMSE on the first RING_BIG_SAMPLE
# ratings), what a rank holds at rest and at its peak printed
RING_BIG = (2_000_000, 1_000_000, 8_000_000)
# 32(a)'s set-up peak a rank when every mesh rank built the whole bucketed
# layout and cut its share (at 2 and at 4 ranks, NVIDIA H100 80GB HBM3,
# 700 W: this phase on the tree before the share build).  32b's capped run
# puts each 2-rank ring process's device memory cap midway between the
# uncapped run's peak (set-up and iterations) and this
WHOLE_BUILD_SETUP_PEAK = 1.005 * 2**30
RING_BIG_FIT = dict(RING_FIT, k=32, niter=3)
RING_BIG_SAMPLE = 200_000


class _RingSpy:
    """What a ring fit does, recorded: the largest shard of each side a
    rank holds (parallel/ring.py:RingSide.shard; bytes), the parts
    assembled by the ring and those gathered whole, by their opposing
    matrix's rows in all (als.update_side's opposing_operand)."""

    def __enter__(self):
        from cmfrec_torch.parallel import ring
        from cmfrec_torch.solvers import als

        self.shards, self.rung, self.whole = {}, {}, {}
        self.real = (ring.RingSide.shard, als.opposing_operand)
        shard, operand = self.real

        def spy_shard(side, blocks):
            out = shard(side, blocks)
            self.shards[side.n_total] = max(
                self.shards.get(side.n_total, 0),
                out.numel() * out.element_size())
            return out

        def spy_operand(mat, bias, mesh):
            out = operand(mat, bias, mesh)
            tally = self.rung if out[2] is not None else self.whole
            rows = mat.shape[0] * ring.world_rank(mesh)[0]
            tally[rows] = tally.get(rows, 0) + 1
            return out

        ring.RingSide.shard = spy_shard
        als.opposing_operand = spy_operand
        return self

    def __exit__(self, *exc):
        from cmfrec_torch.parallel import ring
        from cmfrec_torch.solvers import als

        ring.RingSide.shard, als.opposing_operand = self.real


class _WithRing:
    """``module.name`` (a driver the models call) run with
    shard_opposing_rows=True whenever it is given a mesh."""

    def __init__(self, module, name):
        self.module, self.name = module, name

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def ringed(*a, **kw):
            if kw.get("mesh") is not None:
                kw["shard_opposing_rows"] = True
            return real(*a, **kw)

        setattr(self.module, self.name, ringed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _res_arrays(res):
    """A driver's result as host arrays (its factors and biases)."""
    return {key: res[key].cpu().numpy() for key in
            ("A", "B", "C", "D", "biasA", "biasB")
            if res.get(key) is not None}


def _ring_reading(got, want, tol):
    """(bitwise, max over arrays of max(|got - want| - rtol |want|),
    max|got - want| / max|want| by array)."""
    bitwise = all(np.array_equal(got[key], w) for key, w in want.items())
    worst = max(float(np.max(np.abs(got[key] - w) - tol[0] * np.abs(w)))
                for key, w in want.items())
    rel = {key: float(np.abs(got[key] - w).max() / np.abs(w).max())
           for key, w in want.items()}
    return bitwise, worst, rel


def _explicit_rmse(res, rows, cols, vals, test):
    """Held-out RMSE of a driver's explicit result (no k splits)."""
    import torch

    dev = res["A"].device
    rt, ct = (torch.as_tensor(a[test], device=dev) for a in (rows, cols))
    k = res["k"]
    pred = (res["glob_mean"] + res["biasA"][rt] + res["biasB"][ct]
            + (res["A"][rt, :k] * res["B"][ct, :k]).sum(dim=1)).cpu().numpy()
    if not np.all(np.isfinite(pred)):
        raise AssertionError("non-finite predictions")
    return float(np.sqrt(np.mean((pred - vals[test]) ** 2)))


def ring_phases(ops, rows, cols, vals, test, lastfm, mesh):
    """Phase 32: the big-axis ring on the card, on phase 31's NCCL world of
    one: (a) phase 8's flagship through drivers.fit_explicit_als(
    engine="sparse", use_cg=False, mesh=, shard_opposing_rows=True), (b)
    phase 7's WRMF through drivers.fit_implicit_als(use_cg=False, ...), (c)
    phase 14's collective bucketed fit (CMF with U tags and I genres,
    use_cg=False), (d) phase 26's nonneg flagship (CMF(nonneg=True), the
    CD kernel on the ring-assembled systems, held against its twin on one
    A bucket of the last half-step); each after a meshless repeat of the
    same call: seconds, launches, peak memory, each side's shard bytes a
    rank (S K itemsize / D), the parts that ring and those gathered whole,
    the factors against the repeat (bitwise or RING_TOL) and the phase's
    quality bar.  Returns (launch counts by path, the CD check's records,
    32(a)'s repeat: arrays, RMSE)."""
    import torch

    import cmfrec_torch
    from cmfrec_torch.solvers import collective, drivers

    tr = ~test
    tr_r, tr_c, tr_v = rows[tr], cols[tr], vals[tr]
    l_r, l_c, l_v, l_te_r, l_te_c, test_users = lastfm
    base = float(np.sqrt(np.mean((tr_v.mean() - vals[test]) ** 2)))
    n_rb, n_cb = n_chunks(tr_r, M), n_chunks(tr_c, N)
    U, I = make_user_tags(), make_item_genres()
    print(f"phase 32 ring: shard_opposing_rows=True on the NCCL world of "
          f"{mesh.size()} ({card()})", flush=True)

    def rmse_model(model):
        pred = model.predict(rows[test], cols[test])
        if not np.all(np.isfinite(pred)):
            raise AssertionError("non-finite predictions")
        return float(np.sqrt(np.mean((pred - vals[test]) ** 2)))

    def p10_res(res):
        return ranking_quality(res["A"], res["B"], l_r, l_c, l_te_r, l_te_c,
                               test_users, LFM_N)[0]

    fits = {
        "a": ("8", "explicit", lambda m: drivers.fit_explicit_als(
            tr_r, tr_c, tr_v, M, N, engine="sparse", device="cuda", mesh=m,
            shard_opposing_rows=m is not None, **RING_FIT)),
        "b": ("7", "implicit", lambda m: drivers.fit_implicit_als(
            l_r, l_c, l_v, LFM_M, LFM_N, device="cuda", mesh=m,
            shard_opposing_rows=m is not None, **RING_IMPLICIT_FIT)),
        "c": ("14", "explicit", lambda m: cmfrec_torch.CMF(
            **RING_FIT, NA_as_zero_item=True, device="cuda").fit_triplets(
            tr_r, tr_c, tr_v, M, N, U=U, I=I, mesh=m)),
        "d": ("26", "explicit", lambda m: cmfrec_torch.CMF(
            **RING_NONNEG_FIT, device="cuda").fit_triplets(
            tr_r, tr_c, tr_v, M, N, mesh=m)),
    }
    def widest(calls):
        return max(calls, key=lambda c: c[0].shape[0])

    paths, cd_records, ref_a = {}, [], None
    niter = FIT["niter"]
    last = (niter - 1) * (n_cb + n_rb)
    for label, (ph, kind, fit) in fits.items():
        patch = {"c": (collective, "fit_collective_explicit_als"),
                 "d": (drivers, "fit_explicit_als")}.get(label)
        # (d) keeps its last iteration's CD inputs in both fits, so that
        # the two peaks hold the same copies
        def keep(i, G):
            return label == "d" and i >= last

        timed = _IterTimer if label == "a" else contextlib.nullcontext
        with _WithRing(*patch) if patch else contextlib.nullcontext():
            with _CDSpy(keep=keep), timed() as t_again:
                again, _, s_again, peak_again = _fit_phase(
                    ops, lambda: fit(None))
            if label == "a":
                ref_a = dict(arrays=_res_arrays(again),
                             quality=_explicit_rmse(again, rows, cols, vals,
                                                    test),
                             test_vals=vals[test], half_ms=t_again.half_ms(),
                             peak=peak_again)
            want = (_model_arrays(again) if hasattr(again, "A_")
                    else _res_arrays(again))
            del again
            torch.cuda.empty_cache()
            with _RingSpy() as spy, _CDSpy(keep=keep) as cds, \
                    timed() as t_ring:
                out, launches, s, peak = _fit_phase(ops, lambda: fit(mesh))
        got = _model_arrays(out) if hasattr(out, "A_") else _res_arrays(out)
        tol = RING_TOL[kind]
        bitwise, worst, rel = _ring_reading(got, want, tol)
        expected = dict(NO_LAUNCHES, solve_cd=(niter * (n_rb + n_cb)
                                               if label == "d" else 0))
        if label == "a":
            metric, q = "RMSE", _explicit_rmse(out, rows, cols, vals, test)
            good = q <= RMSE_BOUND
            bar = f"<= {RMSE_BOUND:.4f}"
        elif label == "b":
            metric, q = "P@10", p10_res(out)
            good, bar = q >= P10_BOUND, f">= {P10_BOUND:.4f}"
        elif label == "c":
            metric, q = "RMSE", rmse_model(out)
            good, bar = q <= RMSE_BOUND, f"<= {RMSE_BOUND:.4f}"
        else:
            metric, q = "RMSE", rmse_model(out)
            mins = min(float(np.min(v)) for v in got.values())
            good = q < base and mins >= 0.0
            bar = f"< {base:.5f} (the global mean's), min factor {mins:.3g}"
        shards = "; ".join(
            f"{rows_} rows: {b / 2**20:.2f} MiB a rank (S K itemsize / D)"
            for rows_, b in sorted(spy.shards.items()))
        halves = ("" if label != "a" else
                  f" ({t_ring.half_ms()[1]:.1f} ms a half-step, the "
                  f"repeat {t_again.half_ms()[1]:.1f}; medians, each "
                  f"iteration synchronized)")
        print(f"phase 32({label}) phase {ph} through the ring: {s:.3f} s "
              f"(the meshless repeat {s_again:.3f} s){halves}, peak device "
              f"memory "
              f"{peak / 2**30:.2f} GiB (the repeat "
              f"{peak_again / 2**30:.2f}); opposing shards {shards}; parts "
              f"ringed by opposing rows {dict(sorted(spy.rung.items()))}, "
              f"gathered whole {dict(sorted(spy.whole.items()))}; "
              f"{'bitwise equal to the repeat' if bitwise else 'not bitwise'}"
              f": max(|ring - repeat| - {tol[0]:.0e} |repeat|) {worst:.3e} "
              f"(limit {tol[1]:.0e}), max|ring - repeat| / max|repeat| by "
              f"array {rel}; {metric} {q:.5f} (bar {bar}); launches "
              f"{launches} (expected {expected})", flush=True)
        if launches != expected or worst > tol[1] or not good:
            raise AssertionError(f"phase 32({label}): the ring fit is off "
                                 f"its meshless repeat, its launches or its "
                                 f"bar")
        if label == "d":
            kept = [cds.kept[i] for i in sorted(cds.kept)]
            cd_records = check_cd("32(d)", {"A": widest(kept[n_cb:])})
            del kept
        paths[f"32({label})"] = launches
        del out, spy, cds
        torch.cuda.empty_cache()
    return paths, cd_records, ref_a


# phase 33: CMFREC_TORCH_PROFILE=<dir> (utils/profiling.py) around phase 8's
# bucketed fit and phase 4's flagship at PROFILE_NITER iterations: each
# writes one torch.profiler trace, whose kernel events must name the port's
# own CUDA kernels on its path (csrc/sparse_cg.cu, csrc/masked_matmul.cu)
PROFILE_NITER = 2
PROFILE_KERNELS = {"8": ("bucket_cg_kernel",),
                   "4": ("gram_bf16_wgmma_kernel", "rhs_bf16_wgmma_kernel")}


def profile_phase(ops, rows, cols, vals, test):
    """Phase 33: phases 8 and 4 at PROFILE_NITER iterations under
    CMFREC_TORCH_PROFILE, each into a directory of its own under build/:
    seconds, the trace file and its size, its kernel events, the device
    time of the named kernels, and launches against the expected.  Returns
    the launch counts by path."""
    import os
    import tempfile

    import cmfrec_torch
    from cmfrec_torch.ops import _cuda
    from cmfrec_torch.solvers import drivers
    from cmfrec_torch.utils.profiling import PROFILE_ENV

    tr = ~test
    fit = dict(FIT, niter=PROFILE_NITER)
    fits = {
        "8": (lambda: drivers.fit_explicit_als(
            rows[tr], cols[tr], vals[tr], M, N, engine="sparse",
            device="cuda", **fit),
            dict(NO_LAUNCHES, bucket_cg=(PROFILE_NITER - 1) * (
                n_chunks(rows[tr], M) + n_chunks(cols[tr], N)))),
        "4": (lambda: cmfrec_torch.CMF(**fit, device="cuda").fit_triplets(
            rows[tr], cols[tr], vals[tr], M, N),
            dense_launches(PROFILE_NITER)),
    }
    paths = {}
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD_DIR) as tmp:
        for ph, (fn, want) in fits.items():
            logdir = pathlib.Path(tmp) / ph
            os.environ[PROFILE_ENV] = str(logdir)
            try:
                _, launches, s, _ = _fit_phase(ops, fn)
            finally:
                del os.environ[PROFILE_ENV]
            files = sorted(logdir.glob("*.pt.trace.json"))
            kernels = {}
            for f in files:
                for e in json.loads(f.read_text())["traceEvents"]:
                    if e.get("cat") == "kernel":
                        kernels[e["name"]] = (kernels.get(e["name"], 0.0)
                                              + float(e.get("dur", 0.0)))
            found = {k: sum(us for name, us in kernels.items() if k in name)
                     for k in PROFILE_KERNELS[ph]}
            named = {k: sum(1 for name in kernels if k in name)
                     for k in PROFILE_KERNELS[ph]}
            mib = sum(f.stat().st_size for f in files) / 2**20
            print(f"phase 33({ph}) phase {ph} at {PROFILE_NITER} iterations "
                  f"under {PROFILE_ENV}: {s:.3f} s, {len(files)} trace "
                  f"file(s), {mib:.1f} MiB, {len(kernels)} distinct "
                  f"kernels; device ms of the "
                  f"port's by name " + ", ".join(
                      f"{k} {us / 1e3:.3f} ({named[k]} variant(s))"
                      for k, us in found.items())
                  + f"; launches {launches} (expected {want})", flush=True)
            if (len(files) != 1 or launches != want
                    or not all(named.values())):
                raise AssertionError(f"phase 33({ph}): no trace, or it does "
                                     f"not name {PROFILE_KERNELS[ph]}, or "
                                     f"the launches are off")
            paths[f"33({ph})"] = launches
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
    from cmfrec_torch.ops import _cuda, coord_descent, k1_probes, sparse_cg
    from cmfrec_torch.ops import masked_matmul as mm
    from cmfrec_torch.solvers import drivers
    from scripts.sweep_k1_probes_torch import sweep

    ops = {"masked_gram_matvec": mm.masked_gram_matvec,
           "masked_gram_matvec_rows": mm.masked_gram_matvec_rows,
           "masked_rhs": mm.masked_rhs, "bucket_cg": sparse_cg.bucket_cg,
           "solve_cd": coord_descent.solve_cd}
    probe_ops = {w.__name__: w for w in k1_probes.WRAPPERS}

    # 1. environment
    print(card())
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
    # 3b. K1 on the row lists
    k1_rows = check_k1_rows(rows[tr], cols[tr], vals[tr], weights)
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
    # what phase 31 holds its mesh fits to, by phase
    refs = {"4": dict(arrays=_model_arrays(model), launches=launches,
                      seconds=fit_s, quality=rmse, bar=RMSE_BOUND,
                      test_vals=vals[test])}

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
    want = dict(NO_LAUNCHES, bucket_cg=IMPLICIT_FIT["niter"] * n_buckets)
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
    refs["7"] = dict(arrays=_model_arrays(imodel), launches=ilaunches,
                     seconds=ifit_s, quality=p10, bar=P10_BOUND)
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
    want = dict(NO_LAUNCHES, bucket_cg=(FIT["niter"] - 1) * (
        n_chunks(rows[tr], M) + n_chunks(cols[tr], N)))
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
                                      test_users), p10, refs)
    paths.update(bpaths)

    # 17-21. the L-BFGS family, the offsets models, ContentBased and
    # MostPopular
    lastfm = (tr_r, tr_c, tr_v, te_r, te_c, test_users)
    ctx = dict(rmse_4=rmse, p10_7=p10, p10_pop_7=p10_pop, p10_7b=p10_fold,
               n_buckets_7=n_buckets, refs=refs)
    paths.update(lbfgs_family_phases(ops, rows, cols, vals, test, lastfm,
                                     ctx))

    # 22-24. float64 and Jacobi PCG (25 ran after 16)
    paths.update(float64_phases(ops, rows, cols, vals, test, lastfm, ctx))

    # 26-29. coordinate descent
    cd_paths, cd_records, cd_half = cd_phases(ops, rows, cols, vals, test,
                                              lastfm, ctx)
    paths.update(cd_paths)

    # 30. K past 256
    wide_paths, wide = wide_k_phases(ops, rows, cols, vals, test, weights,
                                     lastfm, ctx)
    paths.update(wide_paths)

    # 31. the mesh path; 32. the big-axis ring on its world of one (31b and
    # 32b on two cards or more)
    mesh_paths, mesh = mesh_phases(ops, rows, cols, vals, test, lastfm, refs)
    paths.update(mesh_paths)
    ring_paths, ring_cd, ring_ref = ring_phases(ops, rows, cols, vals, test,
                                                lastfm, mesh)
    paths.update(ring_paths)
    import torch.distributed as dist

    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # 33. the fits traced under CMFREC_TORCH_PROFILE
    paths.update(profile_phase(ops, rows, cols, vals, test))

    two_card_phase(refs["4"])
    two_card_ring_phase(ring_ref)

    kernels = []
    for name, variants in results.items():
        main_variant = next(v for v in variants if v["side"] == "A"
                            and v["op"] == "bf16" and v["W"] == "int8")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            cuda_kernels=CUDA_KERNELS[name],
            replaces=REPLACES[name], launches=launches[name],
            launches_by_phase={ph: c[name] for ph, c in paths.items()},
            max_abs_err=max(v["max_abs_err"] for v in variants + wide[name]),
            ms=main_variant["ms"], plain_ms=main_variant["plain_ms"],
            bound_ms=main_variant["bound_ms"],
            bound_by=main_variant["bound_by"], library_ms=None,
            variants=variants, wide_k=wide[name],
            cmf_k300=wide["cmf_k300"]))
    # K1 on the row lists: A side, int8 mask; it replaces no TPU kernel (the
    # f32 K1's form for sparse systems)
    head = next(v for v in k1_rows if v["side"] == "A" and v["W"] == "int8")
    kernels.append(dict(
        name="masked_gram_matvec_rows", route="cuda",
        source=SOURCES["masked_gram_matvec_rows"],
        cuda_kernels=CUDA_KERNELS["masked_gram_matvec_rows"], replaces=None,
        launches=launches["masked_gram_matvec_rows"],
        launches_by_phase={ph: c["masked_gram_matvec_rows"]
                           for ph, c in paths.items()},
        max_abs_err=max(v["max_abs_err"] for v in k1_rows),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, variants=k1_rows))
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
        max_abs_err=max(r["max_abs_err"] for r in k3 + wide["bucket_cg"]),
        ms=sum(r["ms"] for r in main),
        plain_ms=sum(r["plain_ms"] for r in main), bound_ms=k3_bound,
        bound_by=k3_by, library_ms=None, variants=k3,
        multipart_check=multipart, wide_k=wide["bucket_cg"],
        cmf_implicit_k260=wide["cmf_implicit_k260"], p6=wide["p6"]["bucket_cg"]))
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
    # the CD kernel: times on the A side's kept bucket in f32 (phase 26);
    # no single PyTorch call solves a batch of box- or l1-constrained
    # quadratic programs
    head = next(r for r in cd_records if r["phase"] == "26"
                and r["side"] == "A" and r["dtype"] == "f32")
    kernels.append(dict(
        name="solve_cd", route="cuda", source=SOURCES["solve_cd"],
        cuda_kernels=CUDA_KERNELS["solve_cd"], replaces=REPLACES["solve_cd"],
        launches=paths["26"]["solve_cd"],
        launches_by_phase={ph: c["solve_cd"] for ph, c in paths.items()},
        max_abs_err=max(r["max_abs_err"]
                        for r in cd_records + ring_cd
                        + [wide["p6"]["solve_cd"]]),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, shape=head["shape"],
        sweeps=head["sweeps"], half_step=cd_half,
        variants=cd_records + ring_cd,
        p6=wide["p6"]["solve_cd"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
