#!/usr/bin/env python3
"""Smoke run of cmfrec_torch on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own line(s):
  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: compiles the CUDA kernels from cmfrec_torch/csrc/ for sm_90a;
  3. kernels: each variant of masked_gram_matvec (K1) and masked_rhs (K2)
     against its plain torch twin on the card, at both orientations of the
     flagship fit (X/W built from the ML10M-shaped data), with errors and
     CUDA-event times;
  4. fit: the flagship explicit ALS-CG fit through the public CMF entry point
     (k=50, lambda 0.05, scale_lam, 15 iterations, CG 3, f32 polish), with its
     kernel launch counts, held-out RMSE against the global-mean baseline;
  5. serving: predict on the held-out pairs and topN for a few users.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; so
does a machine without a CUDA device, or a directory without the package.
"""

import json
import subprocess
import sys
import time

import numpy as np

M, N = 69878, 10677  # ML10M's shape (bench.make_ml10m_shaped)
FIT = dict(k=50, lambda_=0.05, scale_lam=True, niter=15, use_cg=True,
           max_cg_steps=3, finalize_chol=True, user_bias=True,
           item_bias=True, center=True)
# JAX package's held-out RMSE on the same data (BENCH_r05.json) plus 0.01
# for a different random init
RMSE_BOUND = 0.73078 + 0.01
# K1 = 14 bulk iterations x 2 half-steps x (1 + 3 CG steps)
#      + the polish's 2 x (1 + 16);  K2 = one per half-step
EXPECTED_LAUNCHES = {"masked_gram_matvec": 14 * 2 * 4 + 2 * 17,
                     "masked_rhs": 15 * 2}
# max|kernel - twin| / max|twin|, set about 7x above the largest readings at
# these shapes (1.4e-4 bf16, 6.5e-6 f32, NVIDIA H100): f32 differs by
# summation order only; bf16 also flips a few roundings of T*W to bf16
REL_TOL = {"bf16": 1e-3, "f32": 5e-5}
REPLACES = {"masked_gram_matvec": "cmfrec_tpu/ops/masked_matmul.py:87",
            "masked_rhs": "cmfrec_tpu/ops/masked_matmul.py:108"}


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


def check_kernels(rows, cols, vals, weights):
    """Phase 3: every kernel variant against its twin at the flagship shapes."""
    import torch

    from cmfrec_torch.ops import masked_matmul as mm
    from cmfrec_torch.solvers.dense_masked import _setup, padded_dims

    m_pad, n_pad, Kp = padded_dims(M, N, FIT["k"])
    dev = torch.device("cuda")
    up = {key: torch.as_tensor(a).to(dev) for key, a in
          (("r", rows), ("c", cols), ("v", vals.astype(np.float32)),
           ("w", weights.astype(np.float32)))}
    X, W8, XT, W8T, _, _ = _setup(up["r"], up["c"], up["v"], None, m_pad, n_pad)
    _, Wf, _, WfT, _, _ = _setup(up["r"], up["c"], up["v"], up["w"], m_pad,
                                 n_pad)
    gen = torch.Generator(device=dev).manual_seed(0)
    sides = {"A": (m_pad, n_pad, X, W8, Wf), "B": (n_pad, m_pad, XT, W8T, WfT)}
    results = {"masked_gram_matvec": [], "masked_rhs": []}
    for side, (R, S, Xs, W8s, Wfs) in sides.items():
        Q = torch.randn(R, Kp, device=dev, generator=gen) / 8
        Be = torch.randn(S, Kp, device=dev, generator=gen) / 8
        mb = 3.5 + torch.randn(S, device=dev, generator=gen) / 2
        for op, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            Qo, Beo = Q.to(dt), Be.to(dt)
            for wname, Wv in (("int8", W8s), ("f32", Wfs)):
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
                    print(f"kernel {name} side={side} R={R} S={S} K={Kp} "
                          f"op={op} W={wname}: max_abs_err={err:.3e} "
                          f"rel={rel:.3e} (tol {REL_TOL[op]:.0e}) "
                          f"ms={ms:.3f} plain_ms={plain_ms:.3f} "
                          f"{'ok' if ok else 'MISMATCH'}", flush=True)
                    if not ok:
                        raise AssertionError(f"{name} disagrees with its twin")
                    results[name].append(dict(
                        side=side, R=R, S=S, K=Kp, op=op, W=wname,
                        max_abs_err=err, rel_err=rel, ms=ms,
                        plain_ms=plain_ms))
                    del out, ref
    return results


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import cmfrec_torch
    from bench import _cached, make_ml10m_shaped
    from cmfrec_torch.ops import _cuda
    from cmfrec_torch.ops import masked_matmul as mm

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
    mm.masked_gram_matvec.launches = 0
    mm.masked_rhs.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = cmfrec_torch.CMF(**FIT, device="cuda").fit_triplets(
        rows[tr], cols[tr], vals[tr], M, N)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"masked_gram_matvec": mm.masked_gram_matvec.launches,
                "masked_rhs": mm.masked_rhs.launches}
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

    kernels = []
    for name, variants in results.items():
        main_variant = next(v for v in variants if v["side"] == "A"
                            and v["op"] == "bf16" and v["W"] == "int8")
        kernels.append(dict(
            name=name, route="cuda",
            source="cmfrec_torch/csrc/masked_matmul.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=max(v["max_abs_err"] for v in variants),
            ms=main_variant["ms"], plain_ms=main_variant["plain_ms"],
            variants=variants))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
