#!/usr/bin/env python3
"""Where the time of cmfrec_torch's warm serving goes, on one CUDA card.

Run from the repository root:

    python3 scripts/prof_serving_torch.py [--serve explicit|implicit]

``--serve explicit`` (the default) is chip_smoke.py phase 5b's batch: the
8,192 training users of bench.make_ml10m_shaped() that phase picks, folded
in from their training ratings by CMF.factors_multiple (the degree-grouped
route), on a CMF at the flagship's shape (k=50, lambda 0.05, scale_lam,
biases) whose factors are drawn from a seed: the solves cost the same
whatever the factors.  ``--serve implicit`` is phase 7b's: the 2,000
held-out users of bench_implicit.make_lastfm_shaped() folded in from their
training plays by CMF_implicit.factors_multiple, on a CMF_implicit at the
LastFM shape (k=50).  For either:

  1. one cold call (first upload of the model's matrices) and three warm
     calls, with users/s;
  2. one warm call under torch.profiler: device busy, idle share = 1 -
     (union of the device's kernel and copy intervals) / (host wall time),
     and device time by kernel;
  3. with the profiler off, one warm call whose spans are each synchronized
     at their end: the stateless ingest (_ingest_X_new), the group solves
     (warm.factors_explicit_batch or factors_implicit_batch, host and device
     time), the download, and the rest (grouping and packing on the host);
  4. topN_warm(n=10, exclude=seen) for 8 of the users: median ms, and one
     call under the profiler (device busy, idle share, kernel and copy
     counts).

Prints one line per measurement and, last, one JSON object with all of
them.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from scripts.prof_fit_torch import (  # noqa: E402
    _busy_us, _device_events, _timed_wrapper)


def _model(kind, m, n, seed=0, device="cuda"):
    """A model at the cell's shape with factors drawn from ``seed``."""
    import cmfrec_torch

    rng = np.random.default_rng(seed)
    A = (0.3 * rng.normal(size=(m, 50))).astype(np.float32)
    B = (0.3 * rng.normal(size=(n, 50))).astype(np.float32)
    if kind == "implicit":
        return cmfrec_torch.CMF_implicit.from_model_matrices(
            A, B, lambda_=5.0, alpha=1.0, device=device)
    return cmfrec_torch.CMF.from_model_matrices(
        A, B, glob_mean=3.5,
        user_bias=(0.2 * rng.normal(size=m)).astype(np.float32),
        item_bias=(0.2 * rng.normal(size=n)).astype(np.float32),
        lambda_=0.05, scale_lam=True, device=device)


def _profiled(fn):
    """(wall s, device busy ms, idle share, device events) of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = _device_events(prof)
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    return wall, busy / 1e3, 1.0 - busy / 1e6 / wall, dev


def profile_serving(kind, model, X, seen):
    import torch

    from cmfrec_torch.models import base
    from cmfrec_torch.solvers import warm

    R = X.shape[0]

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.factors_multiple(X=X)
        return time.perf_counter() - t0

    out = {"users": R, "entries": int(X.nnz)}
    out["cold_s"] = call()
    out["warm_s"] = [call() for _ in range(3)]
    out["users_per_s"] = [R / s for s in out["warm_s"]]
    print(f"{kind}: {R} users, {X.nnz} entries; factors_multiple cold "
          f"{out['cold_s']:.3f} s, warm "
          f"{', '.join(f'{t:.3f}' for t in out['warm_s'])} s = "
          f"{', '.join(f'{u:.0f}' for u in out['users_per_s'])} users/s",
          flush=True)

    wall, busy, idle, dev = _profiled(lambda: model.factors_multiple(X=X))
    per_kernel = {}
    for e in dev:
        k = per_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e3
    out.update(profiled_s=wall, device_busy_ms=busy, idle_share=idle)
    out["device_ms_by_kernel"] = {
        name: {"calls": c, "ms": ms} for name, ms, c in
        sorted(((nm, v[1], v[0]) for nm, v in per_kernel.items()),
               key=lambda x: -x[1])[:12]}
    print(f"profiled call: {wall:.3f} s, device busy {busy:.1f} ms, idle "
          f"share {idle:.3f}", flush=True)
    for name, v in out["device_ms_by_kernel"].items():
        print(f"  {v['ms']:9.2f} ms {v['calls']:5d} calls  {name[:90]}")

    batch = ("factors_implicit_batch" if kind == "implicit"
             else "factors_explicit_batch")
    spans = [(base._BaseModel, "_ingest_X_new"), (warm, batch),
             (warm, "download")]
    totals = {}
    orig = [_timed_wrapper(mod, name, totals, torch.cuda.synchronize)
            for mod, name in spans]
    try:
        wall = call()
    finally:
        for (mod, name), fn in zip(spans, orig):
            setattr(mod, name, fn)
    out["host_split_s"] = {"call": wall, **totals,
                           "rest": wall - sum(totals.values())}
    print("split (each span synchronized): " + ", ".join(
        f"{k} {v:.4f} s" for k, v in out["host_split_s"].items()), flush=True)

    rows = X.tocsr()
    topn_ms = []

    def topn(u):
        lo, hi = rows.indptr[u], rows.indptr[u + 1]
        c, v = rows.indices[lo:hi], rows.data[lo:hi]
        return model.topN_warm(n=10, X_col=c, X_val=v, exclude=c)

    for u in range(seen):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        topn(u)
        topn_ms.append((time.perf_counter() - t0) * 1e3)
    wall, busy, idle, dev = _profiled(lambda: topn(0))
    copies = sum("Memcpy" in e.name for e in dev)
    out["topN_warm"] = dict(median_ms=float(np.median(topn_ms)),
                            ms=topn_ms, profiled_ms=wall * 1e3,
                            device_busy_ms=busy, idle_share=idle,
                            device_events=len(dev), copies=copies)
    print(f"topN_warm: median {np.median(topn_ms):.2f} ms of {seen} users; "
          f"profiled {wall * 1e3:.2f} ms, device busy {busy:.3f} ms, idle "
          f"share {idle:.3f}, {len(dev)} device events ({copies} copies)",
          flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--serve", choices=("explicit", "implicit"),
                    default="explicit", help="which cell to serve")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("prof_serving_torch: torch sees no CUDA device", file=sys.stderr)
        return 1
    from bench import _cached
    from chip_smoke import (LFM_M, LFM_N, SERVE_TOPN, SERVE_USERS, M, N,
                            _new_user_coo)
    from cmfrec_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.serve == "explicit":
        from bench import make_ml10m_shaped

        rows, cols, vals = _cached(make_ml10m_shaped,
                                   str(_cuda.BUILD_DIR / "ml10m_shaped.npz"))
        tr = ~(np.random.default_rng(1).uniform(size=rows.size) < 0.05)
        rows, cols, vals = rows[tr], cols[tr], vals[tr]
        users = np.sort(np.random.default_rng(21).choice(
            np.unique(rows), SERVE_USERS, replace=False))
        X, _ = _new_user_coo(users, rows, cols, vals, M, N)
        model = _model("explicit", M, N)
    else:
        from bench_implicit import make_lastfm_shaped, split_heldout

        lrows, lcols, lvals = _cached(
            make_lastfm_shaped, str(_cuda.BUILD_DIR / "lastfm_shaped.npz"))
        tr_r, tr_c, tr_v, _, _, test_users = split_heldout(lrows, lcols,
                                                           lvals, LFM_M)
        X, _ = _new_user_coo(test_users, tr_r, tr_c, tr_v, LFM_M, LFM_N)
        model = _model("implicit", LFM_M, LFM_N)
    out = profile_serving(args.serve, model, X, SERVE_TOPN)
    out["card"] = smi
    out["serve"] = args.serve
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
