#!/usr/bin/env python3
"""Where the time of a cmfrec_torch fit goes, on one CUDA card.

Run from the repository root:

    python3 scripts/prof_fit_torch.py [--fit explicit|implicit] [--out DIR]

``--fit explicit`` (the default) fits the flagship configuration of
chip_smoke.py (explicit ALS-CG, k=50, 15 iterations, CG 3, f32 polish) on
bench.make_ml10m_shaped() with the same 5% held out, through
CMF.fit_triplets; ``--fit implicit`` fits chip_smoke.py's WRMF configuration
(k=50, lambda 5, alpha 1, 15 iterations, CG 3) on the train split of
bench_implicit.make_lastfm_shaped(), through CMF_implicit.fit_triplets.
For either:

  1. one cold fit (CUDA context, cuBLAS and allocator warm-up included);
  2. two warm fits;
  3. one warm fit under torch.profiler, which gives the device time per
     kernel and the idle share = 1 - (union of the device's kernel and copy
     intervals) / (host wall time of the fit);
  4. with the profiler off, the host wall time of ingest (_ingest_X), of
     the engine's spans (explicit: fit_explicit_dense_masked; implicit: the
     bucket layout build _build_pair and the iterations
     _implicit_sparse_iteration), each synchronized at its end, and of the
     rest (COO build, driver checks, result download).

Prints one line per measurement and, last, one JSON object with all of
them.  With --out, also writes the profiler's per-kernel table there.
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

M, N = 69878, 10677
FIT = dict(k=50, lambda_=0.05, scale_lam=True, niter=15, use_cg=True,
           max_cg_steps=3, finalize_chol=True, user_bias=True,
           item_bias=True, center=True)
LFM_M, LFM_N = 359347, 160168
IMPLICIT_FIT = dict(k=50, lambda_=5.0, alpha=1.0, niter=15, use_cg=True,
                    max_cg_steps=3)
# the host-split spans of each fit: functions of solvers/drivers.py
SPANS = {"explicit": ("fit_explicit_dense_masked",),
         "implicit": ("_build_pair", "_implicit_sparse_iteration")}


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    busy, end_max = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e <= end_max:
            continue
        busy += e - max(s, end_max)
        end_max = e
    return busy


def _device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _timed_wrapper(module, name, totals, sync):
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
        return out

    setattr(module, name, wrapped)
    return fn


def profile_fit(rows, cols, vals, m, n, device, kind):
    """Cold, warm, profiled and host-split fits of the ``kind`` ("explicit"
    or "implicit") configuration; returns a dict of numbers."""
    import torch

    import cmfrec_torch
    from cmfrec_torch.models import base
    from cmfrec_torch.solvers import drivers

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    model_cls, kw = ((cmfrec_torch.CMF, FIT) if kind == "explicit" else
                     (cmfrec_torch.CMF_implicit, IMPLICIT_FIT))

    def fit():
        sync()
        t0 = time.perf_counter()
        model = model_cls(**kw, device=device).fit_triplets(
            rows, cols, vals, m, n)
        sync()
        return model, time.perf_counter() - t0

    out = {}
    _, out["cold_fit_s"] = fit()
    out["warm_fit_s"] = [fit()[1] for _ in range(2)]
    print(f"fits: cold {out['cold_fit_s']:.3f} s, warm "
          f"{', '.join(f'{t:.3f}' for t in out['warm_fit_s'])} s", flush=True)

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        _, wall = fit()
    dev = _device_events(prof)
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    out["profiled_fit_s"] = wall
    out["device_busy_ms"] = busy / 1e3
    out["idle_share"] = 1.0 - busy / 1e6 / wall
    per_kernel = {}
    for e in dev:
        k = per_kernel.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e3
    out["device_ms_by_kernel"] = {
        name: {"calls": c, "ms": ms} for name, ms, c in
        sorted(((nm, v[1], v[0]) for nm, v in per_kernel.items()),
               key=lambda x: -x[1])[:15]}
    print(f"profiled fit: {wall:.3f} s, device busy "
          f"{out['device_busy_ms']:.1f} ms, idle share "
          f"{out['idle_share']:.3f}", flush=True)
    for name, v in out["device_ms_by_kernel"].items():
        print(f"  {v['ms']:9.2f} ms {v['calls']:5d} calls  {name[:90]}")

    totals = {}
    spans = [(base._BaseModel, "_ingest_X")] + [(drivers, name)
                                                for name in SPANS[kind]]
    orig = [_timed_wrapper(mod, name, totals, sync) for mod, name in spans]
    try:
        _, wall = fit()
    finally:
        for (mod, name), fn in zip(spans, orig):
            setattr(mod, name, fn)
    out["host_split_s"] = {"fit": wall, "ingest": totals["_ingest_X"]}
    out["host_split_s"].update({name: totals[name] for name in SPANS[kind]})
    out["host_split_s"]["rest"] = wall - sum(totals.values())
    print("host split: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in out["host_split_s"].items()), flush=True)
    return out, prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fit", choices=("explicit", "implicit"),
                    default="explicit", help="which configuration to fit")
    ap.add_argument("--out", help="directory for the profiler's table")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("prof_fit_torch: torch sees no CUDA device", file=sys.stderr)
        return 1
    from bench import _cached, make_ml10m_shaped
    from cmfrec_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.fit == "explicit":
        rows, cols, vals = _cached(make_ml10m_shaped,
                                   str(_cuda.BUILD_DIR / "ml10m_shaped.npz"))
        tr = ~(np.random.default_rng(1).uniform(size=rows.size) < 0.05)
        data = (rows[tr], cols[tr], vals[tr], M, N)
    else:
        from bench_implicit import make_lastfm_shaped, split_heldout

        rows, cols, vals = _cached(make_lastfm_shaped,
                                   str(_cuda.BUILD_DIR / "lastfm_shaped.npz"))
        data = (*split_heldout(rows, cols, vals, LFM_M)[:3], LFM_M, LFM_N)
    out, prof = profile_fit(*data, "cuda", args.fit)
    out["card"] = smi
    out["fit"] = args.fit
    if args.out:
        d = pathlib.Path(args.out)
        d.mkdir(parents=True, exist_ok=True)
        (d / f"prof_fit_torch_{args.fit}.txt").write_text(
            prof.key_averages().table(row_limit=40))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
