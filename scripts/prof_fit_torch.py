#!/usr/bin/env python3
"""Where the time of a cmfrec_torch fit goes, on one CUDA card.

Run from the repository root:

    python3 scripts/prof_fit_torch.py \
        [--fit explicit|implicit|collective|collective-bucketed|implicit-dense|lbfgs|nonneg]
        [--out DIR]

``--fit explicit`` (the default) fits the flagship configuration of
chip_smoke.py (explicit ALS-CG, k=50, 15 iterations, CG 3, f32 polish) on
bench.make_ml10m_shaped() with the same 5% held out, through
CMF.fit_triplets; ``--fit implicit`` fits chip_smoke.py's WRMF configuration
(k=50, lambda 5, alpha 1, 15 iterations, CG 3) on the train split of
bench_implicit.make_lastfm_shaped(), through CMF_implicit.fit_triplets (the
bucketed engine); ``--fit collective`` the flagship configuration with
implicit features (chip_smoke.py phase 10a), ``--fit collective-bucketed``
chip_smoke.py phase 14's (the flagship configuration with its user tags
and item genres, the bucketed collective route) and ``--fit implicit-dense``
the WRMF configuration on phase 12's training pairs
(chip_smoke.make_preference_data, 20% held out) through
drivers.fit_implicit_als(engine="dense"), the dense engine; ``--fit lbfgs``
chip_smoke.py phase 17's CMF(method="lbfgs", k=50, lambda 30; maxiter 800
and corr_pairs 4, CMF's defaults) on the flagship's split; ``--fit nonneg``
chip_smoke.py phase 26's, the flagship configuration with nonneg=True and
center=False (the bucketed Cholesky/CD route) on the flagship's split.  For
any:

  1. one cold fit (CUDA context, cuBLAS and allocator warm-up included);
  2. two warm fits;
  3. one warm fit under torch.profiler, which gives the device time per
     kernel and the idle share = 1 - (union of the device's kernel and copy
     intervals) / (host wall time of the fit);
  4. with the profiler off, the host wall time of ingest (_ingest_X; none
     for implicit-dense, which enters at the driver), of
     the engine's spans (explicit: fit_explicit_dense_masked; implicit: the
     bucket layout build _build_pair and the iterations
     _implicit_sparse_iteration; collective: fit_collective_dense_masked;
     collective-bucketed: the layout builds build_bucketed_pair_share,
     build_aligned_parts and build_bucketed_rows_share, and the iterations
     _run;
     implicit-dense: fit_implicit_dense_masked; lbfgs: the objective and
     its gradient, Lbfgs.evaluate, and the line search's host reads,
     Lbfgs.read, which wait for the device no longer since evaluate ends
     synchronized), each synchronized at its end, and of the rest (COO
     build, driver checks, the line search's host arithmetic, the two-loop
     recursion, result download); nonneg: the bucket layout build
     _build_pair, the Gram assembly rowsolve.assemble_system and the CD op
     coord_descent.solve_cd;
  5. one warm fit under cProfile: the HOST_TOP functions with the most host
     time of their own.

Prints one line per measurement and, last, one JSON object with all of
them.  With --out, also writes the profiler's per-kernel table there.
"""

import argparse
import cProfile
import json
import pathlib
import pstats
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
COLLECTIVE_FIT = dict(FIT, add_implicit_features=True, w_implicit=0.5)
COLLECTIVE_BUCKETED_FIT = dict(FIT, NA_as_zero_item=True)  # phase 14's
LBFGS_FIT = dict(k=50, method="lbfgs", lambda_=30.0)  # phase 17's
NONNEG_FIT = dict(FIT, nonneg=True, center=False)  # phase 26's
# functions listed from the fit under cProfile, by their own host time
HOST_TOP = 15
# the host-split spans of each fit: (module of cmfrec_torch.solvers, function)
SPANS = {"explicit": (("drivers", "fit_explicit_dense_masked"),),
         "implicit": (("drivers", "_build_pair"),
                      ("drivers", "_implicit_sparse_iteration")),
         "collective": (("collective", "fit_collective_dense_masked"),),
         "collective-bucketed": (("collective", "build_bucketed_pair_share"),
                                 ("collective", "build_aligned_parts"),
                                 ("collective", "build_bucketed_rows_share"),
                                 ("collective", "_run")),
         "implicit-dense": (("drivers", "fit_implicit_dense_masked"),),
         "lbfgs": (("lbfgs_core.Lbfgs", "evaluate"),
                   ("lbfgs_core.Lbfgs", "read")),
         "nonneg": (("drivers", "_build_pair"),
                    ("ops.rowsolve", "assemble_system"),
                    ("ops.coord_descent", "solve_cd"))}


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

    # one attribute dict: an op that counts its launches through its module's
    # name (fn.launches) keeps counting while the wrapper holds that name
    wrapped.__dict__ = fn.__dict__
    setattr(module, name, wrapped)
    return fn


def profile_fit(rows, cols, vals, m, n, device, kind, side=None):
    """Cold, warm, profiled and host-split fits of the ``kind`` (a key of
    SPANS) configuration, with side information ``side`` (U=, I=) if
    given; returns a dict of numbers."""
    import importlib

    import torch

    import cmfrec_torch
    from cmfrec_torch.models import base

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    from cmfrec_torch.solvers import drivers

    def run():
        if kind == "implicit-dense":
            return drivers.fit_implicit_als(rows, cols, vals, m, n,
                                            engine="dense", device=device,
                                            **IMPLICIT_FIT)
        model_cls, kw = {
            "explicit": (cmfrec_torch.CMF, FIT),
            "implicit": (cmfrec_torch.CMF_implicit, IMPLICIT_FIT),
            "collective": (cmfrec_torch.CMF, COLLECTIVE_FIT),
            "collective-bucketed": (cmfrec_torch.CMF,
                                    COLLECTIVE_BUCKETED_FIT),
            "lbfgs": (cmfrec_torch.CMF, LBFGS_FIT),
            "nonneg": (cmfrec_torch.CMF, NONNEG_FIT),
        }[kind]
        return model_cls(**kw, device=device).fit_triplets(
            rows, cols, vals, m, n, **(side or {}))

    def fit():
        sync()
        t0 = time.perf_counter()
        model = run()
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

    def owner(path):
        """A module of cmfrec_torch.solvers, or a class in one; or a
        module of cmfrec_torch.ops ("ops.<module>")."""
        if path.startswith("ops."):
            return importlib.import_module(f"cmfrec_torch.{path}")
        mod, _, cls = path.partition(".")
        mod = importlib.import_module(f"cmfrec_torch.solvers.{mod}")
        return getattr(mod, cls) if cls else mod

    totals = {}
    spans = [(base._BaseModel, "_ingest_X")] + [
        (owner(mod), name) for mod, name in SPANS[kind]]
    orig = [_timed_wrapper(mod, name, totals, sync) for mod, name in spans]
    try:
        _, wall = fit()
    finally:
        for (mod, name), fn in zip(spans, orig):
            setattr(mod, name, fn)
    out["host_split_s"] = {"fit": wall,
                           "ingest": totals.get("_ingest_X", 0.0)}
    out["host_split_s"].update({name: totals[name]
                                for _, name in SPANS[kind]})
    out["host_split_s"]["rest"] = wall - sum(totals.values())
    print("host split: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in out["host_split_s"].items()), flush=True)

    # where the host's time goes, by function (cProfile inflates Python
    # frames against native calls: it names candidates, the spans measure)
    host = cProfile.Profile()
    host.enable()
    try:
        _, wall = fit()
    finally:
        host.disable()
    stats = pstats.Stats(host).stats
    top = sorted(((tt, ct, nc, f"{pathlib.Path(fn).name}:{line}({name})")
                  for (fn, line, name), (_, nc, tt, ct, _) in stats.items()),
                 reverse=True)[:HOST_TOP]
    out["host_top"] = {"fit_s": wall, "functions": [
        dict(name=n, own_s=tt, cumulative_s=ct, calls=nc)
        for tt, ct, nc, n in top]}
    print(f"host functions (a fit under cProfile, {wall:.3f} s), own time:",
          flush=True)
    for tt, ct, nc, n in top:
        print(f"  {tt:8.3f} s own {ct:8.3f} s cumulative {nc:7d} calls  {n}")
    return out, prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fit", choices=tuple(SPANS),
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
    if args.fit == "implicit-dense":
        from chip_smoke import PREF, PREF_HELDOUT, make_preference_data

        rows, cols, vals = make_preference_data(**PREF)
        tr = ~(np.random.default_rng(8).uniform(size=rows.size) < PREF_HELDOUT)
        data = (rows[tr], cols[tr], vals[tr], M, N)
    elif args.fit != "implicit":
        rows, cols, vals = _cached(make_ml10m_shaped,
                                   str(_cuda.BUILD_DIR / "ml10m_shaped.npz"))
        tr = ~(np.random.default_rng(1).uniform(size=rows.size) < 0.05)
        data = (rows[tr], cols[tr], vals[tr], M, N)
    else:
        from bench_implicit import make_lastfm_shaped, split_heldout

        rows, cols, vals = _cached(make_lastfm_shaped,
                                   str(_cuda.BUILD_DIR / "lastfm_shaped.npz"))
        data = (*split_heldout(rows, cols, vals, LFM_M)[:3], LFM_M, LFM_N)
    side = None
    if args.fit == "collective-bucketed":
        from chip_smoke import make_item_genres, make_user_tags

        side = dict(U=make_user_tags(), I=make_item_genres())
    out, prof = profile_fit(*data, "cuda", args.fit, side)
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
