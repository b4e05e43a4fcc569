#!/usr/bin/env python3
"""The CD kernel on the nonneg flagship's A half-step, on one CUDA card.

Run from the repository root:

    python3 scripts/time_cd_torch.py [--niter 1] [--reps 3]

Fits chip_smoke.py phase 26's configuration (the flagship with nonneg=True,
center=False) for ``--niter`` iterations on bench.make_ml10m_shaped() with
the same 5% held out, keeping the last iteration's CD calls (both sides,
bucket by bucket), then, through ops/coord_descent.solve_cd on the A side's
buckets: the whole A half-step's CUDA-event time (the sum of its buckets',
each the mean of two calls after a warm-up), ``--reps`` times, its bound
from the sweeps the rows ran, and the kernel's largest error against the
twin rowsolve.solve_cd on the widest A bucket's first 4,096 rows in f32
and f64.  Then, on the widest A bucket, where a sweep's time goes: the
time at max_steps 0 (staging and the write only), 1 and 11 with tol < 0
(no row stops early), the kernel's launch plan (coord_descent.plan) and
from them the cycles a coordinate takes at the card's largest SM clock.  Prints the card's name and power limit, one line
per measurement and, last, one JSON object.
"""

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def half_step_ms(calls):
    """One A half-step: the buckets' mean CUDA-event ms."""
    from chip_smoke import _timed
    from cmfrec_torch.ops import coord_descent

    return sum(_timed(lambda: coord_descent.solve_cd(
        G, rhs, l1, nonneg=nonneg, max_steps=steps), 2)
        for G, rhs, l1, nonneg, steps in calls)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--niter", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_cd_torch: torch sees no CUDA device", file=sys.stderr)
        return 1
    import cmfrec_torch
    from bench import _cached, make_ml10m_shaped
    from chip_smoke import (CD_CHECK_ROWS, M, N, NONNEG_FIT, _CDSpy, _cd_work,
                            _timed, bound, n_chunks)
    from cmfrec_torch.ops import _cuda, coord_descent, rowsolve

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rows, cols, vals = _cached(make_ml10m_shaped,
                               str(_cuda.BUILD_DIR / "ml10m_shaped.npz"))
    tr = ~(np.random.default_rng(1).uniform(size=rows.size) < 0.05)
    r, c, v = rows[tr], cols[tr], vals[tr]
    n_rb, n_cb = n_chunks(r, M), n_chunks(c, N)
    last = (args.niter - 1) * (n_rb + n_cb)
    with _CDSpy(keep=lambda i, G: i >= last) as spy:
        cmfrec_torch.CMF(**dict(NONNEG_FIT, niter=args.niter),
                         device="cuda").fit_triplets(r, c, v, M, N)
    kept = [spy.kept[i] for i in sorted(spy.kept)]
    calls = kept[n_cb:]  # the B side's half-step comes first
    out = dict(card=smi, niter=args.niter, rows=sum(G.shape[0] for G, *_ in
                                                    calls),
               buckets=len(calls), K=calls[0][1].shape[1])

    nbytes, ops, sweeps = 0, 0.0, []
    for G, rhs, l1, nonneg, steps in calls:
        _, sw = coord_descent.solve_cd(G, rhs, l1, nonneg=nonneg,
                                       max_steps=steps, return_sweeps=True)
        nb, op = _cd_work(G, rhs, l1, sw, "f32")
        nbytes, ops = nbytes + nb, ops + op["f32"]
        sweeps.append(sw)
    out["bound_ms"], out["bound_by"] = bound(nbytes, {"f32": ops})
    sw = torch.cat(sweeps).float()
    out["sweeps_mean"] = float(sw.mean())
    out["ms"] = [half_step_ms(calls) for _ in range(args.reps)]
    print(f"A half-step: {out['rows']} rows in {out['buckets']} buckets, "
          f"K={out['K']}, f32, sweeps a row mean {out['sweeps_mean']:.2f}: "
          + " ".join(f"{t:.3f}" for t in out["ms"])
          + f" ms; bound {out['bound_ms']:.3f} ms ({out['bound_by']})",
          flush=True)

    G, rhs, l1, nonneg, steps = max(calls, key=lambda call: call[0].shape[0])
    R = min(G.shape[0], CD_CHECK_ROWS)
    out["check"] = {}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        args_ = (G[:R].contiguous().to(dt), rhs[:R].contiguous().to(dt),
                 (l1[:R] if l1.dim() == 2 else l1).contiguous().to(dt))
        want, wsw = rowsolve.solve_cd(*args_, nonneg, steps,
                                      return_sweeps=True)
        got, gsw = coord_descent.solve_cd(*args_, nonneg=nonneg,
                                          max_steps=steps, return_sweeps=True)
        rel = float((got - want).abs().max() / want.abs().max())
        same = float((gsw == wsw).float().mean())
        out["check"][name] = dict(rel=rel, same_sweeps=same)
        print(f"widest A bucket [{R}, {G.shape[1]}] {name}: rel {rel:.3e} "
              f"against the twin, sweeps equal on {100 * same:.2f}% of rows",
              flush=True)

    # where a sweep's time goes, on the widest bucket
    smi_clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True)
    clk = float(smi_clk.stdout.strip()) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    G, rhs, l1, nonneg, steps = max(calls, key=lambda call: call[0].shape[0])
    R, K = G.shape[0], G.shape[1]
    plan = coord_descent.plan(K, False, torch.float32)
    per_wave = plan["rows_per_block"] * plan["blocks_per_sm"] * sms
    waves = -(-R // per_wave)
    out["probe"] = dict(R=R, plan=plan, waves=waves, sm_clock_hz=clk)
    t = {n: _timed(lambda: coord_descent.solve_cd(
        G, rhs, l1, nonneg=nonneg, max_steps=n, tol=-1.0), 3)
         for n in (0, 1, 11)}
    sweep_ms = (t[11] - t[1]) / 10
    cycles = sweep_ms * 1e-3 * clk / (waves * K)
    out["probe"].update(ms=t, sweep_ms=sweep_ms, cycles_a_coordinate=cycles)
    print(f"widest A bucket [{R}, {K}]: plan {plan}, {waves} waves; ms at "
          f"0/1/11 sweeps {t[0]:.3f}/{t[1]:.3f}/{t[11]:.3f}, a sweep "
          f"{sweep_ms:.4f} ms = {cycles:.0f} cycles a coordinate at "
          f"{clk / 1e9:.3f} GHz", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
