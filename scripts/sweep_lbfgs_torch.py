#!/usr/bin/env python3
"""Held-out RMSE of CMF(method="lbfgs") by lambda and iteration count, on
one CUDA card.

Run from the repository root:

    python3 scripts/sweep_lbfgs_torch.py [--lambdas 10 30 100] \
        [--maxiter 200 800] [--k 50]

Fits cmfrec_torch.CMF(method="lbfgs", k=k, lambda_=lam, maxiter=it) on
chip_smoke.py phase 4's split of bench.make_ml10m_shaped() (5% held out)
for every (lam, it), f32 on the card, and prints one JSON line each: fit
seconds, iterations, evaluations, host syncs, the final objective, the
training and held-out RMSE; first, MostPopular(user_bias=True)'s held-out
RMSE and the global mean's, the bars of chip_smoke.py phase 17.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lambdas", type=float, nargs="+",
                    default=[10.0, 30.0, 100.0])
    ap.add_argument("--maxiter", type=int, nargs="+", default=[200, 800])
    ap.add_argument("--k", type=int, default=50)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sweep_lbfgs_torch: torch sees no CUDA device", file=sys.stderr)
        return 1
    import cmfrec_torch
    from bench import _cached, make_ml10m_shaped
    from cmfrec_torch.ops import _cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rows, cols, vals = _cached(make_ml10m_shaped,
                               str(_cuda.BUILD_DIR / "ml10m_shaped.npz"))
    test = np.random.default_rng(1).uniform(size=rows.size) < 0.05
    tr = ~test

    def rmse(model, sel):
        pred = model.predict(rows[sel], cols[sel])
        return float(np.sqrt(np.mean((pred - vals[sel]) ** 2)))

    mp = cmfrec_torch.MostPopular(user_bias=True, device="cuda").fit_triplets(
        rows[tr], cols[tr], vals[tr], M, N)
    base = float(np.sqrt(np.mean((vals[tr].mean() - vals[test]) ** 2)))
    print(json.dumps({"most_popular_rmse": rmse(mp, test),
                      "global_mean_rmse": base}), flush=True)
    for lam in args.lambdas:
        for it in args.maxiter:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = cmfrec_torch.CMF(
                k=args.k, method="lbfgs", lambda_=lam, maxiter=it,
                device="cuda").fit_triplets(rows[tr], cols[tr], vals[tr], M, N)
            torch.cuda.synchronize()
            st = model.fit_stats_
            print(json.dumps({
                "lambda": lam, "maxiter": it, "fit_s": time.perf_counter() - t0,
                "iterations": len(st["values"]), "evaluations": st["n_evals"],
                "host_syncs": st["host_syncs"], "f": st["values"][-1],
                "train_rmse": rmse(model, tr), "heldout_rmse": rmse(model, test),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
