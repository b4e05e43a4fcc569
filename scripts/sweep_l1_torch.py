#!/usr/bin/env python3
"""Share of exact zeros and held-out RMSE of CMF(l1_lambda=...) by l1, on
one CUDA card.

Run from the repository root:

    python3 scripts/sweep_l1_torch.py [--l1 0.03 0.01 0.003 0.001 0.0003]

Fits cmfrec_torch.CMF with chip_smoke.py phase 4's arguments (k=50,
lambda_=0.05, scale_lam, 15 iterations, CG with the Cholesky finish) and
l1_lambda=l1 (scaled by each row's count under scale_lam, so every
half-step solves by coordinate descent) on phase 4's split of
bench.make_ml10m_shaped() (5% held out), f32 on the card, and prints one
JSON line each: fit seconds, held-out RMSE, and the share of exact zeros
in A_ and B_; first, the card's name and power limit and the global
mean's held-out RMSE.  It shows where the l1 penalty starts to zero every
factor, which sets chip_smoke.py's L1_KEEP.
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--l1", type=float, nargs="+",
                    default=[0.03, 0.01, 0.003, 0.001, 0.0003])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sweep_l1_torch: torch sees no CUDA device", file=sys.stderr)
        return 1
    import cmfrec_torch
    from bench import _cached, make_ml10m_shaped
    from chip_smoke import FIT, M, N
    from cmfrec_torch.ops import _cuda

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rows, cols, vals = _cached(make_ml10m_shaped,
                               str(_cuda.BUILD_DIR / "ml10m_shaped.npz"))
    test = np.random.default_rng(1).uniform(size=rows.size) < 0.05
    tr = ~test
    base = float(np.sqrt(np.mean((vals[tr].mean() - vals[test]) ** 2)))
    print(json.dumps({"global_mean_rmse": base}), flush=True)
    for l1 in args.l1:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = cmfrec_torch.CMF(**FIT, l1_lambda=l1, device="cuda"
                                 ).fit_triplets(rows[tr], cols[tr], vals[tr],
                                                M, N)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        pred = model.predict(rows[test], cols[test])
        print(json.dumps({
            "l1_lambda": l1, "fit_s": s,
            "heldout_rmse": float(np.sqrt(np.mean((pred - vals[test]) ** 2))),
            "zeros_A": float(np.mean(model.A_ == 0)),
            "zeros_B": float(np.mean(model.B_ == 0))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
