#!/usr/bin/env python3
"""Warm fit times of cmfrec_torch's two implicit engines, on one CUDA card.

Run from the repository root:

    python3 scripts/time_implicit_engines_torch.py [--k-true K ...]

For each shape below, draws implicit pairs with preference structure
(chip_smoke.make_preference_data) and fits chip_smoke.py's WRMF
configuration (k=50, lambda 5, alpha 1, 15 iterations, CG 3) through
drivers.fit_implicit_als with engine="sparse" (the bucketed engine, K3) and
engine="dense" (the dense-masked engine, K1/K2): one cold fit, then warm
fits in turns (sparse, dense, dense, sparse), each with its seconds (host
input to factors on the card, synchronized) and peak device memory.  At
ML10M's shape it also prints P@10 on 2,000 held-out users (20% of the
pairs held out, chip_smoke.ranking_quality) of both engines and of the
collective implicit fit with chip_smoke.py phase 11's U, once for every
``--k-true`` (the generator's factor width).  One JSON line per reading;
the card's name and power limit first.
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

import chip_smoke as cs  # noqa: E402

# (name, m, n, pairs): ML10M's shape at its own density (chip_smoke phase
# 12), at 5% and at 20%, and a smaller catalogue at ML10M's density
SHAPES = (("ml10m", cs.M, cs.N, 10_000_054),
          ("ml10m-5pct", cs.M, cs.N, int(0.05 * cs.M * cs.N)),
          ("ml10m-20pct", cs.M, cs.N, int(0.20 * cs.M * cs.N)),
          ("20k-x-3k", 20_000, 3_000, int(10_000_054 * 20_000 * 3_000
                                          / (cs.M * cs.N))))


def _fit(drivers, data, engine):
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = drivers.fit_implicit_als(*data, engine=engine, device="cuda",
                                   **cs.IMPLICIT_FIT)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def time_engines(drivers, name, m, n, pairs, k_true):
    rows, cols, vals = cs.make_preference_data(m, n, k_true=k_true,
                                               nnz=pairs, seed=cs.PREF["seed"])
    data = (rows, cols, vals, m, n)
    for engine in ("sparse", "dense"):
        _, s, _ = _fit(drivers, data, engine)
        print(json.dumps({"shape": name, "m": m, "n": n, "pairs": rows.size,
                          "engine": engine, "cold_s": s}), flush=True)
    for engine in ("sparse", "dense", "dense", "sparse"):
        _, s, peak = _fit(drivers, data, engine)
        print(json.dumps({"shape": name, "m": m, "n": n, "pairs": rows.size,
                          "engine": engine, "warm_s": s,
                          "peak_gib": peak / 2**30}), flush=True)


def quality(drivers, k_true):
    import torch

    import cmfrec_torch

    rows, cols, vals = cs.make_preference_data(k_true=k_true,
                                               nnz=cs.PREF["nnz"],
                                               seed=cs.PREF["seed"])
    test = np.random.default_rng(8).uniform(size=rows.size) < cs.PREF_HELDOUT
    tr = ~test
    train = (rows[tr], cols[tr], vals[tr], cs.M, cs.N)
    users = np.random.default_rng(5).choice(np.unique(rows[test]),
                                            cs.RANK_USERS, replace=False)
    out = {"k_true": k_true, "pairs": rows.size}
    for engine in ("sparse", "dense"):
        res = drivers.fit_implicit_als(*train, engine=engine, device="cuda",
                                       **cs.IMPLICIT_FIT)
        p10, map10, pop = cs.ranking_quality(res["A"], res["B"], rows[tr],
                                             cols[tr], rows[test], cols[test],
                                             users, cs.N)
        out[f"p10_{engine}"], out["p10_popularity"] = p10, pop
    U = np.random.default_rng(11).normal(size=(cs.M, cs.SIDE_P))
    model = cmfrec_torch.CMF_implicit(**cs.IMPLICIT_FIT, device="cuda")
    model.fit_triplets(*train, U=U)
    out["p10_collective_U"] = cs.ranking_quality(
        *model._device_x_factors(), rows[tr], cols[tr], rows[test],
        cols[test], users, cs.N)[0]
    del model
    torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k-true", type=int, nargs="+",
                    default=[cs.PREF["k_true"]],
                    help="generator factor widths of the P@10 readings")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_implicit_engines_torch: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    from cmfrec_torch.solvers import drivers

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for k_true in args.k_true:
        quality(drivers, k_true)
    for shape in SHAPES:
        time_engines(drivers, *shape, k_true=cs.PREF["k_true"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
