#!/usr/bin/env python3
"""chip_smoke.py phase 31b or 32b alone, on a machine with two CUDA cards
or more.

Run from the repository root:

    python3 scripts/mesh_two_cards_torch.py          # phase 31b
    python3 scripts/mesh_two_cards_torch.py --ring   # phase 32b

Phase 31b: builds the kernels, makes phase 4's data and split, fits phase
4 meshless on the first card, then runs chip_smoke.two_card_phase: two
spawned processes, one a card, join an NCCL group on a localhost address
and fit the same model with mesh=; rank 0's factors and held-out
predictions are held to the meshless fit's (chip_smoke.MESH2_RMSE_TOL,
MESH2_REL_TOL).  Prints the card's name and power limit, then phase 31b's
line, then each array's max |2 ranks - meshless| beside its max |.|.

Phase 32b (``--ring``): fits 32(a) (phase 8's flagship through
drivers.fit_explicit_als(engine="sparse", use_cg=False)) meshless on the
first card, then runs chip_smoke.two_card_ring_phase: the same fit, and a
2,000,000 x 1,000,000 fit of 8,000,000 uniform ratings (k = 32, three
iterations), through the big-axis ring (shard_opposing_rows=True) and
through slice 7a's mesh= on 2-rank NCCL groups, and on 4-rank ones where
the machine has four cards; each rank's memory at rest and at its peak
(the set-up's beside the iterations') and its seconds a half-step, the
ring's factors and RMSE held to the meshless fit's (32(a)) and to 7a's
(the big fit); then 32(a) through the ring on 2 ranks with each process's
device memory capped between its peak and the 1.005 GiB set-up of every
rank building the whole layout (scripts/ring_capped_torch.py), held bit
for bit to the uncapped run.  No kernel runs on this path (Cholesky), so
nothing is built.
"""

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def ring_main():
    """Phase 32b alone: 32(a)'s meshless fit, then the 2- and 4-rank
    groups."""
    import torch

    from cmfrec_torch.solvers import drivers

    rows, cols, vals, test = cs._split_ml10m()
    tr = ~test
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with cs._IterTimer() as timer:
        res = drivers.fit_explicit_als(rows[tr], cols[tr], vals[tr], cs.M,
                                       cs.N, engine="sparse", device="cuda",
                                       **cs.RING_FIT)
    torch.cuda.synchronize()
    ref = dict(arrays=cs._res_arrays(res),
               quality=cs._explicit_rmse(res, rows, cols, vals, test),
               test_vals=vals[test], half_ms=timer.half_ms(),
               peak=torch.cuda.max_memory_allocated())
    print(f"32(a) meshless on one card: {time.perf_counter() - t0:.2f} s, "
          f"held-out RMSE {ref['quality']:.5f}", flush=True)
    del res
    torch.cuda.empty_cache()
    cs.two_card_ring_phase(ref)
    return 0


def main():
    import torch

    import cmfrec_torch
    from cmfrec_torch.ops import _cuda

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ring", action="store_true",
                    help="phase 32b (the big-axis ring) instead of 31b")
    args = ap.parse_args()
    if torch.cuda.device_count() < 2:
        print("mesh_two_cards_torch: needs two CUDA cards", file=sys.stderr)
        return 1
    print(cs.card(), flush=True)
    if args.ring:
        return ring_main()
    t0 = time.perf_counter()
    _cuda.build()
    _cuda.lib()
    rows, cols, vals, test = cs._split_ml10m()
    tr = ~test
    print(f"build and data in {time.perf_counter() - t0:.1f} s", flush=True)
    model = cmfrec_torch.CMF(**cs.FIT, device="cuda").fit_triplets(
        rows[tr], cols[tr], vals[tr], cs.M, cs.N)
    pred = model.predict(rows[test], cols[test])
    ref = dict(arrays=cs._model_arrays(model),
               quality=float(np.sqrt(np.mean((pred - vals[test]) ** 2))),
               test_vals=vals[test])
    cs.two_card_phase(ref)
    got = dict(np.load(_cuda.BUILD_DIR / "phase31b.npz"))
    for key, w in ref["arrays"].items():
        d = np.abs(got[key] - w)
        print(f"{key}: max|2 ranks - meshless| {float(d.max()):.3e}, "
              f"p99 {float(np.quantile(d, 0.99)):.3e}, max|meshless| "
              f"{float(np.abs(w).max()):.3e}", flush=True)
    print(f"predictions: max|2 ranks - meshless| "
          f"{float(np.abs(got['pred'] - pred).max()):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
