#!/usr/bin/env python3
"""chip_smoke.py phase 31b alone: the flagship fit on a 2-rank NCCL group
against the meshless fit, on a machine with two CUDA cards or more.

Run from the repository root:

    python3 scripts/mesh_two_cards_torch.py

Builds the kernels, makes phase 4's data and split, fits phase 4 meshless
on the first card, then runs chip_smoke.two_card_phase: two spawned
processes, one a card, join an NCCL group on a localhost address and fit
the same model with mesh=; rank 0's factors and held-out predictions are
held to the meshless fit's (chip_smoke.MESH2_RMSE_TOL, MESH2_REL_TOL).
Prints the card's name and power limit, then phase 31b's line, then each
array's max |2 ranks - meshless| beside its max |.|.
"""

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    import torch

    import cmfrec_torch
    from cmfrec_torch.ops import _cuda

    if torch.cuda.device_count() < 2:
        print("mesh_two_cards_torch: needs two CUDA cards", file=sys.stderr)
        return 1
    print(cs.card(), flush=True)
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
