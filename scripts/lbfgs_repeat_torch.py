#!/usr/bin/env python3
"""How far the f32 L-BFGS fit (chip_smoke.py phase 17) repeats on a card,
meshless and through a world-of-one mesh= (phase 31(d)).

Run from the repository root, on a machine with a CUDA card:

    python3 scripts/lbfgs_repeat_torch.py [--fits 6]

Prints the card's name and power limit; then, on random factors at phase
17's shapes, whether each sparse product of the objective
(solvers/lbfgs.py: the sampled product, the two CSR products of the
gradient) gives the same bits six times running, and the largest
difference; then ``--fits`` fits of phase 17 on phase 4's data and split,
alternating meshless and mesh=, each one's seconds and held-out RMSE, and
max|a - b| over the factors and biases of every pair.
"""

import argparse
import itertools
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402


def products(rows, cols, vals):
    """Each sparse product of the objective six times on the same inputs."""
    import torch

    from cmfrec_torch.solvers.lbfgs import SparseObs

    dev = torch.device("cuda")
    obs = SparseObs(rows, cols, vals, None, cs.M, cs.N, torch.float32, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    A = 0.1 * torch.randn(cs.M, 52, generator=gen, device=dev)
    B = 0.1 * torch.randn(cs.N, 52, generator=gen, device=dev)
    w = torch.randn(obs.vals.numel(), generator=gen, device=dev)
    for name, fn in (
            ("sampled_addmm", lambda: torch.sparse.sampled_addmm(
                obs.pattern, A, B.T.contiguous(), beta=0.0).values()),
            ("sparse.mm by rows (dA)", lambda: torch.sparse.mm(
                obs.csr(obs.crow_r, obs.col_r, w, obs.shape), B)),
            ("sparse.mm by columns (dB)", lambda: torch.sparse.mm(
                obs.csr(obs.crow_c, obs.row_c, w[obs.perm_c],
                        obs.shape[::-1]), A))):
        outs = [fn() for _ in range(6)]
        torch.cuda.synchronize()
        same = all(torch.equal(outs[0], o) for o in outs[1:])
        diff = max(float((outs[0] - o).abs().max()) for o in outs[1:])
        print(f"{name}: six calls {'bitwise equal' if same else 'not bitwise'}"
              f", max|diff| {diff:.3e}", flush=True)


def main():
    import torch
    import torch.distributed as dist

    import cmfrec_torch
    from cmfrec_torch.parallel.mesh import init_distributed

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fits", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lbfgs_repeat_torch: torch sees no CUDA device", file=sys.stderr)
        return 1
    print(cs.card(), flush=True)
    rows, cols, vals, test = cs._split_ml10m()
    tr = ~test
    products(rows[tr], cols[tr], vals[tr])
    mesh = init_distributed()
    dist.barrier()
    fits = []
    for i in range(args.fits):
        label = "meshless" if i % 2 == 0 else "mesh"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = cmfrec_torch.CMF(**cs.LBFGS_FIT, device="cuda").fit_triplets(
            rows[tr], cols[tr], vals[tr], cs.M, cs.N,
            mesh=mesh if label == "mesh" else None)
        pred = model.predict(rows[test], cols[test])
        rmse = float(np.sqrt(np.mean((pred - vals[test]) ** 2)))
        fits.append((label, cs._model_arrays(model)))
        print(f"fit {i} {label}: {time.perf_counter() - t0:.2f} s, held-out "
              f"RMSE {rmse:.5f}", flush=True)
        del model
    for (i, a), (j, b) in itertools.combinations(enumerate(fits), 2):
        print(f"fits {i} ({a[0]}) and {j} ({b[0]}): max|diff| "
              f"{cs._max_diff(a[1], b[1]):.3e}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
