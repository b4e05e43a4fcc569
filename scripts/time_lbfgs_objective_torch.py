#!/usr/bin/env python3
"""The L-BFGS fit's objective and gradient two ways, on one CUDA card.

Run from the repository root:

    python3 scripts/time_lbfgs_objective_torch.py [--k 50] [--reps 20]

On chip_smoke.py phase 4's training split of bench.make_ml10m_shaped()
(9.5 M ratings, 69,878 x 10,677) with random f32 factors A, B [., k] and
biases, times one value-and-gradient of the squared-error term
0.5 sum (x - a_u . b_i - bA_u - bB_i)^2 (cmfrec_tpu's _term_sparse):

  autograd  gathers A[rows], B[cols] (index_select), multiplies, sums;
            torch.autograd's backward (two index_add_ over [nnz, k]);
  sparse    the sampled product through torch.sparse.sampled_addmm on
            the ratings' CSR pattern, the gradient through two CSR
            products (by rows and by columns), biases as two extra
            columns of A and B.

Prints the card's name and power limit, each way's mean ms over --reps
(CUDA events, after a warm-up), its peak memory, and max|difference| of
value and gradient between the two; last, one JSON object.
"""

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

M, N = 69878, 10677


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_lbfgs_objective_torch: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    from bench import _cached, make_ml10m_shaped
    from cmfrec_torch.ops import _cuda
    from cmfrec_torch.solvers import lbfgs
    from cmfrec_torch.solvers.lbfgs_core import FlatParams

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    rows, cols, vals = _cached(make_ml10m_shaped,
                               str(_cuda.BUILD_DIR / "ml10m_shaped.npz"))
    tr = ~(np.random.default_rng(1).uniform(size=rows.size) < 0.05)
    rows, cols, vals = rows[tr], cols[tr], vals[tr] - vals[tr].mean()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k = args.k
    params = {"A": 0.1 * torch.randn(M, k, generator=gen, device=dev),
              "B": 0.1 * torch.randn(N, k, generator=gen, device=dev),
              "biasA": 0.1 * torch.randn(M, generator=gen, device=dev),
              "biasB": 0.1 * torch.randn(N, generator=gen, device=dev)}
    r = torch.as_tensor(rows, device=dev)
    c = torch.as_tensor(cols, device=dev)
    v = torch.as_tensor(vals, dtype=torch.float32, device=dev)
    obs = lbfgs.SparseObs(rows, cols, vals, None, M, N, torch.float32, dev)

    layout = FlatParams(params)
    x = layout.flatten(params)
    ways = {
        "autograd": lbfgs.value_and_grad_of(lambda p: lbfgs._term_sparse(
            p["A"], p["B"], r, c, v, None, p["biasA"], p["biasB"]), layout),
        "sparse": lbfgs.value_and_grad_of(lambda p: obs.term(
            p["A"], p["B"], p["biasA"], p["biasB"]), layout),
    }
    out, got = {"card": smi, "nnz": int(rows.size), "k": k}, {}
    for name, fn in ways.items():
        value, grad = fn(x)
        got[name] = value, layout.views(grad)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn(x)
        end.record()
        torch.cuda.synchronize()
        out[name] = {"ms": start.elapsed_time(end) / args.reps,
                     "peak_GiB": torch.cuda.max_memory_allocated() / 2**30}
        print(f"{name}: {out[name]['ms']:.3f} ms, peak "
              f"{out[name]['peak_GiB']:.2f} GiB", flush=True)
    (fa, ga), (fs, gs) = got["autograd"], got["sparse"]
    out["value_rel_diff"] = float(abs(fa - fs) / abs(fa))
    out["grad_rel_diff"] = {key: float((ga[key] - gs[key]).abs().max()
                                       / ga[key].abs().max()) for key in ga}
    print(f"difference: value {out['value_rel_diff']:.1e}, gradient "
          f"{out['grad_rel_diff']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
