#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, at a cell's own
size, on the card.  For each seed: the program's fit (the timed path,
CMF(**args).fit(X), after one warm-up fit) and the configuration's
control (its plain reference computed one precision below the one the
configuration states, put in the program's place), each held against the
plain reference run from the program's start; and with --faults, the
program with each named fault of faults.py planted, judged as a run
judges it.  Not run by the benchmark's own runs.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 \\
        [--extra tf32] [--faults step_unchanged half_batch ...]

Prints one JSON line a seed and side ("program", "control", each --extra
operand format used everywhere, each fault) with the numbers of check.py
and, for the program and the control, the quantiles of the rows' own
gaps.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(BENCH))

import torch  # noqa: E402

import check  # noqa: E402
import faults  # noqa: E402
import harness  # noqa: E402
import plain  # noqa: E402


QUANTILES = (0.5, 0.9, 0.99, 0.999)


def row_quantiles(prog: dict, ref: dict) -> dict:
    """The spread of the rows' own gaps, ||program - reference|| over the
    larger of the row's reference norm and the leaf's rms row norm."""
    out = {}
    for leaf, p, r in check.pairs(prog, ref):
        rn = r.norm(dim=1)
        g = (p - r).norm(dim=1) / rn.clamp(min=float(rn.pow(2).mean().sqrt()))
        qs = torch.quantile(g.float(), torch.tensor(QUANTILES))
        out[f"rows_{leaf}"] = [float(q) for q in qs] + [float(g.max())]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--extra", nargs="*", default=[],
                    help="operand formats to run the reference in, "
                         "everywhere, besides the control")
    ap.add_argument("--faults", nargs="*", default=[],
                    choices=sorted(faults.FAULTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control.py: torch sees no CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    dev = torch.device(args.device)
    k = cell.config["args"]["k"]
    sides = {"control": plain.control_precision(cell.config["control"])}
    sides.update({f: plain.Precision(torch.float32, f, f)
                  for f in args.extra})
    warm = False
    for seed in args.seeds:
        X, train = harness.draw(cell, seed, dev)
        harness.free(dev)
        if not warm:
            harness.fit_program(cell, X, seed, dev)
            warm = True
        t0 = time.perf_counter()
        model = harness.fit_program(cell, X, seed, dev)
        fit_s = time.perf_counter() - t0
        prog = check.model_parts(model)
        del model
        start = harness.reference_start(cell, X, seed, dev)
        harness.free(dev)
        t0 = time.perf_counter()
        ref = harness.reference_fit(cell, train, start, dev)
        ref_s = time.perf_counter() - t0
        head = {"cell": cell.name, "seed": seed}
        print(json.dumps({**head, "side": "program", "fit_s": fit_s,
                          "reference_s": ref_s,
                          **check.start_numbers(
                              start, harness.live_rows(cell, train), k),
                          **check.fit_numbers(prog, ref),
                          **row_quantiles(prog, ref)}), flush=True)
        for name, prec in sides.items():
            other = harness.reference_fit(cell, train, start, dev, prec)
            harness.free(dev)
            print(json.dumps({**head, "side": name,
                              **check.fit_numbers(other, ref),
                              **row_quantiles(other, ref)}), flush=True)
        del prog, ref, start
        harness.free(dev)
        for name in args.faults:
            with faults.FAULTS[name]():
                kept = check.model_parts(
                    harness.fit_program(cell, X, seed, dev))
                values = harness.readings(cell, X, train, seed, kept, dev)
            del kept
            harness.free(dev)
            print(json.dumps({**head, "side": name, **values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
