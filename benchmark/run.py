#!/usr/bin/env python3
"""Run one cell of the cmfrec_torch benchmark (BENCHMARK.json).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, with --trace 1 breakdown, and last
checks (each number that decided ``correct`` with its limit, also the last
lines of standard error).  Exits non-zero with no result where torch sees
no CUDA card (or fewer than the cell asks for), where the program cannot
be imported, or where jax, jaxlib, flax or cmfrec_tpu was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # a fit traces itself into this directory when it is set
    os.environ.pop("CMFREC_TORCH_PROFILE", None)
    sys.path.insert(0, str(ROOT))
    import torch

    import cmfrec_torch  # noqa: F401  (the program under test, or no run)
    import harness

    cell = harness.Cell(args.workload)
    chips = cell.work["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); torch sees "
              f"{cards}", file=sys.stderr)
        return 2
    traced = bool(args.trace)
    out = harness.run_cell(cell, args.seed, args.seconds, traced,
                           t_start=T_START)
    line = harness.result_line(out, traced)
    found = harness.banned_modules()
    if found:
        print(f"run.py: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    run = out["run"]
    parts = {k: round(v, 3) for k, v in run.setup_parts.items()}
    print(f"{cell.name} seed {args.seed}: set-up {run.setup_s:.3f} s "
          f"{parts}, fits (s) {[round(e - s, 4) for s, e in run.fits]}, "
          f"spans {run.spans}, launches {run.launches}, data {run.stats}",
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
