#!/usr/bin/env python3
"""The program's own record of one profiled fit of a benchmark cell: each
span that cmfrec_torch.utils.profiling kept (name, parent, attributes,
host and device milliseconds), its counters, the share of the root that
its children cover, and the engine's parts against the engine's span.

    python3 scripts/fit_record_torch.py [--workload explicit_als_cg.ml10m]
        [--seed 1] [--seconds 5] [--out record.json]

It makes the cell's traced run (benchmark/harness.py, with a short
window), then reads profiling.last_record(), which is the run's profiled
fit's.  ``--device cpu --tiny`` rehearses it on the CPU on the cell's mix
cut as the benchmark's own tests cut it (no device times there)."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmark"))

# the benchmark's tests' cut of a mix (benchmark/tests/bench_support.py)
TINY = {"m": 100, "n": 40, "nnz": 1000}


def _ms(s):
    return None if s is None else 1e3 * s


def summary(rec) -> dict:
    """The record's spans and counters, and the checks of its coverage."""
    spans = [{"name": s.name, "id": s.id, "parent": s.parent,
              "attrs": s.attrs, "host_ms": _ms(s.host_s),
              "device_ms": _ms(s.device_s)} for s in rec.spans]
    root = rec.root
    iters = rec.named("cmfrec.engine.iter")
    engine = sum(s.seconds for s in rec.named("cmfrec.engine"))
    parts = sum(s.seconds for s in iters
                + rec.named("cmfrec.engine.setup")
                + rec.named("cmfrec.engine.bias_init"))
    return {
        "spans": spans,
        "counters": rec.counters,
        "iterations": [s.attrs.get("compute") for s in iters],
        "root_covered": sum(c.host_s for c in rec.children(root))
        / root.host_s,
        "engine_s": engine,
        "engine_parts_s": parts,
        "parts_over_engine": parts / engine if engine else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="explicit_als_cg.ml10m")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import harness
    from cmfrec_torch.utils import profiling

    cell = harness.Cell(args.workload)
    if args.tiny:
        cell.traffic = {k: max(v // TINY[k], 1) if k in TINY else v
                        for k, v in cell.traffic.items()}
    out = harness.run_cell(cell, args.seed, args.seconds, True,
                           device=args.device)
    line = harness.result_line(out, True, args.device)
    result = dict(summary(profiling.last_record()),
                  metrics={k: v["value"] for k, v in line["metrics"].items()},
                  device=line["device"], correct=line["correct"],
                  idle_gaps=line.get("breakdown", {}).get("idle_gaps"),
                  nnz=out["run"].stats["nnz"])
    for s in result["spans"]:
        dev = s["device_ms"]
        print(f"{s['id']:3d} <- {s['parent']!s:4} {s['name']:24} "
              f"host {s['host_ms']:9.3f} ms  device "
              f"{'-' if dev is None else f'{dev:9.3f}'} ms  {s['attrs']}")
    for key in ("counters", "iterations", "root_covered", "engine_s",
                "engine_parts_s", "parts_over_engine", "nnz", "metrics",
                "idle_gaps", "device", "correct"):
        print(f"{key}: {result[key]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
