"""Helpers of the benchmark's own tests: the benchmark's folder and the
repository root on sys.path, and tiny copies of the cells for runs on
the CPU."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# each cell's mix shrunk to a size the CPU fits in a second: every width
# (k, the model's arguments) as configured
SHRINK = {"m": 100, "n": 40, "nnz": 1000}


def tiny(cell):
    """``cell`` with its mix's counts cut by SHRINK, in place."""
    t = dict(cell.traffic)
    for key, by in SHRINK.items():
        t[key] = max(t[key] // by, 1)
    cell.traffic = t
    return cell
