#!/usr/bin/env python3
"""Phase 32b's capped run: 32(a) (phase 8's flagship through
drivers.fit_explicit_als(engine="sparse", use_cg=False)) through the
big-axis ring on 2 NCCL ranks, one spawned process a card, each process's
device memory capped by torch.cuda.set_per_process_memory_fraction.

Run from the repository root on a machine with two CUDA cards or more:

    python3 scripts/ring_capped_torch.py --cap-gib 0.86

Prints the card's name and power limit, then one line a rank: whether its
fit completed or where it ran out of device memory (``set-up``: before the
first iteration), its set-up peak and its iterations' peak.  Exits 0 when
every rank completed.  chip_smoke.two_card_ring_phase calls
:func:`capped_run` and holds the capped fit to the uncapped one bit for
bit.  The script reads of chip_smoke.py only what it held before a mesh
rank built its share alone (_split_ml10m, RING_FIT, _IterTimer,
_res_arrays, _spawn_ranks), so a copy of it placed in a checkout of an
older commit (its scripts/ directory) runs that commit's fit under the
same cap.  The data is phase 4's cached file (build/ml10m_shaped.npz),
made first where it is missing.
"""

import argparse
import datetime
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

WORLD = 2
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)


def _rank(rank, world, address, out, cap):
    """One rank: the capped 32(a) ring fit, its outcome and peaks saved to
    ``out``.<rank>.npz (rank 0's arrays too, where it completed).  The
    allocator maps its memory in expandable segments, so that what it
    reserves follows what the fit allocates and the cap bounds the
    latter, not the allocator's fragmentation; a rank left waiting on one
    that ran out ends after COLLECTIVE_TIMEOUT."""
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    import torch.distributed as dist

    from cmfrec_torch.parallel.mesh import init_distributed
    from cmfrec_torch.solvers import drivers

    mesh = init_distributed(address, world, rank, timeout=COLLECTIVE_TIMEOUT)
    dev = torch.cuda.current_device()
    torch.cuda.set_per_process_memory_fraction(
        cap / torch.cuda.get_device_properties(dev).total_memory, dev)
    rows, cols, vals, test = cs._split_ml10m()
    tr = ~test
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = {}
    timer = cs._IterTimer(reset_peak=True)
    try:
        with timer:
            res = drivers.fit_explicit_als(
                rows[tr], cols[tr], vals[tr], cs.M, cs.N, engine="sparse",
                device="cuda", mesh=mesh, shard_opposing_rows=True,
                **cs.RING_FIT)
            torch.cuda.synchronize()
        st.update(outcome="completed", setup_peak=timer.setup_peak,
                  peak_iter=torch.cuda.max_memory_allocated(),
                  reserved=torch.cuda.max_memory_reserved())
        if rank == 0:
            st.update(cs._res_arrays(res))
        del res
    except torch.cuda.OutOfMemoryError as err:
        where = (f"iteration {len(timer.its)}" if timer.its else "set-up")
        st.update(outcome=f"out of memory at {where}",
                  setup_peak=(timer.setup_peak if timer.its
                              else torch.cuda.max_memory_allocated()),
                  peak_iter=(torch.cuda.max_memory_allocated() if timer.its
                             else 0),
                  reserved=torch.cuda.max_memory_reserved(),
                  error=str(err).splitlines()[0])
    np.savez(f"{out}.{rank}.npz", **st)
    dist.destroy_process_group()


def capped_run(cap, out):
    """The capped fit on WORLD ranks, each capped at ``cap`` bytes: each
    rank's record (outcome, setup_peak, peak_iter; rank 0's arrays where it
    completed) and the seconds the ranks took."""
    wall = cs._spawn_ranks(_rank, WORLD, (str(out), float(cap)),
                           f"capped ring ({WORLD} ranks)")
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(WORLD)], wall


def describe(records):
    """One line a rank."""
    return "; ".join(
        f"rank {r}: {st['outcome']}, set-up peak "
        f"{float(st['setup_peak']) / 2**30:.3f} GiB, the iterations' "
        f"{float(st['peak_iter']) / 2**30:.3f} GiB, reserved at most "
        f"{float(st['reserved']) / 2**30:.3f} GiB"
        for r, st in enumerate(records))


def main():
    import torch

    from cmfrec_torch.ops import _cuda

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cap-gib", type=float, required=True,
                    help="each process's device memory cap, GiB")
    args = ap.parse_args()
    if torch.cuda.device_count() < WORLD:
        print("ring_capped_torch: needs two CUDA cards", file=sys.stderr)
        return 1
    print(cs.card(), flush=True)
    cs._split_ml10m()  # the cached data, made here where it is missing
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    records, wall = capped_run(args.cap_gib * 2**30,
                               _cuda.BUILD_DIR / "ring_capped")
    print(f"32(a) ring on {WORLD} ranks capped at {args.cap_gib:.3f} GiB a "
          f"process, {wall:.1f} s: {describe(records)}", flush=True)
    return 0 if all(st["outcome"] == "completed" for st in records) else 1


if __name__ == "__main__":
    sys.exit(main())
