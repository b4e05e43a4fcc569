#!/usr/bin/env python3
"""K3 past K = 256 (csrc/sparse_cg.cu) on one CUDA card: where a launch's
time goes, in the loop design (a block or cluster a row, its warps looping
over K: ``sparse_cg.block_plan``) and in the rows design (several rows a
block sharing each read of gfix, slot sums in registers: ``rows_plan``).

Run from the repository root:

    python3 scripts/time_k3_wide_torch.py [--K 304 1024] [--reps 3]
                                          [--designs loop rows]

Builds the kernels and prints ptxas's registers and spills for K3's
kernels; then, on the A side of the LastFM-shaped layout (chip_smoke.py
phase 30's case: each bucket's first ``--rows`` rows, log-play
coefficients, a bf16 opposing matrix of random factors, 3 CG steps), for
each ``--K`` and design, bucket by bucket: the plan, the check against the
twin (phase 30's tolerance; a second launch bitwise equal), and CUDA-event
means over ``--reps`` calls of the production launch and of three probe
builds (csrc/sparse_cg.cu compiled alone with -DCMF_K3_PROBE, built here
by ``_cuda.probe_libs``), without the stop rule so that every row runs
every step: no slot passes, no gfix v, neither.  The slot passes' time is
the launch less no slot passes, gfix v's the launch less no gfix v, and
"vector updates and barriers" the build with neither.  The whole is the
production launch with its stop rule: at 3 steps few rows stop, but a
build without the stop rule alone, another binary, read 1.7 times the
loop design's launch (the rows design's within 0.5%).
The designs are timed in turns (loop, rows, rows, loop; the mean of each
pair).  Prints the card's name and power limit, one line per bucket and
design, the sums by design and class and, last, one JSON object.  Refuses
a machine without CUDA; raises on a mismatch.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NO_STOP, NO_SLOTS, NO_GV = 4, 1, 2  # csrc/sparse_cg.cu kProbe* (CMF_K3_PROBE)
VARIANTS = {"no_slots": NO_STOP | NO_SLOTS, "no_gv": NO_STOP | NO_GV,
            "neither": NO_STOP | NO_SLOTS | NO_GV}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--K", type=int, nargs="+", default=[304, 1024])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--designs", nargs="+", default=["loop", "rows"],
                    choices=["loop", "rows"])
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_k3_wide_torch: torch sees no CUDA device", file=sys.stderr)
        return 1
    from bench import _cached
    from bench_implicit import make_lastfm_shaped, split_heldout
    from chip_smoke import (IMPLICIT_FIT, K3_REL_TOL, K3_STEPS, LFM_M, LFM_N,
                            _bucket_case, _timed, bound, card, ptxas_report)
    from cmfrec_torch.data.device_fill import build_bucketed_pair
    from cmfrec_torch.ops import _cuda, sparse_cg

    print(f"card: {card()}", flush=True)
    _, log = _cuda.build()
    probes = _cuda.probe_libs(VARIANTS.values())
    for fn, regs, st, ld in ptxas_report(log, ("bucket_cg_rows_kernel",
                                               "bucket_cg_kernel")):
        print(f"ptxas: {fn}: {regs} registers, spill stores {st} B, spill "
              f"loads {ld} B", flush=True)
    dev = torch.device("cuda")
    rows, cols, vals = _cached(make_lastfm_shaped,
                               str(_cuda.BUILD_DIR / "lastfm_shaped.npz"))
    tr_r, tr_c, tr_v, *_ = split_heldout(rows, cols, vals, LFM_M)
    RB, _ = build_bucketed_pair(tr_r, tr_c, tr_v, LFM_M, LFM_N, device="cuda")
    sms, optin = _cuda.sm_count(dev), _cuda.optin_smem(dev)
    planner = {"loop": sparse_cg.block_plan, "rows": sparse_cg.k3_plan}
    tol = K3_REL_TOL["implicit-log", "bf16"]
    gen = torch.Generator(device=dev).manual_seed(31)
    records = []
    for K in args.K:
        k = K - 4
        lam = torch.ones(K, device=dev)
        lam[:k] = IMPLICIT_FIT["lambda_"]
        mat = torch.randn(LFM_N, K, device=dev, generator=gen) / k ** 0.5
        mat[:, k:] = 0.0
        gfix = mat.T @ mat + torch.diag(lam)
        matx = mat.to(torch.bfloat16)
        for i, full in enumerate(RB.buckets):
            R = min(full.n_rows, args.rows)
            b = _prefix(full, R)
            cw, cv, gf, _, _ = _bucket_case(b, mat, gfix, "implicit-log", gen)
            a0 = torch.randn(R, K, device=dev, generator=gen) / 8
            a0[:, k:] = 0.0
            ops = (matx, b.idx, cw.contiguous(), cv.contiguous(), gf, None,
                   None, a0, b.length, K3_STEPS)
            ref = sparse_cg.bucket_cg_ref(*ops[:8], n_steps=K3_STEPS)
            top = ref.abs().max().item()
            slots = int(b.length.sum())
            plans = {d: planner[d](R, b.width, K, 2, sms, optin)
                     for d in args.designs}
            rec = dict(K=K, bucket=i, R=R, L=b.width, slots=slots)
            for d, plan in plans.items():
                out = sparse_cg.launch(*ops, plan)
                again = sparse_cg.launch(*ops, plan)
                torch.cuda.synchronize()
                rel = (out - ref).abs().max().item() / top
                same = bool(torch.equal(out, again))
                if not (np.isfinite(rel) and rel <= tol and same):
                    raise AssertionError(
                        f"K3 {d} design at K={K} bucket {i}: rel {rel:.3e} "
                        f"(tol {tol:.0e}), repeat equal {same}")
                rec[d] = dict(plan=plan, rel_err=rel)
            turns = args.designs + args.designs[::-1]
            ms = {d: [] for d in args.designs}
            for d in turns:
                ms[d].append(_timed(lambda: sparse_cg.launch(
                    *ops, plans[d]), args.reps))
            for d in args.designs:
                rec[d]["ms"] = sum(ms[d]) / len(ms[d])
                for name, bits in VARIANTS.items():
                    rec[d][name] = _timed(lambda: sparse_cg.launch(
                        *ops, plans[d], probes[bits]), args.reps)
                p, t = rec[d]["plan"], rec[d]
                print(f"K={K} bucket={i} R={R} L={b.width} slots={slots} "
                      f"{d}: class={p['cls']} rows={p.get('rows')} "
                      f"threads={p['threads']} cluster={p['cluster']} "
                      f"stage_slots={p['stage_slots']} smem={p['smem']} "
                      f"rel={t['rel_err']:.3e} ms={t['ms']:.3f} "
                      f"(slots {t['ms'] - t['no_slots']:.3f}, gv "
                      f"{t['ms'] - t['no_gv']:.3f}, vectors and barriers "
                      f"{t['neither']:.3f})", flush=True)
            uniq = int(torch.unique(b.idx[
                torch.arange(b.width, device=dev)[None, :]
                < b.length[:, None]]).numel())
            nbytes = uniq * K * 2 + slots * 12 + R * (4 + 8 * K) + 4 * K * K
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, {
                "bf16": slots * (2 * K + (1 + K3_STEPS) * 4 * K),
                "f32": R * (1 + K3_STEPS) * 2 * K * K})
            records.append(rec)
            del ref, ops, cw, cv, a0
        del mat, matx, gfix
        torch.cuda.empty_cache()
        for d in args.designs:
            mine = [r for r in records if r["K"] == K]
            tot = {key: sum(r[d][key] for r in mine)
                   for key in ("ms", "no_slots", "no_gv", "neither")}
            by_cls = {}
            for r in mine:
                by_cls.setdefault(r[d]["plan"]["cls"], []).append(r[d]["ms"])
            print(f"K={K} {d} design: the {len(mine)} buckets' "
                  f"{sum(r['R'] for r in mine)} rows in {tot['ms']:.3f} ms "
                  f"(bound {sum(r['bound_ms'] for r in mine):.4f}): slot "
                  f"passes {tot['ms'] - tot['no_slots']:.3f}, gfix v "
                  f"{tot['ms'] - tot['no_gv']:.3f}, vector updates and "
                  f"barriers {tot['neither']:.3f}; by class "
                  + ", ".join(f"{c} {sum(v):.3f} ({len(v)} buckets)"
                              for c, v in sorted(by_cls.items())),
                  flush=True)
    print(json.dumps({"card": card(), "records": records}))
    return 0


def _prefix(b, R):
    """The first R rows of bucket b, as an object with its attributes."""
    import types

    return types.SimpleNamespace(
        width=b.width, n_rows=R, n_real=min(b.n_real, R),
        idx=b.idx[:R].contiguous(), val=b.val[:R].contiguous(),
        length=b.length[:R].contiguous())


if __name__ == "__main__":
    sys.exit(main())
