#!/usr/bin/env python3
"""K1 with f32 operands on row lists (csrc/masked_rows.cu) against the
dense f32 K1 (csrc/masked_matmul.cu) on one CUDA card, and the density
where the two cost the same.

Run from the repository root:

    python3 scripts/time_k1_rows_torch.py [--seed 1] [--reps 10]
        [--densities 0.05 0.1 0.15 0.2] [--chunks 2048] [--out FILE]

Builds the kernels and prints ptxas's registers and spills for the
row-list kernels.  Draws the benchmark's ML10M-shaped ratings on the card
(benchmark/traffic/ml10m.json, 9.5M entries of a 69,878 x 10,677 matrix,
padded to 69,888 x 10,688), forms the dense int8 mask and f32 weights
(uniform 0.5-2) of both sides, and for each side and W type: the lists'
build (ms, entries against torch.nonzero), the row-list K1 against the
dense f32 K1 and against its twin (max|err| / max|dense|), two calls
bitwise equal, and the CUDA-event mean ms over ``--reps`` calls of the
row-list K1 (for each of ``--chunks``, the entries a warp takes), the
dense f32 K1 and the twin, beside the row-list K1's bound (ids, weights,
Q, Be and out read or written once at 3.35 TB/s against 4 K operations
an entry at the f32 peak; its Be gathers from L2 are not in it).  Then,
on the int8 mask of each side, more cells drawn uniformly until W holds
each of ``--densities``: the two kernels' ms and the density where a
line through the row-list times meets the dense time.  Prints the card's
name and power limit, one line per measurement and, last, one JSON
object (also written to ``--out``).  Refuses a machine without CUDA;
raises on a mismatch.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmark"))

# max|row-list K1 - dense f32 K1| / max|dense|: the same f32 products summed
# in another order (chip_smoke.REL_TOL["f32"])
REL_TOL = 5e-5
KERNELS = ("rowlist_gram_kernel", "rowlist_sum_kernel",
           "rowlist_count_kernel", "rowlist_scan_kernel",
           "rowlist_fill_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--densities", type=float, nargs="*",
                    default=[0.05, 0.1, 0.15, 0.2])
    ap.add_argument("--chunks", type=int, nargs="+", default=[2048])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_k1_rows_torch: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    from chip_smoke import _timed, bound, card, ptxas_report
    from cmfrec_torch.ops import _cuda
    from cmfrec_torch.ops import masked_matmul as mm
    from cmfrec_torch.solvers.dense_masked import _setup, padded_dims
    from data.generate import generate

    dev = torch.device("cuda")
    print(f"card: {card()}", flush=True)
    _, log = _cuda.build()
    _cuda.lib()
    for fn, regs, st, ld in ptxas_report(log, KERNELS):
        print(f"ptxas: {fn}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B", flush=True)

    traffic = json.loads((ROOT / "benchmark" / "traffic" / "ml10m.json")
                         .read_text())
    mat = generate(traffic, args.seed, dev)
    rows, cols, vals = mat.train
    nnz = rows.numel()
    m_pad, n_pad, K = padded_dims(mat.m, mat.n, 50)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    wts = 0.5 + 1.5 * torch.rand(nnz, device=dev, generator=g)
    _, W8, _, W8T, _, _ = _setup(rows, cols, vals.float(), None, m_pad, n_pad)
    _, Wf, _, WfT, _, _ = _setup(rows, cols, vals.float(), wts, m_pad, n_pad)
    del mat, rows, cols, vals, wts
    sides = {"A": (W8, Wf), "B": (W8T, WfT)}
    result = {"card": card(), "nnz": nnz, "K": K, "checks": [],
              "crossover": []}

    def rows_bound(R, S, entries, weighted):
        nbytes = (entries * (8 if weighted else 4) + 2 * (R + 1) * 4
                  + (R + S) * K * 4 + R * K * 4)
        return bound(nbytes, {"f32": 4 * entries * K})

    for side, (Wi8, Wfl) in sides.items():
        R, S = Wi8.shape
        Q = torch.randn(R, K, device=dev, generator=g) / 8
        Be = torch.randn(S, K, device=dev, generator=g) / 8
        for wname, W in (("int8", Wi8), ("f32", Wfl)):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            lists = mm.row_lists(W, nnz)
            end.record()
            torch.cuda.synchronize()
            build_ms = start.elapsed_time(end)
            entries = int(lists.offsets[-1])
            if entries != int((W != 0).sum()):
                raise AssertionError(f"side {side} W {wname}: the lists hold "
                                     f"{entries} entries")
            dense = mm.masked_gram_matvec(Q, Be, W)
            out = mm.masked_gram_matvec_rows(Q, Be, lists)
            again = mm.masked_gram_matvec_rows(Q, Be, lists)
            twin = mm.masked_gram_matvec_rows_ref(Q, Be, lists)
            torch.cuda.synchronize()
            scale = dense.abs().max().item()
            rel = (out - dense).abs().max().item() / scale
            rel_twin = (out - twin).abs().max().item() / scale
            bitwise = bool(torch.equal(out, again))
            ok = rel <= REL_TOL and rel_twin <= REL_TOL and bitwise
            dense_ms = _timed(lambda: mm.masked_gram_matvec(Q, Be, W),
                              args.reps)
            twin_ms = _timed(
                lambda: mm.masked_gram_matvec_rows_ref(Q, Be, lists), 2)
            by_chunk, chunk0 = {}, mm.ROW_CHUNK
            for chunk in args.chunks:
                mm.ROW_CHUNK = chunk
                lc = mm.row_lists(W, nnz)
                by_chunk[chunk] = _timed(
                    lambda: mm.masked_gram_matvec_rows(Q, Be, lc),
                    args.reps)
                del lc
            mm.ROW_CHUNK = chunk0
            b_ms, b_by = rows_bound(R, S, entries, wname == "f32")
            rec = dict(side=side, R=R, S=S, K=K, W=wname, entries=entries,
                       density=entries / (R * S), build_ms=build_ms,
                       rel_dense=rel, rel_twin=rel_twin, bitwise=bitwise,
                       rows_ms=by_chunk, dense_ms=dense_ms, twin_ms=twin_ms,
                       bound_ms=b_ms, bound_by=b_by)
            result["checks"].append(rec)
            shown = " ".join(f"chunk {c}: {t:.4f}" for c, t in
                             by_chunk.items())
            print(f"k1_rows side={side} R={R} S={S} K={K} W={wname} "
                  f"entries={entries} ({100 * entries / (R * S):.3f}%): "
                  f"build {build_ms:.3f} ms; rel vs dense {rel:.3e}, vs "
                  f"twin {rel_twin:.3e} (tol {REL_TOL:.0e}), bitwise "
                  f"{bitwise}; rows ms {shown}; dense f32 ms "
                  f"{dense_ms:.4f}; twin ms {twin_ms:.3f}; bound "
                  f"{b_ms:.4f} ({b_by}) {'ok' if ok else 'MISMATCH'}",
                  flush=True)
            if not ok:
                raise AssertionError("the row-list K1 disagrees")
            del lists, dense, out, again, twin

        points = [(Wi8, nnz)]
        W = Wi8
        for density in args.densities:
            want = int(density * R * S)
            have = int((W != 0).sum())
            if want <= have:
                continue
            # more cells, drawn uniformly among the empty ones
            p = (want - have) / (R * S - have)
            extra = torch.rand(R, S, device=dev, generator=g) < p
            W = (W.bool() | extra).to(torch.int8)
            del extra
            points.append((W, want))
        line = []
        for Wd, bound_entries in points:
            entries = int((Wd != 0).sum())
            lists = mm.row_lists(Wd, max(bound_entries, entries))
            rows_ms = _timed(lambda: mm.masked_gram_matvec_rows(Q, Be, lists),
                             args.reps)
            dense_ms = _timed(lambda: mm.masked_gram_matvec(Q, Be, Wd),
                              args.reps)
            rel = ((mm.masked_gram_matvec_rows(Q, Be, lists)
                    - mm.masked_gram_matvec(Q, Be, Wd)).abs().max().item()
                   / mm.masked_gram_matvec(Q, Be, Wd).abs().max().item())
            line.append((entries / (R * S), rows_ms, dense_ms))
            result["crossover"].append(dict(side=side, density=entries
                                            / (R * S), rows_ms=rows_ms,
                                            dense_ms=dense_ms, rel=rel))
            print(f"k1_rows crossover side={side} density="
                  f"{100 * entries / (R * S):.3f}%: rows ms {rows_ms:.4f}, "
                  f"dense f32 ms {dense_ms:.4f}, rel {rel:.3e}", flush=True)
            if rel > REL_TOL:
                raise AssertionError("the row-list K1 disagrees")
            del lists
        if len(line) >= 2:
            # least squares rows_ms = a + b * density; meets the mean dense ms
            n = len(line)
            mx = sum(d for d, _, _ in line) / n
            my = sum(r for _, r, _ in line) / n
            b = (sum((d - mx) * (r - my) for d, r, _ in line)
                 / sum((d - mx) ** 2 for d, _, _ in line))
            a = my - b * mx
            dense_mean = sum(t for _, _, t in line) / n
            cross = (dense_mean - a) / b
            result[f"crossover_{side}"] = cross
            print(f"k1_rows crossover side={side}: rows ms = {a:.4f} + "
                  f"{b:.4f} x density; dense {dense_mean:.4f} ms; they meet "
                  f"at density {100 * cross:.2f}%", flush=True)
        del points, W, Q, Be
        torch.cuda.empty_cache()

    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
