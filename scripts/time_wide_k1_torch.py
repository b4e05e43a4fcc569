#!/usr/bin/env python3
"""K1 past K = 256 (the wide configurations of csrc/masked_matmul.cu) on one
CUDA card.

Run from the repository root:

    python3 scripts/time_wide_k1_torch.py [--K 320 1024] [--reps 3]

Builds the kernels and prints ptxas's registers and spills for the wide
kernels; holds K1 against its twin (ops/masked_matmul.masked_gram_matvec_ref)
at a small shape, 192 x 320 (a ragged 128-row block), at every K of
CHECK_K for bf16 operands on an int8 mask, bf16 and f32 weights and f32
operands on the same, each call twice (bitwise equal), and beside it how
far kernel and twin each lie from the twin's roundings applied to T summed
in float64 (exact_ref: the twin's own f32 sum runs in cuBLAS's order);
then, at the
flagship's A-side shape (69,888 x 10,688, an int8 mask at ML10M's density
and bf16 weights on it, the kernel reads W whole whatever it holds), for
each ``--K``: K1 with bf16 operands on the mask and on the weights and with
f32 operands on the mask: its plan (configuration, column chunks, S
chunks, shared memory), the CUDA-event mean over ``--reps`` calls after a
warm-up, the twin's time, the bound (chip_smoke.bound: each input read
once and the output written once at 3.35 TB/s against 4RSK operations at
the operand type's peak) and the error against the twin.  Prints the
card's name and power limit, one line per measurement and, last, one JSON
object.  Refuses a machine without CUDA; raises on a mismatch.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CHECK_K = (320, 384, 448, 512, 576, 1024)
R_A, S_A = 69888, 10688  # the flagship's padded A side (chip_smoke phase 3)
DENSITY = 10_000_054 / (69878 * 10677)  # ML10M's ratings over its cells


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--K", type=int, nargs="+", default=[320, 1024])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_wide_k1_torch: torch sees no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import REL_TOL, _timed, bound, card, ptxas_report
    from cmfrec_torch.ops import _cuda
    from cmfrec_torch.ops import masked_matmul as mm

    print(f"card: {card()}", flush=True)
    _, log = _cuda.build()
    for fn, regs, st, ld in ptxas_report(
            log, ("gram_bf16_whole_kernel", "gram_bf16_wide_kernel",
                  "gram_f32_wide_kernel")):
        print(f"ptxas: {fn}: {regs} registers, spill stores {st} B, spill "
              f"loads {ld} B", flush=True)
    for line in log.splitlines():  # wgmma serialized, or other losses
        if "Performance Loss" in line or "serialized" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    names = {torch.bfloat16: "bf16", torch.float32: "f32",
             torch.int8: "int8"}
    cases = [(torch.bfloat16, torch.int8), (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.float32, torch.int8),
             (torch.float32, torch.bfloat16), (torch.float32, torch.float32)]

    def inputs(R, S, K, op, wdt, density=DENSITY):
        Q = (torch.randn(R, K, device=dev, generator=gen) / 8).to(op)
        Be = (torch.randn(S, K, device=dev, generator=gen) / 8).to(op)
        mask = torch.rand(R, S, device=dev, generator=gen) < density
        W = (mask.to(torch.int8) if wdt == torch.int8 else
             (mask * (0.5 + torch.rand(R, S, device=dev, generator=gen))
              ).to(wdt))
        return Q, Be, W

    def rel(out, ref):
        return ((out - ref).abs().max() / ref.abs().max()).item()

    def exact_ref(Q, Be, W):
        """The twin's roundings on T summed in float64 (then rounded to
        f32), the second product in float64."""
        bf16 = Be.dtype == torch.bfloat16
        t = (Q.double() @ Be.double().T).float()
        if bf16 and W.dtype == torch.bfloat16:
            t = t.to(torch.bfloat16).float()
        t = t * W.float()
        if bf16:
            t = t.to(torch.bfloat16).float()
        return t.double() @ Be.double()

    for K in CHECK_K:
        for op, wdt in cases:
            Q, Be, W = inputs(192, 320, K, op, wdt, density=0.3)
            plan = mm.gram_plan(192, 320, K, op, wdt, dev)
            out = mm.masked_gram_matvec(Q, Be, W)
            again = mm.masked_gram_matvec(Q, Be, W)
            twin = mm.masked_gram_matvec_ref(Q, Be, W)
            err = rel(out, twin)
            exact = exact_ref(Q, Be, W)
            same = bool(torch.equal(out, again))
            ok = err <= REL_TOL[names[op]] and same
            print(f"check K={K} op={names[op]} W={names[wdt]}: configuration "
                  f"{plan['variant']}, column chunks "
                  f"{[w for _, w in plan['cols']]}, smem {plan['smem']} B; "
                  f"rel={err:.3e} (kernel vs f64-T "
                  f"{rel(out.double(), exact):.3e}, twin vs f64-T "
                  f"{rel(twin.double(), exact):.3e}) repeat bitwise {same} "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                raise AssertionError(f"K1 at K={K} {names[op]}/{names[wdt]} "
                                     "disagrees with its twin")

    records = []
    for K in args.K:
        Q32, Be32, W8 = inputs(R_A, S_A, K, torch.float32, torch.int8)
        Wb = (W8 * (0.5 + torch.rand(R_A, S_A, device=dev, generator=gen))
              ).to(torch.bfloat16)
        for op, wdt in ((torch.bfloat16, torch.int8),
                        (torch.bfloat16, torch.bfloat16),
                        (torch.float32, torch.int8)):
            Q, Be = Q32.to(op), Be32.to(op)
            W = W8 if wdt == torch.int8 else Wb
            plan = mm.gram_plan(R_A, S_A, K, op, wdt, dev)
            mm.masked_gram_matvec.launches = 0
            got = mm.masked_gram_matvec(Q, Be, W)
            launches = mm.masked_gram_matvec.launches
            ref = mm.masked_gram_matvec_ref(Q, Be, W)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            r = err / ref.abs().max().item()
            del got, ref
            ms = _timed(lambda: mm.masked_gram_matvec(Q, Be, W), args.reps)
            plain_ms = _timed(lambda: mm.masked_gram_matvec_ref(Q, Be, W), 1)
            esz, wsz = Q.element_size(), W.element_size()
            b_ms, b_by = bound((R_A + S_A) * K * esz + R_A * S_A * wsz
                               + R_A * K * 4, {names[op]: 4 * R_A * S_A * K})
            ok = r <= REL_TOL[names[op]] and launches == 1
            print(f"K1 side=A R={R_A} S={S_A} K={K} op={names[op]} "
                  f"W={names[wdt]}: configuration {plan['variant']}, column "
                  f"chunks {[w for _, w in plan['cols']]}, S chunk "
                  f"{plan['chunk']} ({plan['chunks']} chunks), smem "
                  f"{plan['smem']} B; ms={ms:.3f} plain_ms={plain_ms:.3f} "
                  f"bound_ms={b_ms:.4f} ({b_by}) max_abs_err={err:.3e} "
                  f"rel={r:.3e} {'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                raise AssertionError(f"K1 at K={K} disagrees with its twin")
            records.append(dict(K=K, op=names[op], W=names[wdt], ms=ms,
                                plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, max_abs_err=err, rel_err=r,
                                plan=plan))
            del Q, Be
        del Q32, Be32, W8, Wb
        torch.cuda.empty_cache()
    print(json.dumps({"card": card(), "wide_k1": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
