#!/usr/bin/env python3
"""K2 past K = 256 with bf16 operands (rhs_bf16_wide_kernel in
csrc/masked_matmul.cu) on one CUDA card: its time against the kernel it
replaced, and where a launch's time goes.

Run from the repository root:

    python3 scripts/time_k2_wide_torch.py [--K 320 1024] [--reps 5]
                                          [--parent DIR]

DIR, if given, is a checkout of the tree before the wide kernel (K2 a
block of 64 output columns at any K): its csrc/masked_matmul.cu is compiled
alone and bound with that tree's C interface (cmf_masked_rhs without the
column chunk).  Builds the kernels (the ops' library, three probe builds of
masked_matmul.cu with -DCMF_K2_PROBE, built by ``_cuda.probe_libs``, and the
parent's, all at once) and prints ptxas's registers and spills for K2's
kernels; then, at chip_smoke.py phase 30's shape (the flagship's padded A
side, 69,888 x 10,688: an int8 mask at ML10M's density, and bf16 weights on
it; bf16 ratings, f32 mb, bf16 Be; K2 reads X and W whole whatever they
hold), for each ``--K`` and W type: the plan (configuration, column
chunks, S chunks, shared memory), the check against the twin
(masked_rhs_ref; phase 30's tolerance; a second call bitwise equal), and
CUDA-event means over ``--reps`` calls after a warm-up of the parent's
kernel and the wide one in turns (parent, wide, wide, parent; the mean of
each pair), then of the probe builds with the wide kernel's plan: the copies
alone (no V, no products), no Be copies (the products read whatever the
ring holds), and the X, W and mb copies alone.  The products' share is the
launch less the copies alone, the Be copies' share the copies alone less
the X, W and mb copies.  Bound: chip_smoke.bound (X, W, mb and Be read
once, out written once at 3.35 TB/s against 2RSK operations at the bf16
peak); beside it the bytes the blocks read from L2 (X and W once, Be once a
128-row block).  Prints the card's name and power limit, one line per
measurement and, last, one JSON object.  Refuses a machine without CUDA;
raises on a mismatch.
"""

import argparse
import ctypes
import json
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

R_A, S_A = 69888, 10688  # the flagship's padded A side (chip_smoke phase 3)
DENSITY = 10_000_054 / (69878 * 10677)  # ML10M's ratings over its cells
NO_MATH, NO_BE = 1, 2  # csrc/masked_matmul.cu kK2Probe* (CMF_K2_PROBE)
PROBES = {"copies": NO_MATH, "no_be": NO_BE, "xw_copies": NO_MATH | NO_BE}


def _parent_lib(tree):
    """The parent's masked_matmul.cu compiled alone, bound with its C
    interface: cmf_masked_rhs(X, W, mb, Be, out, part, R, S, K, chunk,
    variant, w_type, stream) and cmf_rhs_geometry."""
    from cmfrec_torch.ops import _cuda

    src = pathlib.Path(tree).resolve() / "cmfrec_torch" / "csrc" / \
        "masked_matmul.cu"
    path = _cuda._hashed("libcmfrec_parent_k2", (src,), _cuda.NVCC_FLAGS)
    log = ""
    if not path.exists():
        log = _cuda._build_all([(path, (src,), _cuda.NVCC_FLAGS)])
    so = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.cmf_masked_rhs.argtypes = [P] * 6 + [I] * 6 + [P]
    so.cmf_masked_rhs.restype = I
    so.cmf_rhs_geometry.argtypes = [I, I, I, ctypes.POINTER(I)]
    so.cmf_rhs_geometry.restype = I
    return so, log


def _parent_call(so, X, W, mb, Be):
    """One call of the parent's K2 as its wrapper planned it (64 output
    columns a block, split_chunk over K / 64 column blocks)."""
    import torch

    from cmfrec_torch.ops import _cuda
    from cmfrec_torch.ops import masked_matmul as mm

    (R, S), K = X.shape, Be.shape[1]
    geo = (ctypes.c_int * 6)()
    _cuda.check(so.cmf_rhs_geometry(K, 0, mm.W_TYPES[W.dtype], geo),
                "parent rhs geometry")
    variant, row_tile, s_tile, per_sm = geo[0], geo[1], geo[2], max(1, geo[3])
    chunk = mm.split_chunk(R, S, _cuda.sm_count(X.device), row_tile=row_tile,
                           s_tile=s_tile, per_sm=per_sm, col_blocks=K // 64)
    chunks = -(-S // chunk)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        out = torch.empty(R, K, dtype=torch.float32, device=X.device)
        part = (torch.empty(chunks, R, K, dtype=torch.float32,
                            device=X.device) if chunks > 1 else out)
        _cuda.check(so.cmf_masked_rhs(
            X.data_ptr(), W.data_ptr(), mb.data_ptr(), Be.data_ptr(),
            out.data_ptr(), part.data_ptr(), R, S, K, chunk, variant,
            mm.W_TYPES[W.dtype], stream), "parent masked_rhs")
        return out

    return call, dict(variant=variant, chunk=chunk, chunks=chunks,
                      smem=geo[5])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--K", type=int, nargs="+", default=[320, 1024])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_k2_wide_torch: torch sees no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import REL_TOL, _timed, bound, card, ptxas_report
    from cmfrec_torch.ops import _cuda
    from cmfrec_torch.ops import masked_matmul as mm

    print(f"card: {card()}", flush=True)
    with ThreadPoolExecutor(3) as pool:  # every nvcc at once
        built = pool.submit(_cuda.build)
        probe = pool.submit(_cuda.probe_libs, PROBES.values(), "k2")
        parent = pool.submit(_parent_lib, args.parent) if args.parent else None
        log = built.result()[1]
        probes = {name: probe.result()[bits] for name, bits in PROBES.items()}
        parent_so, parent_log = parent.result() if parent else (None, "")
    for what, text in (("wide", log), ("parent", parent_log)):
        for fn, regs, st, ld in ptxas_report(
                text, ("rhs_bf16_wide_kernel", "rhs_bf16_wgmma_kernel")):
            print(f"ptxas ({what}): {fn}: {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B", flush=True)
        # wgmma serialized by the compiler (C7515, C7518, ...): the products
        # then wait for each other and for V
        serial = [ln for ln in text.splitlines() if "serialized" in ln
                  and ("rhs_bf16_wide" in ln or "rhs_bf16_wgmma" in ln)]
        print(f"ptxas ({what}): {len(serial)} K2 kernels with wgmma "
              "serialized" + "".join(f"\n  {ln.strip()}" for ln in serial),
              flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    mask = torch.rand(R_A, S_A, device=dev, generator=gen) < DENSITY
    W8 = mask.to(torch.int8)
    Wb = (mask * (0.5 + 1.5 * torch.rand(R_A, S_A, device=dev,
                                         generator=gen))).to(torch.bfloat16)
    del mask
    X = (torch.randint(1, 11, (R_A, S_A), device=dev, generator=gen) / 2).to(
        torch.bfloat16)
    mb = 3.5 + torch.randn(S_A, device=dev, generator=gen) / 2
    sms = _cuda.sm_count(dev)
    records = []
    for K in args.K:
        Be = (torch.randn(S_A, K, device=dev, generator=gen) / 8).to(
            torch.bfloat16)
        for wname, W in (("int8", W8), ("bf16", Wb)):
            plan = mm.rhs_plan(R_A, S_A, K, torch.bfloat16, W.dtype, dev)
            ref = mm.masked_rhs_ref(X, W, mb, Be)
            got = mm.masked_rhs(X, W, mb, Be)
            again = mm.masked_rhs(X, W, mb, Be)
            torch.cuda.synchronize()
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            if not (rel <= REL_TOL["bf16"] and torch.equal(got, again)):
                raise AssertionError(f"K2 at K={K} W={wname}: rel {rel:.3e} "
                                     f"or repeat not bitwise equal")
            del got, again

            def wide():
                return mm.masked_rhs(X, W, mb, Be)

            rec = dict(K=K, W=wname, R=R_A, S=S_A, rel_err=rel, plan=dict(
                variant=plan["variant"], col_chunk=plan["col_chunk"],
                cols=[w for _, w in plan["cols"]], chunk=plan["chunk"],
                chunks=plan["chunks"], smem=plan["smem"], sms=sms))
            if parent_so is not None:
                old, rec["parent_plan"] = _parent_call(parent_so, X, W, mb, Be)
                prel = ((old() - ref).abs().max() / ref.abs().max()).item()
                if not prel <= REL_TOL["bf16"]:
                    raise AssertionError(f"parent K2 at K={K}: rel {prel:.3e}")
                turns = [_timed(fn, args.reps) for fn in (old, wide, wide, old)]
                rec.update(parent_ms=(turns[0] + turns[3]) / 2,
                           ms=(turns[1] + turns[2]) / 2, turns=turns)
            else:
                rec["ms"] = _timed(wide, args.reps)
            for name, so in probes.items():
                rec[f"{name}_ms"] = _timed(
                    lambda so=so: mm.rhs_launch(X, W, mb, Be, plan, kernels=so),
                    args.reps)
            del ref
            wsz = W.element_size()
            nbytes = R_A * S_A * (2 + wsz) + S_A * 4 + S_A * K * 2 + R_A * K * 4
            rec["bound_ms"], rec["bound_by"] = bound(
                nbytes, {"bf16": 2 * R_A * S_A * K})
            rec["l2_gb"] = (R_A * S_A * (2 + wsz)
                            + -(-R_A // 128) * S_A * K * 2) / 1e9
            records.append(rec)
            print(f"K2 K={K} W={wname}: configuration {plan['variant']}, nc "
                  f"{plan['col_chunk']}, column chunks {rec['plan']['cols']}, "
                  f"S chunk {plan['chunk']} ({plan['chunks']} chunks), smem "
                  f"{plan['smem']} B; rel={rel:.3e} (tol {REL_TOL['bf16']:.0e})"
                  f"; ms={rec['ms']:.3f}"
                  + (f" parent_ms={rec['parent_ms']:.3f} (turns "
                     + " / ".join(f"{t:.3f}" for t in rec["turns"]) + ")"
                     if "parent_ms" in rec else "")
                  + f"; probes: copies {rec['copies_ms']:.3f}, no Be copies "
                  f"{rec['no_be_ms']:.3f}, X/W/mb copies "
                  f"{rec['xw_copies_ms']:.3f} ms; bound {rec['bound_ms']:.4f} "
                  f"({rec['bound_by']}), L2 reads {rec['l2_gb']:.2f} GB",
                  flush=True)
        del Be
        torch.cuda.empty_cache()
    print(json.dumps({"card": card(), "k2_wide": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
