#!/usr/bin/env python3
"""Mask @ F of the collective fit with implicit features, four ways, on one
CUDA card.

Run from the repository root:

    python3 scripts/time_mask_matmul_torch.py

The fit of chip_smoke.py phase 10a computes Mask @ F four times an
iteration (dense_masked._mask_matmul: the int8 0/1 mask, [69,888 x 10,688]
padded, or its transpose, against F [S, 50]; F rounded to bf16 in the bulk
iterations).  At both orientations of that shape (the mask drawn by
chip_smoke.make_preference_data with ML10M's number of pairs) this times,
with CUDA events:

  cast_gemm   _mask_matmul as the fit runs it: int8 -> f32 casts of row
              chunks and cuBLAS f32 GEMMs;
  cast_only   the chunk casts alone;
  f32_copy    one cuBLAS f32 GEMM on an f32 copy of the mask made once
              (4 B an entry kept on the card);
  k2_bf16     K2 (masked_rhs) with X = 0 in bf16 (2 B an entry kept),
              mb = -1 and F in bf16 padded to 64 columns: ((0 + 1) * M) F,
              the TPU's bf16 x bf16 -> f32 product;
  k2_f32      the same with F in f32 (the polish iterations' product).

Each prints its ms a call, the card memory it keeps, and max |x - cast_gemm|
/ max |cast_gemm| against the fit's product at the same operand type.  One
JSON line per reading; the card's name and power limit first.
"""

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

K = 50
REPS = 20


def main():
    import torch

    if not torch.cuda.is_available():
        print("time_mask_matmul_torch: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    from cmfrec_torch.ops.masked_matmul import masked_rhs, row_chunks
    from cmfrec_torch.solvers.dense_masked import (
        _mask_matmul, _setup_implicit, padded_dims)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rows, cols, vals = cs.make_preference_data(**cs.PREF)
    m_pad, n_pad, _ = padded_dims(cs.M, cs.N, K)
    up = [torch.as_tensor(a, device="cuda") for a in (rows, cols, vals)]
    dense = _setup_implicit(up[0], up[1], up[2].float(), m_pad, n_pad)
    masks = {"A": dense[2], "B": dense[5]}
    del dense, up
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for side, Mask in masks.items():
        R, S = Mask.shape
        F = 0.3 * torch.randn(S, K, generator=gen, device="cuda")

        def rel(x, ref):
            return float((x - ref).abs().max() / ref.abs().max())

        def report(name, ms, kept, err):
            print(json.dumps({"side": side, "R": R, "S": S, "K": K,
                              "variant": name, "ms": ms, "kept_gib":
                              kept / 2**30, "rel_err": err}), flush=True)

        for op in (torch.bfloat16, torch.float32):
            ref = _mask_matmul(Mask, F, op)
            tag = "bf16" if op == torch.bfloat16 else "f32"
            report(f"cast_gemm_{tag}", cs._timed(
                lambda: _mask_matmul(Mask, F, op), REPS), 0, 0.0)
            if op == torch.bfloat16:
                def casts():
                    for sl in row_chunks(R, S):
                        Mask[sl].float()
                report("cast_only", cs._timed(casts, REPS), 0, None)
                Mf = Mask.float()
                Fm = F.to(op).float()
                report("f32_copy", cs._timed(lambda: Mf @ Fm, REPS),
                       Mf.numel() * 4, rel(Mf @ Fm, ref))
                del Mf
                torch.cuda.empty_cache()
            Xz = torch.zeros(R, S, dtype=torch.bfloat16, device="cuda")
            mb = torch.full((S,), -1.0, device="cuda")
            Fp = torch.zeros(S, 64, dtype=op, device="cuda")
            Fp[:, :K] = F.to(op)
            out = masked_rhs(Xz, Mask, mb, Fp)[:, :K]
            report(f"k2_{tag}", cs._timed(lambda: masked_rhs(Xz, Mask, mb, Fp),
                                          REPS),
                   Xz.numel() * 2, rel(out, ref))
            del Xz, out, ref
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
