#!/usr/bin/env python3
"""Where K1's time goes on one CUDA card: every probe of K1 (the port of
scripts/sweep_kernel_probe2.py, sweep_kernel_variants.py and
sweep_kernel_probe3.py), timed at the flagship fit's padded shape.

Run from the repository root, on a machine with a CUDA card:

    python3 scripts/sweep_k1_probes_torch.py [--reps N]

Operands, drawn from a seeded torch.Generator on the card as the TPU
scripts drew theirs: Q and Be normal bf16, W a Bernoulli(0.013) int8 mask
(and the same mask in bf16), at the padded flagship shape
solvers.dense_masked.padded_dims(69878, 10677, 50) = 69888 x 10688, K=64,
for side A and, with R and S swapped, side B.  Each probe
(cmfrec_torch.ops.k1_probes.PROBES) is timed with CUDA events over `reps`
back-to-back launches on one stream after one warm-up; W (0.75 GB int8) is
larger than the 50 MB L2, so no flush is needed.  Also timed: p_part at
other chunk widths, and torch.sum(W, dtype=torch.int32) as xla_sum_int8
(the platform's own reduce of the W stream).

Prints the card's name and power limit, then one JSON line per probe and
side under the TPU scripts' names ("probe" for P1 and P3, "variant" and
"tf_s" for P2) with "side", "ms", "bound_ms" and "bound_by".  A probe that
fails to build or launch raises and the script exits non-zero; without a
CUDA device it exits non-zero at once.
"""

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

M, N, k = 69878, 10677, 50
DENSITY = 0.013
PART_CHUNKS = (1024, 16384)  # besides k1_probes.PART_CHUNK


def sweep(reps):
    """Yield one record per probe and side (what main prints)."""
    import torch

    from chip_smoke import _timed, bound
    from cmfrec_torch.ops import k1_probes
    from cmfrec_torch.solvers.dense_masked import padded_dims

    m_pad, n_pad, K = padded_dims(M, N, k)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p_part = next(p for p in k1_probes.PROBES if p.name == "p_part")
    for side, (R, S) in (("A", (m_pad, n_pad)), ("B", (n_pad, m_pad))):
        Q = torch.randn(R, K, device=dev, generator=gen).to(torch.bfloat16)
        Be = torch.randn(S, K, device=dev, generator=gen).to(torch.bfloat16)
        W = {torch.int8: (torch.rand(R, S, device=dev, generator=gen)
                          < DENSITY).to(torch.int8)}
        W[torch.bfloat16] = W[torch.int8].to(torch.bfloat16)
        base = dict(side=side, R=R, S=S, K=K)

        def record(key, name, fn, probe, **extra):
            Wp = W[probe.w_dtype]
            ms = _timed(lambda: fn(Q, Be, Wp), reps)
            b_ms, b_by = bound(*k1_probes.work(probe, R, S, K,
                                               Wp.element_size()))
            line = {key: name, **base, "ms": ms, "bound_ms": b_ms,
                    "bound_by": b_by, **extra}
            if key == "variant":
                line["tf_s"] = 4 * R * S * K / ms / 1e9
            return line

        for probe in k1_probes.PROBES:
            key = "variant" if probe.row == "p2" else "probe"
            extra = ({"chunk": k1_probes.PART_CHUNK}
                     if probe.name == "p_part" else {})
            yield record(key, probe.name, probe.kernel, probe, **extra)
        for chunk in PART_CHUNKS:
            yield record("probe", "p_part",
                         lambda q, b, w, c=chunk: k1_probes.part(q, b, w,
                                                                 chunk=c),
                         p_part, chunk=chunk)
        W8 = W[torch.int8]
        ms = _timed(lambda: torch.sum(W8, dtype=torch.int32), reps)
        b_ms, b_by = bound(R * S + 4, {"f32": R * S})
        yield {"probe": "xla_sum_int8", **base, "ms": ms, "bound_ms": b_ms,
               "bound_by": b_by, "library": "torch.sum"}
        del Q, Be, W, W8
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("sweep_k1_probes_torch: torch sees no CUDA device",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for line in sweep(args.reps):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
