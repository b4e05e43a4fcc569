"""k1_roofline: % of K1's roofline over the profiled fit: the sum of each
launch's bound (work.k1_launch: its operands' bytes as launched, 4 (k+1)
operations an observed entry) over K1's device seconds, taken from the
trace by its CUDA kernels' names (csrc/masked_matmul.cu)."""

import work

CALLS = {"k1": "cmfrec_torch.solvers.dense_masked:masked_gram_matvec"}
KERNELS = ("gram_bf16_wgmma_kernel", "gram_f32_tile8_kernel",
           "gram_f32_ring_kernel", "gram_bf16_whole_kernel",
           "gram_bf16_wide_kernel", "gram_f32_wide_kernel")


def read(run):
    calls = run.calls.get("k1")
    if not calls or run.trace is None:
        return None
    seconds = run.trace.seconds(KERNELS)
    if seconds <= 0.0:
        return None
    K = run.args["k"] + 1
    least = sum(work.bound(*work.k1_launch(Q, Be, W, run.stats["nnz"], K))
                for Q, Be, W, *_ in calls)
    return 100.0 * least / seconds
