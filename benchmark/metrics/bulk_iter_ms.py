"""bulk_iter_ms: the median device milliseconds of the profiled fit's
bf16 iterations (``cmfrec.engine.iter`` spans with compute "bf16": the
CG iterations before the polish, K1 and K2 on bf16 operands), from the
CUDA events at each span's ends; None off the card."""

import statistics

import fit_record


def read(run):
    spans = fit_record.iterations(fit_record.record(run), "bf16")
    return 1e3 * statistics.median(spans) if spans else None
