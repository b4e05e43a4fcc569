"""polish_s: device seconds of the profiled fit's f32 iteration (the
``cmfrec.engine.iter`` span with compute "f32": finalize_chol's last
iteration, K1 and K2 on f32 operands), from the CUDA events at the span's
ends; None off the card."""

import fit_record


def read(run):
    spans = fit_record.iterations(fit_record.record(run), "f32")
    return sum(spans) if spans else None
