"""engine_s: seconds in the solver engine over one fit, synchronized at
the span's end: solvers/dense_masked.py:fit_explicit_dense_masked (the
dense form, the bias start and the iterations)."""

SPANS = {"engine_dense": "cmfrec_torch.solvers.drivers:"
                         "fit_explicit_dense_masked"}


def read(run):
    return run.spans.get("engine_dense")
