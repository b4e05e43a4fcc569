"""dense_setup_s: seconds of the profiled fit's ``cmfrec.engine.setup``
span (solvers/dense_masked.py:_dense_explicit_setup: the uploads, the
dense form in both orientations, the counts and the liveness), the larger
of its host and device durations."""

import fit_record


def read(run):
    return fit_record.seconds(fit_record.record(run), "cmfrec.engine.setup")
