"""host_syncs: the points of the profiled fit at which the host waits on
the device (the record's ``host_syncs`` counter: the factors' copies to
the host, fences, exact CG's exit test, L-BFGS's scalar reads)."""

import fit_record


def read(run):
    return fit_record.counter(fit_record.record(run), "host_syncs")
