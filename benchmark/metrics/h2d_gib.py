"""h2d_gib: GiB uploaded from the host in the profiled fit (the record's
``h2d_bytes`` counter over the engines' uploads: the COO triplets and
the small per-coordinate vectors)."""

import fit_record


def read(run):
    n = fit_record.counter(fit_record.record(run), "h2d_bytes")
    return None if n is None else n / 2 ** 30
