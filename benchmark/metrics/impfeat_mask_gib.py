"""impfeat_mask_gib: GiB of the mask that the profiled fit's
implicit-features products read, in the form the program holds it (the
record's ``impfeat.mask_bytes`` counter: R x S bytes a product for the
dense int8 mask); None without the counter."""

import fit_record


def read(run):
    n = fit_record.counter(fit_record.record(run), "impfeat.mask_bytes")
    return None if n is None else n / 2 ** 30
