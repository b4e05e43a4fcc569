"""driver_self_s: host seconds of the profiled fit's ``cmfrec.driver``
spans less those of the spans opened in them (the engine): the driver's
own part of a fit (solvers/drivers.py:fit_explicit_als: the global mean,
the engine's choice and the card's memory query)."""

import fit_record


def read(run):
    rec = fit_record.record(run)
    drivers = [] if rec is None else rec.named("cmfrec.driver")
    if not drivers:
        return None
    return sum(d.host_s - sum(c.host_s for c in rec.children(d))
               for d in drivers)
