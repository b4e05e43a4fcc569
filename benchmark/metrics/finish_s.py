"""finish_s: seconds of the profiled fit's ``cmfrec.finish`` span
(models/cmf.py:CMF.fit after the driver returns: the factors copied to
the host, the id dicts, the prediction caches), the larger of its host
and device durations."""

import fit_record


def read(run):
    return fit_record.seconds(fit_record.record(run), "cmfrec.finish")
