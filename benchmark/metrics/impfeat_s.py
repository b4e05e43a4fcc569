"""impfeat_s: device seconds of the profiled fit's implicit-features work
(the ``cmfrec.engine.impfeat`` spans, one an iteration: the Ai and Bi
solves and the products Xones @ F), summed, from the CUDA events at each
span's ends; None off the card or without such spans."""

import fit_record


def read(run):
    rec = fit_record.record(run)
    spans = [] if rec is None else [
        s.device_s for s in rec.named("cmfrec.engine.impfeat")
        if s.device_s is not None]
    return sum(spans) if spans else None
