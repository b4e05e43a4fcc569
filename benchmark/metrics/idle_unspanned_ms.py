"""idle_unspanned_ms: milliseconds of the profiled fit's idle gaps (no
kernel or copy on the device: devtrace's union and gaps) at whose
midpoint the host is in no ``cmfrec.*`` range below ``cmfrec.fit``, the
part of the idle time that no span of the program names.  None where the
trace holds no such range (a program without spans)."""

import devtrace

ROOT = "cmfrec.fit"


def read(run):
    trace = run.trace
    if trace is None:
        return None
    spans = [ev for ev in trace.host
             if ev.name.startswith("cmfrec.") and ev.name != ROOT]
    if not spans:
        return None
    idle = 0.0
    for s, e in devtrace._gaps(devtrace._union(trace.device), trace.start,
                               trace.end):
        mid = (s + e) / 2
        if not any(ev.start <= mid <= ev.end for ev in spans):
            idle += e - s
    return 1e3 * idle
