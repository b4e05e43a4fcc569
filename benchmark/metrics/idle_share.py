"""idle_share: % of the profiled fit's host wall time in which no kernel
or copy ran on the device (1 - the union of their intervals / the fit)."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
