"""fit_mfu: % of the card's peak that the algorithm's floating-point
operations for these inputs take in the untraced window's fit_s: the
least time those operations need at the peak of their operand type (the
configuration reference's ``fit_ops`` and work.bound, as every roofline
here costs an operation), over fit_s."""

import work


def read(run):
    fit_s = run.fit_s
    if fit_s is None or run.device.type != "cuda":
        return None
    ops = run.cell.reference.fit_ops(run.stats, run.cell.config)
    return 100.0 * work.bound(0, ops) / fit_s
