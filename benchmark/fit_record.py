"""The program's own record of the profiled fit: the spans and counters
that cmfrec_torch.utils.profiling keeps while a profiler records, read by
the metrics of the fit's layers.  A program that keeps no record (before
it had spans) gives None, and those metrics then report nothing."""

from __future__ import annotations

from typing import Optional


def record(run):
    """The record of the run's profiled fit (``profiling.last_record()``,
    the newest, since the profiled fit is the run's last under a
    profiler), or None: no profiled fit, or no record in the program."""
    if run.trace is None:
        return None
    try:
        from cmfrec_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_record", None)
    return None if last is None else last()


def seconds(rec, name: str) -> Optional[float]:
    """The seconds of the spans called ``name`` (each the larger of its host
    and device durations), summed; None where there are none."""
    spans = [] if rec is None else rec.named(name)
    if not spans:
        return None
    return sum(s.seconds for s in spans)


def iterations(rec, compute: str) -> list:
    """The device seconds of the iteration spans of operand type
    ``compute``; empty off the card (no device times)."""
    if rec is None:
        return []
    return [s.device_s for s in rec.named("cmfrec.engine.iter")
            if s.attrs.get("compute") == compute and s.device_s is not None]


def counter(rec, name: str) -> Optional[int]:
    return None if rec is None else rec.counters.get(name)
