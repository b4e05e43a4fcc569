"""Reading a ``torch.profiler`` trace of one fit: the device's busy time
(the union of its kernel and copy intervals, as
scripts/prof_fit_torch.py takes it), the seconds of named kernels, and
the breakdown that the result line carries.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

# a kernel that finishes another's split work runs right after it on the
# stream, and is counted with it (masked_matmul.cu's split-S sum)
HELPERS = ("sum_chunks_kernel",)
TOP = 10
# how far back the host look for a gap's activity searches
SCAN = 4000


class Event(NamedTuple):
    name: str
    start: float  # seconds on the profiler's clock
    end: float


class Trace(NamedTuple):
    """A profiled fit: its device events and host events in start order,
    and the fit's own interval on the same clock."""

    device: list
    host: list
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        return sum(e - s for s, e in _union(self.device))

    def seconds(self, match) -> float:
        """Device seconds of the kernels whose name holds one of ``match``,
        with the helper kernels that follow them."""
        total, owner = 0.0, False
        for ev in self.device:
            if any(h in ev.name for h in HELPERS):
                if owner:
                    total += ev.end - ev.start
                continue
            owner = any(s in ev.name for s in match)
            if owner:
                total += ev.end - ev.start
        return total

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing in them (the innermost host
        event or span around each gap's middle)."""
        ops = {}
        for ev in self.device:
            ops[ev.name] = ops.get(ev.name, 0.0) + ev.end - ev.start
        gaps = {}
        starts = [ev.start for ev in self.host]
        for s, e in _gaps(_union(self.device), self.start, self.end):
            name = _host_at(self.host, starts, (s + e) / 2)
            gaps[name] = gaps.get(name, 0.0) + e - s
        return {"device_ops": _top(ops), "idle_gaps": _top(gaps)}


def from_profile(prof, fit_name: str, ranges=()) -> Trace:
    """The Trace of a profiler run that holds one host range named
    ``fit_name`` around the fit; ``ranges`` are the names of the other
    host ranges the run marked."""
    ranges = {fit_name, *ranges}
    from torch.autograd import DeviceType

    device, host, fit = [], [], None
    for e in prof.events():
        ev = Event(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type == DeviceType.CUDA:
            # a host range is mirrored on the device's timeline as an
            # annotation: it is no kernel or copy
            if not getattr(e, "is_user_annotation", False) and \
                    e.name not in ranges:
                device.append(ev)
        elif e.name == fit_name:
            fit = ev
        else:
            host.append(ev)
    if fit is None:
        raise RuntimeError(f"the trace holds no range {fit_name!r}")
    device.sort(key=lambda ev: ev.start)
    host.sort(key=lambda ev: ev.start)
    return Trace(device, host, fit.start, fit.end)


def _union(events):
    out = []
    for ev in sorted(events, key=lambda ev: ev.start):
        if out and ev.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ev.end)
        else:
            out.append([ev.start, ev.end])
    return out


def _gaps(busy, start, end):
    t = start
    for s, e in busy:
        if s > t:
            yield t, min(s, end)
        t = max(t, e)
    if end > t:
        yield t, end


def _host_at(host, starts, t) -> str:
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 1 - SCAN, -1), -1):
        if host[j].end >= t:
            return host[j].name
    return "host, outside any traced operation"


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
