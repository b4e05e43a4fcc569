"""Profiling and timing utilities (port of cmfrec_tpu/utils/profiling.py).

``torch.profiler`` takes the place of ``jax.profiler``: a trace of the host
and, on a card, of every kernel it runs (the port's own kernels among
them, by their CUDA names), written where Perfetto or TensorBoard reads
it.  The fit drivers print per-iteration times with ``verbose=True``.

While a ``torch.profiler`` records (``trace``, ``CMFREC_TORCH_PROFILE``,
or any profiler the caller runs), every fit also keeps a record of its own
(:func:`last_record`): the spans the program opens, nested as the calls
are, each a ``record_function`` range on the profiler's timeline and, on
a card, a pair of CUDA events on the current stream; and counters of the
bytes uploaded, the host's waits on the device and the kernels' launches.
With no profiler recording, a span or counter is one check of a module
global and nothing more: no event, no range, no record.

The spans: ``cmfrec.fit`` (the root: a model's ``fit``, or a fit driver
called on its own), ``cmfrec.ingest`` (the model's input to COO triplets),
``cmfrec.driver`` (a fit driver), ``cmfrec.engine`` (an engine the driver
calls), under it ``cmfrec.engine.layout`` (the bucketed layout),
``cmfrec.engine.setup`` (the dense form), ``cmfrec.engine.bias_init`` and
one ``cmfrec.engine.iter`` an iteration (in a collective dense fit with
implicit features, ``cmfrec.engine.impfeat`` inside it: the Xones
half-steps), and ``cmfrec.finish`` (the model's copies of the factors to
the host and its prediction caches).  The counters: ``h2d_bytes``,
``host_syncs``, ``d2h_bytes``, ``launches.k1`` / ``k1_rows`` / ``k2`` /
``k3`` / ``cd`` (the ops' own ``launches`` over the fit; ``k1_rows`` is
K1 on row lists, masked_gram_matvec_rows), and those a fit adds by
:func:`count` where it runs (``impfeat.products``, ``impfeat.mask_bytes``:
the Xones products and the mask bytes they read)."""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import torch

# the environment variable naming the directory every fit traces into
PROFILE_ENV = "CMFREC_TORCH_PROFILE"


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of everything inside the context:
    the host's operators, and the card's kernels and copies where torch
    sees a card.  The trace is written into ``logdir`` as a Chrome trace
    (``<host>_<pid>.<time>.pt.trace.json``), which Perfetto
    (ui.perfetto.dev) and TensorBoard's profiler plugin read:

        with trace("/tmp/tb"): model.fit(X)
    """
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


_tracing = False


@contextlib.contextmanager
def maybe_trace():
    """Honor CMFREC_TORCH_PROFILE=<logdir>: every fit wrapped in this
    context writes a :func:`trace` there; unset, it does nothing.
    Re-entrant: nested fits (the offsets model's inner ALS) join the outer
    trace."""
    global _tracing
    logdir = os.environ.get(PROFILE_ENV)
    if not logdir or _tracing:
        yield
        return
    _tracing = True
    try:
        with trace(logdir):
            yield
    finally:
        _tracing = False


# ----------------------------------------------------------------------- #
# the fit's record                                                         #
# ----------------------------------------------------------------------- #

# the record of the fit in flight while a profiler records, else None: the
# one state every span and counter checks
_open: Optional["Record"] = None
_last: Optional["Record"] = None
_OFF = contextlib.nullcontext()


class Span:
    """A span of a fit's record: ``name``, ``id``, ``parent`` (the id of the
    span it opened in; None for the root), ``attrs``, the host's start and
    end in ns from the root's start, and on a card the device's, in ms from
    the root's start event (None off the card)."""

    __slots__ = ("name", "id", "parent", "attrs", "host_start_ns",
                 "host_end_ns", "device_start_ms", "device_end_ms", "_rec",
                 "_range", "_events")

    def __init__(self, rec: "Record", name: str, attrs: dict):
        self.name, self.attrs, self._rec = name, attrs, rec
        self.id = self.parent = None
        self.host_start_ns = self.host_end_ns = None
        self.device_start_ms = self.device_end_ms = None
        self._range = self._events = None

    def __enter__(self):
        rec = self._rec
        self.id = len(rec.spans)
        self.parent = rec.stack[-1] if rec.stack else None
        rec.spans.append(self)
        rec.stack.append(self.id)
        self._range = torch.autograd.profiler.record_function(self.name)
        self._range.__enter__()
        if rec.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = (start,)
        self.host_start_ns = time.perf_counter_ns() - rec.t0_ns
        return self

    def __exit__(self, *exc):
        rec = self._rec
        self.host_end_ns = time.perf_counter_ns() - rec.t0_ns
        if rec.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events += (end,)
        self._range.__exit__(*exc)
        self._range = None
        rec.stack.pop()
        return False

    @property
    def host_s(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e9

    @property
    def device_s(self) -> Optional[float]:
        if self.device_start_ms is None:
            return None
        return (self.device_end_ms - self.device_start_ms) / 1e3

    @property
    def seconds(self) -> float:
        """The larger of the host's and the device's duration."""
        dev = self.device_s
        return self.host_s if dev is None else max(self.host_s, dev)


LAUNCHES = ("k1", "k1_rows", "k2", "k3", "cd")


def _launch_counts() -> dict:
    """The ops' own launch counters (each op's ``launches``), by kernel."""
    from ..ops import coord_descent, masked_matmul, sparse_cg

    ops = (masked_matmul.masked_gram_matvec,
           masked_matmul.masked_gram_matvec_rows, masked_matmul.masked_rhs,
           sparse_cg.bucket_cg, coord_descent.solve_cd)
    return {k: getattr(op, "launches", 0) for k, op in zip(LAUNCHES, ops)}


class Record:
    """One fit's spans (``spans[0]`` the root, ``cmfrec.fit``) and counters,
    kept from the root's start to its end."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.spans = []
        self.stack = []
        self.counters = {"h2d_bytes": 0, "host_syncs": 0, "d2h_bytes": 0}
        self.t0_ns = time.perf_counter_ns()
        self._launches0 = _launch_counts()

    @property
    def root(self) -> Span:
        return self.spans[0]

    def named(self, name: str) -> list:
        """The spans called ``name``, in the order they opened."""
        return [s for s in self.spans if s.name == name]

    def children(self, span: Span) -> list:
        return [s for s in self.spans if s.parent == span.id]

    def _close(self):
        """The launches over the fit, and the events as device times.  The
        fit has read its results back by now, so the events are done."""
        now = _launch_counts()
        for k in LAUNCHES:
            self.counters[f"launches.{k}"] = now[k] - self._launches0[k]
        if self.cuda:
            start = self.root._events[0]
            self.root._events[-1].synchronize()
            for s in self.spans:
                if s._events is not None and len(s._events) == 2:
                    s.device_start_ms = start.elapsed_time(s._events[0])
                    s.device_end_ms = start.elapsed_time(s._events[1])
        for s in self.spans:
            s._events = s._rec = None
        self.stack = []


class _Root:
    """Opens a record and its root span, and closes both."""

    def __init__(self, device, attrs):
        self.cuda = (torch.device(device).type == "cuda"
                     and torch.cuda.is_available())
        self.attrs = attrs

    def __enter__(self):
        global _open
        _open = Record(self.cuda)
        self.span = Span(_open, "cmfrec.fit", self.attrs).__enter__()

    def __exit__(self, *exc):
        global _open, _last
        rec = _open
        try:
            self.span.__exit__(*exc)
        finally:
            _open = None
        rec._close()
        _last = rec
        return False


def _root(device, attrs):
    """A record for this fit: where a profiler records and no record is
    open (a nested fit joins the outer one)."""
    if _open is not None or not torch.autograd._profiler_enabled():
        return _OFF
    return _Root("cuda" if device is None else device, attrs)


def last_record() -> Optional[Record]:
    """The newest closed record (None before any fit under a profiler)."""
    return _last


def span(name: str, **attrs):
    """A span of the open record (``with span("cmfrec.x", it=3): ...``);
    with none open, a shared do-nothing context."""
    if _open is None:
        return _OFF
    return Span(_open, name, attrs)


def engine(fn):
    """Decorator: a ``cmfrec.engine`` span around an engine's entry point,
    its name the span's ``engine``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _open is None:
            return fn(*args, **kwargs)
        with Span(_open, "cmfrec.engine", {"engine": fn.__name__}):
            return fn(*args, **kwargs)

    return wrapper


def synced(nbytes: int = 0) -> None:
    """The host waits on the device here (a fence, or a read of
    ``nbytes``): one ``host_syncs``, ``nbytes`` of ``d2h_bytes``."""
    if _open is None:
        return
    _open.counters["host_syncs"] += 1
    _open.counters["d2h_bytes"] += nbytes


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the open record's counter ``name`` (made at 0)."""
    if _open is None:
        return
    _open.counters[name] = _open.counters.get(name, 0) + n


def to_host(t):
    """``t.cpu().numpy()`` (None stays None), counted by :func:`synced`."""
    if t is None:
        return None
    out = t.cpu().numpy()
    synced(out.nbytes)
    return out


def upload(a, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(a, dtype=dtype, device=device)``; where ``a`` is
    host data (not a tensor, or a CPU tensor sent to a card) its bytes on
    the device count as ``h2d_bytes``."""
    t = torch.as_tensor(a, dtype=dtype, device=device)
    if _open is not None and (not torch.is_tensor(a)
                              or a.device.type != t.device.type):
        _open.counters["h2d_bytes"] += t.nbytes
    return t


def profiled_fit(fn):
    """Decorator of the fit drivers: :func:`maybe_trace` and a
    ``cmfrec.driver`` span around the call (a fit driver called on its own
    under a profiler opens the record)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with maybe_trace(), _root(kwargs.get("device"), {}), \
                span("cmfrec.driver", driver=fn.__name__):
            return fn(*args, **kwargs)

    return wrapper


def recorded_fit(fn):
    """Decorator of the models' public ``fit``: :func:`maybe_trace` around
    the whole fit, and its record's root span while a profiler records."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with maybe_trace(), _root(getattr(self, "device", None),
                                  {"model": type(self).__name__}):
            return fn(self, *args, **kwargs)

    return wrapper


class Timer:
    """Wall-time sections, each fenced on the device at its end: ``sync_on``
    a tensor (or a callable returning one) is read back, which waits for
    the work queued before it; a ``torch.device`` of a card is
    synchronized whole.  Each section is also a span of its name."""

    def __init__(self):
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name, sync_on=None):
        t0 = time.perf_counter()
        with span(name):
            try:
                yield
            finally:
                if sync_on is not None:
                    _fence(sync_on() if callable(sync_on) else sync_on)
                self.sections[name] = (
                    self.sections.get(name, 0.0) + time.perf_counter() - t0
                )

    def report(self):
        """The sections' seconds, longest first."""
        return dict(sorted(self.sections.items(), key=lambda kv: -kv[1]))


def _fence(on):
    if torch.is_tensor(on):
        float(on.sum())
    elif torch.device(on).type == "cuda":
        torch.cuda.synchronize(on)
