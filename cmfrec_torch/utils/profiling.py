"""Profiling and timing utilities (port of cmfrec_tpu/utils/profiling.py).

``torch.profiler`` takes the place of ``jax.profiler``: a trace of the host
and, on a card, of every kernel it runs (the port's own kernels among
them, by their CUDA names), written where Perfetto or TensorBoard reads
it.  The fit drivers print per-iteration times with ``verbose=True``."""

from __future__ import annotations

import contextlib
import functools
import os
import time

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


def profiled_fit(fn):
    """Decorator applying :func:`maybe_trace` around a fit driver."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with maybe_trace():
            return fn(*args, **kwargs)

    return wrapper


class Timer:
    """Wall-time sections, each fenced on the device at its end: ``sync_on``
    a tensor (or a callable returning one) is read back, which waits for
    the work queued before it; a ``torch.device`` of a card is
    synchronized whole."""

    def __init__(self):
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name, sync_on=None):
        t0 = time.perf_counter()
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
