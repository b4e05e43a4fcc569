"""Faults planted in the program to show that ``correct`` catches them:
each a context manager that breaks the timed path underneath for the
length of a ``with``.  Used by the benchmark's tests (at a tiny size on
the CPU) and by control.py (at a cell's own size on the card), never by
a benchmark run.  A cell on one card has no exchange between cards to
leave out."""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def _patched(owner, attr: str, make):
    real = getattr(owner, attr)
    setattr(owner, attr, make(real))
    try:
        yield
    finally:
        setattr(owner, attr, real)


def step_unchanged():
    """Every ALS iteration returns its state as it found it."""
    from cmfrec_torch.solvers import dense_masked

    return _patched(dense_masked, "_iteration",
                    lambda real: lambda A, B, *a, **k: (A, B))


def half_batch():
    """The fit sees every second entry: half the batch left out, the
    mean taken over the rest."""
    from cmfrec_torch.models import base

    def make(real):
        def halved(self, X, W=None):
            rows, cols, vals, wgt, m, n = real(self, X, W)
            return rows[::2], cols[::2], vals[::2], wgt, m, n
        return halved

    return _patched(base._BaseModel, "_ingest_X", make)


def answer_altered():
    """The fit's user factors come back with one row in 64 replaced by
    draws at the factors' own scale."""
    from cmfrec_torch.solvers import drivers

    def make(real):
        def fit(*args, **kwargs):
            res = real(*args, **kwargs)
            A = res["A"]
            bad = torch.arange(0, A.shape[0], 64, device=A.device)
            gen = torch.Generator(device=A.device).manual_seed(1)
            A[bad] = A.std() * torch.randn(len(bad), A.shape[1],
                                           generator=gen, device=A.device,
                                           dtype=A.dtype)
            return res
        return fit

    return _patched(drivers, "fit_explicit_als", make)


def start_scaled():
    """The random start drawn with standard deviation 1, not 1/sqrt(k):
    both sides start from it, so only the start's own check sees it."""
    from cmfrec_torch.solvers import dense_masked

    def make(real):
        def init(gen, live, bias0, s, Kp, coord, seed_bias):
            M = real(gen, live, bias0, s, Kp, coord, seed_bias)
            M[:, :coord] *= math.sqrt(max(coord, 1))
            return M
        return init

    return _patched(dense_masked, "_init_factors", make)


FAULTS = {"step_unchanged": step_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered, "start_scaled": start_scaled}
