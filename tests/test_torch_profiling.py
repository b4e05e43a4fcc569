"""cmfrec_torch.utils.profiling on the CPU (the port's counterpart of
tests/test_metrics.py:47-65): CMFREC_TORCH_PROFILE=<dir> wraps every fit
driver in a torch.profiler trace, unset it writes nothing, nested fits join
one trace, and Timer sums its sections."""

import json
import time

import numpy as np
import pytest
import torch

import cmfrec_torch.utils as utils
from cmfrec_torch.solvers import collective, drivers, lbfgs, offsets
from cmfrec_torch.utils import profiling


def _data(m=20, n=10, nnz=60):
    rng = np.random.default_rng(0)
    return (rng.integers(0, m, nnz), rng.integers(0, n, nnz),
            3.0 + rng.normal(size=nnz), m, n)


def _traces(logdir):
    return sorted(logdir.rglob("*.pt.trace.json"))


def _names(path):
    """The names of a trace's events."""
    return {e.get("name") for e in json.loads(path.read_text())
            ["traceEvents"]}


def test_profile_env_emits_trace(tmp_path, monkeypatch):
    rows, cols, vals, m, n = _data()
    logdir = tmp_path / "prof"
    monkeypatch.setenv("CMFREC_TORCH_PROFILE", str(logdir))
    drivers.fit_explicit_als(rows, cols, vals, m, n, k=3, niter=1,
                             use_cg=False, dtype=np.float64, device="cpu")
    files = _traces(logdir)
    assert len(files) == 1, "no trace emitted"
    # the host's operators of the fit are in it
    assert any(name and name.startswith("aten::")
               for name in _names(files[0]))


def test_no_trace_without_the_variable(tmp_path, monkeypatch):
    rows, cols, vals, m, n = _data()
    monkeypatch.delenv("CMFREC_TORCH_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    traced = []
    monkeypatch.setattr(profiling, "trace", traced.append)
    drivers.fit_explicit_als(rows, cols, vals, m, n, k=3, niter=1,
                             use_cg=False, device="cpu")
    assert not traced and not list(tmp_path.rglob("*"))


def test_nested_fits_join_one_trace(tmp_path, monkeypatch):
    """The offsets model's ALS fit calls fit_explicit_als inside its own
    trace: one file, holding both."""
    rows, cols, vals, m, n = _data()
    U = np.random.default_rng(1).normal(size=(m, 3))
    logdir = tmp_path / "prof"
    monkeypatch.setenv("CMFREC_TORCH_PROFILE", str(logdir))
    inner = []
    real = offsets.fit_explicit_als  # itself profiled
    monkeypatch.setattr(offsets, "fit_explicit_als", lambda *a, **kw:
                        inner.append(profiling._tracing) or real(*a, **kw))
    offsets.fit_offsets_als(rows, cols, vals, m, n, k=3, niter=1,
                            side_U=(None, None, None, m, 3, True, U),
                            device="cpu")
    # the inner fit ran inside the outer trace, which it joined
    assert inner == [True]
    assert len(_traces(logdir)) == 1
    assert not profiling._tracing


@pytest.mark.parametrize("fn", [
    drivers.fit_explicit_als, drivers.fit_implicit_als,
    collective.fit_collective_explicit_als,
    collective.fit_collective_implicit_als,
    lbfgs.fit_collective_explicit_lbfgs, offsets.fit_offsets_explicit_lbfgs,
    offsets.fit_offsets_als], ids=lambda fn: fn.__name__)
def test_every_fit_driver_is_profiled(fn):
    """The fit drivers cmfrec_tpu decorates with profiled_fit
    (cmfrec_tpu/solvers/drivers.py:156, :646; collective.py:309, :1027;
    lbfgs.py:127; offsets.py:77, :259)."""
    assert fn.__wrapped__.__name__ == fn.__name__
    assert fn.__code__ is profiling.profiled_fit(len).__code__


def test_trace_and_exports(tmp_path):
    assert utils.__all__ == ["metrics", "profiling"]
    assert utils.profiling is profiling
    with profiling.trace(str(tmp_path)):
        torch.ones(4).sum()
    assert len(_traces(tmp_path)) == 1


def test_timer_sums_sections():
    timer = profiling.Timer()
    for _ in range(2):
        with timer.section("a", sync_on=torch.ones(3)):
            time.sleep(0.01)
    with timer.section("b", sync_on=lambda: torch.zeros(2)):
        pass
    with timer.section("c", sync_on=torch.device("cpu")):
        time.sleep(0.1)
    rep = timer.report()
    assert list(rep) == ["c", "a", "b"]
    assert rep["a"] >= 0.02 and rep["c"] >= 0.1 and rep["b"] >= 0.0
    assert rep == timer.sections
