"""cmfrec_torch.utils.profiling on the CPU (the port's counterpart of
tests/test_metrics.py:47-65): CMFREC_TORCH_PROFILE=<dir> wraps every fit
in a torch.profiler trace, unset it writes nothing, nested fits join one
trace, and Timer sums its sections.  Under a profiler every fit keeps a
record (profiling.last_record): its spans nested by parent id, its
counters of uploads, host syncs and launches; with none recording, no
record, range or event is made."""

import json
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

import cmfrec_torch
import cmfrec_torch.utils as utils
from cmfrec_torch.solvers import collective, drivers, lbfgs, offsets
from cmfrec_torch.solvers.dense_masked import padded_dims
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


# ----------------------------------------------------------------------- #
# the fit's record                                                         #
# ----------------------------------------------------------------------- #


def _profiled(fn):
    """``fn()`` under a CPU torch.profiler; returns (its result, the
    profiler, the newest record)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, profiling.last_record()


def _coo(m=30, n=12, nnz=150, seed=0):
    rng = np.random.default_rng(seed)
    return sp.coo_matrix((np.round(2 * (3.0 + rng.normal(size=nnz))) / 2,
                          (rng.integers(0, m, nnz), rng.integers(0, n, nnz))),
                         shape=(m, n))


def test_spans_nest_with_parent_ids():
    def nest():
        with profiling._root("cpu", {"test": 1}):
            with profiling.span("cmfrec.a") as a:
                with profiling.span("cmfrec.b", it=1):
                    time.sleep(0.002)
            with profiling.span("cmfrec.c"):
                pass
        return a

    a, _, rec = _profiled(nest)
    assert [(s.name, s.id, s.parent) for s in rec.spans] == [
        ("cmfrec.fit", 0, None), ("cmfrec.a", 1, 0), ("cmfrec.b", 2, 1),
        ("cmfrec.c", 3, 0)]
    root, a_, b, c = rec.spans
    assert a_ is a and b.attrs == {"it": 1} and root.attrs == {"test": 1}
    assert rec.children(root) == [a_, c] and rec.children(a_) == [b]
    assert 0 <= root.host_start_ns <= a_.host_start_ns <= b.host_start_ns
    assert b.host_end_ns <= a_.host_end_ns <= c.host_start_ns \
        <= c.host_end_ns <= root.host_end_ns
    assert b.host_s >= 0.002 and b.seconds == b.host_s
    # off the card: no device times
    assert all(s.device_s is None for s in rec.spans)
    assert profiling._open is None


def test_nothing_is_recorded_outside_a_profiler(monkeypatch):
    made = []

    class Spy:
        def __init__(self, *a, **kw):
            made.append(a)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    monkeypatch.setattr(torch.cuda, "Event", Spy)
    monkeypatch.setattr(profiling, "_last", None)
    model = cmfrec_torch.CMF(k=3, niter=3, device="cpu").fit(_coo())
    assert model.A_.shape == (30, 3)
    assert not made and profiling.last_record() is None
    assert profiling._open is None
    # a span and a counter are the shared do-nothing context and no-ops
    assert profiling.span("cmfrec.x", it=1) is profiling._OFF
    profiling.synced(8)
    assert profiling.upload(np.zeros(3), "cpu").shape == (3,)
    assert profiling.last_record() is None


def test_a_dense_masked_fit_records_every_layer():
    X = _coo()
    k, niter = 3, 4
    model = cmfrec_torch.CMF(k=k, niter=niter, device="cpu")
    _, prof, rec = _profiled(lambda: model.fit(X))
    names = [(s.name, rec.spans[s.parent].name if s.parent is not None
              else None) for s in rec.spans]
    assert names == [
        ("cmfrec.fit", None), ("cmfrec.ingest", "cmfrec.fit"),
        ("cmfrec.driver", "cmfrec.fit"), ("cmfrec.engine", "cmfrec.driver"),
        ("cmfrec.engine.setup", "cmfrec.engine"),
        ("cmfrec.engine.bias_init", "cmfrec.engine")] + [
        ("cmfrec.engine.iter", "cmfrec.engine")] * niter + [
        ("cmfrec.finish", "cmfrec.fit")]
    assert rec.root.attrs == {"model": "CMF"}
    assert rec.named("cmfrec.driver")[0].attrs == {
        "driver": "fit_explicit_als"}
    assert rec.named("cmfrec.engine")[0].attrs == {
        "engine": "fit_explicit_dense_masked"}
    iters = rec.named("cmfrec.engine.iter")
    assert [s.attrs for s in iters] == [
        {"it": i + 1, "compute": "bf16"} for i in range(niter - 1)] + [
        {"it": niter, "compute": "f32"}]
    # the root's children cover it but for a few lines of CMF.fit
    kids = sum(s.host_s for s in rec.children(rec.root))
    assert kids <= rec.root.host_s
    # int64 rows and columns and f32 values of every triplet, and the two
    # f32 lambda rows of Kp coordinates
    Kp = padded_dims(30, 12, k)[2]
    assert rec.counters["h2d_bytes"] == X.nnz * (8 + 8 + 4) + 2 * Kp * 4
    # A, B and the biases copied to the host, one sync each
    assert rec.counters["host_syncs"] == 4
    assert rec.counters["d2h_bytes"] == 4 * (30 * k + 12 * k + 30 + 12)
    assert {rec.counters[f"launches.{x}"] for x in profiling.LAUNCHES} == {0}
    # the profiler's events hold the program's ranges
    ranged = {e.name for e in prof.events() if e.name.startswith("cmfrec.")}
    assert ranged == {s.name for s in rec.spans}


def test_a_bucketed_fit_records_its_layout_and_iterations():
    rows, cols, vals, m, n = _data()

    def fit():
        return drivers.fit_explicit_als(rows, cols, vals, m, n, k=3,
                                        niter=3, engine="sparse",
                                        device="cpu")

    _, _, rec = _profiled(fit)
    # a driver called on its own opens the record
    assert [s.name for s in rec.spans[:3]] == [
        "cmfrec.fit", "cmfrec.driver", "cmfrec.engine"]
    engine = rec.named("cmfrec.engine")[0]
    assert engine.attrs == {"engine": "_fit_explicit_bucketed"}
    (layout,) = rec.named("cmfrec.engine.layout")
    assert layout.parent == engine.id
    iters = rec.named("cmfrec.engine.iter")
    assert [(s.attrs["it"], s.attrs["method"], s.parent) for s in iters] \
        == [(1, "cg", engine.id), (2, "cg", engine.id),
            (3, "chol", engine.id)]
    # no bf16 rows off the card
    assert {s.attrs["compute"] for s in iters} == {"f32"}
    # the layout's entries and plans, the perms and lambda vectors
    assert rec.counters["h2d_bytes"] >= len(rows) * (8 + 8 + 4)
    # the layout's plan reads each side's counts back
    assert rec.counters["host_syncs"] == 2


def test_nested_fits_join_one_record():
    rng = np.random.default_rng(1)
    X = _coo()
    model = cmfrec_torch.OMF_explicit(k=3, method="als", niter=2,
                                      device="cpu")
    _, _, rec = _profiled(lambda: model.fit(X, U=rng.normal(size=(30, 3))))
    drv = rec.named("cmfrec.driver")
    assert [d.attrs["driver"] for d in drv] == ["fit_offsets_als",
                                                "fit_explicit_als"]
    assert drv[1].parent == drv[0].id and drv[0].parent == 0
    assert len(rec.named("cmfrec.fit")) == 1
    assert rec.named("cmfrec.finish")[0].parent == 0


def test_lbfgs_host_syncs_count_through_the_record():
    """The L-BFGS core's reads are the record's host syncs: the fit's
    fit_stats_ and the record agree but for the parameters' copies."""
    model = cmfrec_torch.CMF(k=3, method="lbfgs", maxiter=4, device="cpu")
    _, _, rec = _profiled(lambda: model.fit(_coo()))
    params = ("A", "B", "biasA", "biasB")
    assert rec.counters["host_syncs"] == \
        model.fit_stats_["host_syncs"] + len(params)
    assert rec.named("cmfrec.engine")[0].attrs == {"engine": "run_lbfgs"}


def test_profile_env_records_the_model_fit(tmp_path, monkeypatch):
    """CMFREC_TORCH_PROFILE traces the whole model fit, which its record
    covers."""
    monkeypatch.setenv("CMFREC_TORCH_PROFILE", str(tmp_path))
    monkeypatch.setattr(profiling, "_last", None)
    cmfrec_torch.CMF(k=3, niter=2, device="cpu").fit(_coo())
    (path,) = _traces(tmp_path)
    rec = profiling.last_record()
    assert rec.root.attrs == {"model": "CMF"}
    assert {s.name for s in rec.spans} <= _names(path)
    assert "cmfrec.ingest" in _names(path)


def test_upload_counts_host_data_only():
    def ups():
        with profiling._root("cpu", {}):
            t = profiling.upload(np.zeros(5, np.float32), "cpu")
            profiling.upload(t, "cpu")  # already there: no upload
            profiling.upload([1, 2], "cpu", torch.float64)
            assert profiling.to_host(t).shape == (5,)
            assert profiling.to_host(None) is None

    _, _, rec = _profiled(ups)
    assert rec.counters["h2d_bytes"] == 5 * 4 + 2 * 8
    assert rec.counters["host_syncs"] == 1
    assert rec.counters["d2h_bytes"] == 20


def test_timer_sections_are_spans():
    timer = profiling.Timer()

    def timed():
        with profiling._root("cpu", {}):
            with timer.section("load"):
                time.sleep(0.002)
            with timer.section("solve", sync_on=torch.ones(2)):
                pass

    _, prof, rec = _profiled(timed)
    assert [(s.name, s.parent) for s in rec.spans[1:]] == [("load", 0),
                                                           ("solve", 0)]
    assert rec.named("load")[0].host_s >= 0.002
    assert list(timer.sections) == ["load", "solve"]
    assert {"load", "solve"} <= {e.name for e in prof.events()}


@pytest.mark.parametrize("name", cmfrec_torch.__all__)
def test_every_model_fit_opens_the_record(name):
    """Each public model class's fit is wrapped by recorded_fit."""
    fit = getattr(cmfrec_torch, name).fit
    assert fit.__wrapped__.__name__ == "fit"
    assert fit.__code__ is profiling.recorded_fit(len).__code__
