"""The benchmark of cmfrec_torch's fits, driven by BENCHMARK.json.

A cell names a configuration (its file of model arguments, with its plain
reference beside it: ``configs/<config>.json`` and ``.py``) and a traffic
mix (``traffic/<mix>.json``, read by data/generate.py).  Each metric is a
reader of its own, ``metrics/<metric>.py``: ``read(run)`` returns its
value, or None where it finds nothing to read, and may name the program's
functions it needs timed (``SPANS``) or whose calls it needs recorded
(``CALLS``), as "module:attribute.path".  A cell's limits are
``limits/<cell>.json``.  So a cell, a configuration, a mix or a metric is
added by adding files and entries, with no file here edited.

One run: set-up (the data drawn on the device from the seed and copied to
the host once, two warm-up fits), then fits back to back for ``seconds``,
each a new model ``Model(**args).fit(X)`` on the scipy COO matrix X and
ending in ``torch.cuda.synchronize()``.  With ``trace`` the run then
times one fit with the spans and profiles one more.  Last, one fit of the
window drawn from the seed is held against the plain reference, and the
random start that both share against the program's documented draw.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import check  # noqa: E402
import devtrace  # noqa: E402
from data.generate import generate  # noqa: E402

FIT_RANGE = "benchmark.fit"
# warm-up fits in set-up: the first builds or loads the kernels; after
# one alone a window's first fit read up to 30% above the rest
WARM_FITS = 2
# the names that may not be loaded in a run's process (compared whole)
BANNED = ("jax", "jaxlib", "flax", "cmfrec_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its configuration, mix, limits
    and the readers of the metrics it reports."""

    def __init__(self, name: str, root: Path = ROOT):
        manifest = load_json(root / "BENCHMARK.json")
        self.manifest = manifest
        self.work = _named(manifest["workloads"], name)
        cfg = _named(manifest["configs"], self.work["config"])
        self.config_path = root / cfg["file"]
        self.config = load_json(self.config_path)
        bench = root / manifest["paths"][0]
        self.traffic = load_json(bench / "traffic"
                                 / f"{self.work['traffic']}.json")
        self.limits = load_json(bench / "limits" / f"{name}.json")
        self.reference = _module(self.config_path.with_suffix(".py"),
                                 f"reference_{self.work['config']}")
        self.name = name
        self.bench = bench

    def metrics(self, traced: bool) -> dict:
        """{name: (entry, reader module)} of the metrics this cell reports
        with ``traced`` (per-layer) or without (end-to-end)."""
        key = "per_layer" if traced else "end_to_end"
        reported = {e["name"] for e in self.manifest["end_to_end"]
                    if self.name in e.get("workloads", [self.name])}
        out = {}
        for e in self.manifest[key]:
            if "workloads" in e:
                if self.name not in e["workloads"]:
                    continue
            elif traced and e["moves"] not in reported:
                continue
            out[e["name"]] = (e, _module(self.bench / "metrics"
                                         / f"{e['name']}.py",
                                         f"metric_{e['name']}"))
        return out

    def model_class(self):
        import cmfrec_torch

        return getattr(cmfrec_torch, self.config["model"])

    def model_args(self, seed: int) -> dict:
        return dict(self.config["args"], random_state=int(seed) % 2 ** 31)


def _named(entries, name):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no entry named {name!r}")


class Run:
    """What a run measured, for the metrics' readers."""

    def __init__(self, cell: Cell, device: str):
        self.cell = cell
        self.device = torch.device(device)
        self.args = cell.config["args"]
        self.setup_s = None
        self.setup_parts = {}  # seconds of set-up's steps, for stderr
        self.fits = []  # (start, end) host seconds of the window's fits
        self.failed = 0
        self.peak_bytes = 0
        self.run_peak_bytes = 0
        self.spans = {}
        self.calls = {}
        self.launches = {}
        self.trace = None
        self.stats = {}

    @property
    def fit_s(self) -> Optional[float]:
        if not self.fits:
            return None
        return (self.fits[-1][1] - self.fits[0][0]) / len(self.fits)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def draw(cell: Cell, seed: int, device) -> tuple:
    """The cell's matrix for ``seed``: drawn on ``device``, then held on
    the host as the scipy COO matrix the fits take, with its training
    entries as CPU tensors for the reference."""
    import scipy.sparse as sp

    mat = generate(cell.traffic, seed, device)
    row, col, val = (t.cpu() for t in mat.train)
    del mat
    X = sp.coo_matrix((val.numpy(), (row.numpy(), col.numpy())),
                      shape=(cell.traffic["m"], cell.traffic["n"]))
    return X, (row, col, val)


def data_stats(train, m, n) -> dict:
    row, col, _ = train
    return {"nnz": int(row.numel()), "m": m, "n": n,
            "live_m": int((torch.bincount(row, minlength=m) > 0).sum()),
            "live_n": int((torch.bincount(col, minlength=n) > 0).sum())}


def fit_program(cell: Cell, X, seed: int, device, **override):
    """One fit of the program: a new model on X, synchronized."""
    model = cell.model_class()(**dict(cell.model_args(seed), **override),
                               device=str(device))
    model.fit(X)
    sync(device)
    return model


def window(run: Run, X, seed: int, seconds: float, fit=fit_program):
    """Fits back to back until ``seconds`` have passed; the fit in flight
    finishes and counts.  Returns the parts of one fit drawn from the
    seed (reservoir sampling over the fits as they come)."""
    pick = random.Random(seed)
    kept = None
    dev = run.device
    t_end = None
    while True:
        t0 = time.perf_counter()
        if t_end is None:
            t_end = t0 + seconds
        elif t0 >= t_end:
            break
        try:
            model = fit(run.cell, X, seed, dev)
        except Exception as exc:  # a fit that raises counts as failed
            sync(dev)
            run.failed += 1
            run.fits.append((t0, time.perf_counter()))
            print(f"fit failed: {exc!r}", file=sys.stderr)
            continue
        run.fits.append((t0, time.perf_counter()))
        if pick.random() * len(run.fits) < 1.0:
            kept = check.model_parts(model)
        del model
    return kept


def _resolve(spec: str):
    """(owner, attribute, function) of "module:Attr.path"."""
    mod_name, _, path = spec.partition(":")
    owner = importlib.import_module(mod_name)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr, getattr(owner, attr)


class Patched:
    """Wrap the named functions for the length of a ``with``: each
    ``make(name, fn)`` returns the wrapper.  The wrapper shares the
    function's attribute dict, so an op that counts its launches on its
    module-level name keeps counting."""

    def __init__(self, specs: dict, make: Callable):
        self.specs, self.make, self.saved = specs, make, []

    def __enter__(self):
        for name, spec in self.specs.items():
            owner, attr, fn = _resolve(spec)
            wrapped = self.make(name, fn)
            wrapped.__dict__ = fn.__dict__
            setattr(owner, attr, wrapped)
            self.saved.append((owner, attr, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)
        self.saved = []


def _describe(a):
    if torch.is_tensor(a):
        return {"shape": tuple(a.shape), "dtype": str(a.dtype),
                "itemsize": a.element_size()}
    return None


def spans_fit(run: Run, X, seed: int, specs: dict):
    """One fit with each span's seconds summed, synchronized at its end."""
    dev = run.device

    def make(name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(dev)
            run.spans[name] = run.spans.get(name, 0.0) + (
                time.perf_counter() - t0)
            return out
        return timed

    with Patched(specs, make):
        fit_program(run.cell, X, seed, dev)


def profiled_fit(run: Run, X, seed: int, spans: dict, calls: dict):
    """One fit under torch.profiler, its calls of ``calls`` recorded (the
    tensors' shapes and types) and the spans marked as host ranges."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def ranged(name, fn):
        def inner(*args, **kwargs):
            with record_function(f"span.{name}"):
                return fn(*args, **kwargs)
        return inner

    def recorded(name, fn):
        def inner(*args, **kwargs):
            run.calls.setdefault(name, []).append(
                [_describe(a) for a in args])
            return fn(*args, **kwargs)
        return inner

    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    ops = _launch_ops()
    for op in ops.values():
        op.launches = 0
    with Patched(spans, ranged), Patched(calls, recorded):
        sync(run.device)
        with profile(activities=acts) as prof:
            with record_function(FIT_RANGE):
                fit_program(run.cell, X, seed, run.device)
    run.launches = {k: op.launches for k, op in ops.items()}
    run.trace = devtrace.from_profile(prof, FIT_RANGE,
                                   [f"span.{name}" for name in spans])


def _launch_ops() -> dict:
    """The port's ops that count their launches, by kernel."""
    from cmfrec_torch.ops import coord_descent, masked_matmul, sparse_cg

    return {"k1": masked_matmul.masked_gram_matvec,
            "k2": masked_matmul.masked_rhs, "k3": sparse_cg.bucket_cg,
            "cd": coord_descent.solve_cd}


def reference_start(cell: Cell, X, seed: int, device) -> dict:
    """The program's random start: the factors of the same model fitted
    with ``niter=0`` (their draws follow the program's own layout), which
    check.start_numbers holds against the documented draw."""
    model = fit_program(cell, X, seed, device, niter=0)
    start = {"A": torch.as_tensor(model.A_).float(),
             "B": torch.as_tensor(model.B_).float()}
    del model
    return start


def live_rows(cell: Cell, train) -> dict:
    """{"A", "B"}: the users' and items' has-training-entries masks."""
    row, col, _ = train
    return {"A": torch.bincount(row, minlength=cell.traffic["m"]) > 0,
            "B": torch.bincount(col, minlength=cell.traffic["n"]) > 0}


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def reference_fit(cell: Cell, train, start: dict, device, prec=None):
    """The plain reference's model on ``device`` (float64 by default)."""
    import plain

    row, col, val = (t.to(device) for t in train)
    out = cell.reference.fit(row, col, val, cell.traffic["m"],
                             cell.traffic["n"], cell.config["args"], start,
                             plain.PLAIN if prec is None else prec)
    return {k: (torch.as_tensor(v).double().cpu()
                if torch.is_tensor(v) else torch.tensor(float(v),
                                                        dtype=torch.float64))
            for k, v in out.items()}


def banned_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".")[0] in BANNED)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             fit=fit_program) -> dict:
    """One run of ``cell``; returns the result's fields (with the
    numbers compared under "checks", last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell, device)
    dev = run.device
    metrics = cell.metrics(traced)
    t0 = time.perf_counter()
    run.setup_parts["imports"] = t0 - t_start
    X, train = draw(cell, seed, dev)
    run.stats = data_stats(train, cell.traffic["m"], cell.traffic["n"])
    free(dev)
    run.setup_parts["draw"] = time.perf_counter() - t0
    for i in range(WARM_FITS):  # builds or loads the kernels, and more
        t0 = time.perf_counter()
        fit(cell, X, seed, dev)
        run.setup_parts[f"warm_fit_{i + 1}"] = time.perf_counter() - t0
    gc.collect()  # the allocator keeps its blocks for the window's fits
    if dev.type == "cuda":
        run.run_peak_bytes = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup_s = time.perf_counter() - t_start
    kept = window(run, X, seed, seconds, fit)
    if dev.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(dev)
        run.run_peak_bytes = max(run.run_peak_bytes, run.peak_bytes)
    if traced:
        spans = {n: s for _, mod in metrics.values()
                 for n, s in getattr(mod, "SPANS", {}).items()}
        calls = {n: s for _, mod in metrics.values()
                 for n, s in getattr(mod, "CALLS", {}).items()}
        spans_fit(run, X, seed, spans)
        free(dev)
        profiled_fit(run, X, seed, spans, calls)
        free(dev)
    values = {}
    for name, (entry, mod) in metrics.items():
        v = mod.read(run)
        if v is not None:
            values[name] = {"value": float(v), "unit": entry["unit"]}
    correct, checks = judge_window(cell, X, train, seed, kept, dev)
    return {"run": run, "correct": correct and run.failed == 0,
            "metrics": values, "checks": checks}


def readings(cell: Cell, X, train, seed: int, kept, device) -> dict:
    """Every number of check.py: the program's start against its
    documented draw, and the kept fit against the plain reference from
    that start."""
    start = reference_start(cell, X, seed, device)
    free(device)
    values = check.start_numbers(start, live_rows(cell, train),
                                 cell.config["args"]["k"])
    ref = reference_fit(cell, train, start, device)
    free(device)
    values.update(check.fit_numbers(kept, ref))
    return values


def judge_window(cell: Cell, X, train, seed: int, kept, device):
    """(correct, checks) of the kept fit, by the cell's limits."""
    if kept is None:
        return False, {}
    return check.judge(readings(cell, X, train, seed, kept, device),
                       cell.limits)


def result_line(out: dict, traced: bool, device: str = "cuda") -> dict:
    run = out["run"]
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(run.run_peak_bytes)}
    line = {"correct": bool(out["correct"]), "attempted": len(run.fits),
            "failed": run.failed, "metrics": out["metrics"], "device": info}
    if traced and run.trace is not None:
        info["busy_s"] = run.trace.busy_s()
        info["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = out["checks"]
    return line


