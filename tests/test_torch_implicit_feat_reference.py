"""cmfrec_torch's CMF with implicit features (the collective dense engine's
Xones half-steps) against the plain reference tests/plain_implicit_feat.py
on the CPU, at a tiny size with one user and one item without ratings (so
that every row's being live is held too); the benchmark's copy of the
reference against the repo's; and the fit's span and counters of the
Xones work under a profiler."""

import ast
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

import cmfrec_torch
from cmfrec_torch.solvers import dense_masked
from cmfrec_torch.utils import profiling

from . import plain_implicit_feat

ROOT = Path(__file__).resolve().parents[1]
BENCH_COPY = ROOT / "benchmark" / "configs" / "explicit_als_cg_implicit_feat.py"
# upstream's "ALS-CG + implicit features" protocol (the benchmark's
# configuration) at its widths but k
ARGS = dict(k=8, lambda_=0.05, scale_lam=True, niter=15, use_cg=True,
            max_cg_steps=3, finalize_chol=True, user_bias=True,
            item_bias=True, center=True, use_float=True,
            add_implicit_features=True, w_implicit=0.5)
M, N, EMPTY_USER, EMPTY_ITEM = 120, 48, 7, 11
# niter=1 is the float32 finalize iteration alone: the program's f32 CG
# (16 steps, each row frozen once r.r <= 1e-8) against the reference's
# Cholesky in float64 reads 2.2e-4 to 6.0e-4 (gap_rows) over seeds 3-10;
# 1e-3 is above that and some 1,000 times below the faults' gaps (below)
TOL_FINAL_ROWS = 1e-3
# the whole fit: the 14 CG iterations take bf16 operands (the kernels'
# CPU twins), which moves the result by 7.0e-3 to 2.4e-2 (gap_norm) over
# seeds 3-10; the planted faults read 0.75 to 1.6
TOL_FIT_NORM = 3e-2


def _data(seed):
    """Half-point ratings of a rank-4 model at ~25% density, user
    EMPTY_USER and item EMPTY_ITEM without ratings."""
    rng = np.random.default_rng(seed)
    A = 0.6 * rng.normal(size=(M, 4))
    B = 0.6 * rng.normal(size=(N, 4))
    keep = rng.random((M, N)) < 0.25
    keep[EMPTY_USER, :] = False
    keep[:, EMPTY_ITEM] = False
    r, c = np.nonzero(keep)
    full = 3.5 + A @ B.T + 0.3 * rng.normal(size=(M, N))
    v = np.clip(np.round(2 * full[r, c]) / 2, 0.5, 5.0)
    return sp.coo_matrix((v, (r, c)), shape=(M, N))


def _fit_program(X, seed, **override):
    args = dict(ARGS, **override)
    return cmfrec_torch.CMF(**args, random_state=seed, device="cpu").fit(X)


def _reference(X, seed, niter, module=plain_implicit_feat, **kw):
    start = _fit_program(X, seed, niter=0)
    args = dict(ARGS, niter=niter)
    t = (torch.as_tensor(X.row.astype(np.int64)),
         torch.as_tensor(X.col.astype(np.int64)), torch.as_tensor(X.data))
    return module.fit(*t, M, N, args, {"A": torch.as_tensor(start.A_),
                                       "B": torch.as_tensor(start.B_)}, **kw)


def _parts(model):
    return {"A": model.A_, "B": model.B_, "biasA": model.user_bias_,
            "biasB": model.item_bias_, "glob_mean": model.glob_mean_}


def _pairs(prog, ref):
    """(program, reference) of each leaf as float64 [rows, columns]."""
    for leaf, r in ref.items():
        r = torch.as_tensor(r, dtype=torch.float64)
        p = torch.as_tensor(np.asarray(prog[leaf]), dtype=torch.float64)
        rows = r.shape[0] if r.dim() else 1
        yield p.reshape(rows, -1), r.reshape(rows, -1)


def gap_norm(prog, ref):
    """The worst leaf's ||program - reference|| / ||reference||."""
    return max(float((p - r).norm() / r.norm()) for p, r in _pairs(prog, ref))


def gap_rows(prog, ref):
    """The worst leaf's largest row gap over its rms row norm."""
    return max(float((p - r).norm(dim=1).max()
                     / r.norm(dim=1).pow(2).mean().sqrt())
               for p, r in _pairs(prog, ref))


def _load_bench_copy():
    bench = str(ROOT / "benchmark")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    spec = importlib.util.spec_from_file_location(
        "bench_reference_implicit_feat", BENCH_COPY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [3, 4])
def test_final_iteration_agrees(seed):
    X = _data(seed)
    ref = _reference(X, seed, niter=1)
    prog = _parts(_fit_program(X, seed, niter=1))
    assert gap_rows(prog, ref) < TOL_FINAL_ROWS
    assert abs(prog["glob_mean"] - ref["glob_mean"]) < 1e-12
    # the rows without ratings are live: the start is drawn there, and
    # their Xones rhs is zero, so the exact iteration takes them to zero;
    # the program's f32 CG freezes them at 6e-5 to 6e-4 (seeds 3-10)
    start = _fit_program(X, seed, niter=0)
    assert np.abs(start.A_[EMPTY_USER]).max() > 0.05
    assert np.abs(start.B_[EMPTY_ITEM]).max() > 0.05
    assert float(ref["A"][EMPTY_USER].abs().max()) < 1e-12
    assert np.abs(prog["A"][EMPTY_USER]).max() < 1e-3


@pytest.mark.parametrize("seed", [5, 6])
def test_whole_fit_agrees(seed):
    X = _data(seed)
    ref = _reference(X, seed, niter=ARGS["niter"])
    prog = _parts(_fit_program(X, seed))
    assert gap_norm(prog, ref) < TOL_FIT_NORM


def _frozen_xones(real):
    """_shared_na0_solve keeping each mask's first solve: Ai and Bi frozen
    at the first iteration's."""
    first = {}

    def solve(Fk, Mask, lam_diag, op_dtype):
        key = Mask.data_ptr()
        if key not in first:
            first[key] = real(Fk, Mask, lam_diag, op_dtype)
        return first[key]
    return solve


def _weight_dropped(real):
    """The dense engine fitted with w_implicit = 1 whatever it is given."""
    def fit(*args, **kwargs):
        return real(*args, **dict(kwargs, w_implicit=1.0))
    return fit


@pytest.mark.parametrize("fault,attr,make", [
    ("ai_bi_frozen", "_shared_na0_solve", _frozen_xones),
    ("w_implicit_ignored", "fit_collective_dense_masked", _weight_dropped)])
def test_planted_fault_exceeds_the_tolerance(monkeypatch, fault, attr, make):
    X = _data(5)
    ref = _reference(X, 5, niter=ARGS["niter"])
    if attr == "fit_collective_dense_masked":
        from cmfrec_torch.solvers import collective as owner
    else:
        owner = dense_masked
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    prog = _parts(_fit_program(X, 5))
    assert gap_norm(prog, ref) > TOL_FIT_NORM, fault


def test_the_two_copies_agree():
    X = _data(8)
    ours = _reference(X, 8, niter=4)
    bench = _load_bench_copy()
    theirs = _reference(X, 8, niter=4, module=bench)
    for leaf, r in ours.items():
        t = torch.as_tensor(theirs[leaf], dtype=torch.float64)
        r = torch.as_tensor(r, dtype=torch.float64)
        assert float((t - r).abs().max()) <= 1e-12 * max(
            float(r.abs().max()), 1.0), leaf


@pytest.mark.parametrize("path", [Path(plain_implicit_feat.__file__),
                                  BENCH_COPY], ids=["repo", "benchmark"])
def test_the_reference_imports_nothing_of_the_program(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names]
                 if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for n in names:
            assert n.split(".")[0] not in ("cmfrec_torch", "cmfrec_tpu",
                                           "jax", "jaxlib"), (path, n)


@pytest.mark.parametrize("niter", [1, 3])
def test_the_record_holds_the_xones_work(niter):
    X = _data(9)
    with profile(activities=[ProfilerActivity.CPU]):
        _fit_program(X, 9, niter=niter)
    rec = profiling.last_record()
    spans = rec.named("cmfrec.engine.impfeat")
    assert [s.attrs for s in spans] == [
        {"it": i + 1, "compute": "f32" if i + 1 == niter else "bf16"}
        for i in range(niter)]
    iters = rec.named("cmfrec.engine.iter")
    assert [rec.spans[s.parent] for s in spans] == iters
    products = rec.counters["impfeat.products"]
    assert products == 4 * niter
    m_pad, n_pad, _ = dense_masked.padded_dims(M, N, ARGS["k"])
    assert rec.counters["impfeat.mask_bytes"] == products * m_pad * n_pad


def test_the_counters_are_off_without_a_profiler(monkeypatch):
    monkeypatch.setattr(profiling, "_last", None)
    _fit_program(_data(9), 9, niter=2)
    assert profiling.last_record() is None
    profiling.count("impfeat.products")
    assert profiling._open is None
