"""The metrics that read the program's own record of the profiled fit:
a tiny traced run on the CPU reports each of them but the two that need
the card's events, and their entries in BENCHMARK.json keep the
manifest's contract."""

import json

import pytest

import harness
from bench_support import ROOT, tiny

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
RECORDED = ("dense_setup_s", "bias_init_s", "driver_self_s", "finish_s",
            "host_syncs", "h2d_gib", "idle_unspanned_ms")
CARD_ONLY = ("bulk_iter_ms", "polish_s")
CELL = "explicit_als_cg.ml10m"


@pytest.fixture(scope="module")
def traced():
    cell = tiny(harness.Cell(CELL))
    out = harness.run_cell(cell, 2 ** 31 + 7, 0.3, True, device="cpu")
    return cell, out


def test_a_traced_run_reports_the_recorded_metrics(traced):
    cell, out = traced
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    for name in RECORDED:
        assert name in metrics, name
        assert metrics[name]["value"] >= 0.0
    for name in CARD_ONLY:
        assert name not in metrics  # no device events off the card
    # every COO entry uploaded once: int64 row and column, f32 value
    nnz = out["run"].stats["nnz"]
    assert metrics["h2d_gib"]["value"] * 2 ** 30 >= 20 * nnz
    # A, B and the two biases copied to the host
    assert metrics["host_syncs"]["value"] == 4


def test_the_record_is_the_profiled_fits(traced):
    from cmfrec_torch.utils import profiling

    cell, _ = traced
    rec = profiling.last_record()
    iters = rec.named("cmfrec.engine.iter")
    niter = cell.config["args"]["niter"]
    assert [s.attrs["compute"] for s in iters] == ["bf16"] * (niter - 1) \
        + ["f32"]
    kids = rec.children(rec.root)
    assert [s.name for s in kids] == ["cmfrec.ingest", "cmfrec.driver",
                                      "cmfrec.finish"]


@pytest.mark.parametrize("name", RECORDED + CARD_ONLY)
def test_entries(name):
    (entry,) = [e for e in MANIFEST["per_layer"] if e["name"] == name]
    assert entry["moves"] == "fit_s" and entry["better"] == "lower"
    assert entry["workloads"] == [CELL]
    assert entry["source"] in ("program_span", "program_counter",
                               "device_trace")
    assert (ROOT / "benchmark" / "metrics" / f"{name}.py").is_file()
    # the new entries come after the accepted ones
    names = [e["name"] for e in MANIFEST["per_layer"]]
    assert names.index(name) > names.index("fit_mfu")
