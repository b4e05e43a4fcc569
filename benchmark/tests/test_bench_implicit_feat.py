"""The cell ``explicit_als_cg_implicit_feat.ml10m``: it loads from
BENCHMARK.json by its files alone and runs ``correct`` at a tiny size on
the CPU; impfeat_roofline's count of the Xones work against a size worked
out by hand; and the three readers of the Xones work give None where the
run has no record to read."""

import json

import pytest

import harness
from bench_support import BENCH, ROOT, tiny

CELL = "explicit_als_cg_implicit_feat.ml10m"
METRICS = ("impfeat_s", "impfeat_roofline", "impfeat_mask_gib")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def _reader(name):
    return harness._module(BENCH / "metrics" / f"{name}.py",
                           f"metric_{name}")


@pytest.fixture(scope="module")
def traced():
    cell = tiny(harness.Cell(CELL))
    return cell, harness.run_cell(cell, 2 ** 33 + 5, 0.3, True,
                                  device="cpu")


def test_the_cell_loads_by_its_files():
    cell = harness.Cell(CELL)
    assert cell.config["args"]["add_implicit_features"] is True
    assert cell.config["args"]["w_implicit"] == 0.5
    assert cell.work["traffic"] == "ml10m" and cell.work["chips"] == 1
    # its configuration is the explicit one plus the implicit features
    explicit = harness.Cell("explicit_als_cg.ml10m").config["args"]
    assert {k: v for k, v in cell.config["args"].items()
            if k not in ("add_implicit_features", "w_implicit")} == explicit
    assert set(cell.metrics(traced=True)) == set(METRICS)
    # no start_dead: every real row's start is drawn (dense_masked.py,
    # live_all_A/B), which harness.live_rows would read as dead rows
    assert "start_dead" not in cell.limits


def test_a_tiny_traced_run_is_correct(traced):
    cell, out = traced
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    # off the card no device seconds: only the counter's metric
    assert "impfeat_s" not in metrics and "impfeat_roofline" not in metrics
    from cmfrec_torch.solvers.dense_masked import padded_dims

    m_pad, n_pad, _ = padded_dims(cell.traffic["m"], cell.traffic["n"],
                                  cell.config["args"]["k"])
    products = 4 * cell.config["args"]["niter"]
    assert metrics["impfeat_mask_gib"]["value"] * 2 ** 30 == \
        products * m_pad * n_pad


def test_roofline_count_by_hand():
    roof = _reader("impfeat_roofline")
    config = {"args": {"k": 1, "niter": 2, "finalize_chol": True},
              "operands": {"bulk": "bf16", "final": "f32"}}
    stats = {"nnz": 10, "m": 2, "n": 3}
    # every piece is bound by its bytes here.  A product over R rows
    # against F [S, 1]: 4 x 10 B of positions, 4 (R + 1) of offsets, F at
    # its operand size, out [R, 1] in f32.  Iteration 1 (bf16 F): (R, S)
    # = (2, 3) 40 + 12 + 6 + 8 = 66 B twice, (3, 2) 40 + 16 + 4 + 12 = 72
    # twice; iteration 2 (f32 F): 72 twice and 76 twice.  Each iteration's
    # Grams (F read, [1, 1] written) 4 (2 + 1) + 4 (3 + 1) = 28 B and
    # solves (rhs read, solution written, the Gram) 4 (2 x 3 + 1) +
    # 4 (2 x 2 + 1) = 48 B
    nbytes = (2 * 66 + 2 * 72 + 28 + 48) + (2 * 72 + 2 * 76 + 28 + 48)
    assert roof.least_seconds(stats, config) == pytest.approx(
        nbytes / 3.35e12)


def test_roofline_at_the_cells_size():
    # ~60 products of 15-20 us and the Grams' and solves' ~1 us each
    roof = _reader("impfeat_roofline")
    cell = harness.Cell(CELL)
    t = cell.traffic
    nnz = t["nnz"] - round(t["nnz"] * t["heldout_share"])
    least = roof.least_seconds({"nnz": nnz, "m": t["m"], "n": t["n"]},
                               cell.config)
    assert 0.9e-3 < least < 1.4e-3


class _Run:
    """A run with no profiled fit, or one whose record lacks the span."""

    def __init__(self, trace, cell):
        self.trace, self.cell = trace, cell
        self.stats = {"nnz": 10, "m": 2, "n": 3}


@pytest.mark.parametrize("name", METRICS)
def test_readers_give_none_without_a_record(name, monkeypatch):
    reader = _reader(name)
    cell = harness.Cell(CELL)
    assert reader.read(_Run(None, cell)) is None
    # a record of a program without the span and counter (the parent's)
    from cmfrec_torch.utils import profiling

    class Bare:
        counters = {"h2d_bytes": 0}

        def named(self, _):
            return []

    monkeypatch.setattr(profiling, "last_record", lambda: Bare())
    assert reader.read(_Run(object(), cell)) is None


@pytest.mark.parametrize("name", METRICS)
def test_entries(name):
    (entry,) = [e for e in MANIFEST["per_layer"] if e["name"] == name]
    assert entry["moves"] == "fit_s" and entry["workloads"] == [CELL]
    assert entry["layer"] == "solver engine"
    names = [e["name"] for e in MANIFEST["per_layer"]]
    assert names.index(name) > names.index("idle_unspanned_ms")


def test_fit_ops_adds_the_xones_work():
    # k = 1, 2 iterations (one bf16 CG iteration of 1 step, the f32
    # finalize): the explicit model's count, plus four products of 2 k an
    # entry in each iteration's type, plus in f32 each iteration's Grams
    # and solves, 4 (m + n) k^2 + 2 k^3 / 3 = 20 + 2/3, and the CG
    # iteration's (1 + 1) products with G0, 2 x 2 (m + n) k^2 = 20
    import work

    cell = harness.Cell(CELL)
    config = {"args": dict(cell.config["args"], k=1, niter=2,
                           max_cg_steps=1),
              "operands": {"bulk": "bf16", "final": "f32"}}
    stats = {"nnz": 10, "m": 2, "n": 3}
    got = cell.reference.fit_ops(stats, config)
    base = work.explicit_fit_ops(10, 2, 3, 1, 2, 1, True, "bf16", "f32")
    assert got["bf16"] == pytest.approx(base["bf16"] + 4 * 2 * 10)
    assert got["f32"] == pytest.approx(base["f32"] + 4 * 2 * 10
                                       + 2 * (20 + 2 / 3) + 20)
