"""A configuration, a traffic mix and a per-layer metric added to a copy
of the benchmark as new files (and entries in its BENCHMARK.json) are
listed and run with no file that was there edited."""

import hashlib
import json
import shutil

import harness
from bench_support import BENCH, ROOT, tiny

READER = '''"""fits_done: the window's fits (a test's metric)."""


def read(run):
    return float(len(run.fits))
'''


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_add_by_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    bench = tmp_path / "benchmark"
    # a configuration: the explicit one at another lambda, its reference
    # beside it; a mix: MovieLens-shaped with another skew
    cfg = json.loads((bench / "configs/explicit_als_cg.json").read_text())
    cfg["args"]["lambda_"] = 0.1
    (bench / "configs/explicit_lam01.json").write_text(json.dumps(cfg))
    shutil.copy(bench / "configs/explicit_als_cg.py",
                bench / "configs/explicit_lam01.py")
    mix = json.loads((bench / "traffic/ml10m.json").read_text())
    mix["item_exponent"] = 1.0
    (bench / "traffic/ml10m_skewed.json").write_text(json.dumps(mix))
    (bench / "metrics/fits_done.py").write_text(READER)
    (bench / "limits/explicit_lam01.ml10m_skewed.json").write_text(
        json.dumps({"gap_norm": 0.05}))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(
        manifest["configs"][0], name="explicit_lam01",
        file="benchmark/configs/explicit_lam01.json"))
    manifest["workloads"].append({
        "name": "explicit_lam01.ml10m_skewed", "config": "explicit_lam01",
        "traffic": "ml10m_skewed", "chips": 1, "why": "a test's cell"})
    manifest["per_layer"].append({
        "name": "fits_done", "unit": "fits", "better": "higher",
        "source": "host_clock", "layer": "whole fit", "moves": "fit_s",
        "workloads": ["explicit_lam01.ml10m_skewed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = tiny(harness.Cell("explicit_lam01.ml10m_skewed", root=tmp_path))
    assert cell.traffic["item_exponent"] == 1.0
    assert cell.config["args"]["lambda_"] == 0.1
    assert "fits_done" in cell.metrics(traced=True)
    out = harness.run_cell(cell, 11, 0.3, True, device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["fits_done"]["value"] >= 1
    after = _digests(tmp_path)
    assert all(after[f] == d for f, d in before.items())
