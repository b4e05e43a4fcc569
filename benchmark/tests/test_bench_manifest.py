"""BENCHMARK.json against the benchmark's contract: its keys, names,
units and cross references, and a file for every name it gives."""

import json
import re

import pytest

from bench_support import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_keys():
    assert set(MANIFEST) == KEYS
    for section, keys in ENTRY_KEYS.items():
        for e in MANIFEST[section]:
            assert set(e) - {"workloads"} == keys, (section, e["name"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd[1:]:
        assert not word.startswith("/") and ".." not in word
        assert any(word.startswith(p + "/") for p in MANIFEST["paths"])
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_names_and_units(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for e in MANIFEST[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_cross_references():
    configs = {c["name"] for c in MANIFEST["configs"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
    assert configs == {w["config"] for w in MANIFEST["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:  # each cell reports setup_s, another e2e, a layer
        reported = {n for n, m in e2e.items()
                    if cell in m.get("workloads", cells)}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in MANIFEST["per_layer"])


def test_files_found_by_name():
    bench = ROOT / MANIFEST["paths"][0]
    for c in MANIFEST["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and path.with_suffix(".py").is_file()
        assert str(path.relative_to(ROOT)).startswith(MANIFEST["paths"][0])
        assert c["reduced"] == []
        assert c["source"].startswith("https://")
        cfg = json.loads(path.read_text())
        assert {"model", "args", "precision", "control"} <= set(cfg)
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for w in MANIFEST["workloads"]:
        assert (bench / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((bench / "limits" / f"{w['name']}.json")
                            .read_text())
        assert limits and all(v >= 0 for v in limits.values())
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()
    assert bench == BENCH
