"""The harness as a process: what it loads, and what it does without a
card or without the program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bench_support import BENCH, ROOT

# a tiny run of each cell's traffic, program and reference on the CPU, in
# a process of its own; prints the banned modules it then holds
TINY_RUN = """
import sys
sys.path[:0] = [{root!r}, {bench!r}, {tests!r}]
import harness
from bench_support import tiny
for name in ("explicit_als_cg.ml10m",):
    cell = tiny(harness.Cell(name))
    out = harness.run_cell(cell, 2 ** 40 + 3, 0.2, False, device="cpu")
    assert out["correct"], out["checks"]
print("BANNED", harness.banned_modules())
"""


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_jax_loaded():
    code = TINY_RUN.format(root=str(ROOT), bench=str(BENCH),
                           tests=str(BENCH / "tests"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["-c", code], ROOT, env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BANNED []" in out.stdout


def test_banned_names_compare_whole(monkeypatch):
    import harness

    monkeypatch.setitem(sys.modules, "jaxlike_module", sys)
    assert "jaxlike_module" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.banned_modules()


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(["benchmark/run.py", "--workload", "explicit_als_cg.ml10m",
                "--seed", "3000000017", "--seconds", "1", "--trace", "0"],
               ROOT, env)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    # a checkout of BENCHMARK.json and the benchmark's files alone
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    out = _run(["benchmark/run.py", "--workload", "explicit_als_cg.ml10m",
                "--seed", "5", "--seconds", "1", "--trace", "0"],
               tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_run_on_the_card(card):
    out = _run(["benchmark/run.py", "--workload", "explicit_als_cg.ml10m",
                "--seed", "3000000019", "--seconds", "2", "--trace", "0"],
               ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
