"""The plain references against cmfrec_torch's CPU path at a tiny size.
The test imports both; the references import nothing of the program."""

import ast

import pytest
import scipy.sparse as sp
import torch

import check
import harness
import plain
from bench_support import BENCH, tiny

def _fit_both(cell, seed, **override):
    """The program's fit on the CPU and the float64 reference's, from the
    program's start, with the configuration's arguments and ``override``."""
    cell.config = dict(cell.config, args=dict(cell.config["args"],
                                              **override))
    X, train = harness.draw(cell, seed, "cpu")
    model = harness.fit_program(cell, X, seed, "cpu")
    start = harness.reference_start(cell, X, seed, "cpu")
    return check.model_parts(model), harness.reference_fit(
        cell, train, start, "cpu")


def test_explicit_final_iteration_agrees():
    # one iteration, the finalize one: the program's float32 CG polish
    # against Cholesky in float64 (readings ~1e-4 at this size)
    prog, ref = _fit_both(tiny(harness.Cell("explicit_als_cg.ml10m")), 5,
                          niter=1)
    assert check.gap_rows(prog, ref) < 1e-3
    assert abs(float(prog["glob_mean"]) - float(ref["glob_mean"])) < 1e-12


def test_explicit_fit_agrees():
    # the whole fit: the program's bulk iterations take bf16 operands on
    # the CPU too, which moves the result by ~1.4e-2 (gap_norm) here
    prog, ref = _fit_both(tiny(harness.Cell("explicit_als_cg.ml10m")), 6)
    assert check.gap_norm(prog, ref) < 0.03


def test_start_is_the_documented_draw():
    # the program's niter=0 start on a matrix with a user and an item
    # without entries: zero there, N(0, 1/k) elsewhere
    cell = tiny(harness.Cell("explicit_als_cg.ml10m"))
    _, (row, col, val) = harness.draw(cell, 8, "cpu")
    keep = (row != 3) & (col != 5)
    train = (row[keep], col[keep], val[keep])
    X = sp.coo_matrix((train[2].numpy(), (train[0].numpy(),
                                          train[1].numpy())),
                      (cell.traffic["m"], cell.traffic["n"]))
    start = harness.reference_start(cell, X, 8, "cpu")
    live = harness.live_rows(cell, train)
    assert not live["A"][3] and not live["B"][5]
    got = check.start_numbers(start, live, cell.config["args"]["k"])
    assert got["start_dead"] == 0.0
    assert got["start_mean_z"] < 5 and got["start_sd_z"] < 5


@pytest.mark.parametrize("fmt", ["tf32", "e4m3"])
def test_round_operand(fmt):
    x = torch.tensor([1.0, -1.0, 3.14159, -1e-3, 0.0])
    y = plain.round_operand(x, fmt)
    rel = ((y - x).abs() / x.abs().clamp(min=1e-30))[x != 0]
    # relative spacing: 2^-10 TF32, 2^-3 e4m3 (half of it at
    # round-to-nearest), and the same value twice over
    assert float(rel.max()) <= {"tf32": 2 ** -11, "e4m3": 2 ** -4}[fmt]
    assert torch.equal(plain.round_operand(y, fmt), y)
    assert float(y[-1]) == 0.0


def test_references_import_nothing_of_the_program():
    files = [*BENCH.glob("configs/*.py"), BENCH / "plain.py",
             BENCH / "check.py", BENCH / "work.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("cmfrec_torch", "cmfrec_tpu",
                                               "jax", "jaxlib", "harness"), f
