"""check.py's numbers on models made by hand."""

import math

import pytest
import torch

import check


def test_gaps_take_the_worst_leaf():
    ref = {"A": torch.ones(4, 2), "glob_mean": torch.tensor(2.0)}
    prog = {"A": torch.ones(4, 2).numpy(), "glob_mean": 2.0}
    assert check.gap_norm(prog, ref) == 0.0
    prog["A"][3] += 1.0  # one row off by sqrt(2): the rows' rms is sqrt(2)
    assert check.gap_rows(prog, ref) == pytest.approx(1.0)
    assert check.gap_norm(prog, ref) == pytest.approx(math.sqrt(2 / 8))
    prog["glob_mean"] = 4.0
    assert check.gap_norm(prog, ref) == pytest.approx(1.0)


def test_a_missing_or_misshapen_leaf_raises():
    ref = {"A": torch.ones(4, 2)}
    with pytest.raises(ValueError):
        check.gap_norm({}, ref)
    with pytest.raises(ValueError):
        check.gap_norm({"A": torch.ones(3, 2)}, ref)


def test_not_finite_reads_infinite():
    ref = {"A": torch.ones(2, 2)}
    assert check.gap_norm({"A": torch.full((2, 2), math.nan)}, ref) == \
        math.inf
    values = check.fit_numbers({"A": torch.full((2, 2), math.nan)}, ref)
    ok, out = check.judge(values, {"gap_rows": 0.1})
    assert not ok and out["gap_rows"]["limit"] == 0.1


def _start(m, n, k, scale, gen):
    return {"A": torch.randn(m, k, generator=gen, dtype=torch.float64)
            * scale,
            "B": torch.randn(n, k, generator=gen, dtype=torch.float64)
            * scale}


def test_start_as_documented_reads_small():
    k = 50
    gen = torch.Generator().manual_seed(3)
    start = _start(400, 300, k, k ** -0.5, gen)
    live = {"A": torch.ones(400, dtype=torch.bool),
            "B": torch.ones(300, dtype=torch.bool)}
    live["A"][7] = False
    start["A"][7] = 0.0
    got = check.start_numbers(start, live, k)
    assert got["start_dead"] == 0.0
    assert got["start_mean_z"] < 4 and got["start_sd_z"] < 4


def test_start_off_its_draw_reads_large():
    k = 50
    gen = torch.Generator().manual_seed(4)
    live = {"A": torch.ones(400, dtype=torch.bool),
            "B": torch.ones(300, dtype=torch.bool)}
    scaled = _start(400, 300, k, 1.0, gen)  # sd 1, not 1/sqrt(k)
    assert check.start_numbers(scaled, live, k)["start_sd_z"] > 100
    shifted = _start(400, 300, k, k ** -0.5, gen)
    shifted["B"] += 0.05
    assert check.start_numbers(shifted, live, k)["start_mean_z"] > 10
    dead = _start(400, 300, k, k ** -0.5, gen)
    live["A"][0] = False  # a row without entries that kept its draw
    assert check.start_numbers(dead, live, k)["start_dead"] > 0
    dead["B"][1, 1] = math.nan
    assert check.start_numbers(dead, live, k)["start_sd_z"] == math.inf
    with pytest.raises(ValueError):
        check.start_numbers({"A": dead["A"][:, :3], "B": dead["B"]}, live,
                            k)


def test_judge_holds_each_limit():
    ok, out = check.judge({"gap_norm": 0.01, "start_dead": 0.0},
                          {"gap_norm": 0.02, "start_dead": 0.0})
    assert ok and out["start_dead"] == {"value": 0.0, "limit": 0.0}
    ok, _ = check.judge({"gap_norm": 0.03}, {"gap_norm": 0.02})
    assert not ok
    ok, _ = check.judge({"gap_norm": math.nan}, {"gap_norm": 0.02})
    assert not ok
