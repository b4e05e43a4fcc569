"""``correct`` comes out false when the timed path is broken underneath:
a run driven past the look for a card (on the CPU, at a tiny size), with
each fault of faults.py planted in the program, and with the
configuration's control, its plain reference one precision below the
stated one, put in the program's place."""

import numpy as np
import pytest
import torch

import faults
import harness
import plain
from bench_support import tiny

CELL = "explicit_als_cg.ml10m"
SEED = 2 ** 35 + 9


def test_sound_run_is_correct():
    out = harness.run_cell(tiny(harness.Cell(CELL)), SEED, 0.2, False,
                           device="cpu")
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_caught(fault):
    with faults.FAULTS[fault]():
        out = harness.run_cell(tiny(harness.Cell(CELL)), SEED, 0.2, False,
                               device="cpu")
    assert not out["correct"], out["checks"]


def test_start_fault_reads_on_the_start():
    # both sides start from the scaled draw; the start's own check reads
    # it, whatever the fit's numbers do
    with faults.start_scaled():
        out = harness.run_cell(tiny(harness.Cell(CELL)), SEED, 0.2, False,
                               device="cpu")
    checks = out["checks"]
    assert checks["start_sd_z"]["value"] > checks["start_sd_z"]["limit"]


class _Fitted:
    """The attributes of a fitted model that the check reads."""

    def __init__(self, out):
        self.A_, self.B_ = out["A"].numpy(), out["B"].numpy()
        self.user_bias_ = out["biasA"].numpy()
        self.item_bias_ = out["biasB"].numpy()
        self.glob_mean_ = float(out["glob_mean"])


def _control_fit(cell, X, seed, device):
    coo = X.tocoo()
    train = (torch.as_tensor(coo.row.astype(np.int64)),
             torch.as_tensor(coo.col.astype(np.int64)),
             torch.as_tensor(coo.data))
    start = harness.reference_start(cell, X, seed, device)
    return _Fitted(harness.reference_fit(
        cell, train, start, device,
        plain.control_precision(cell.config["control"])))


def test_control_is_not_correct():
    out = harness.run_cell(tiny(harness.Cell(CELL)), SEED, 0.2, False,
                           device="cpu", fit=_control_fit)
    assert not out["correct"], out["checks"]
