"""The comparison that decides ``correct``: the fitted model that the
timed window left, against the configuration's plain reference run from
the same start on the same ratings; and that start, which both sides
share, against the program's documented random draw.

Numbers of the fit, each a "worst leaf" over the model's parts (factors A
and B, and where the model has them the user and item biases and the
global mean; a vector leaf counts as one column):

- ``gap_norm``: ||program - reference|| / ||reference|| (Frobenius);
- ``gap_rows``: the largest row's ||program - reference|| over the root
  mean square of the reference's row norms: one row that is wrong reads
  as large as the whole.

Numbers of the start (the factors of the same model fitted with
``niter=0``).  The program documents them as independent N(0, 1/k) draws
on every row with training entries and zero on the others
(cmfrec_torch/solvers/dense_masked.py:_init_factors, as the JAX
package's cmfrec_tpu/solvers/dense_pallas.py:_init_factors).  With N
values on live rows and s = 1 / sqrt(k), the worst of A and B:

- ``start_dead``: the largest magnitude on a row without entries (0);
- ``start_mean_z``: |mean| / (s / sqrt(N)), the magnitude of a standard
  normal under the documented draw;
- ``start_sd_z``: |sd / s - 1| sqrt(2 N), likewise (to first order).

A cell's limits file (limits/<cell>.json) names the numbers it holds and
their limits; PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

import math

import torch

LEAVES = (("A", "A_"), ("B", "B_"), ("biasA", "user_bias_"),
          ("biasB", "item_bias_"), ("glob_mean", "glob_mean_"))


def model_parts(model) -> dict:
    """The fitted attributes that the check reads, {leaf: value} for the
    leaves the model has: references only, so that keeping them costs a
    window nothing."""
    return {leaf: getattr(model, attr) for leaf, attr in LEAVES
            if getattr(model, attr, None) is not None}


def pairs(prog: dict, ref: dict):
    for leaf, r in ref.items():
        if leaf not in prog:
            raise ValueError(f"the fitted model lacks {leaf}")
        p = torch.as_tensor(prog[leaf]).to("cpu", torch.float64)
        r = torch.as_tensor(r).to(torch.float64).cpu()
        if p.shape != r.shape:
            raise ValueError(f"{leaf}: shape {tuple(p.shape)}, the "
                             f"reference's {tuple(r.shape)}")
        yield leaf, p.reshape(r.shape[0] if r.dim() else 1, -1), \
            r.reshape(r.shape[0] if r.dim() else 1, -1)


def gap_norm(prog: dict, ref: dict) -> float:
    worst = 0.0
    for _, p, r in pairs(prog, ref):
        worst = max(worst, _ratio(float((p - r).norm()), float(r.norm())))
    return worst


def gap_rows(prog: dict, ref: dict) -> float:
    worst = 0.0
    for _, p, r in pairs(prog, ref):
        rms = float(r.norm(dim=1).pow(2).mean().sqrt())
        worst = max(worst, _ratio(float((p - r).norm(dim=1).max()), rms))
    return worst


NUMBERS = {"gap_norm": gap_norm, "gap_rows": gap_rows}


def fit_numbers(prog: dict, ref: dict) -> dict:
    return {name: fn(prog, ref) for name, fn in NUMBERS.items()}


def start_numbers(start: dict, live: dict, k: int) -> dict:
    """The start's numbers: ``start`` and ``live`` map "A" and "B" to the
    [rows, k] factors and to the rows' [rows] has-entries masks."""
    s = 1.0 / math.sqrt(k)
    out = {"start_dead": 0.0, "start_mean_z": 0.0, "start_sd_z": 0.0}
    for leaf in ("A", "B"):
        f = torch.as_tensor(start[leaf]).to("cpu", torch.float64)
        alive = torch.as_tensor(live[leaf]).cpu()
        if f.shape != (alive.numel(), k):
            raise ValueError(f"start {leaf}: shape {tuple(f.shape)}, "
                             f"expected ({alive.numel()}, {k})")
        if not bool(torch.isfinite(f).all()):
            return dict.fromkeys(out, math.inf)
        dead = f[~alive]
        if dead.numel():
            out["start_dead"] = max(out["start_dead"],
                                    float(dead.abs().max()))
        x = f[alive]
        N = x.numel()
        if N < 2:
            continue
        out["start_mean_z"] = max(out["start_mean_z"],
                                  abs(float(x.mean())) / s * math.sqrt(N))
        out["start_sd_z"] = max(out["start_sd_z"],
                                abs(float(x.std()) / s - 1.0)
                                * math.sqrt(2 * N))
    return out


def _ratio(num: float, den: float) -> float:
    if not (math.isfinite(num) and math.isfinite(den)):
        return math.inf
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return num / den


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) of the numbers in ``limits``,
    read from ``values``."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = values[name]
        out[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, out
