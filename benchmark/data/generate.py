"""Traffic generators: synthetic user x item matrices drawn on a device
from a seed, with the shapes of the public data sets that upstream
cmfrec's benchmarks fit (github.com/david-cortes/cmfrec, benchmark/).

A traffic file (``benchmark/traffic/<mix>.json``) names its generator under
``"generator"`` and holds every parameter the generator reads.  A
generator draws on ``device`` with one ``torch.Generator`` seeded from the
run's seed, so the same seed gives the same matrix on any run of one
device type.  Every seed gets the same sizes: the matrix has exactly
``nnz`` distinct (row, column) pairs, and the held-out part is fixed by
count, not by a per-entry coin.

Copied from the repository's numpy generator (bench.py:make_ml10m_shaped)
and rewritten to draw on the card; the numbers it draws differ, the
distributions do not.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Matrix(NamedTuple):
    """A generated matrix, split: ``train`` and ``test`` are (rows, cols,
    vals) int64 / int64 / float64 tensors on the generating device."""

    m: int
    n: int
    train: tuple
    test: tuple


def _power_law(n: int, exponent: float, device) -> torch.Tensor:
    """The cumulative distribution of P(i) ~ 1 / (i + 1)^exponent."""
    p = 1.0 / torch.arange(1, n + 1, device=device,
                           dtype=torch.float64) ** exponent
    cdf = torch.cumsum(p / p.sum(), 0)
    cdf[-1] = 1.0
    return cdf


def _draw(cdf: torch.Tensor, size: int, gen) -> torch.Tensor:
    u = torch.rand(size, generator=gen, device=cdf.device, dtype=torch.float64)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)


def _distinct_pairs(draw_pairs, nnz: int, factor: float, gen) -> torch.Tensor:
    """``nnz`` distinct flat pair ids in a seeded random order:
    ``draw_pairs(size)`` is called for ``factor * nnz`` draws, and again
    for more while fewer than ``nnz`` distinct pairs came out."""
    pairs = torch.unique(draw_pairs(int(math.ceil(nnz * factor))))
    while pairs.numel() < nnz:
        more = int(math.ceil((nnz - pairs.numel()) * factor * 2)) + 1024
        pairs = torch.unique(torch.cat([pairs, draw_pairs(more)]))
    order = torch.randperm(pairs.numel(), generator=gen,
                           device=pairs.device)[:nnz]
    return pairs[order]


def power_law_ratings(p: dict, seed: int, device) -> Matrix:
    """Explicit ratings (bench.py:make_ml10m_shaped): users and items drawn
    on power laws, ratings from a rank-``k_true`` model with user and item
    biases and Gaussian noise, rounded to ``round_to`` and clipped; the
    first ``heldout_share`` of the shuffled pairs held out."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    m, n, nnz = p["m"], p["n"], p["nnz"]
    user_cdf = _power_law(m, p["user_exponent"], device)
    item_cdf = _power_law(n, p["item_exponent"], device)

    def draw_pairs(size):
        return _draw(user_cdf, size, gen) * n + _draw(item_cdf, size, gen)

    pairs = _distinct_pairs(draw_pairs, nnz, p["draw_factor"], gen)
    rows, cols = pairs // n, pairs % n
    kt, sd = p["k_true"], p["factor_sd"]
    A = torch.randn(m, kt, generator=gen, device=device) * sd
    B = torch.randn(n, kt, generator=gen, device=device) * sd
    bA = torch.randn(m, generator=gen, device=device) * p["bias_sd"]
    bB = torch.randn(n, generator=gen, device=device) * p["bias_sd"]
    noise = torch.randn(nnz, generator=gen, device=device) * p["noise_sd"]
    vals = torch.empty(nnz, device=device)
    step = 1 << 22  # bounds the [step, k_true] temporaries
    for s in range(0, nnz, step):
        sl = slice(s, s + step)
        vals[sl] = (p["mean"] + bA[rows[sl]] + bB[cols[sl]]
                    + (A[rows[sl]] * B[cols[sl]]).sum(1) + noise[sl])
    lo, hi = p["clip"]
    q = p["round_to"]
    vals = torch.clamp(torch.round(vals / q) * q, lo, hi).double()
    n_test = int(round(nnz * p["heldout_share"]))
    return Matrix(m, n, (rows[n_test:], cols[n_test:], vals[n_test:]),
                  (rows[:n_test], cols[:n_test], vals[:n_test]))


GENERATORS = {"power_law_ratings": power_law_ratings}


def generate(params: dict, seed: int, device) -> Matrix:
    """The matrix of a traffic file's ``params`` for ``seed``."""
    return GENERATORS[params["generator"]](params, int(seed), device)
