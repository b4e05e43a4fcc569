"""End-to-end ALS fit of the classic (non-collective) explicit model
(port of cmfrec_tpu/solvers/drivers.py::fit_explicit_als, dense-engine
subset).

It mirrors the reference's fit path for a plain X-only model
(upstream cmfrec src/collective.c:7263 with no side info): center -> bias
init -> alternating half-iterations over item/user orientations, with
CG-until-last-iteration-then-f32-polish (finalize_chol,
upstream cmfrec src/collective.c:8336-8340).  The port has one engine,
``dense_masked``; configurations that need another engine raise a
``ValueError`` naming the ROADMAP slice that brings them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..utils.checkpoint import FitCheckpointer
from . import preprocess
from .dense_masked import fit_explicit_dense_masked, padded_dims

# CG steps of the f32 polish iteration (finalize_chol)
FINALIZE_STEPS = 16


def _resolve_lambdas(lambda_, l1_lambda):
    """lambda_ may be a scalar or a length-6 array ordered as
    (user_bias, item_bias, A, B, C, D) — upstream cmfrec src/cmfrec.h:1858."""

    def expand(x):
        x = np.asarray(x, np.float64).ravel()
        if x.size == 1:
            return np.full(6, float(x[0]))
        if x.size != 6:
            raise ValueError("lambda_ must be a scalar or have 6 entries")
        return x

    return expand(lambda_), expand(l1_lambda)


def dense_bytes(m: int, n: int, k: int, weighted: bool) -> int:
    """Device bytes of the dense form: bf16 X plus int8 mask (f32 weights),
    in both orientations, at the padded sizes."""
    m_pad, n_pad, _ = padded_dims(m, n, k)
    return m_pad * n_pad * (2 + (4 if weighted else 1)) * 2


def _dense_budget(dev: torch.device) -> Optional[int]:
    """Device bytes the dense form may take: 90% of the card's free memory.
    None on the CPU, where it is not bounded."""
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    return int(0.9 * free)


def _unsupported(what: str, slice_: str):
    return ValueError(f"{what} is not supported by cmfrec_torch yet "
                      f"(ROADMAP {slice_})")


def fit_explicit_als(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    m: int,
    n: int,
    *,
    k: int = 40,
    lambda_=10.0,
    l1_lambda=0.0,
    niter: int = 10,
    use_cg: bool = True,
    max_cg_steps: int = 3,
    precondition_cg: bool = False,
    finalize_chol: bool = True,
    user_bias: bool = True,
    item_bias: bool = True,
    center: bool = True,
    scale_lam: bool = False,
    scale_bias_const: bool = False,
    NA_as_zero: bool = False,
    nonneg: bool = False,
    weights: Optional[np.ndarray] = None,
    dtype=np.float32,
    seed: int = 1,
    verbose: bool = False,
    engine: str = "auto",  # "auto" | "dense"
    mesh=None,
    init=None,  # warm restart: dict(A=, B=[, biasA=, biasB=]) to continue
    # training from (the reference's reset_values=False)
    checkpoint_path: Optional[str] = None,  # mid-fit periodic checkpoints
    checkpoint_every: int = 0,  # every N iterations (utils/checkpoint.py)
    shard_opposing_rows: bool = False,
    device="cuda",
) -> dict:
    lam6, l16 = _resolve_lambdas(lambda_, l1_lambda)
    dtype = resolve_dtype(dtype)
    dev = resolve_device(device)

    if mesh is not None or shard_opposing_rows:
        raise _unsupported("multi-device fitting (mesh=, shard_opposing_rows)",
                           "slice 7")
    if engine == "sparse":
        raise _unsupported("engine='sparse' (the bucketed engine)", "slice 4")
    if engine not in ("auto", "dense"):
        raise ValueError(f"engine must be 'auto' or 'dense', got {engine!r}")
    if nonneg:
        raise _unsupported("nonneg", "slice 4")
    if np.any(l16 > 0):
        raise _unsupported("l1_lambda", "slice 4")
    if NA_as_zero and weights is not None:
        raise _unsupported("weighted NA_as_zero", "slice 4")
    if use_cg and precondition_cg:
        raise _unsupported("precondition_cg",
                           "slice 1 item 4, the dense_engine Jacobi PCG")
    if dtype != np.float32:
        raise _unsupported(f"dtype {dtype}",
                           "slice 1 item 4, the float64 dense engine")

    need = dense_bytes(m, n, k, weights is not None)
    budget = _dense_budget(dev)
    if budget is not None and need > budget:
        raise _unsupported(
            f"data whose padded dense form needs {need / 2**30:.2f} GiB "
            f"(budget {budget / 2**30:.2f} GiB)",
            "slice 4, the bucketed sparse engine")

    glob_mean = (
        preprocess.weighted_global_mean(vals, weights) if center else 0.0
    )
    if NA_as_zero and center:
        # under NA-as-zero the mean is over ALL m*n cells (unobserved = 0,
        # weight 1): sum/(wsum + m*n - nnz) — common.c:3513
        wsum = (float(len(vals)) if weights is None
                else float(np.sum(weights)))
        glob_mean *= wsum / (wsum + float(m) * float(n) - float(len(vals)))

    ckpt = FitCheckpointer(checkpoint_path, checkpoint_every, niter)
    return fit_explicit_dense_masked(
        rows, cols, vals, m, n, weights=weights,
        k=k, lam6=lam6, niter=niter, max_cg_steps=max_cg_steps,
        finalize_chol=finalize_chol, finalize_steps=FINALIZE_STEPS,
        user_bias=user_bias, item_bias=item_bias,
        glob_mean=glob_mean, scale_lam=scale_lam,
        scale_bias_const=scale_bias_const,
        seed=seed, verbose=verbose, device=dev,
        init=init, na_as_zero=NA_as_zero, ckpt=ckpt,
        # use_cg=False runs exact mode on the same engine, as on the TPU
        exact=not use_cg,
    )
