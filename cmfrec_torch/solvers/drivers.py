"""End-to-end ALS fits of the classic (non-collective) models
(port of cmfrec_tpu/solvers/drivers.py).

fit_explicit_als mirrors the reference's fit path for a plain X-only model
(upstream cmfrec src/collective.c:7263 with no side info): center -> bias
init -> alternating half-iterations over item/user orientations, with
CG-until-last-iteration-then-f32 (finalize_chol,
upstream cmfrec src/collective.c:8336-8340).  A float32 fit runs on one of
two engines: ``dense_masked`` (the padded dense form, kernels K1/K2) or the
bucketed sparse engine (degree buckets, kernel K3), which takes
``engine="sparse"``, weighted ``NA_as_zero`` and, under ``engine="auto"``,
data whose dense form exceeds the card's memory budget.  A float64 fit, or
one with Jacobi PCG (``precondition_cg``), takes no kernel, as in the JAX
package (cmfrec_tpu/solvers/drivers.py:285-293): the plain dense engine
(solvers/dense_engine.py, :func:`_fit_explicit_dense`) when its dense form
fits the budget, the bucketed engine's plain-torch solves otherwise.

fit_implicit_als mirrors fit_collective_implicit_als (upstream cmfrec
src/collective.c:9375): optional log transform, alpha confidence scaling,
adjust_weight -> w_main_multiplier = nnz/(m*n) (src/collective.c:9776-9782).
It runs on the bucketed engine (K3; plain-torch solves in float64 and
under Jacobi PCG) unless the caller asks for the dense-masked engine
(``engine="dense"``: K1/K2 on the dense confidence form, float32 without
a preconditioner).  ``engine="auto"`` stays bucketed: on an H100 at
ML10M's shape the
bucketed fit was the faster with 1.34%, 5% and 20% of the pairs observed,
and the dense one won only on a small catalogue
(scripts/time_implicit_engines_torch.py; PERF.md, Findings).  The
collective fits (side information, implicit features) are in
solvers/collective.py.

``nonneg`` and ``l1_lambda`` solve every half-step by coordinate descent
(solvers/als.py; the CD kernel of ops/coord_descent.py on a card) on the
bucketed engine, as the JAX package does: ``nonneg`` turns CG off, and
neither ever takes the dense engine.

``mesh=`` (a 1-D ``DeviceMesh``, parallel/mesh.py) fits data-parallel, as
the JAX package's ``mesh=`` (cmfrec_tpu/solvers/drivers.py:105-135): the
bucketed engine's buckets are padded to rows that divide over the mesh,
each rank builds only its share of every bucket from its entries
(:func:`_build_pair`) and solves it (K3, the CD kernel, Cholesky or
rowsolve.solve_cg, as the route decides), then gathers; the
dense-masked engine holds each rank's rows of the dense form
(solvers/dense_masked.py).  The plain dense engine takes no mesh, as in the
JAX package (:344-357): under one it runs whole on every rank.

``shard_opposing_rows=True`` with a mesh (the big-axis ring,
parallel/ring.py; cmfrec_tpu/solvers/drivers.py:428-447, 487-609,
772-857) keeps every factor matrix row-sharded for the whole fit: a rank
holds the rows it solves (its share of each bucket, parallel/ring.py:
RingSide) and nothing more of them; the bucket slots are rewritten into
the opposing side's ring order once a fit, each half-step's opposing
matrix is the rank's shard (padding rows zeroed, the bias column from the
real-row mask), its rows' systems are assembled by rotating the shards,
and the NA-as-zero and implicit Gram bases are partial sums added over
the ranks.  It takes the bucketed engine, Cholesky or coordinate descent
(the gates of the JAX package: ``mesh=`` and ``use_cg=False``), and one
all-gather of each factor matrix makes the model whole at the end of the
fit and at each checkpoint.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import (resolve_device, resolve_dtype, should_handle_interrupt,
                      torch_dtype)
from ..data.device_fill import build_bucketed_pair_share
from ..parallel.mesh import check_mesh, reduce_min, world_rank
from ..parallel.ring import RingSide, row_sum
from ..utils import profiling
from ..utils.checkpoint import FitCheckpointer
from ..utils.profiling import profiled_fit
from . import dense_engine, preprocess
from .als import SidePlan, blocks_to_orig, gram_matrix, init_blocks, update_side
from .dense_masked import (
    _round_up,
    fit_explicit_dense_masked,
    fit_implicit_dense_masked,
    padded_dims,
)

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


def dense_bytes(m: int, n: int, k: int, weighted: bool,
                implicit: bool = False) -> int:
    """Device bytes of the dense form, in both orientations at the padded
    sizes: explicit, bf16 X plus the int8 mask (f32 weights); implicit,
    bf16 Wx and Xp plus the int8 mask (10 B a padded entry)."""
    m_pad, n_pad, _ = padded_dims(m, n, k)
    per_entry = 2 + 2 + 1 if implicit else 2 + (4 if weighted else 1)
    return m_pad * n_pad * per_entry * 2


def _dense_budget(dev: torch.device) -> Optional[int]:
    """Device bytes the dense form may take: 90% of the card's free memory.
    None on the CPU, where it is not bounded."""
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    return int(0.9 * free)


def _mesh_budget(dev: torch.device, mesh) -> Optional[int]:
    """_dense_budget, the least over the mesh's ranks: every rank takes the
    same engine."""
    budget = _dense_budget(dev)
    return None if budget is None else reduce_min(budget, mesh, dev)


def _unsupported(what: str, slice_: str):
    return ValueError(f"{what} is not supported by cmfrec_torch yet "
                      f"(ROADMAP {slice_})")


def _host(state: dict) -> dict:
    return {key: profiling.to_host(v) for key, v in state.items()}


def _fence(dev: torch.device) -> None:
    profiling.synced()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _compute(mxu_bf16: bool, tdt) -> str:
    """A bucketed iteration's operand type, as its span names it."""
    return "bf16" if mxu_bf16 else {torch.float64: "f64"}.get(tdt, "f32")


# ----------------------------------------------------------------------- #
# bucketed-engine helpers                                                  #
# ----------------------------------------------------------------------- #


def _sparse_fit_state(A_blocks, B_blocks, perm_A, perm_B, k, user_bias,
                      item_bias):
    """Bucketed-engine state -> the init= dict shape (checkpointing)."""
    A_orig = blocks_to_orig(A_blocks, perm_A)
    B_orig = blocks_to_orig(B_blocks, perm_B)
    return {
        "A": A_orig[:, :k], "B": B_orig[:, :k],
        "biasA": A_orig[:, k] if user_bias else None,
        "biasB": B_orig[:, k] if item_bias else None,
    }


def _with_bias_col(orig: torch.Tensor, col: int, ones: bool) -> torch.Tensor:
    """A copy with column ``col`` set to ones, or zeros (the bias-column
    trick, upstream cmfrec src/common.c:561-565)."""
    out = orig.clone()
    out[:, col] = 1.0 if ones else 0.0
    return out


def _make_l1_vec(k: int, k_pad: int, l1: float, l1_bias: float,
                 has_bias: bool, dev, dtype=torch.float32):
    """Per-coordinate l1: [l1]*k + [l1_bias] + 0s on padding coordinates;
    None when every entry is 0 (no coordinate descent)."""
    if l1 == 0.0 and (not has_bias or l1_bias == 0.0):
        return None
    v = np.zeros(k_pad, np.float64)
    v[:k] = l1
    if has_bias:
        v[k] = l1_bias
    return profiling.upload(v, dev, dtype)


def _make_lam_vec(k: int, k_pad: int, lam: float, lam_bias: float,
                  has_bias: bool, dev, dtype=torch.float32) -> torch.Tensor:
    """Per-coordinate L2: [lam]*k + [lam_bias] + 1s on padding coordinates
    (a positive diagonal keeps padded coordinates at exactly zero)."""
    v = np.ones(k_pad, np.float64)
    v[:k] = lam
    if has_bias:
        v[k] = lam_bias
    return profiling.upload(v, dev, dtype)


def _build_pair(rows, cols, vals_c, m, n, weights, dev, mesh=None):
    """Both orientations of the bucketed layout with the values' dtype,
    bucket rows dividing over ``mesh``: ((RB, CB), shares), the plans and
    this rank's shares, built on the fit's device from the rank's entries
    alone (data/device_fill.py:build_bucketed_pair_share; the whole layouts,
    both plan and share, without a mesh)."""
    with profiling.span("cmfrec.engine.layout"):
        return build_bucketed_pair_share(rows, cols, vals_c, m, n, weights,
                                         device=dev, mesh=mesh,
                                         dtype=np.asarray(vals_c).dtype)


def _row_index(bucketed, b, dev):
    """Original row ids of bucket b's rows (-1 on padding rows)."""
    return profiling.upload(bucketed.row_of[b.start:b.start + b.n_rows], dev)


def _seed_factor_blocks(blocks, bucketed, M, k):
    """Write warm-start factor rows into the bucketed block layout, in the
    blocks' dtype (padding rows get zeros): each block's rows picked on the
    host, so that ``M`` is never whole on the device."""
    M = profiling.to_host(M) if torch.is_tensor(M) else np.asarray(M)
    ext = np.concatenate([M[:, :k], np.zeros((1, k), M.dtype)])
    for b, blk in zip(bucketed.buckets, blocks):
        blk[:, :k] = profiling.upload(
            ext[bucketed.row_of[b.start:b.start + b.n_rows]], blk.device,
            blk.dtype)
    return blocks


def _set_bias_coord(blocks, bucketed, bias_vec, coord):
    """Write biases into each block's bias coordinate."""
    dev = blocks[0].device if blocks else None
    dt = blocks[0].dtype if blocks else None
    bias = profiling.upload(bias_vec, dev, dt)
    ext = torch.cat([bias, torch.zeros(1, dtype=dt, device=dev)])
    for b, blk in zip(bucketed.buckets, blocks):
        blk[:, coord] = ext[_row_index(bucketed, b, dev)]
    return blocks


def _na0_rhs_base(opp, opp_bias, glob_mean):
    """opp^T (-mu - opp_bias): rhs contribution of the all-zero entries
    under NA-as-zero (the reference's BtXbias, upstream cmfrec
    src/collective.c:303-312)."""
    t = torch.full((opp.shape[0],), -glob_mean, dtype=opp.dtype,
                   device=opp.device)
    if opp_bias is not None:
        t = t - opp_bias
    return opp.T @ t


def _check_engine(engine):
    if engine not in ("auto", "dense", "sparse"):
        raise ValueError("engine must be 'auto', 'dense' or 'sparse', "
                         f"got {engine!r}")


def implicit_values(vals, apply_log_transf):
    """The implicit fits' values as f64, log-transformed on request; values
    <= 0 under ``apply_log_transf`` raise (ROADMAP F4)."""
    vals = np.asarray(vals, np.float64)
    if apply_log_transf:
        if np.any(vals <= 0):
            raise ValueError("apply_log_transf needs every value > 0 (the "
                             "log of a value <= 0 is -inf or NaN)")
        vals = np.log(vals)
    return vals


def plain_route(dtype, use_cg, precondition_cg) -> bool:
    """Whether a fit takes no kernel: float64, or CG with Jacobi
    preconditioning (the JAX package's Pallas gates need f32 without PCG,
    cmfrec_tpu/solvers/drivers.py:285-291)."""
    return np.dtype(dtype) == np.float64 or bool(use_cg and precondition_cg)


def _reject_common(mesh, shard_opposing_rows, dev, use_cg):
    """The multi-device options: the big-axis ring needs a mesh and
    ``use_cg=False`` (the JAX package's gates and messages,
    cmfrec_tpu/solvers/drivers.py:200-208); a mesh must be a 1-D DeviceMesh
    of the fit's device type (parallel/mesh.py:check_mesh)."""
    if shard_opposing_rows:
        if mesh is None:
            raise ValueError("shard_opposing_rows requires mesh=")
        if use_cg:
            raise ValueError(RING_GATE_MESSAGE)
    check_mesh(mesh, dev)


# cmfrec_tpu/solvers/drivers.py:204-208
RING_GATE_MESSAGE = ("shard_opposing_rows supports Cholesky/CD solves only "
                     "(truncated CG would cost one ring per matvec); pass "
                     "use_cg=False")


# cmfrec_tpu/solvers/drivers.py:248-251
DENSE_CD_MESSAGE = ("engine='dense' does not support nonneg/l1_lambda; "
                    "use engine='auto' or 'sparse'")


# ----------------------------------------------------------------------- #
# explicit                                                                 #
# ----------------------------------------------------------------------- #


@profiled_fit
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
    max_cd_steps: int = 100,
    weights: Optional[np.ndarray] = None,
    dtype=np.float32,
    seed: int = 1,
    verbose: bool = False,
    engine: str = "auto",  # "auto" | "dense" | "sparse"
    mesh=None,
    init=None,  # warm restart: dict(A=, B=[, biasA=, biasB=]) to continue
    # training from (the reference's reset_values=False)
    checkpoint_path: Optional[str] = None,  # mid-fit periodic checkpoints
    checkpoint_every: int = 0,  # every N iterations (utils/checkpoint.py)
    shard_opposing_rows: bool = False,
    device="cuda",
) -> dict:
    """Explicit ALS.  Returns A [m,k], B [n,k], biasA/biasB (or None) as
    tensors of the fit's dtype on ``device``, plus glob_mean and k.

    float32 without ``precondition_cg``: ``engine="auto"`` takes the
    dense-masked engine (K1/K2) unless the data is weighted NA_as_zero or
    its padded dense form exceeds 90% of the card's free memory; then, as
    with ``engine="sparse"``, the bucketed engine (K3).  float64, or CG
    under ``precondition_cg``: ``engine="auto"`` takes the plain dense
    engine for CG fits without NA_as_zero whose dense form fits that
    budget, the bucketed engine's plain solves otherwise; ``"dense"``
    forces the plain dense engine (30 CG steps a half-step without
    ``use_cg``), as the JAX package's routes do.  ``nonneg`` or an
    ``l1_lambda`` takes the bucketed engine and solves by coordinate
    descent (``nonneg`` without CG, the global mean clamped at 0)."""
    lam6, l16 = _resolve_lambdas(lambda_, l1_lambda)
    dtype = resolve_dtype(dtype)
    dev = resolve_device(device)
    _check_engine(engine)
    _reject_common(mesh, shard_opposing_rows, dev, use_cg)
    if shard_opposing_rows:
        engine = "sparse"  # the bucketed engine is the ring's
    if nonneg:
        use_cg = False
    use_cd = nonneg or bool(np.any(l16 > 0))
    if engine == "dense" and use_cd:
        raise ValueError(DENSE_CD_MESSAGE)
    weighted_na0 = NA_as_zero and weights is not None
    if engine == "dense" and weighted_na0:
        raise ValueError("engine='dense' has no weighted NA_as_zero form; "
                         "use engine='auto' or 'sparse'")
    plain = plain_route(dtype, use_cg, precondition_cg)
    if plain and engine == "dense" and NA_as_zero:
        raise ValueError("engine='dense' has no NA_as_zero form in float64 "
                         "or under precondition_cg; use engine='auto' or "
                         "'sparse'")
    bucketed = engine == "sparse" or weighted_na0 or use_cd or (
        plain and engine == "auto" and (NA_as_zero or not use_cg))
    if engine == "auto" and not bucketed:
        budget = _mesh_budget(dev, mesh)
        # the dense-masked engine holds 1/world of the dense form a rank;
        # the plain dense engine runs whole on every rank
        need = (dense_engine.estimate_dense_bytes(
                    m, n, len(vals), k, dtype.itemsize, weights is not None)
                if plain else dense_bytes(m, n, k, weights is not None)
                // world_rank(mesh)[0])
        bucketed = budget is not None and need > budget

    glob_mean = (
        preprocess.weighted_global_mean(vals, weights) if center else 0.0
    )
    if NA_as_zero and center:
        # under NA-as-zero the mean is over ALL m*n cells (unobserved = 0,
        # weight 1): sum/(wsum + m*n - nnz) — common.c:3513
        wsum = (float(len(vals)) if weights is None
                else float(np.sum(weights)))
        glob_mean *= wsum / (wsum + float(m) * float(n) - float(len(vals)))
    if nonneg:
        # centred like any other, the mean clamped at 0 (common.c:3599)
        glob_mean = max(glob_mean, 0.0)

    ckpt = FitCheckpointer(checkpoint_path, checkpoint_every, niter, mesh)
    common = dict(weights=weights, k=k, lam6=lam6, niter=niter,
                  finalize_chol=finalize_chol, user_bias=user_bias,
                  item_bias=item_bias, glob_mean=glob_mean,
                  scale_lam=scale_lam, scale_bias_const=scale_bias_const,
                  seed=seed, verbose=verbose, dev=dev, init=init, ckpt=ckpt,
                  dtype=dtype, precondition_cg=precondition_cg)
    if bucketed:
        return _fit_explicit_bucketed(
            rows, cols, vals, m, n, use_cg=use_cg, max_cg_steps=max_cg_steps,
            NA_as_zero=NA_as_zero, l16=l16, nonneg=nonneg,
            max_cd_steps=max_cd_steps, mesh=mesh, ring=shard_opposing_rows,
            **common)
    if plain:
        return _fit_explicit_dense(
            rows, cols, vals, m, n,
            # use_cg=False (engine="dense"): every half-step's CG runs 30
            # steps, converged on these k x k systems
            max_cg_steps=max_cg_steps if use_cg else 30, **common)
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
        exact=not use_cg, dtype=dtype,
        precondition_cg=use_cg and precondition_cg, mesh=mesh,
    )


def _centered(vals, glob_mean, dtype):
    """The values minus the global mean, in the fit's dtype."""
    return (np.asarray(vals, np.float64) - glob_mean).astype(dtype)


def _initial_biases(rows, cols, vals_c, m, n, lam6, weights, user_bias,
                    item_bias, scale_lam, nonneg=False):
    """preprocess.initialize_biases of the centered values, or (None, None)
    without biases."""
    if not (user_bias or item_bias):
        return None, None
    return preprocess.initialize_biases(
        rows, cols, vals_c, m, n, lam_user=lam6[0], lam_item=lam6[1],
        wgt=weights, user_bias=user_bias, item_bias=item_bias,
        scale_lam=scale_lam, nonneg=nonneg)


@profiling.engine
def _fit_explicit_bucketed(
    rows, cols, vals, m, n, *, weights, k, lam6, niter, use_cg, max_cg_steps,
    finalize_chol, user_bias, item_bias, glob_mean, scale_lam,
    scale_bias_const, NA_as_zero, seed, verbose, dev, init, ckpt, dtype,
    precondition_cg, l16, nonneg, max_cd_steps, mesh=None, ring=False,
) -> dict:
    """The bucketed route of fit_explicit_als
    (cmfrec_tpu/solvers/drivers.py:361-470), in the fit's dtype.  Under
    ``mesh`` the plans seed the start and each rank builds, holds and
    solves its share of the layouts (_build_pair).  Under ``ring`` each
    rank keeps only its rows of A and B (parallel/ring.py)."""
    tdt = torch_dtype(dtype)
    vals_c = _centered(vals, glob_mean, dtype)
    biasA0, biasB0 = _initial_biases(rows, cols, vals_c, m, n, lam6, weights,
                                     user_bias, item_bias, scale_lam, nonneg)
    (RB, CB), shares = _build_pair(rows, cols, vals_c, m, n, weights, dev,
                                   mesh)
    perm_A = profiling.upload(RB.perm, dev)
    perm_B = profiling.upload(CB.perm, dev)

    k_pad = _round_up(k + 1, 8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    sides = _ring_start(RB, CB, mesh, dev, tdt) if ring else None
    side_A, side_B = sides or (None, None)
    A_blocks = init_blocks(gen, RB, k, k_pad, tdt, side_A)
    B_blocks = init_blocks(gen, CB, k, k_pad, tdt, side_B)
    lay_A, lay_B = shares if ring else (RB, CB)  # the blocks' layouts
    if user_bias:
        _set_bias_coord(A_blocks, lay_A, biasA0, k)
    if item_bias:
        _set_bias_coord(B_blocks, lay_B, biasB0, k)
    if init is not None:
        if init.get("A") is not None:
            _seed_factor_blocks(A_blocks, lay_A, init["A"], k)
        if init.get("B") is not None:
            _seed_factor_blocks(B_blocks, lay_B, init["B"], k)
        if user_bias and init.get("biasA") is not None:
            _set_bias_coord(A_blocks, lay_A, init["biasA"], k)
        if item_bias and init.get("biasB") is not None:
            _set_bias_coord(B_blocks, lay_B, init["biasB"], k)

    lam_vec_A, lam_vec_B, lam_const_A, lam_const_B = _lam_vecs(
        k, k_pad, lam6, user_bias, item_bias, scale_lam, scale_bias_const,
        weights, len(vals), m, n, dev, tdt)
    l1_vec_A = _make_l1_vec(k, k_pad, l16[2], l16[0], user_bias, dev, tdt)
    l1_vec_B = _make_l1_vec(k, k_pad, l16[3], l16[1], item_bias, dev, tdt)

    statics = dict(k=k, user_bias=user_bias, item_bias=item_bias,
                   NA_as_zero=NA_as_zero, max_cg_steps=max_cg_steps,
                   scale_lam=scale_lam, m=m, n=n,
                   precondition=precondition_cg, nonneg=nonneg,
                   max_cd_steps=max_cd_steps, mesh=mesh)
    RB, CB = shares
    if ring:
        side_B.remap_slots(RB)  # A's slots index B's rows
        side_A.remap_slots(CB)
    args = (RB, CB, perm_A, perm_B, lam_vec_A, lam_vec_B, lam_const_A,
            lam_const_B, l1_vec_A, l1_vec_B, float(glob_mean))

    def state():
        return _sparse_fit_state(*_whole(A_blocks, B_blocks, sides),
                                 perm_A, perm_B, k, user_bias, item_bias)

    try:
        for it in range(niter):
            method = ("cg" if use_cg and not (finalize_chol and it == niter - 1)
                      else "chol")
            t0 = time.time()
            # bf16 copies of the opposing matrix in the f32 CG iterations
            # on a card, as the JAX package does on the TPU; Cholesky stays
            # in the fit's dtype
            bf16 = _bf16_rows(dev, method, tdt)
            with profiling.span("cmfrec.engine.iter", it=it + 1,
                                compute=_compute(bf16, tdt), method=method):
                A_blocks, B_blocks = _explicit_sparse_iteration(
                    A_blocks, B_blocks, *args, method=method,
                    mxu_bf16=bf16, ring=sides, **statics)
            if verbose:
                _fence(dev)
                print(f"iter {it + 1}/{niter} [{method}] "
                      f"{time.time() - t0:.3f}s")
            ckpt.maybe_save(it + 1, lambda: _host(state()))
    except KeyboardInterrupt:
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")

    out = state()
    out.update({"glob_mean": float(glob_mean), "k": k})
    return out


def _lam_vecs(k, K, lam6, user_bias, item_bias, scale_lam, scale_bias_const,
              weights, nnz, m, n, dev, tdt):
    """(lam_vec_A, lam_vec_B, lam_const_A, lam_const_B) of an explicit fit
    with K coordinates, the bias at k.  scale_bias_const: the bias
    coordinate's penalty scales with the average observation count instead
    of the per-row count (upstream cmfrec src/common.c:717-722)."""
    lam_vec_A = _make_lam_vec(k, K, lam6[2], lam6[0], user_bias, dev, tdt)
    lam_vec_B = _make_lam_vec(k, K, lam6[3], lam6[1], item_bias, dev, tdt)
    lam_const_A = lam_const_B = None
    if scale_lam and scale_bias_const:
        wsum = float(np.sum(weights)) if weights is not None else float(nnz)
        if user_bias:
            lam_const_A = torch.zeros(K, dtype=tdt, device=dev)
            lam_const_A[k] = lam6[0] * (wsum / max(m, 1))
            lam_vec_A[k] = 0.0
        if item_bias:
            lam_const_B = torch.zeros(K, dtype=tdt, device=dev)
            lam_const_B[k] = lam6[1] * (wsum / max(n, 1))
            lam_vec_B[k] = 0.0
    return lam_vec_A, lam_vec_B, lam_const_A, lam_const_B


def _bf16_rows(dev, method, tdt) -> bool:
    """bf16 opposing rows: the f32 CG iterations on a card, as the JAX
    package's bf16 MXU operands on the TPU (never in float64)."""
    return dev.type == "cuda" and method == "cg" and tdt == torch.float32


def _explicit_sparse_iteration(
    A_blocks, B_blocks, RB, CB, perm_A, perm_B, lam_vec_A, lam_vec_B,
    lam_const_A, lam_const_B, l1_vec_A, l1_vec_B, glob_mean,
    *, m, n, k, user_bias, item_bias, NA_as_zero, method, max_cg_steps,
    scale_lam, mxu_bf16, precondition, nonneg, max_cd_steps, mesh=None,
    ring=None,
):
    """One full explicit ALS iteration over bucketed data, B half-step then
    A (the reference's order, upstream cmfrec src/collective.c:8614 "Updating
    B" precedes :8802 "Updating A").  ``ring``: the (A, B) RingSides of a
    big-axis fit, whose blocks are this rank's."""
    mode = "na0" if NA_as_zero else "explicit"
    common = dict(mu=glob_mean if NA_as_zero else None, method=method,
                  n_steps=max_cg_steps, scale_lam=scale_lam,
                  mxu_bf16=mxu_bf16, precondition=precondition,
                  nonneg=nonneg, max_cd_steps=max_cd_steps)
    if ring is None:
        common["mesh"] = mesh
    else:
        common["ring_mesh"] = mesh

    def half(blocks, plan, opp_blocks, perm, side, opp_bias_on, ones,
             lam_vec, lam_const, l1_vec):
        if side is None:
            opp_orig = blocks_to_orig(opp_blocks, perm)
            opp = _with_bias_col(opp_orig, k, ones)
        else:
            # this rank's shard, padding rows zero and the bias column
            # from the real-row mask (cmfrec_tpu/solvers/drivers.py:600-609)
            opp_orig = side.shard(opp_blocks)
            opp = opp_orig.clone()
            opp[:, k] = side.mask if ones else 0.0
        opp_bias = opp_orig[:, k] if opp_bias_on else None
        G0 = r0_vec = None
        if NA_as_zero:
            G0 = row_sum(gram_matrix, side, mesh, opp)
            r0_vec = row_sum(lambda o, b: _na0_rhs_base(o, b, glob_mean),
                             side, mesh, opp, opp_bias)
        return update_side(plan, blocks, opp, opp_bias, lam_vec, G0=G0,
                           r0_vec=r0_vec, lam_const_vec=lam_const,
                           l1_vec=l1_vec, **common)

    side_A, side_B = (None, None) if ring is None else ring
    B_blocks = half(B_blocks, SidePlan(CB, mode, m), A_blocks, perm_A,
                    side_A, user_bias, item_bias, lam_vec_B, lam_const_B,
                    l1_vec_B)
    A_blocks = half(A_blocks, SidePlan(RB, mode, n), B_blocks, perm_B,
                    side_B, item_bias, user_bias, lam_vec_A, lam_const_A,
                    l1_vec_A)
    return A_blocks, B_blocks


# ----------------------------------------------------------------------- #
# the big-axis ring (parallel/ring.py)                                     #
# ----------------------------------------------------------------------- #


def _ring_start(RB, CB, mesh, dev, tdt):
    """The (A, B) RingSides of a big-axis fit, from the layouts' plans."""
    return RingSide(RB, mesh, dev, tdt), RingSide(CB, mesh, dev, tdt)


def _whole(A_blocks, B_blocks, sides):
    """Both sides' blocks whole: as they are, or under a ring (``sides``)
    gathered, one all-gather each."""
    if sides is None:
        return A_blocks, B_blocks
    return sides[0].whole(A_blocks), sides[1].whole(B_blocks)


@profiling.engine
def _fit_explicit_dense(
    rows, cols, vals, m, n, *, weights, k, lam6, niter, max_cg_steps,
    finalize_chol, user_bias, item_bias, glob_mean, scale_lam,
    scale_bias_const, seed, verbose, dev, init, ckpt, dtype,
    precondition_cg,
) -> dict:
    """The plain dense route of fit_explicit_als
    (cmfrec_tpu/solvers/drivers.py:862-966): float64 and Jacobi-PCG fits
    on solvers/dense_engine.py, in the fit's dtype on ``dev``.  K = k + 1
    coordinates, the bias at k.  finalize_chol runs the last iteration as
    30 CG steps without the preconditioner, converged on these k x k
    systems, in place of the reference's Cholesky
    (upstream cmfrec src/collective.c:8336-8340)."""
    tdt = torch_dtype(dtype)
    vals_c = _centered(vals, glob_mean, dtype)
    biasA0, biasB0 = _initial_biases(rows, cols, vals_c, m, n, lam6, weights,
                                     user_bias, item_bias, scale_lam)
    X, W = dense_engine.dense_from_coo(rows, cols, vals_c, m, n, weights,
                                       dtype=tdt, device=dev)
    K = k + 1  # the bias coordinate, zero with lambda 1 when unused
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    scale = 1.0 / np.sqrt(max(k, 1))
    A = scale * torch.randn(m, K, generator=gen, dtype=tdt, device=dev)
    B = scale * torch.randn(n, K, generator=gen, dtype=tdt, device=dev)

    def up(a):
        return profiling.upload(a, dev, tdt)

    init = init or {}
    if init.get("A") is not None:
        A[:, :k] = up(init["A"])
    if init.get("B") is not None:
        B[:, :k] = up(init["B"])
    if user_bias and init.get("biasA") is not None:
        biasA0 = init["biasA"]
    if item_bias and init.get("biasB") is not None:
        biasB0 = init["biasB"]
    A[:, k] = up(biasA0) if user_bias else 0.0
    B[:, k] = up(biasB0) if item_bias else 0.0

    lam_vec_A, lam_vec_B, lam_const_A, lam_const_B = _lam_vecs(
        k, K, lam6, user_bias, item_bias, scale_lam, scale_bias_const,
        weights, len(vals), m, n, dev, tdt)
    lam_mult_A = lam_mult_B = None
    if scale_lam:
        lam_mult_A = dense_engine.weight_sums(W, 1, tdt)
        lam_mult_B = dense_engine.weight_sums(W, 0, tdt)

    def state():
        return {"A": A[:, :k], "B": B[:, :k],
                "biasA": A[:, k] if user_bias else None,
                "biasB": B[:, k] if item_bias else None}

    try:
        for it in range(niter):
            final = finalize_chol and it == niter - 1
            steps = 30 if final else max_cg_steps
            jacobi = precondition_cg and not final
            t0 = time.time()
            # B before A, the reference's order (src/collective.c:8614/8802)
            with profiling.span("cmfrec.engine.iter", it=it + 1,
                                compute=_compute(False, tdt),
                                method="dense-cg"):
                B = dense_engine.dense_cg_update(
                    B, X, W, _with_bias_col(A, k, item_bias),
                    A[:, k] if user_bias else None, lam_vec_B, lam_mult_B,
                    lam_const_B, steps, 1, jacobi=jacobi)
                A = dense_engine.dense_cg_update(
                    A, X, W, _with_bias_col(B, k, user_bias),
                    B[:, k] if item_bias else None, lam_vec_A, lam_mult_A,
                    lam_const_A, steps, 0, jacobi=jacobi)
            if verbose:
                _fence(dev)
                tag = "dense-cg*" if final else "dense-cg"
                print(f"iter {it + 1}/{niter} [{tag}] "
                      f"{time.time() - t0:.3f}s")
            ckpt.maybe_save(it + 1, lambda: _host(state()))
    except KeyboardInterrupt:
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")

    out = state()
    out.update({"glob_mean": float(glob_mean), "k": k})
    return out


# ----------------------------------------------------------------------- #
# implicit                                                                 #
# ----------------------------------------------------------------------- #


@profiled_fit
def fit_implicit_als(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    m: int,
    n: int,
    *,
    k: int = 50,
    lambda_=1.0,
    l1_lambda=0.0,
    niter: int = 15,
    use_cg: bool = True,
    max_cg_steps: int = 3,
    precondition_cg: bool = False,
    finalize_chol: bool = False,
    alpha: float = 1.0,
    apply_log_transf: bool = False,
    adjust_weight: bool = False,
    nonneg: bool = False,
    max_cd_steps: int = 100,
    dtype=np.float32,
    seed: int = 1,
    verbose: bool = False,
    mesh=None,
    init=None,  # warm restart: dict(A=, B=)
    checkpoint_path: Optional[str] = None,  # mid-fit periodic checkpoints
    checkpoint_every: int = 0,
    shard_opposing_rows: bool = False,
    engine: str = "auto",  # "auto" | "dense" | "sparse"
    device="cuda",
) -> dict:
    """Implicit-feedback ALS (WRMF).  Returns A [m,k] and B [n,k] as
    tensors of the fit's dtype on ``device`` plus w_main_multiplier and
    alpha.

    ``engine="auto"`` and ``"sparse"`` take the bucketed engine,
    ``"dense"`` the dense-masked one, whose padded dense form takes 10 B
    an entry (bf16 Wx and Xp, the int8 mask, both orientations).  The
    dense engine runs K1 and K2 (bf16 bulk iterations, f32 under
    finalize_chol's last iteration or use_cg=False's exact mode), in float32
    without ``precondition_cg`` only.  The bucketed engine's f32 CG
    iterations launch K3 once per bucket and side on a card (bf16 opposing
    matrix); its float64 and Jacobi-PCG iterations run rowsolve.solve_cg,
    and its Cholesky iterations (use_cg=False, or the last one under
    finalize_chol) stay in the fit's dtype.  ``nonneg`` (without CG) and
    ``l1_lambda`` solve by coordinate descent on the bucketed engine."""
    lam6, l16 = _resolve_lambdas(lambda_, l1_lambda)
    dtype = resolve_dtype(dtype)
    dev = resolve_device(device)
    _check_engine(engine)
    if nonneg:
        use_cg = False
    # after nonneg's use_cg, as cmfrec_tpu/solvers/drivers.py:679-690
    _reject_common(mesh, shard_opposing_rows, dev, use_cg)
    if shard_opposing_rows:
        engine = "sparse"  # the bucketed engine is the ring's
    use_cd = nonneg or bool(np.any(l16 > 0))
    if engine == "dense" and use_cd:
        raise ValueError(DENSE_CD_MESSAGE)
    plain = plain_route(dtype, use_cg, precondition_cg)
    dense = engine == "dense"
    if dense and plain:
        raise ValueError("engine='dense' (kernels K1/K2) takes float32 "
                         "without precondition_cg; use engine='auto' or "
                         "'sparse'")
    ckpt = FitCheckpointer(checkpoint_path, checkpoint_every, niter, mesh)
    tdt = torch_dtype(dtype)

    vals = implicit_values(vals, apply_log_transf).astype(dtype)
    w_main = len(vals) / (float(m) * float(n)) if adjust_weight else 1.0
    if dense:
        return fit_implicit_dense_masked(
            rows, cols, vals, m, n, k=k, lam6=lam6, niter=niter,
            max_cg_steps=max_cg_steps, finalize_steps=FINALIZE_STEPS,
            finalize_chol=finalize_chol, alpha=alpha,
            w_main_multiplier=w_main, seed=seed, verbose=verbose, device=dev,
            init=init, ckpt=ckpt, exact=not use_cg, dtype=dtype,
            precondition_cg=use_cg and precondition_cg, mesh=mesh)

    return _fit_implicit_bucketed(
        rows, cols, vals, m, n, k=k, lam6=lam6, l16=l16, niter=niter,
        use_cg=use_cg, max_cg_steps=max_cg_steps,
        precondition_cg=precondition_cg, finalize_chol=finalize_chol,
        alpha=alpha, w_main=w_main, nonneg=nonneg, max_cd_steps=max_cd_steps,
        seed=seed, verbose=verbose, mesh=mesh, init=init, ckpt=ckpt,
        ring=shard_opposing_rows, dev=dev, tdt=tdt)


@profiling.engine
def _fit_implicit_bucketed(
    rows, cols, vals, m, n, *, k, lam6, l16, niter, use_cg, max_cg_steps,
    precondition_cg, finalize_chol, alpha, w_main, nonneg, max_cd_steps,
    seed, verbose, mesh, init, ckpt, ring, dev, tdt,
) -> dict:
    """The bucketed route of fit_implicit_als (K3 on a card, the plain
    solves in float64 and under Jacobi PCG, coordinate descent under
    ``nonneg`` or an l1), in the fit's dtype; under ``ring`` each rank
    keeps only its rows of A and B (parallel/ring.py)."""
    (RB, CB), shares = _build_pair(rows, cols, vals, m, n, None, dev, mesh)
    perm_A = profiling.upload(RB.perm, dev)
    perm_B = profiling.upload(CB.perm, dev)

    k_pad = _round_up(k, 8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    sides = _ring_start(RB, CB, mesh, dev, tdt) if ring else None
    side_A, side_B = sides or (None, None)
    A_blocks = init_blocks(gen, RB, k, k_pad, tdt, side_A)
    B_blocks = init_blocks(gen, CB, k, k_pad, tdt, side_B)
    lay_A, lay_B = shares if sides else (RB, CB)  # the blocks' layouts
    if init is not None:
        if init.get("A") is not None:
            _seed_factor_blocks(A_blocks, lay_A, init["A"], k)
        if init.get("B") is not None:
            _seed_factor_blocks(B_blocks, lay_B, init["B"], k)

    lam_vec_A = _make_lam_vec(k, k_pad, lam6[2], 0.0, False, dev, tdt)
    lam_vec_B = _make_lam_vec(k, k_pad, lam6[3], 0.0, False, dev, tdt)
    l1_vec_A = _make_l1_vec(k, k_pad, l16[2], 0.0, False, dev, tdt)
    l1_vec_B = _make_l1_vec(k, k_pad, l16[3], 0.0, False, dev, tdt)

    def state():
        return _sparse_fit_state(*_whole(A_blocks, B_blocks, sides),
                                 perm_A, perm_B, k, False, False)

    RB, CB = shares
    if sides:
        side_B.remap_slots(RB)  # A's slots index B's rows
        side_A.remap_slots(CB)

    try:
        for it in range(niter):
            method = ("cg" if use_cg and not (finalize_chol and it == niter - 1)
                      else "chol")
            t0 = time.time()
            bf16 = _bf16_rows(dev, method, tdt)
            with profiling.span("cmfrec.engine.iter", it=it + 1,
                                compute=_compute(bf16, tdt), method=method):
                A_blocks, B_blocks = _implicit_sparse_iteration(
                    A_blocks, B_blocks, RB, CB, perm_A, perm_B, lam_vec_A,
                    lam_vec_B, l1_vec_A, l1_vec_B, w_main, alpha, m=m, n=n,
                    method=method, max_cg_steps=max_cg_steps,
                    mxu_bf16=bf16, precondition=precondition_cg,
                    nonneg=nonneg, max_cd_steps=max_cd_steps, mesh=mesh,
                    ring=sides)
            if verbose:
                _fence(dev)
                print(f"iter {it + 1}/{niter} [{method}] "
                      f"{time.time() - t0:.3f}s")
            ckpt.maybe_save(it + 1, lambda: _host(state()))
    except KeyboardInterrupt:
        if not should_handle_interrupt():
            raise
        print("interrupted — returning partially-fit model")

    out = state()
    out.update({"glob_mean": 0.0, "k": k, "w_main_multiplier": w_main,
                "alpha": alpha})
    return out


def _implicit_sparse_iteration(
    A_blocks, B_blocks, RB, CB, perm_A, perm_B, lam_vec_A, lam_vec_B,
    l1_vec_A, l1_vec_B, w_main, alpha, *, m, n, method, max_cg_steps,
    mxu_bf16, precondition, nonneg, max_cd_steps, mesh=None, ring=None,
):
    """One full WRMF iteration over bucketed data, B half-step then A
    (upstream cmfrec src/collective.c:9927 precedes :9981), with the
    shared Gram base G0 = w * opp^T opp (a sum over the ranks' shards
    under ``ring``, the (A, B) RingSides of a big-axis fit)."""
    common = dict(w=w_main, alpha=alpha, method=method,
                  n_steps=max_cg_steps, mxu_bf16=mxu_bf16,
                  precondition=precondition, nonneg=nonneg,
                  max_cd_steps=max_cd_steps)
    if ring is None:
        common["mesh"] = mesh
    else:
        common["ring_mesh"] = mesh
    side_A, side_B = (None, None) if ring is None else ring

    def opposing(blocks, perm, side):
        return (blocks_to_orig(blocks, perm) if side is None
                else side.shard(blocks))

    A_orig = opposing(A_blocks, perm_A, side_A)
    B_blocks = update_side(
        SidePlan(CB, "implicit", m), B_blocks, A_orig, None, lam_vec_B,
        G0=w_main * row_sum(gram_matrix, side_A, mesh, A_orig),
        l1_vec=l1_vec_B, **common)
    B_orig = opposing(B_blocks, perm_B, side_B)
    A_blocks = update_side(
        SidePlan(RB, "implicit", n), A_blocks, B_orig, None, lam_vec_A,
        G0=w_main * row_sum(gram_matrix, side_B, mesh, B_orig),
        l1_vec=l1_vec_A, **common)
    return A_blocks, B_blocks
