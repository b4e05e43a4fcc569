"""cmfrec_torch's bucketed collective route against cmfrec_tpu's.

On the CPU, cmfrec_tpu's fit_collective_explicit_als and
fit_collective_implicit_als take their bucketed route (the dense one is
gated on a TPU), so each case calls the JAX driver and the port's
_fit_collective_*_bucketed on the same numpy inputs and the same init= (all
eight keys: jax.random and torch draw different numbers).  Both run in f32.

Tolerances (max |difference|, factors of order 1): Cholesky 1e-5, the same
f32 arithmetic in another summation order; CG 1e-4, since three truncated
CG steps from the same start amplify those roundings.

NA_as_zero_uncentered under CG read 1.05e-4 at two iterations, on one row
of A: the two packages' f32 inputs to its second A half-step differ by
their roundings (G 1.6e-7 and rhs 4e-7 relative, the warm start 1.1e-6),
no row freezes at another step, and three CG steps in exact arithmetic
from inputs perturbed by those amounts spread by 3.3e-4 on that row.  Its
CG case runs one iteration in f32 (3.0e-6; the other CG cases read <=
3.1e-6 at two), test_na0_uncentered_cg_matches_jax_in_float64 holds the
two iterations in float64 at 1e-8, and
test_na0_uncentered_cg_two_iterations_in_float32 holds them in f32 at 1e-3,
about three times that spread.
"""

import numpy as np
import pytest
import torch

from cmfrec_torch.ops import rowsolve, sparse_cg
from cmfrec_torch.solvers import als, collective
from cmfrec_torch.solvers import drivers as port_drivers
from cmfrec_torch.utils.checkpoint import load_fit_checkpoint
from cmfrec_tpu.solvers import collective as jax_collective

M, N, P, Q, K = 70, 50, 12, 7, 4
TOL = {"chol": 1e-5, "cg": 1e-4}
FACTORS = ("A", "B", "C", "D", "Ai", "Bi", "biasA", "biasB")


def _coo_side(dense):
    """An ingested side tuple of a matrix with NaN for missing entries (what
    _BaseModel._ingest_side makes of it)."""
    rr, cc = np.nonzero(~np.isnan(dense))
    return (rr, cc, dense[rr, cc], dense.shape[0], dense.shape[1], False,
            None)


def _dense_side(dense):
    return (None, None, None, dense.shape[0], dense.shape[1], True, dense)


def _data(side="sparse", seed=5, m=M, n=N):
    """Deduplicated ratings, weights, and U/I side tuples: ``sparse`` (30%
    / 40% observed), ``nan`` (a dense U with 20% NaN holes), ``short`` (a dense
    U of m - 20 rows), ``long`` (a dense U of m + 15 rows), ``one_hot``
    (U's observed entries set to 1, for NA-as-zero)."""
    rng = np.random.default_rng(seed)
    pairs = np.unique(rng.integers(0, m * n, 900))
    rows, cols = pairs // n, pairs % n
    vals = rng.normal(3.0, 1.0, rows.size)
    wgt = rng.uniform(0.5, 2.0, rows.size)
    U = rng.normal(size=(m, P)) + 0.2
    I = rng.normal(size=(n, Q)) - 0.1
    U[rng.uniform(size=U.shape) > 0.3] = np.nan
    I[rng.uniform(size=I.shape) > 0.4] = np.nan
    if side == "one_hot":
        U = np.where(np.isnan(U), np.nan, 1.0)
    side_U, side_I = _coo_side(U), _coo_side(I)
    if side == "nan":
        full = rng.normal(size=(m, P))
        full[rng.uniform(size=full.shape) < 0.2] = np.nan
        side_U = _coo_side(full)
    elif side == "short":
        side_U = _dense_side(rng.normal(size=(m - 20, P)))
    elif side == "long":
        side_U = _dense_side(rng.normal(size=(m + 15, P)))
    return rng, rows, cols, vals, wgt, side_U, side_I


def _init(rng, m_eff, n_eff, ka, kb, kc, kd, ki, implicit=False):
    init = {"A": rng.normal(size=(m_eff, ka)),
            "B": rng.normal(size=(n_eff, kb)),
            "C": rng.normal(size=(P, kc)), "D": rng.normal(size=(Q, kd))}
    if not implicit:
        init.update(Ai=rng.normal(size=(m_eff, ki)),
                    Bi=rng.normal(size=(n_eff, ki)),
                    biasA=0.1 * rng.normal(size=m_eff),
                    biasB=0.1 * rng.normal(size=n_eff))
    return {key: (0.5 * v).astype(np.float32) for key, v in init.items()}


def port_explicit(rows, cols, vals, m, n, *, side_U=None, side_I=None,
                  center_U=True, center_I=True, NA_as_zero_user=False,
                  NA_as_zero_item=False, lambda_=1.0, **kw):
    """The port's bucketed body on the public driver's arguments."""
    U = collective.prepare_side(
        collective._sparsify_short_dense_side(side_U, m), center_U,
        NA_as_zero_user)
    I = collective.prepare_side(
        collective._sparsify_short_dense_side(side_I, n), center_I,
        NA_as_zero_item)
    args = dict(k_user=0, k_item=0, k_main=0, w_main=1.0, w_user=1.0,
                w_item=1.0, w_implicit=0.5, add_implicit_features=False,
                niter=10, use_cg=True, max_cg_steps=3, finalize_chol=True,
                user_bias=True, item_bias=True, center=True, scale_lam=False,
                scale_lam_sideinfo=False, scale_bias_const=False,
                NA_as_zero=False, weights=None, seed=1, verbose=False,
                device="cpu", init=None, checkpoint_path=None,
                checkpoint_every=0)
    args.update(kw)
    return collective._fit_collective_explicit_bucketed(
        rows, cols, vals, m, n, U=U, I=I,
        lam6=port_drivers._resolve_lambdas(lambda_, 0.0)[0], **args)


def port_implicit(rows, cols, vals, m, n, *, side_U=None, side_I=None,
                  center_U=True, center_I=True, NA_as_zero_user=False,
                  NA_as_zero_item=False, lambda_=1.0, w_main=1.0, **kw):
    U = collective.prepare_side(
        collective._sparsify_short_dense_side(side_U, m), center_U,
        NA_as_zero_user)
    I = collective.prepare_side(
        collective._sparsify_short_dense_side(side_I, n), center_I,
        NA_as_zero_item)
    args = dict(k_user=0, k_item=0, k_main=0, w_user=1.0, w_item=1.0,
                alpha=1.0, niter=10, use_cg=True, max_cg_steps=3,
                finalize_chol=False, seed=1, verbose=False, device="cpu",
                init=None, checkpoint_path=None, checkpoint_every=0)
    args.update(kw)
    return collective._fit_collective_implicit_bucketed(
        rows, cols, np.asarray(vals, np.float64), m, n, U=U, I=I,
        lam6=port_drivers._resolve_lambdas(lambda_, 0.0)[0], w_x=w_main,
        w_mult=1.0, **args)


def _compare(rj, rt, tol, keys=FACTORS):
    compared = 0
    for key in keys:
        if rj.get(key) is None:
            assert rt.get(key) is None, key
            continue
        np.testing.assert_allclose(rt[key].numpy(), np.asarray(rj[key]),
                                   rtol=0, atol=tol, err_msg=key)
        compared += 1
    return compared


# explicit cases: (data kind, fit arguments, uses weights)
EXPLICIT = {
    "sparse_U_I": ("sparse", dict(), False),
    "U_with_nan": ("nan", dict(), False),
    "U_fewer_rows": ("short", dict(), False),
    "U_more_rows": ("long", dict(), False),
    "k_splits": ("sparse", dict(k_user=2, k_item=1, k_main=1), False),
    "w_main_weights": ("sparse", dict(w_main=0.5), True),
    "NA_as_zero": ("sparse", dict(NA_as_zero=True), False),
    "NA_as_zero_uncentered": ("sparse", dict(NA_as_zero=True, center=False),
                              False),
    "NA_as_zero_user": ("one_hot", dict(NA_as_zero_user=True), False),
    "NA_as_zero_user_uncentered": ("one_hot", dict(NA_as_zero_user=True,
                                                   center_U=False), False),
    "NA_as_zero_item": ("sparse", dict(NA_as_zero_item=True), False),
    "NA_as_zero_item_uncentered": ("sparse", dict(NA_as_zero_item=True,
                                                  center_I=False), False),
    "implicit_features_weights": ("sparse", dict(add_implicit_features=True),
                                  True),
    "scale_lam_bias_const": ("sparse", dict(scale_lam=True,
                                            scale_bias_const=True), False),
    "scale_lam_sideinfo_bias_const": ("long", dict(
        scale_lam_sideinfo=True, scale_bias_const=True), False),
}


@pytest.mark.parametrize("solver", ["chol", "cg"])
@pytest.mark.parametrize("case", list(EXPLICIT))
def test_explicit_matches_jax(case, solver):
    kind, fit, weighted = EXPLICIT[case]
    rng, rows, cols, vals, wgt, side_U, side_I = _data(kind)
    ku, ki_, km = (fit.get(key, 0) for key in ("k_user", "k_item", "k_main"))
    m_eff = max(M, side_U[3])
    init = _init(rng, m_eff, N, ku + K + km, ki_ + K + km, ku + K, ki_ + K,
                 K + km)
    kw = dict(k=K, niter=2, lambda_=[0.3, 0.4, 0.9, 0.8, 0.6, 0.7],
              w_user=0.8, w_item=1.3, use_cg=solver == "cg",
              finalize_chol=False, weights=wgt if weighted else None,
              side_U=side_U, side_I=side_I, init=init, **fit)
    if case == "NA_as_zero_uncentered" and solver == "cg":
        kw["niter"] = 1  # see the module's notes
    rj = jax_collective.fit_collective_explicit_als(
        rows, cols, vals, M, N, dtype=np.float32, **kw)
    rt = port_explicit(rows, cols, vals, M, N, **kw)
    assert _compare(rj, rt, TOL[solver]) >= 4
    assert rt["A"].shape[0] == m_eff
    for key in ("U_colmeans", "I_colmeans"):
        np.testing.assert_array_equal(rt[key], rj[key])
    for key in ("scaling_biasA", "scaling_biasB", "glob_mean"):
        assert rt[key] == pytest.approx(rj[key], rel=1e-12), key


def test_na0_uncentered_cg_matches_jax_in_float64():
    """NA_as_zero_uncentered under CG, two iterations, in float64 through
    both packages' public collective drivers from one init=: every factor
    within 1e-8 of max|cmfrec_tpu's| (readings <= 1.5e-13)."""
    kind, fit, _ = EXPLICIT["NA_as_zero_uncentered"]
    rng, rows, cols, vals, _, side_U, side_I = _data(kind)
    init = {key: v.astype(np.float64)
            for key, v in _init(rng, M, N, K, K, K, K, K).items()}
    kw = dict(k=K, niter=2, lambda_=[0.3, 0.4, 0.9, 0.8, 0.6, 0.7],
              w_user=0.8, w_item=1.3, use_cg=True, finalize_chol=False,
              side_U=side_U, side_I=side_I, init=init, dtype=np.float64,
              **fit)
    rj = jax_collective.fit_collective_explicit_als(rows, cols, vals, M, N,
                                                    **kw)
    rt = collective.fit_collective_explicit_als(rows, cols, vals, M, N,
                                                device="cpu", **kw)
    for key in ("A", "B", "C", "D", "biasA", "biasB"):
        want = np.asarray(rj[key])
        assert rt[key].dtype == torch.float64, key
        assert (np.abs(rt[key].numpy() - want).max()
                <= 1e-8 * np.abs(want).max()), key


def test_na0_uncentered_cg_two_iterations_in_float32():
    """NA_as_zero_uncentered under CG, two iterations in f32, as
    test_explicit_matches_jax ran it: within 1e-3, about three times the
    3.3e-4 by which three CG steps spread from the packages' f32 input
    roundings (the module's notes); reading 1.05e-4."""
    kind, fit, _ = EXPLICIT["NA_as_zero_uncentered"]
    rng, rows, cols, vals, _, side_U, side_I = _data(kind)
    init = _init(rng, M, N, K, K, K, K, K)
    kw = dict(k=K, niter=2, lambda_=[0.3, 0.4, 0.9, 0.8, 0.6, 0.7],
              w_user=0.8, w_item=1.3, use_cg=True, finalize_chol=False,
              side_U=side_U, side_I=side_I, init=init, **fit)
    rj = jax_collective.fit_collective_explicit_als(
        rows, cols, vals, M, N, dtype=np.float32, **kw)
    rt = port_explicit(rows, cols, vals, M, N, **kw)
    assert _compare(rj, rt, 1e-3) >= 4


IMPLICIT = {
    "sparse_U": ("sparse", dict(side_I=None)),
    "NA_as_zero_item": ("sparse", dict(NA_as_zero_item=True)),
    "U_more_rows_k_splits": ("long", dict(k_user=1, k_main=2)),
}


@pytest.mark.parametrize("solver", ["chol", "cg"])
@pytest.mark.parametrize("case", list(IMPLICIT))
def test_implicit_matches_jax(case, solver):
    kind, fit = IMPLICIT[case]
    rng, rows, cols, vals, _, side_U, side_I = _data(kind)
    vals = np.abs(vals) + 0.5
    ku, ki_, km = (fit.get(key, 0) for key in ("k_user", "k_item", "k_main"))
    m_eff = max(M, side_U[3])
    init = _init(rng, m_eff, N, ku + K + km, ki_ + K + km, ku + K, ki_ + K,
                 0, implicit=True)
    kw = dict(k=K, niter=2, lambda_=[0.0, 0.0, 0.9, 0.8, 0.6, 0.7],
              alpha=1.5, w_user=0.8, w_item=1.3, use_cg=solver == "cg",
              side_U=side_U, side_I=side_I, init=init)
    kw.update(fit)
    rj = jax_collective.fit_collective_implicit_als(
        rows, cols, vals, M, N, dtype=np.float32, w_main=0.7, **kw)
    rt = port_implicit(rows, cols, vals, M, N, w_main=0.7, **kw)
    assert _compare(rj, rt, TOL[solver], ("A", "B", "C", "D")) >= 3
    for key in ("U_colmeans", "I_colmeans"):
        np.testing.assert_array_equal(rt[key], rj[key])


def test_public_implicit_driver_weights_the_main_part():
    """fit_collective_implicit_als takes the bucketed route for sparse side
    info and weights the X part by w_main times adjust_weight's nnz/(m*n)."""
    rng, rows, cols, vals, _, side_U, _ = _data()
    vals = np.abs(vals) + 0.5
    init = _init(rng, M, N, K, K, K, K, 0, implicit=True)
    kw = dict(k=K, niter=2, side_U=side_U, w_main=0.6, adjust_weight=True,
              apply_log_transf=True, init=init)
    rj = jax_collective.fit_collective_implicit_als(
        rows, cols, vals, M, N, dtype=np.float32, **kw)
    rt = collective.fit_collective_implicit_als(rows, cols, vals, M, N,
                                                device="cpu", **kw)
    _compare(rj, rt, TOL["cg"], ("A", "B", "C"))
    assert rt["w_main_multiplier"] == pytest.approx(rj["w_main_multiplier"])


def _bucket_parts(seed=3, R=24, K_=16):
    """Three sparse parts of one bucket, each over its own opposing matrix,
    as the collective A systems have them (X, a side part, implicit
    features), with ragged lengths and some empty rows."""
    g = torch.Generator().manual_seed(seed)
    parts, sparse = [], []
    for S, L in ((40, 16), (12, 8), (40, 16)):
        mat = torch.randn(S, K_, generator=g)
        length = torch.randint(0, L + 1, (R,), generator=g, dtype=torch.int32)
        length[:2] = 0
        idx = torch.randint(0, S, (R, L), generator=g, dtype=torch.int32)
        mask = rowsolve.length_mask(length, L).float()
        cw = torch.rand(R, L, generator=g) * mask
        cv = torch.randn(R, L, generator=g) * mask
        parts.append(als.PartData(idx=idx, val=cv, length=length, wgt=None,
                                  opp=mat, opp_bias=None, w=1.0, alpha=None,
                                  mu=None))
        sparse.append(rowsolve.SparsePart(mat, idx, cw, cv))
    return parts, sparse, g


@pytest.mark.parametrize("with_lam_row", [False, True])
def test_stacked_parts_twin_matches_jax_separate_parts(with_lam_row):
    """The CUDA path's layout on the CPU: the parts stacked into one K3 part
    through stack_slots / stacked_part, solved by bucket_cg's twin, against
    cmfrec_tpu's rowsolve.solve_cg over the separate parts."""
    import jax.numpy as jnp
    from cmfrec_tpu.ops import rowsolve as jrs

    parts, sparse, g = _bucket_parts()
    R, K_ = parts[0].idx.shape[0], parts[0].opp.shape[1]
    st = als.stack_slots(tuple(parts))
    assert torch.equal(st.length, sum(p.length for p in parts))
    assert st.idx.shape[1] % 8 == 0
    mat = torch.cat([p.opp for p in parts])
    sp = als.stacked_part(sparse, mat, st)
    lam = torch.rand(K_, generator=g) + 0.5
    G0 = torch.randn(K_, K_, generator=g)
    G0 = G0 @ G0.T / K_
    r0 = torch.randn(R, K_, generator=g)
    a0 = torch.randn(R, K_, generator=g)
    mult = torch.rand(R, generator=g) * 5 + 1 if with_lam_row else None
    lam_row = None if mult is None else lam[None, :] * mult[:, None]
    gfix = G0 if with_lam_row else G0 + torch.diag(lam)
    got = sparse_cg.bucket_cg(mat, sp.idx, sp.cw, sp.cv, gfix, lam_row, r0,
                              a0, n_steps=3, length=st.length)

    def j(t):
        return None if t is None else jnp.asarray(t.numpy())

    want = jrs.solve_cg(
        [jrs.SparsePart(j(p.mat), j(p.idx), j(p.cw), j(p.cv))
         for p in sparse], j(lam), j(a0), n_steps=3, lam_mult=j(mult),
        G0=j(G0), r0=j(r0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_stack_slots_keeps_each_part_in_order():
    parts, sparse, _ = _bucket_parts(seed=4)
    st = als.stack_slots(tuple(parts))
    off = np.cumsum([0] + [p.opp.shape[0] for p in parts])
    for r in range(parts[0].idx.shape[0]):
        want = np.concatenate([p.idx[r, :int(p.length[r])].numpy() + o
                               for p, o in zip(parts, off)])
        got = st.idx[r, :int(st.length[r])].numpy()
        np.testing.assert_array_equal(got, want)
        assert (st.idx[r, int(st.length[r]):] == 0).all()
    sp = als.stacked_part(sparse, torch.cat([p.opp for p in parts]), st)
    for got, want in ((sp.cw, [s.cw for s in sparse]),
                      (sp.cv, [s.cv for s in sparse])):
        np.testing.assert_allclose(got.sum(1).numpy(),
                                   sum(x.sum(1) for x in want).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_checkpoint_resume_is_exact(tmp_path):
    """A bucketed collective fit checkpointed after 2 of 4 iterations and
    resumed from the file for 2 more ends where the straight fit ends."""
    rng, rows, cols, vals, wgt, side_U, side_I = _data()
    kw = dict(k=K, lambda_=0.7, side_U=side_U, side_I=side_I,
              add_implicit_features=True, finalize_chol=False)
    full = port_explicit(rows, cols, vals, M, N, niter=4, **kw)
    path = str(tmp_path / "ckpt.npz")
    port_explicit(rows, cols, vals, M, N, niter=4, checkpoint_path=path,
                  checkpoint_every=2, **kw)
    init, done = load_fit_checkpoint(path)
    assert done == 2 and set(FACTORS) <= set(init)
    resumed = port_explicit(rows, cols, vals, M, N, niter=2, init=init, **kw)
    for key in FACTORS:
        np.testing.assert_allclose(resumed[key].numpy(), full[key].numpy(),
                                   rtol=0, atol=1e-6, err_msg=key)


def test_public_driver_routes():
    """Dense side info with no bucketed-only option rides the dense engine
    (no scaling_biasA key); sparse side info, k splits, or a warm start
    with C take the bucketed route."""
    rng, rows, cols, vals, _, _, _ = _data()
    U = _dense_side(rng.normal(size=(M, P)))
    base = dict(k=K, niter=1, device="cpu")
    dense = collective.fit_collective_explicit_als(rows, cols, vals, M, N,
                                                   side_U=U, **base)
    assert "scaling_biasA" not in dense
    for extra in (dict(k_main=1), dict(init={"C": np.ones((P, K))}),
                  dict(NA_as_zero_user=True)):
        res = collective.fit_collective_explicit_als(
            rows, cols, vals, M, N, side_U=U, **base, **extra)
        assert "scaling_biasA" in res, extra


@pytest.mark.parametrize("case", ["sparse_U_I", "implicit_features_weights",
                                  "NA_as_zero_user"])
def test_several_parts_take_the_stacked_layout(case, monkeypatch):
    """A fit's CG over several parts runs one stacked part a bucket (the
    slot maps of update_side into bucket_cg, its twin here), as on a card,
    and matches cmfrec_tpu's solve_cg over the separate parts."""
    kind, fit, weighted = EXPLICIT[case]
    rng, rows, cols, vals, wgt, side_U, side_I = _data(kind)
    init = _init(rng, M, N, K, K, K, K, K)
    kw = dict(k=K, niter=2, lambda_=0.6, finalize_chol=False,
              weights=wgt if weighted else None, side_U=side_U,
              side_I=side_I, init=init, **fit)
    stacked_calls = []
    real = als.stacked_part
    monkeypatch.setattr(als, "stacked_part",
                        lambda *a: stacked_calls.append(1) or real(*a))
    stacked = port_explicit(rows, cols, vals, M, N, **kw)
    assert stacked_calls
    rj = jax_collective.fit_collective_explicit_als(
        rows, cols, vals, M, N, dtype=np.float32, **kw)
    _compare(rj, stacked, TOL["cg"])


@pytest.mark.parametrize("scale_lam", [False, True])
def test_solve_bucket_stacks_several_parts_itself(scale_lam):
    """solve_bucket given several parts and no slot map builds the stacked
    layout itself and agrees with rowsolve.solve_cg over the separate
    parts, empty rows solving to zero."""
    parts, _, g = _bucket_parts()
    R, K_ = parts[0].idx.shape[0], parts[0].opp.shape[1]
    lam = torch.rand(K_, generator=g) + 0.5
    a0 = torch.randn(R, K_, generator=g)
    modes, n_totals = ("explicit",) * 3, (40, 12, 40)
    got = als.solve_bucket(tuple(parts), a0, None, None, None, lam, None,
                           modes=modes, method="cg", n_steps=3,
                           scale_lam=scale_lam, n_totals=n_totals)
    sparse = [als._coefficients(p, md) for p, md in zip(parts, modes)]
    mult = None
    if scale_lam:
        mult = torch.clamp(sum(als._lam_multiplier(p, md, nt) for p, md, nt
                               in zip(parts, modes, n_totals)), min=1.0)
    want = rowsolve.solve_cg(sparse, lam, a0, n_steps=3, lam_mult=mult)
    live = sum(p.length for p in parts) > 0
    assert not live.all()
    want = torch.where(live[:, None], want, 0.0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)
