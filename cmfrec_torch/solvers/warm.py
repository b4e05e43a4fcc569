"""Warm- and cold-start factors of fitted models (port of
cmfrec_tpu/solvers/warm.py).

The reference's collective_factors_warm / collective_factors_cold /
factors_implicit (upstream cmfrec src/collective.c:3555,3309,
src/common.c:2063) as batched closed-form solves: new rows never use CG
(the reference notes CG "should not be used for new data",
src/common.c:650).  The JAX package reaches no Pallas kernel here, and the
port writes none: row gathers, batched Grams (``rowsolve.assemble_system``)
and ``torch.linalg.cholesky_ex`` on the model's ``device``.

build_precomputed assembles the prediction caches of
precompute_collective_explicit (src/collective.c:10209) in float64 on the
host, as the JAX package does.  Each matrix a solve needs is uploaded to
the device once, as f32, and reused for as long as the model holds the
array it was made from (compared by identity, never by ``id()``).  Serving
runs in f32 whatever the model's ``dtype_``: a model loaded from a
cmfrec_tpu float64 checkpoint is served in f32 too.

A batch's result on the device is one [R, w + 2] f32 tensor: the w =
k_user + k + k_main factors, the user bias, and the Cholesky ``info`` of
each row (0 where its factorization succeeded).  ``download`` copies it to
the host once and raises if a row failed.

The offsets models (OMF_explicit, OMF_implicit, ContentBased) serve
through ``offsets_warm_batch`` and binary side information through
``factors_bin_batch`` (one L-BFGS over all the rows, solvers/lbfgs_core.py);
both run in the model's dtype (float64 for a float64 model, as cmfrec_tpu)
on the model's device.

Not here yet: nonneg and l1_lambda, which need rowsolve.solve_cd (ROADMAP
slice 4 item 10).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops import rowsolve
from ..ops.rowsolve import SparsePart, length_mask
from .dense_masked import _round_up
from .drivers import _resolve_lambdas, _unsupported

SLICE_CD = "slice 4 item 10, the coordinate-descent solver rowsolve.solve_cd"


def _count(model, key):
    """Which branch served a call (``model._cache_stats``, as cmfrec_tpu)."""
    stats = model.__dict__.setdefault("_cache_stats", {})
    stats[key] = stats.get(key, 0) + 1


def _same(a, b) -> bool:
    """Tokens are equal: arrays by identity, scalars and bytes by value."""
    return len(a) == len(b) and all(
        x is y or (isinstance(x, (bool, int, float, bytes)) and x == y)
        for x, y in zip(a, b))


def _sources(model) -> tuple:
    """The fitted state the prediction caches are built from."""
    return (model.B_, getattr(model, "C_", None), getattr(model, "Bi_", None),
            model.item_bias_, getattr(model, "U_colmeans_", None),
            float(model.glob_mean_))


def precomputed(model) -> dict:
    """The model's prediction caches; {} when there are none or they were
    built from other arrays than the model holds now (a ``B_`` replaced
    after the fit), so that the solves take their uncached branches."""
    pre = getattr(model, "_precomputed", None) or {}
    if pre and not _same(pre.get("sources", ()), _sources(model)):
        return {}
    return pre


def _dev(model, name, arr, token=None, dtype=np.float32):
    """Copy of the host array ``arr`` on the model's device (f32 unless
    ``dtype`` says otherwise), kept in the model's device cache under
    ``name`` while ``token`` (default: the array itself, by identity) and
    the device are unchanged."""
    token = (arr,) if token is None else token
    cache = model.__dict__.setdefault("_device_cache", {})
    key = "warm:" + name + ("" if np.dtype(dtype) == np.float32
                            else ":" + np.dtype(dtype).name)
    hit = cache.get(key)
    if hit is None or hit[1] != model.device or not _same(hit[0], token):
        cache[key] = (token, model.device, torch.as_tensor(
            np.asarray(arr, dtype), device=resolve_device(model.device)))
    return cache[key][2]


def _small(model, name, arr):
    """A small f32 vector on the device, cached by value."""
    arr = np.asarray(arr, np.float64)
    return _dev(model, name, arr, token=(arr.tobytes(),))


def _upload(arr, dtype, dev):
    return torch.as_tensor(np.ascontiguousarray(arr, dtype), device=dev)


def _width(model) -> int:
    return (getattr(model, "k_user", 0) + model.k
            + getattr(model, "k_main", 0))


def _ext_B(model):
    """Extended opposing matrix for a new-user solve: coordinates
    [k_user | k | k_main | bias] built from B[:, k_item:] (+ ones), padded
    to a multiple of 8.  Served from the precompute when present."""
    pre = precomputed(model)
    if "extB" in pre:
        return pre["extB"], pre["width"], pre["k_pad"], pre["user_bias"]
    ku = getattr(model, "k_user", 0)
    user_bias = model.user_bias_ is not None
    width = _width(model)
    k_pad = _round_up(width + 1, 8)
    B = np.asarray(model.B_, np.float64)
    ext = np.zeros((B.shape[0], k_pad))
    ext[:, ku:width] = B[:, getattr(model, "k_item", 0):]
    if user_bias:
        ext[:, width] = 1.0
    return ext, width, k_pad, user_bias


def _ext_B_dev(model, ext, k_pad, user_bias):
    return _dev(model, "extB", ext, token=(model.B_, user_bias, k_pad))


def _ext_C(model, k_pad):
    """C occupies coordinates [0 : k_user + k] of the user system."""
    pre = precomputed(model)
    if "extC" in pre and pre["extC"].shape[1] == k_pad:
        return pre["extC"]
    C = np.asarray(model.C_, np.float64)
    ext = np.zeros((C.shape[0], k_pad))
    ext[:, :C.shape[1]] = C
    return ext


def _pad_sq(M, k_pad):
    if M.shape[0] == k_pad:
        return M
    out = np.zeros((k_pad, k_pad))
    out[:M.shape[0], :M.shape[1]] = M
    return out


def _trans_btb_inv_bt(model):
    """Lazy TransBtBinvBt = (w BtB + diag(lam))^-1 w extB^T
    (src/collective.c:10363): built on first use and kept in the
    precompute."""
    pre = precomputed(model)
    if "TransBtBinvBt" in pre:
        return pre["TransBtBinvBt"]
    if "TransBtBinvBt_G" not in pre:
        return None
    w_main = float(getattr(model, "w_main", 1.0)) * float(
        getattr(model, "w_main_multiplier_", 1.0))
    pre["TransBtBinvBt"] = np.linalg.solve(pre["TransBtBinvBt_G"],
                                           w_main * pre["extB"].T)
    return pre["TransBtBinvBt"]


def _reject_cd(model, l16):
    if getattr(model, "nonneg", False) or np.any(l16 > 0):
        raise _unsupported("warm and cold factors of a model with nonneg or "
                           "l1_lambda", SLICE_CD)


def _result(a, kw, bias_col, info=None):
    """[R, kw + 2]: factors, bias (0 without one), Cholesky info."""
    R = a.shape[0]
    bias = (a[:, bias_col:bias_col + 1] if bias_col is not None
            else a.new_zeros(R, 1))
    info = (a.new_zeros(R, 1) if info is None
            else info.to(a.dtype)[:, None])
    return torch.cat([a[:, :kw], bias, info], 1)


def download(out: torch.Tensor):
    """One device-to-host copy of a batch result -> (a [R, w], bias [R]) as
    f32 numpy; raises if any row's Cholesky factorization failed."""
    h = out.cpu().numpy()
    bad = np.flatnonzero(h[:, -1])
    if bad.size:
        raise torch.linalg.LinAlgError(
            f"the Cholesky factorization of {bad.size} new-row system(s) "
            f"failed (first: row {bad[0]}, info {int(h[bad[0], -1])}); "
            "their Gram matrices are not positive definite")
    return h[:, :-2], h[:, -2]


def _full_rows(idx, lengths, n) -> bool:
    """Every row observes every one of the n items, in order."""
    return (idx.shape[1] == n and bool(np.all(np.asarray(lengths) == n))
            and np.array_equal(np.asarray(idx),
                               np.broadcast_to(np.arange(n), idx.shape)))


# ----------------------------------------------------------------------- #
# explicit                                                                 #
# ----------------------------------------------------------------------- #


def _warm_plain(ext, idx, vals, lengths, item_bias, glob_mean, lam_vec,
                lam_const, w_main, scale_lam):
    """Fused plain-warm solve on raw idx/vals (the port of cmfrec_tpu's
    ``_warm_plain_kernel``): mask, residual (mean and item bias), Gram and
    batched Cholesky on the device.  Returns (a [R, K], info [R])."""
    R, L = idx.shape
    msk = length_mask(lengths, L).to(ext.dtype)
    v = vals - glob_mean - item_bias.index_select(0, idx.reshape(-1)).view(R, L)
    cw = w_main * msk
    lam_mult = lengths.clamp(min=1).to(ext.dtype) if scale_lam else None
    # scale_bias_const: the bias coordinate's penalty stays lam_bias *
    # scaling_biasA whatever the row's multiplier (src/common.c:717-722);
    # zeros when unused
    G, rhs = rowsolve.assemble_system(
        [SparsePart(ext, idx, cw, cw * v)], lam_vec, lam_mult=lam_mult,
        G0=torch.diag(lam_const))
    a, info = rowsolve.solve_chol_ex(G, rhs)
    return torch.where(lengths[:, None] == 0, 0.0, a), info


def _u_part(model, U, k_pad, dev):
    """Dense new-user side-info rows (NaN = missing) -> (SparsePart on the
    device, observed counts, extra Gram base [K, K] f64 or None, extra rhs
    base [K] f64 or None).

    Under NA_as_zero_user the missing entries take part with value 0
    (minus the column means): the part carries only the observed entries'
    corrections (cw = 0, cv = w_u * raw value) on top of the shared bases
    w_u CtC and CtUbias (src/collective.c:3389, :10466)."""
    na0_u = bool(getattr(model, "NA_as_zero_user", False))
    U = np.asarray(U, np.float64)
    if model.U_colmeans_ is not None and not na0_u:
        U = U - model.U_colmeans_[None, :]
    R = U.shape[0]
    rows, cols = np.nonzero(~np.isnan(U))
    idx, vals, _, counts = pack_padded_rows(rows, cols, U[rows, cols], None, R)
    Ce = _ext_C(model, k_pad)
    msk = (np.arange(idx.shape[1])[None, :] < counts[:, None]).astype(float)
    w_user = float(getattr(model, "w_user", 1.0))
    G0x = r0x = None
    cv = w_user * vals * msk
    if na0_u:
        cw = np.zeros_like(msk)
        pre = precomputed(model)
        if "CtCw" in pre:
            CtCw = pre["CtCw"]
            _count(model, "ctcw")
        else:
            CtCw = w_user * (Ce.T @ Ce)
        G0x = _pad_sq(CtCw, k_pad)
        if model.U_colmeans_ is not None:
            kc = np.asarray(model.C_).shape[1]
            ctu = (pre["CtUbias"] if "CtUbias" in pre else
                   -w_user * (Ce[:, :kc].T @ np.asarray(model.U_colmeans_)))
            r0x = np.zeros(k_pad)
            r0x[:ctu.shape[0]] = ctu
    else:
        cw = w_user * msk
    part = SparsePart(
        _dev(model, "extC", Ce, token=(model.C_, k_pad)),
        _upload(idx, np.int32, dev), _upload(cw, np.float32, dev),
        _upload(cv, np.float32, dev))
    return part, counts, G0x, r0x


def factors_explicit_batch(model, idx, vals, wgt, lengths, U=None,
                           return_device=False, _no_fused=False):
    """Closed-form warm factors for a batch of new users.

    idx/vals/wgt: [R, L] padded item ids / raw values / weights (wgt may be
    None); lengths: [R] observation counts; U: optional [R, p] dense side
    info (NaN = missing).  Returns (a [R, k_user+k+k_main], bias [R]) as
    numpy, or with ``return_device=True`` the [R, w + 2] device result that
    ``download`` reads (no host sync), so that a caller solving several
    batches downloads once.  ``_no_fused=True`` forces the eager path
    (tests hold the fused one against it)."""
    dev = resolve_device(model.device)
    ext, width, k_pad, user_bias = _ext_B(model)
    lam6, l16 = _resolve_lambdas(model.lambda_,
                                 getattr(model, "l1_lambda", 0.0))
    _reject_cd(model, l16)
    kw = _width(model)
    pre = precomputed(model)
    bias_col = width if user_bias else None
    idx = np.asarray(idx)
    R, L = idx.shape
    n = ext.shape[0]
    has_bi = getattr(model, "Bi_", None) is not None
    na0 = bool(getattr(model, "NA_as_zero", False))
    scaled = bool(getattr(model, "scale_lam", False)
                  or getattr(model, "scale_lam_sideinfo", False))
    bias_const = scaled and user_bias and bool(
        getattr(model, "scale_bias_const", False))
    w_main = float(getattr(model, "w_main", 1.0))

    def finish(out):
        return out if return_device else download(out)

    # Cold rows through the TransCtCinvCt cache: ONE matmul, no
    # factorization (src/collective.c:3389).  The reference dispatches to
    # collective_factors_cold only without implicit features
    # (collective.c:3656); with Bi the cold rows take the warm path below.
    if (L == 0 and U is not None and "TransCtCinvCt" in pre and not has_bi
            and not na0 and not getattr(model, "NA_as_zero_user", False)):
        Uarr = np.asarray(U, np.float64)
        if not np.isnan(Uarr).any():
            if model.U_colmeans_ is not None:
                Uarr = Uarr - np.asarray(model.U_colmeans_)[None, :]
            T = _dev(model, "TransCtCinvCt", pre["TransCtCinvCt"])  # [kc, p]
            a = torch.zeros(R, kw, device=dev)
            a[:, :T.shape[0]] = _upload(Uarr, np.float32, dev) @ T.T
            _count(model, "cold_matmul")
            return finish(_result(a, kw, None))

    # Fully observed unweighted rows (dense transform workloads): ONE
    # matmul through the lazy TransBtBinvBt (collective.c:10363, :3790).
    dense_trans = (wgt is None and not na0 and U is None and not scaled
                   and "TransBtBinvBt_G" in pre and _full_rows(idx, lengths, n))

    # The fused path (the common serving shape): mask, centring, item-bias
    # gather and coefficients move to the device, fed by raw int32 idx and
    # f32 vals.  Unlike cmfrec_tpu's gate it admits scale_lam models, whose
    # scale_lam_sideinfo (implied by scale_lam) changes nothing without U.
    if (not _no_fused and L > 0 and wgt is None and U is None and not has_bi
            and not na0 and not dense_trans):
        lam_np = np.ones(k_pad)
        lam_np[:kw] = lam6[2]
        lam_const = np.zeros(k_pad)
        if user_bias:
            lam_np[width] = lam6[0]
            if bias_const:
                # the bias penalty held at lam_bias * scaling_biasA
                # (common.c:717-722; scaling = fit-time wsum/m,
                # collective.c:3787)
                lam_np[width] = 0.0
                lam_const[width] = lam6[0] * float(
                    getattr(model, "scaling_biasA_", 0.0))
        ib = (np.zeros(n) if model.item_bias_ is None else model.item_bias_)
        a, info = _warm_plain(
            _ext_B_dev(model, ext, k_pad, user_bias),
            _upload(idx, np.int32, dev), _upload(vals, np.float32, dev),
            _upload(lengths, np.int32, dev),
            _dev(model, "item_bias", ib, token=(model.item_bias_, n)),
            float(model.glob_mean_), _small(model, "lam_warm", lam_np),
            _small(model, "lam_const_warm", lam_const), w_main, scaled)
        _count(model, "warm_fused")
        return finish(_result(a, kw, bias_col, info))

    lengths = np.asarray(lengths)
    msk = (np.arange(max(L, 1))[None, :] < lengths[:, None]).astype(float)
    v = np.asarray(vals, np.float64) - model.glob_mean_
    if model.item_bias_ is not None and L > 0:
        v = v - np.asarray(model.item_bias_, np.float64)[idx]
    ww = np.ones((R, L)) if wgt is None else np.asarray(wgt, np.float64)

    if dense_trans:
        T = _trans_btb_inv_bt(model)
        a = _upload(v, np.float32, dev) @ _dev(model, "TransBtBinvBt", T).T
        _count(model, "warm_dense_matmul")
        return finish(_result(a, kw, bias_col))

    ext_d = _ext_B_dev(model, ext, k_pad, user_bias)
    parts = []
    G0 = None  # shared [K, K] Gram base, f64 on the host
    r0 = None  # shared [K] rhs base, f64 on the host
    if L > 0:
        if na0:
            cw = w_main * (ww - 1.0) * msk
            base = model.glob_mean_ + (
                np.asarray(model.item_bias_, np.float64)[idx]
                if model.item_bias_ is not None else 0.0)
            cv = w_main * (ww * v + base) * msk
        else:
            cw = w_main * ww * msk
            cv = cw * v
        parts.append(SparsePart(ext_d, _upload(idx, np.int32, dev),
                                _upload(cw, np.float32, dev),
                                _upload(cv, np.float32, dev)))
    if na0:
        if "BtBw" in pre and "BtXbias" in pre:
            # served from the precompute (src/collective.c:10300-10352)
            G0, r0 = pre["BtBw"], pre["BtXbias"]
            _count(model, "na0_base")
        else:
            G0 = w_main * (ext.T @ ext)
            t = -model.glob_mean_ * np.ones(n)
            if model.item_bias_ is not None:
                t = t - model.item_bias_
            r0 = w_main * (ext.T @ t)

    # implicit features (add_implicit_features): Xones ~ a[ku:] Bi^T taken
    # NA-as-zero, Gram base w_imp BiTBi, rhs w_imp * sum of observed Bi_j
    # (src/collective.c:1428-1443, BiTBi at :1465).  The base applies to
    # cold (L == 0) rows too: with implicit features the reference solves
    # them on the warm path (collective.c:3656, :1487).
    if has_bi:
        Bi = np.asarray(model.Bi_, np.float64)
        ku = getattr(model, "k_user", 0)
        kiw = Bi.shape[1]
        wi = float(getattr(model, "w_implicit", 0.5))
        if "extBi" in pre and "BiTBi" in pre:
            ext_bi, Gi = pre["extBi"], pre["BiTBi"]
            _count(model, "bitbi")
        else:
            ext_bi = np.zeros((Bi.shape[0], k_pad))
            ext_bi[:, ku:ku + kiw] = Bi
            Gi = np.zeros((k_pad, k_pad))
            Gi[ku:ku + kiw, ku:ku + kiw] = wi * (Bi.T @ Bi)
        G0 = Gi if G0 is None else G0 + Gi
        if L > 0:
            parts.append(SparsePart(
                _dev(model, "extBi", ext_bi, token=(model.Bi_, k_pad)),
                parts[0].idx, torch.zeros(R, L, device=dev),
                _upload(wi * msk, np.float32, dev)))

    u_counts = 0
    up = _u_part(model, U, k_pad, dev) if (
        U is not None and model.C_ is not None) else None
    if up is not None:
        parts.append(up[0])
        u_counts = up[1]
        if up[2] is not None:  # NA_as_zero_user: the shared w_u CtC base
            G0 = up[2] if G0 is None else G0 + up[2]
        if up[3] is not None:  # the CtUbias centring term
            r0 = up[3] if r0 is None else r0 + up[3]

    lam_mult = None
    if scaled:
        # scale_lam_sideinfo scales even without scale_lam
        # (collective.c:1286 gates on scale_lam || scale_lam_sideinfo)
        if na0:
            # weighted: wsum over observed + 1 per missing entry;
            # unweighted: the full column count (common.c:708-710)
            base = (ww * msk).sum(axis=1) + (float(n) - lengths)
        else:
            # rows without X observations: multiplier 1 on the warm path
            # (taken with Bi, collective.c:1332-1337); the side count only
            # on the cold dispatch without Bi (collective.c:3656)
            base = np.where(lengths > 0, (ww * msk).sum(axis=1),
                            1.0 if has_bi else 0.0)
        if getattr(model, "scale_lam_sideinfo", False) and np.ndim(u_counts):
            base = base + u_counts
        lam_mult = np.maximum(base, 1.0)

    lam_vec = np.ones(k_pad)
    lam_vec[:kw] = lam6[2]
    if user_bias:
        lam_vec[width] = lam6[0]
    if lam_mult is not None and bias_const:
        # scale_bias_const: the bias penalty lam_bias * scaling_biasA is
        # the same for every row (common.c:717-722, collective.c:3787)
        Gc = np.zeros((k_pad, k_pad))
        Gc[width, width] = lam6[0] * float(getattr(model, "scaling_biasA_",
                                                   0.0))
        lam_vec[width] = 0.0
        G0 = Gc if G0 is None else G0 + Gc

    # BeTBeChol (src/collective.c:1365, built at :10425): when every row's
    # Gram is the cached extended system (fully observed unweighted X, or
    # NA-as-zero with rhs-only corrections, plus fully observed dense U),
    # one rhs product and two triangular solves replace the factorizations.
    # Unlike cmfrec_tpu's gate it admits scaled rows whose multiplier is the
    # one the cache was built with (a full row: n + p, or n)
    if ("BeTBeChol" in pre and up is not None
            and (lam_mult is None or (
                not bias_const
                and np.all(lam_mult == pre["BeTBeChol_mult"])))
            and not np.isnan(np.asarray(U, np.float64)).any()
            and ((not na0 and wgt is None and _full_rows(idx, lengths, n))
                 or (na0 and wgt is None))):
        rhs = torch.zeros(R, k_pad, device=dev)
        for prt in parts:
            rhs = rhs + rowsolve.part_rhs(prt)
        if r0 is not None:
            rhs = rhs + _upload(r0, np.float32, dev)
        Lc = _dev(model, "BeTBeChol", pre["BeTBeChol"])
        y = torch.linalg.solve_triangular(Lc, rhs.T, upper=False)
        a = torch.linalg.solve_triangular(Lc.T, y, upper=True).T
        _count(model, "bechol")
        return finish(_result(a, kw, bias_col))

    if not parts:  # no rows' data at all: a zero-length X part
        parts.append(SparsePart(ext_d, torch.zeros(R, 1, dtype=torch.int32,
                                                   device=dev),
                                torch.zeros(R, 1, device=dev),
                                torch.zeros(R, 1, device=dev)))
    G, rhs = rowsolve.assemble_system(
        parts, _small(model, "lam_eager", lam_vec),
        lam_mult=None if lam_mult is None else _upload(lam_mult, np.float32,
                                                       dev),
        G0=None if G0 is None else _upload(G0, np.float32, dev),
        r0=None if r0 is None else _upload(r0, np.float32, dev)[None, :])
    a, info = rowsolve.solve_chol_ex(G, rhs)
    if not na0 and U is None:
        # rows with no data anywhere -> zeros (the reference's zero_out)
        a = torch.where(_upload(lengths, np.int64, dev)[:, None] == 0, 0.0, a)
    return finish(_result(a, kw, bias_col, info))


def factors_explicit_grouped(model, rows, cols, vals, wgt, R, U=None,
                             row_block=128, implicit=False):
    """Degree-grouped batched warm factors for serving-size batches.

    pack_padded_rows pads every row to the batch's largest degree; with
    power-law degrees that wastes 10-30x.  This sorts rows by degree,
    cuts a new group where the degree falls below half the group's
    largest (padding waste <= 2x, <= ~log2(max degree) groups), pads
    group sizes to ``row_block`` multiples and widths to powers of two,
    solves each group on the device, and downloads all groups' results
    once.  Row for row identical to the ungrouped call."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    kw = _width(model)
    if R == 0:
        return np.zeros((0, kw), np.float32), np.zeros(0, np.float32)
    counts = np.bincount(rows, minlength=R)
    order = np.argsort(-counts, kind="stable")
    c2 = -2 * counts[order]  # non-decreasing
    boundaries = [0]
    while boundaries[-1] < R:  # first row below half its group's largest
        boundaries.append(int(np.searchsorted(
            c2, -counts[order[boundaries[-1]]], side="right")))

    # the entries in degree order: one stable sort by the row's rank (a
    # radix sort where the ranks fit 16 bits), so that each group's entries
    # are one slice, each row's in their given order
    rank = np.empty(R, np.uint16 if R <= 1 << 16 else np.int64)
    rank[order] = np.arange(R)
    rk = rank[rows]
    eorder = np.argsort(rk, kind="stable")
    rk, c_s, v_s = rk[eorder].astype(np.int64), cols[eorder], vals[eorder]
    w_s = None if wgt is None else np.asarray(wgt, np.float64)[eorder]
    starts = np.concatenate([[0], np.cumsum(counts[order])])
    within_all = np.arange(rk.size) - starts[rk]
    Uarr = None if U is None else np.asarray(U, np.float64)

    # zero-degree rows with nothing else feeding their system are zeros by
    # definition (the reference's zero_out); groups that still need a
    # solve (side info, NA-as-zero, implicit features) keep width >= 1
    plain_zero = U is None and (implicit or (
        not getattr(model, "NA_as_zero", False)
        and getattr(model, "Bi_", None) is None))
    outs, spans = [], []
    for i0, i1 in zip(boundaries[:-1], boundaries[1:]):
        g_rows = order[i0:i1]
        Lg = int(counts[g_rows[0]])
        if Lg == 0 and plain_zero:
            continue  # outputs stay zero
        Lg_pad = max(1 << max(Lg - 1, 0).bit_length(), 1)
        Rg = g_rows.size
        Rg_pad = -(-Rg // row_block) * row_block
        idx_g = np.zeros((Rg_pad, Lg_pad), np.int64)
        val_g = np.zeros((Rg_pad, Lg_pad))
        wgt_g = None if wgt is None else np.zeros((Rg_pad, Lg_pad))
        lens_g = np.zeros(Rg_pad, np.int64)
        lens_g[:Rg] = counts[g_rows]
        sl = slice(starts[i0], starts[i1])
        li, wi = rk[sl] - i0, within_all[sl]
        idx_g[li, wi] = c_s[sl]
        val_g[li, wi] = v_s[sl]
        if wgt_g is not None:
            wgt_g[li, wi] = w_s[sl]
        U_g = None
        if Uarr is not None:
            U_g = np.zeros((Rg_pad, Uarr.shape[1]))
            U_g[:Rg] = Uarr[g_rows]
        if implicit:
            out = factors_implicit_batch(model, idx_g, val_g, lens_g, U=U_g,
                                         return_device=True)
        else:
            out = factors_explicit_batch(model, idx_g, val_g, wgt_g, lens_g,
                                         U=U_g, return_device=True)
        outs.append(out[:Rg])
        spans.append(g_rows)

    a_out = np.zeros((R, kw), np.float32)
    bias_out = np.zeros(R, np.float32)
    if spans:
        a_all, b_all = download(torch.cat(outs))  # one download, all groups
        at = np.concatenate(spans)
        a_out[at] = a_all
        bias_out[at] = b_all
    return a_out, bias_out


# ----------------------------------------------------------------------- #
# implicit                                                                 #
# ----------------------------------------------------------------------- #


def _warm_implicit(ext, idx, vals, lengths, G0, lam_vec, alpha, w_mult):
    """Fused implicit-warm solve on raw idx/vals (the port of cmfrec_tpu's
    ``_warm_implicit_kernel``): confidence weighting, Gram and batched
    Cholesky on the device.  Returns (a [R, K], info [R])."""
    msk = length_mask(lengths, idx.shape[1]).to(ext.dtype)
    av = alpha * vals
    G, rhs = rowsolve.assemble_system(
        [SparsePart(ext, idx, w_mult * av * msk, w_mult * (1.0 + av) * msk)],
        lam_vec, G0=G0)
    a, info = rowsolve.solve_chol_ex(G, rhs)
    return torch.where(lengths[:, None] == 0, 0.0, a), info


def factors_implicit_batch(model, idx, vals, lengths, U=None,
                           return_device=False, _no_fused=False):
    """WRMF warm factors: (BtB + sum alpha*x B B^T + lam) a = sum (1+alpha*x) B.

    With side info the w_user * C parts join the system over the
    [k_user | k] coordinates as in the explicit batch
    (collective_factors_warm_implicit, src/collective.c:3640).  The shared
    Gram base comes from the precompute when present (src/collective.c:3498).
    Returns a [R, k_user+k+k_main] as numpy, or with ``return_device=True``
    the [R, w + 2] device result (bias 0)."""
    dev = resolve_device(model.device)
    ext, _, k_pad, user_bias = _ext_B(model)
    width = _width(model)
    lam6, l16 = _resolve_lambdas(model.lambda_,
                                 getattr(model, "l1_lambda", 0.0))
    _reject_cd(model, l16)
    w_mult = float(getattr(model, "w_main_multiplier_", 1.0)) * float(
        getattr(model, "w_main", 1.0))
    pre = precomputed(model)
    idx = np.asarray(idx)
    R, L = idx.shape
    ext_d = _ext_B_dev(model, ext, k_pad, user_bias)
    if "BtBw" in pre:
        G0 = _dev(model, "BtBw", pre["BtBw"])
        _count(model, "implicit_gram")
    else:
        G0 = w_mult * (ext_d.T @ ext_d)
    lam_vec = np.ones(k_pad)
    lam_vec[:width] = lam6[2]
    lam_d = _small(model, "lam_implicit", lam_vec)

    def finish(a, info):
        out = _result(a, width, None, info)
        return out if return_device else download(out)[0]

    # the fused serving path (the common implicit-warm shape)
    if not _no_fused and L > 0 and U is None:
        a, info = _warm_implicit(
            ext_d, _upload(idx, np.int32, dev),
            _upload(vals, np.float32, dev), _upload(lengths, np.int32, dev),
            G0, lam_d, float(model.alpha), w_mult)
        _count(model, "warm_fused_implicit")
        return finish(a, info)

    msk = (np.arange(max(L, 1))[None, :]
           < np.asarray(lengths)[:, None]).astype(float)
    av = float(model.alpha) * np.asarray(vals, np.float64)
    parts = [SparsePart(ext_d, _upload(idx, np.int32, dev),
                        _upload(w_mult * av * msk, np.float32, dev),
                        _upload(w_mult * (1.0 + av) * msk, np.float32, dev))]
    r0 = None
    if U is not None and getattr(model, "C_", None) is not None:
        up, _, G0x, r0x = _u_part(model, U, k_pad, dev)
        parts.append(up)
        if G0x is not None:
            G0 = G0 + _upload(G0x, np.float32, dev)
        if r0x is not None:
            r0 = _upload(r0x, np.float32, dev)[None, :]
    G, rhs = rowsolve.assemble_system(parts, lam_d, G0=G0, r0=r0)
    a, info = rowsolve.solve_chol_ex(G, rhs)
    if U is None:
        # no X observations and no side info -> zero factors; with U the
        # row still gets a side-info-only (cold) solve
        a = torch.where(_upload(lengths, np.int64, dev)[:, None] == 0, 0.0, a)
    return finish(a, info)


def factors_implicit_grouped(model, rows, cols, vals, R, U=None,
                             row_block=128):
    """Degree-grouped implicit-warm factors (see factors_explicit_grouped);
    returns a [R, k_user+k+k_main]."""
    return factors_explicit_grouped(model, rows, cols, vals, None, R, U=U,
                                    row_block=row_block, implicit=True)[0]


def factors_cold_implicit(model, U):
    """Side-info-only factors of the implicit model.  The reference's cold
    implicit system includes the B Gram (collective_factors_cold_implicit,
    src/collective.c:3442,3491): it is the warm system with no X
    observations, so the batch solver takes it."""
    U = np.asarray(U, np.float64)
    R = U.shape[0]
    # one zero-length padded slot per row (length 0 masks it out)
    return factors_implicit_batch(model, np.zeros((R, 1), np.int64),
                                  np.zeros((R, 1)), np.zeros(R, np.int64),
                                  U=U)


def pack_padded_rows(rows, cols, vals, wgt, m):
    """COO triplets -> padded [m, L] idx / value / weight blocks and per-row
    counts, without a Python loop over rows."""
    rows = np.asarray(rows, np.int64)
    order = np.argsort(rows, kind="stable")
    rows = rows[order]
    cols = np.asarray(cols, np.int64)[order]
    vals = np.asarray(vals, np.float64)[order]
    if wgt is not None:
        wgt = np.asarray(wgt, np.float64)[order]
    counts = np.bincount(rows, minlength=m).astype(np.int64)
    L = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(rows.size) - starts[rows]
    idx = np.zeros((m, L), np.int64)
    vv = np.zeros((m, L))
    idx[rows, within] = cols
    vv[rows, within] = vals
    ww = None
    if wgt is not None:
        ww = np.zeros((m, L))
        ww[rows, within] = wgt
    return idx, vv, ww, counts


# ----------------------------------------------------------------------- #
# the precompute                                                           #
# ----------------------------------------------------------------------- #


def build_precomputed(model) -> dict:
    """Prediction caches (precompute_collective_explicit,
    src/collective.c:10209-10470), float64 on the host.

    In the extended [k_user | k | k_main | bias] coordinates of every warm
    and cold solve:
      extB          — extended opposing matrix [n, k_pad] (B_plus_bias)
      BtB, BtBw     — extB^T extB, and w_main times it (the shared Gram
                      base of NA-as-zero and implicit solves)
      BtXbias       — w_main extB^T (-mu - biasB): the shared rhs base of
                      NA-as-zero solves (collective.c:10300-10342)
      TransBtBinvBt_G — w_main BtB + diag(lam): TransBtBinvBt, one matmul
                      for fully observed rows (collective.c:10363), is
                      built from it on first use
      BiTBi, extBi  — w_implicit Bi^T Bi and extended Bi (implicit features)
      extC, CtC, CtCw — side-info matrix, Gram, and w_user times it
      TransCtCinvCt — (w_u CtC + lam_C)^-1 w_u C^T: one matmul a cold call
                      (collective.c:10396)
      CtUbias       — -w_user C^T U_colmeans (NA_as_zero_user centring,
                      collective.c:10466)
      BeTBeChol     — chol(w_main BtB + w_user CtC [+ BiTBi] + diag(lam)):
                      the extended system without corrections
                      (collective.c:10425); BeTBeChol_mult, the lambda
                      multiplier it holds (1, or n [+ p] under scale_lam)
    ``sources`` holds the arrays they were built from (``precomputed``)."""
    model._precomputed = {}
    out = {}
    ext, width, k_pad, user_bias = _ext_B(model)
    lam6, _ = _resolve_lambdas(model.lambda_, 0.0)
    kw = _width(model)
    ku = getattr(model, "k_user", 0)
    w_main = float(getattr(model, "w_main", 1.0)) * float(
        getattr(model, "w_main_multiplier_", 1.0))
    w_u = float(getattr(model, "w_user", 1.0))
    scale_lam_side = bool(getattr(model, "scale_lam_sideinfo", False))
    nonneg = bool(getattr(model, "nonneg", False))
    n = ext.shape[0]

    out.update(extB=ext, width=width, k_pad=k_pad, user_bias=user_bias)
    BtB = ext.T @ ext
    out["BtB"] = BtB
    out["BtBw"] = w_main * BtB

    lam_vec = np.ones(k_pad)
    lam_vec[:kw] = lam6[2]
    if user_bias:
        lam_vec[width] = lam6[0]
    mult = 1.0
    if getattr(model, "scale_lam", False) or scale_lam_side:
        p_side = np.asarray(model.C_).shape[0] if model.C_ is not None else 0
        mult = float(n + (p_side if scale_lam_side else 0))
    if not nonneg and not getattr(model, "add_implicit_features", False):
        # TransBtBinvBt itself costs O(n k^2) on the host and serves only
        # fully observed unweighted rows: keep its ingredients
        out["TransBtBinvBt_G"] = w_main * BtB + np.diag(lam_vec * mult)

    if getattr(model, "NA_as_zero", False):
        t = -float(model.glob_mean_) * np.ones(n)
        if model.item_bias_ is not None:
            t = t - np.asarray(model.item_bias_)
        out["BtXbias"] = w_main * (ext.T @ t)

    if getattr(model, "Bi_", None) is not None:
        Bi = np.asarray(model.Bi_, np.float64)
        kiw = Bi.shape[1]
        BiTBi = np.zeros((k_pad, k_pad))
        BiTBi[ku:ku + kiw, ku:ku + kiw] = float(
            getattr(model, "w_implicit", 0.5)) * (Bi.T @ Bi)
        out["BiTBi"] = BiTBi
        ext_bi = np.zeros((Bi.shape[0], k_pad))
        ext_bi[:, ku:ku + kiw] = Bi
        out["extBi"] = ext_bi

    if model.C_ is not None:
        Ce = _ext_C(model, k_pad)
        out["extC"] = Ce
        CtC = Ce.T @ Ce
        out["CtC"] = CtC
        out["CtCw"] = w_u * CtC
        kc = np.asarray(model.C_).shape[1]
        # cold solves scale lam by the side-info column count only under
        # scale_lam_sideinfo (collective.c:3389 passes it as both flags)
        lam_C = lam6[2] * (float(Ce.shape[0]) if scale_lam_side else 1.0)
        if not nonneg:
            Gc = w_u * CtC[:kc, :kc] + lam_C * np.eye(kc)
            out["TransCtCinvCt"] = np.linalg.solve(Gc, w_u * Ce[:, :kc].T)
        if (getattr(model, "NA_as_zero_user", False)
                and model.U_colmeans_ is not None):
            out["CtUbias"] = -w_u * (Ce[:, :kc].T
                                     @ np.asarray(model.U_colmeans_))
        if not nonneg:
            Ge = w_main * BtB + w_u * CtC + np.diag(lam_vec * mult)
            if "BiTBi" in out:
                Ge = Ge + out["BiTBi"]
            out["BeTBeChol"] = np.linalg.cholesky(Ge)
            out["BeTBeChol_mult"] = mult
    if model.item_bias_ is not None:
        out["B_plus_bias"] = ext
    out["sources"] = _sources(model)
    return out


# ----------------------------------------------------------------------- #
# the offsets models (OMF_explicit, OMF_implicit, ContentBased)            #
# ----------------------------------------------------------------------- #


def _model_dtype(model):
    """(numpy dtype, torch dtype) the model's own solves run in."""
    if np.dtype(getattr(model, "dtype_", np.float32)) == np.float64:
        return np.float64, torch.float64
    return np.float32, torch.float32


def offsets_warm_batch(model, idx, vals, lengths, wgt=None, base=None,
                       implicit=False, alpha=1.0, return_bias=False,
                       exact=None):
    """Batched warm factors of the offsets models
    (offsets_factors_warm, upstream cmfrec src/offsets.c:578).

    Three cases matching the reference:
      * implicit: a plain WRMF solve over the full Am width, attributes
        ignored (offsets.c:654 takes the ``|| implicit`` branch);
      * explicit, not exact and k_sec == 0: a plain ridge over the
        observed entries on the full Am width, attributes ignored (the
        regularization lands on Am rather than the free A, offsets.c:665);
      * explicit, exact or k_sec > 0: X' = X - uc Bm[:, :ks+k]^T taken as
        fully dense (an unobserved entry is 0 minus the projection, weight
        1), the free A solved over columns [k_sec : k_sec+k+k_main] of Bm,
        then Am[:ks+k] += uc (offsets.c:747-852).

    base: [R, ks+k+k_main] attribute-projection rows (only the first ks+k
    columns are used, and only on the exact / k_sec path).  Batched Grams
    and Cholesky on the model's device in the model's dtype.  Returns Am
    rows [R, ks+k+k_main] as numpy (and the warm bias with
    ``return_bias`` on the explicit paths: zeros without user biases)."""
    ndt, tdt = _model_dtype(model)
    dev = resolve_device(model.device)
    Bm = np.asarray(model.Bm_, np.float64)
    n, kk = Bm.shape
    ks = int(getattr(model, "k_sec", 0))
    k = int(getattr(model, "k", 0))
    km = int(getattr(model, "k_main", 0))
    if exact is None:
        exact = bool(getattr(model, "exact", False))
    lam6, _ = _resolve_lambdas(model.lambda_, 0.0)
    lam = float(lam6[2])
    lam_bias = float(lam6[0])
    idx = np.asarray(idx, np.int64)
    R, L = idx.shape
    lengths = np.asarray(lengths)
    msk = (np.arange(max(L, 1))[None, :] < lengths[:, None]).astype(float)
    v = np.asarray(vals, np.float64)
    append_bias = (not implicit and return_bias
                   and model.user_bias_ is not None)
    idx_d = _upload(idx, np.int64, dev)

    def up(a):
        return _upload(a, ndt, dev)

    def solve(parts, lam_vec, G0=None, r0=None):
        G, rhs = rowsolve.assemble_system(parts, up(lam_vec), G0=G0, r0=r0)
        return rowsolve.solve_chol(G, rhs).cpu().numpy()

    if implicit:
        # WRMF warm solve on Bm, attributes ignored (offsets.c:707-729)
        k_pad = _round_up(kk, 8)
        ext = np.zeros((n, k_pad))
        ext[:, :kk] = Bm
        av = alpha * v
        BmtBm, _, _ = _omf_gram_pieces(model, kk, ks, k, False)
        lam_vec = np.full(k_pad, lam)
        lam_vec[kk:] = 1.0  # padded coords stay zero even at lam = 0
        part = SparsePart(
            _dev(model, "omf_ext_implicit", ext, token=(model.Bm_, k_pad),
                 dtype=ndt),
            idx_d, up(av * msk), up((1.0 + av) * msk))
        a = solve([part], lam_vec, G0=up(_pad_sq(BmtBm, k_pad)))[:, :kk]
        a[lengths == 0] = 0.0
        return a

    vv = v - model.glob_mean_
    if model.item_bias_ is not None and L > 0:
        vv = vv - np.asarray(model.item_bias_, np.float64)[idx]
    ww = np.ones((R, L)) if wgt is None else np.asarray(wgt, np.float64)

    if not exact and ks == 0:
        # ridge over the observed entries on the full Am width
        width = kk + append_bias
        k_pad = _round_up(width, 8)
        ext = np.zeros((n, k_pad))
        ext[:, :kk] = Bm
        if append_bias:
            ext[:, kk] = 1.0
        cw = ww * msk
        lam_vec = np.full(k_pad, lam)
        lam_vec[width:] = 1.0  # padding guard (singular at lam = 0)
        if append_bias:
            lam_vec[kk] = lam_bias
        part = SparsePart(
            _dev(model, "omf_ext_ridge", ext,
                 token=(model.Bm_, k_pad, append_bias), dtype=ndt),
            idx_d, up(cw), up(cw * vv))
        a = solve([part], lam_vec)
        a[lengths == 0] = 0.0
        bias = a[:, kk] if append_bias else np.zeros(R)
        return (a[:, :kk], bias) if return_bias else a[:, :kk]

    # exact / k_sec: the full-dense transformed solve on the free block
    if base is None:
        base = np.zeros((R, kk))
    uc = np.asarray(base, np.float64)[:, :ks + k]
    out = np.zeros((R, kk))
    out[:, :ks + k] = uc
    kf = k + km
    if kf == 0:
        return (out, np.zeros(R)) if return_bias else out
    width = kf + append_bias
    k_pad = _round_up(width, 8)
    ext = np.zeros((n, k_pad))
    ext[:, :kf] = Bm[:, ks:]
    if append_bias:
        ext[:, kf] = 1.0
    # the full-dense Gram ext^T ext: observed entries carry weight w (the
    # sparse correction uses w - 1); the rhs gets -Bf^T Bc uc from the
    # unobserved projection plus the observed-entry terms.  The blocks
    # come from the BmtBm / colsum cache when precomputed (offsets.c:870).
    BmtBm, colsum, n_cache = _omf_gram_pieces(model, kk, ks, k, append_bias)
    G0 = np.zeros((k_pad, k_pad))
    G0[:kf, :kf] = BmtBm[ks:, ks:]
    if append_bias:
        G0[kf, :kf] = colsum[ks:]
        G0[:kf, kf] = colsum[ks:]
        G0[kf, kf] = float(n_cache)
    M = np.zeros((ks + k, k_pad))  # Bc^T ext
    M[:, :kf] = BmtBm[:ks + k, ks:]
    if append_bias:
        M[:, kf] = colsum[:ks + k]
    uc_d = up(uc)
    Bc = _dev(model, "omf_Bc", Bm[:, :ks + k], token=(model.Bm_, ks + k),
              dtype=ndt)
    proj = torch.einsum("rlk,rk->rl", rowsolve.gather_rows(Bc, idx_d), uc_d)
    msk_d, ww_d = up(msk[:, :L]), up(ww)
    cw = (ww_d - 1.0) * msk_d
    cv = (ww_d * up(vv) - (ww_d - 1.0) * proj) * msk_d
    lam_vec = np.full(k_pad, lam)
    lam_vec[width:] = 1.0  # padding guard
    if append_bias:
        lam_vec[kf] = lam_bias
    part = SparsePart(
        _dev(model, "omf_ext_exact", ext,
             token=(model.Bm_, ks, k_pad, append_bias), dtype=ndt),
        idx_d, cw, cv)
    a = solve([part], lam_vec, G0=up(G0), r0=-(uc_d @ up(M)))
    out[:, ks:] += a[:, :kf]
    bias = a[:, kf] if append_bias else np.zeros(R)
    return (out, bias) if return_bias else out


def build_precomputed_offsets(model) -> dict:
    """Prediction caches of the offsets models (precompute_offsets_both,
    upstream cmfrec src/offsets.c:870), f64 on the host: Bm, its Gram and
    column sums, from which every offsets_warm_batch branch takes its
    shared base without a per-call O(n k^2) product."""
    model._precomputed = {}
    Bm = np.asarray(model.Bm_, np.float64)
    return {"Bm": Bm, "BmtBm": Bm.T @ Bm, "Bm_colsum": Bm.sum(axis=0),
            "n": Bm.shape[0]}


def _omf_gram_pieces(model, kk, ks, k, append_bias):
    """(BmtBm, colsum, n) from the cache, or computed afresh."""
    pre = getattr(model, "_precomputed", None) or {}
    if "BmtBm" in pre:
        _count(model, "omf_gram")
        return pre["BmtBm"], pre["Bm_colsum"], pre["n"]
    Bm = np.asarray(model.Bm_, np.float64)
    return Bm.T @ Bm, Bm.sum(axis=0), Bm.shape[0]


# ----------------------------------------------------------------------- #
# binary side information: one L-BFGS over all the rows                    #
# ----------------------------------------------------------------------- #

LBFGS_ROWS_MEMORY = 5
LBFGS_ROWS_TOL = 1e-7


def _lbfgs_rows(a0, loss_fn, n_steps, memory=LBFGS_ROWS_MEMORY):
    """Minimize the summed per-row objective ``loss_fn({"a": a})`` from a0
    with the L-BFGS of solvers/lbfgs_core.py.  Rows are independent, so
    the joint minimizer is the per-row minimizers (the batched form of the
    reference's per-row liblbfgs, upstream cmfrec src/collective.c:1146).
    Stops after ``n_steps`` iterations, or once the sup-norm of the
    gradient an iteration started from is below
    ``LBFGS_ROWS_TOL * max(1, max|a|)``; each iteration reads both on the
    host in one sync.  Returns (a, the Lbfgs object with its counters)."""
    from .lbfgs import value_and_grad_of
    from .lbfgs_core import FlatParams, Lbfgs

    layout = FlatParams({"a": a0})
    a = a0.reshape(-1)
    core = Lbfgs(value_and_grad_of(loss_fn, layout), a, memory)
    for _ in range(int(n_steps)):
        a, _ = core.step(a)
        gnorm, anorm = core.read(torch.stack([
            torch.max(torch.abs(core.prev_grad)),
            torch.clamp(torch.max(torch.abs(a)), min=1.0)]))
        if gnorm < LBFGS_ROWS_TOL * anorm:
            break
    return a.view(a0.shape), core


def factors_bin_batch(model, idx, vals, wgt, lengths, U=None, U_bin=None,
                      cold=False, return_bias=False, maxiter=None):
    """Warm or cold factors where binary side information takes part: no
    closed form exists, so the reference's per-row gradient solve
    (collective_factors_lbfgs, upstream cmfrec src/collective.c:1146,
    gated at :3825-3862) runs as ONE L-BFGS over all R rows, started from
    zeros, on the model's device in the model's dtype.

    idx/vals/wgt: [R, L] padded X observations (ignored when cold); U:
    [R, p] dense (NaN = missing) or None; U_bin: [R, pbin] dense.  Runs
    ``maxiter`` iterations at most (the model's ``maxiter``, else 200).
    Returns numpy a [R, k_user+k+k_main] (and the bias with
    ``return_bias`` when warm; zeros without user biases)."""
    ndt, tdt = _model_dtype(model)
    dev = resolve_device(model.device)
    k = model.k
    ku = getattr(model, "k_user", 0)
    km = getattr(model, "k_main", 0)
    ki = getattr(model, "k_item", 0)
    kc = ku + k
    lam6, _ = _resolve_lambdas(model.lambda_, 0.0)
    w_main = float(getattr(model, "w_main", 1.0))
    w_user = float(getattr(model, "w_user", 1.0))
    R = int(np.asarray(lengths).shape[0])
    append_bias = (not cold and return_bias and model.user_bias_ is not None)

    def up(a):
        return _upload(a, ndt, dev)

    Bg = cw = cv = None
    if cold:
        width = kc  # k_main coordinates stay zero (collective.c:3412)
        w_main = 1.0
    else:
        width = ku + k + km + (1 if append_bias else 0)
        B = np.asarray(model.B_, np.float64)
        # the X part sees a[:, ku:]: B[:, ki:] (+ ones) placed at those
        # coordinates of a full-width matrix
        Bfull = np.zeros((B.shape[0], width))
        Bfull[:, ku:ku + k + km] = B[:, ki:]
        if append_bias:
            Bfull[:, ku + k + km] = 1.0
        idx = np.asarray(idx, np.int64)
        L = idx.shape[1]
        msk = (np.arange(max(L, 1))[None, :]
               < np.asarray(lengths)[:, None]).astype(np.float64)
        v = np.asarray(vals, np.float64) - model.glob_mean_
        if model.item_bias_ is not None and L > 0:
            v = v - np.asarray(model.item_bias_, np.float64)[idx]
        ww = msk if wgt is None else np.asarray(wgt, np.float64) * msk
        Bg = rowsolve.gather_rows(
            _dev(model, "bin_Bx", Bfull,
                 token=(model.B_, ku, width, append_bias), dtype=ndt),
            _upload(idx, np.int64, dev))
        cw, cv = up(ww), up(v * msk)

    Cm = u = umask = None
    if U is not None and model.C_ is not None:
        Uarr = np.asarray(U, np.float64)
        if model.U_colmeans_ is not None:
            Uarr = Uarr - np.asarray(model.U_colmeans_)[None, :]
        umask = up((~np.isnan(Uarr)).astype(np.float64))
        u = up(np.nan_to_num(Uarr))
        Cm = _dev(model, "bin_C", model.C_, dtype=ndt)
    Cb = ub = ubmask = None
    if U_bin is not None:
        if getattr(model, "Cb_", None) is None:
            raise ValueError("Model was fit without binary user side info")
        Ub = np.asarray(U_bin, np.float64)
        ubmask = up((~np.isnan(Ub)).astype(np.float64))
        ub = up(np.nan_to_num(Ub))
        Cb = _dev(model, "bin_Cb", model.Cb_, dtype=ndt)

    lam_np = np.full(width, float(lam6[2]))
    if append_bias:
        lam_np[width - 1] = float(lam6[0])
    lam_vec = up(lam_np)

    def loss_fn(p):
        a = p["a"]
        f = torch.zeros((), dtype=tdt, device=dev)
        if Bg is not None:
            r = cv - torch.einsum("rlk,rk->rl", Bg, a)
            f = f + 0.5 * w_main * torch.sum(cw * r * r)
        au = a[:, :kc]
        if Cm is not None:
            ru = (u - au @ Cm.T) * umask
            f = f + 0.5 * w_user * torch.sum(ru * ru)
        if Cb is not None:
            rb = (ub - torch.sigmoid(au @ Cb.T)) * ubmask
            f = f + 0.5 * w_user * torch.sum(rb * rb)
        return f + 0.5 * torch.sum(lam_vec[None, :] * a * a)

    # an explicit maxiter= wins; else the model's (the reference's
    # collective_factors_lbfgs inherits the fit setting), else 200
    if maxiter is None:
        maxiter = getattr(model, "maxiter", None)
    n_steps = int(maxiter) if maxiter is not None else 200
    a, _ = _lbfgs_rows(torch.zeros(R, width, dtype=tdt, device=dev), loss_fn,
                       n_steps)
    a = a.cpu().numpy()
    if cold:
        out = np.zeros((R, ku + k + km), a.dtype)
        out[:, :kc] = a
        return out
    bias = a[:, width - 1] if append_bias else np.zeros(R)
    out = a[:, :ku + k + km]
    return (out, bias) if return_bias else out
