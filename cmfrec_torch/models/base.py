"""Shared model-API plumbing (port of cmfrec_tpu/models/base.py): parameter
handling, input ingestion with ID reindexing, and the predict/topN entry
points.

Mirrors the reference's `_CMF` base (upstream cmfrec/__init__.py:25):
pandas DataFrames with arbitrary Id columns are reindexed (pandas is
imported only for DataFrame input); SciPy sparse and dense NumPy inputs pass
through with positional indices.  Fitted attributes are NumPy arrays under
the reference's names (A_, B_, user_bias_, item_bias_, glob_mean_,
user_mapping_, item_mapping_, is_fitted_); predict/topN score on the
model's ``device`` from copies uploaded once and then reused.  ``save``/``load`` use the same .npz format
as cmfrec_tpu, so a model saved by either package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..ops import predict as predict_ops
from ..solvers import warm


def _is_df(x):
    # pandas is optional, and imported only for what may be a DataFrame
    if not type(x).__module__.startswith("pandas"):
        return False
    import pandas as pd

    return isinstance(x, pd.DataFrame)


def _is_sparse(x):
    return hasattr(x, "tocoo") and hasattr(x, "shape")


def _parse_df_values(X, W):
    """Rating/Value/Count + Weight columns of an X DataFrame."""
    val_col = "Rating" if "Rating" in X.columns else (
        "Value" if "Value" in X.columns else "Count"
    )
    if val_col not in X.columns:
        raise ValueError("X DataFrame needs a Rating/Value/Count column")
    vals = X[val_col].to_numpy(np.float64)
    wgt = X["Weight"].to_numpy(np.float64) if "Weight" in X.columns else None
    if W is not None:
        wgt = np.asarray(W, np.float64).ravel()
    return vals, wgt


class _BaseModel:
    """sklearn-style base: set_params/get_params, ingestion, prediction."""

    _supports_extra_side_rows = False  # side info may hold ids X lacks

    def __repr__(self):
        return f"{self.__class__.__name__}({'fitted' if getattr(self, 'is_fitted_', False) else 'unfitted'})"

    __str__ = __repr__

    def get_params(self, deep=True):
        # sklearn semantics: the constructor's parameters by introspection
        # (a name filter on __dict__ would drop `lambda_`)
        import inspect

        names = [p for p in
                 inspect.signature(type(self).__init__).parameters
                 if p != "self"]
        return {nm: getattr(self, nm) for nm in names if hasattr(self, nm)}

    def set_params(self, **params):
        if getattr(self, "is_fitted_", False):
            raise ValueError(
                "Cannot change parameters after the model has been fit."
            )
        for k, v in params.items():
            if not hasattr(self, k):
                raise ValueError(f"Invalid parameter: {k}")
            setattr(self, k, v)
        return self

    def fit_triplets(self, rows, cols, vals, m, n, W=None, **fit_kwargs):
        """Convenience: fit directly from positional COO triplets."""
        import scipy.sparse as sp

        X = sp.coo_matrix(
            (np.asarray(vals, np.float64),
             (np.asarray(rows, np.int64), np.asarray(cols, np.int64))),
            shape=(m, n),
        )
        if W is not None:
            fit_kwargs["W"] = W
        return self.fit(X, **fit_kwargs)

    # ------------------------------------------------------------------ #
    # input ingestion                                                     #
    # ------------------------------------------------------------------ #

    def _reset(self):
        self.A_ = None
        self.B_ = None
        self.C_ = None
        self.D_ = None
        self.Ai_ = None
        self.Bi_ = None
        self.Cb_ = None
        self.Db_ = None
        self.Am_ = None
        self.Bm_ = None
        self.C_bias_ = None
        self.D_bias_ = None
        self.user_bias_ = None
        self.item_bias_ = None
        self.glob_mean_ = 0.0
        self.scaling_biasA_ = 0.0
        self.scaling_biasB_ = 0.0
        self.U_colmeans_ = None
        self.I_colmeans_ = None
        self.user_mapping_ = np.array([], dtype=object)
        self.item_mapping_ = np.array([], dtype=object)
        self.reindex_ = False
        self.is_fitted_ = False
        self.niter_ = None
        self.user_dict_ = {}
        self.item_dict_ = {}
        self._device_cache = {}
        self._precomputed = {}

    def _ingest_X(self, X, W=None):
        """Fit-time ingestion: also records X's dims (``_m_orig``/``_n_orig``,
        the include_all_X gate of topN)."""
        out = self._ingest_X_inner(X, W)
        self._m_orig = out[4]
        self._n_orig = out[5]
        return out

    def _ingest_X_new(self, X, W=None):
        """New-data rows (factors_multiple, predict_warm_multiple): the
        formats of fit, but stateless.  Item ids go through the model's
        item mapping, the new rows' ids are local to the call, and no
        attribute of the model is written."""
        if _is_df(X):
            import pandas as pd

            need = {"UserId", "ItemId"}
            if not need.issubset(X.columns):
                raise ValueError("X DataFrame needs UserId and ItemId columns")
            ucodes, _ = pd.factorize(X["UserId"], use_na_sentinel=False)
            icodes, _ = self._map_ids(np.asarray(X["ItemId"]),
                                      self.item_mapping_, "item")
            icodes = np.atleast_1d(icodes)
            n_items = np.asarray(self._xB).shape[0]
            bad = (icodes < 0) | (icodes >= n_items)
            if bad.any():
                raise ValueError("unknown item id(s) in new X: "
                                 f"{np.asarray(X['ItemId'])[bad][:5]}")
            vals, wgt = _parse_df_values(X, W)
            return (ucodes.astype(np.int64), icodes.astype(np.int64), vals,
                    wgt, int(ucodes.max()) + 1 if ucodes.size else 0,
                    n_items)
        # positional formats carry no ids to map
        return self._ingest_X_inner(X, W, store=False)

    def _ingest_X_inner(self, X, W=None, store=True):
        """X as DataFrame(UserId, ItemId, Rating[, Weight]) / scipy sparse /
        dense ndarray (NaN = missing) -> COO triplets + dims, and with
        ``store`` the id mappings."""
        if _is_df(X):
            import pandas as pd

            need = {"UserId", "ItemId"}
            if not need.issubset(X.columns):
                raise ValueError("X DataFrame needs UserId and ItemId columns")
            ucodes, umap = pd.factorize(X["UserId"], use_na_sentinel=False)
            icodes, imap = pd.factorize(X["ItemId"], use_na_sentinel=False)
            if store:
                self.user_mapping_ = np.asarray(umap)
                self.item_mapping_ = np.asarray(imap)
                self.reindex_ = True
            vals, wgt = _parse_df_values(X, W)
            return (ucodes.astype(np.int64), icodes.astype(np.int64), vals,
                    wgt, len(umap), len(imap))
        if _is_sparse(X):
            coo = X.tocoo()
            wgt = None
            if W is not None:
                wgt = W.tocoo().data if _is_sparse(W) else np.asarray(W).ravel()
            if store:
                self.reindex_ = False
            return (coo.row.astype(np.int64), coo.col.astype(np.int64),
                    coo.data.astype(np.float64), wgt, X.shape[0], X.shape[1])
        X = np.asarray(X, np.float64)
        if X.ndim != 2:
            raise ValueError("X must be 2-dimensional")
        rows, cols = np.nonzero(~np.isnan(X))
        vals = X[rows, cols]
        wgt = None
        if W is not None:
            W = np.asarray(W, np.float64)
            wgt = W[rows, cols] if W.ndim == 2 else W.ravel()
        if store:
            self.reindex_ = False
        return rows, cols, vals, wgt, X.shape[0], X.shape[1]

    def _ingest_side(self, U, mapping, n_main, name="U"):
        """Side-info matrix: DataFrame with an Id column, sparse, or dense.

        Returns (rows, cols, vals, n_rows, n_cols, is_dense, dense_mat).
        Rows are aligned to the main matrix's id space; side info may add
        rows beyond n_main (side-info-only entities, m_u > m in the
        reference, upstream cmfrec src/collective.c:7263 signature), whose
        factors the fit solves from side info alone.  A DataFrame's ids that
        X lacks are appended to the id mapping (the reference's _append_NAs,
        upstream cmfrec/__init__.py:342) in models that take them
        (``_supports_extra_side_rows``).
        """
        if U is None:
            return None
        if _is_df(U):
            import pandas as pd

            id_col = "UserId" if name == "U" else "ItemId"
            if id_col in U.columns:
                ids = np.asarray(U[id_col])
                if self.reindex_:
                    codes = pd.Index(mapping).get_indexer(ids).astype(np.int64)
                    if (codes < 0).any():
                        self._check_extra_side_rows(name)
                        mapping = np.concatenate(
                            [np.asarray(mapping), np.unique(ids[codes < 0])])
                        if name == "U":
                            self.user_mapping_ = mapping
                        else:
                            self.item_mapping_ = mapping
                        codes = pd.Index(mapping).get_indexer(ids).astype(
                            np.int64)
                    n_rows = len(mapping)
                else:
                    codes = ids.astype(np.int64)
                    n_ids = int(codes.max()) + 1 if codes.size else 0
                    if n_ids > n_main:
                        self._check_extra_side_rows(name)
                    n_rows = max(n_main, n_ids)
                feat = U.drop(columns=[id_col]).to_numpy(np.float64)
                dense = np.full((n_rows, feat.shape[1]), np.nan)
                dense[codes] = feat
                return self._side_from_dense(dense)
            U = U.to_numpy(np.float64)
        if _is_sparse(U):
            coo = U.tocoo()
            return (coo.row.astype(np.int64), coo.col.astype(np.int64),
                    coo.data.astype(np.float64), U.shape[0], U.shape[1],
                    False, None)
        return self._side_from_dense(np.asarray(U, np.float64))

    def _check_extra_side_rows(self, name):
        if not self._supports_extra_side_rows:
            raise ValueError(f"{name} contains ids not present in X; this "
                             "model does not support side-info-only "
                             "entities")

    @staticmethod
    def _side_from_dense(U):
        if np.isnan(U).any():
            rows, cols = np.nonzero(~np.isnan(U))
            return rows, cols, U[rows, cols], U.shape[0], U.shape[1], False, None
        return None, None, None, U.shape[0], U.shape[1], True, U

    def _store_side(self, res):
        """The side factors and side-info column means of a collective fit
        (None where the fit has no such part)."""
        for attr, key in (("C_", "C"), ("D_", "D"), ("Ai_", "Ai"),
                          ("Bi_", "Bi")):
            t = res.get(key)
            setattr(self, attr, None if t is None else t.cpu().numpy())
        self.U_colmeans_ = res.get("U_colmeans")
        self.I_colmeans_ = res.get("I_colmeans")

    def _build_dicts(self):
        """id -> position dicts (the reference's produce_dicts,
        upstream cmfrec/__init__.py:2727 user_dict_/item_dict_)."""
        if getattr(self, "produce_dicts", False) and self.reindex_:
            self.user_dict_ = {u: i for i, u in
                               enumerate(self.user_mapping_)}
            self.item_dict_ = {it: i for i, it in
                               enumerate(self.item_mapping_)}

    # ------------------------------------------------------------------ #
    # id mapping                                                          #
    # ------------------------------------------------------------------ #

    def _map_ids(self, ids, mapping, kind="user", allow_missing=False):
        ids = np.asarray(ids)
        scalar = ids.ndim == 0
        ids = np.atleast_1d(ids)
        if self.reindex_:
            import pandas as pd

            codes = pd.Index(mapping).get_indexer(ids).astype(np.int64)
            if (codes < 0).any() and not allow_missing:
                raise ValueError(f"unknown {kind} id(s): {ids[codes < 0][:5]}")
        else:
            codes = ids.astype(np.int64)
            if allow_missing:
                mat = self._xA if kind == "user" else self._xB
                codes = np.where((codes < 0) | (codes >= mat.shape[0]), -1,
                                 codes)
        return (codes[0] if scalar else codes), scalar

    def _item_rows(self, items):
        i, _ = self._map_ids(items, self.item_mapping_, "item")
        return np.atleast_1d(i)

    def _new_row_U(self, U, U_col, U_val):
        """One new row of side info as [1, p] (NaN = missing), or None."""
        if U is None and U_col is None:
            return None
        if U is not None:
            return np.asarray(U, np.float64).ravel()[None, :]
        u = np.full(self.C_.shape[0], np.nan)
        u[np.asarray(U_col, np.int64)] = np.asarray(U_val, np.float64)
        return u[None, :]

    def _check_fitted(self):
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")

    def _unmap_items(self, idx):
        if self.reindex_:
            return self.item_mapping_[idx]
        return idx

    # ------------------------------------------------------------------ #
    # prediction surface                                                  #
    # ------------------------------------------------------------------ #

    @property
    def _xA(self):
        """A columns that participate in X (strips k_user)."""
        ku = getattr(self, "k_user", 0)
        return self.A_[:, ku:] if ku else self.A_

    @property
    def _xB(self):
        ki = getattr(self, "k_item", 0)
        return self.B_[:, ki:] if ki else self.B_

    def _on_device(self, name):
        """f32 copy of the fitted array attribute ``name`` on the model's
        device.  It is uploaded once and reused for as long as the attribute
        holds the same array and the device is unchanged; an array modified
        in place is not seen (assign a new array instead)."""
        a = getattr(self, name, None)
        if a is None:
            return None
        cache = self.__dict__.setdefault("_device_cache", {})
        hit = cache.get(name)
        if hit is None or hit[0] is not a or hit[1] != self.device:
            dev = resolve_device(self.device)
            cache[name] = (a, self.device,
                           torch.as_tensor(np.asarray(a, np.float32),
                                           device=dev))
        return cache[name][2]

    def _to_device(self, a):
        """A host array (a new row's factors) as f32 on the model's device."""
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=resolve_device(self.device))

    def _device_x_factors(self):
        """(A, B) on the device, restricted to the columns that participate
        in X (as ``_xA``/``_xB``)."""
        return (self._on_device("A_")[:, getattr(self, "k_user", 0):],
                self._device_xB())

    def _device_xB(self):
        return self._on_device("B_")[:, getattr(self, "k_item", 0):]

    # Unknown user/item combinations: the explicit CMF predicts the global
    # mean plus whichever bias is known; other models yield NaN
    # (upstream cmfrec/__init__.py:1188-1192).
    _unknown_pred_mean = False

    def predict(self, user, item):
        """Predict X[user, item] for arrays or scalars of ids
        (reference: upstream cmfrec/__init__.py:1183)."""
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")
        u, scalar_u = self._map_ids(user, self.user_mapping_, "user",
                                    allow_missing=True)
        i, scalar_i = self._map_ids(item, self.item_mapping_, "item",
                                    allow_missing=True)
        u = np.atleast_1d(u)
        i = np.atleast_1d(i)
        if u.size == 1 and i.size > 1:
            u = np.repeat(u, i.size)
        if i.size == 1 and u.size > 1:
            i = np.repeat(i, u.size)
        bad = (u < 0) | (i < 0)
        dev = resolve_device(self.device)
        A, B = self._device_x_factors()
        p = predict_ops.predict_pairs(
            A, B,
            torch.as_tensor(np.maximum(u, 0), device=dev),
            torch.as_tensor(np.maximum(i, 0), device=dev),
            self._on_device("user_bias_"), self._on_device("item_bias_"),
            float(self.glob_mean_),
        )
        p = p.cpu().numpy()
        if bad.any():
            if self._unknown_pred_mean:
                fill = np.full(bad.sum(), self.glob_mean_)
                if self.user_bias_ is not None:
                    ub = np.asarray(self.user_bias_)
                    fill += np.where(u[bad] >= 0, ub[np.maximum(u[bad], 0)], 0.0)
                if self.item_bias_ is not None:
                    ib = np.asarray(self.item_bias_)
                    fill += np.where(i[bad] >= 0, ib[np.maximum(i[bad], 0)], 0.0)
                p[bad] = fill
            else:
                p[bad] = np.nan
        return float(p[0]) if (scalar_u and scalar_i) else p

    def topN(self, user, n=10, include=None, exclude=None, output_score=False):
        """Top-N highest-predicted items for an existing user
        (reference: upstream cmfrec/__init__.py:1355)."""
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")
        u, _ = self._map_ids(user, self.user_mapping_, "user")
        a_vec = self._device_x_factors()[0][int(u)]
        a_bias = float(self.user_bias_[int(u)]) if self.user_bias_ is not None else 0.0
        return self._topN_vec(a_vec, a_bias, n, include, exclude, output_score)

    def _topN_row(self, out, n, include, exclude, output_score,
                  with_bias=True):
        """topN over a new user's device result ``out`` [1, w + 2]
        (solvers/warm.py); its bias and its factorization's status come to
        the host first."""
        _, bias = warm.download(out)
        return self._topN_vec(out[0, self.k_user:warm._width(self)],
                              float(bias[0]) if with_bias else 0.0, n,
                              include, exclude, output_score)

    def _topN_vec(self, a_vec, a_bias, n, include, exclude, output_score):
        """``a_vec`` is the user's factor row, a tensor on the device."""
        if include is not None:
            include, _ = self._map_ids(include, self.item_mapping_, "item")
            include = np.atleast_1d(include)
        if exclude is not None:
            exclude, _ = self._map_ids(exclude, self.item_mapping_, "item")
            exclude = np.atleast_1d(exclude)
        B, ib = self._device_xB(), self._on_device("item_bias_")
        # include_all_X=False: items present only in the side info (rows of
        # I beyond X's columns) are excluded from recommendation
        # (upstream cmfrec/__init__.py:2759; ignored under NA_as_zero)
        lim = getattr(self, "_n_orig", None)
        if (not getattr(self, "include_all_X", True)
                and not getattr(self, "NA_as_zero", False)
                and lim is not None and lim < B.shape[0]):
            if include is not None and (include >= lim).any():
                raise ValueError(
                    "include= contains items absent from X; refit with "
                    "include_all_X=True to recommend side-info-only items"
                )
            if exclude is not None:
                exclude = exclude[(exclude >= 0) & (exclude < lim)]
                if exclude.size == 0:
                    exclude = None
            B = B[:lim]
            ib = None if ib is None else ib[:lim]
        idx, scores = predict_ops.topn(
            a_vec, B, n, ib, float(self.glob_mean_), a_bias,
            include, exclude,
        )
        items = self._unmap_items(idx)
        return (items, scores) if output_score else items

    # ------------------------------------------------------------------ #
    # model-matrix utilities                                              #
    # ------------------------------------------------------------------ #

    def swap_users_and_items(self, precompute=True):
        """A copy with users and items exchanged (reference: upstream
        cmfrec/__init__.py:2165).  It shares the fitted arrays and starts
        with empty prediction and device caches."""
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")
        import copy

        new = copy.copy(self)
        new.A_, new.B_ = self.B_, self.A_
        new.C_, new.D_ = self.D_, self.C_
        new.Ai_, new.Bi_ = self.Bi_, self.Ai_
        new.Cb_ = getattr(self, "Db_", None)
        new.Db_ = getattr(self, "Cb_", None)
        new.user_bias_, new.item_bias_ = self.item_bias_, self.user_bias_
        new.user_mapping_, new.item_mapping_ = (self.item_mapping_,
                                                self.user_mapping_)
        new.user_dict_, new.item_dict_ = (getattr(self, "item_dict_", {}),
                                          getattr(self, "user_dict_", {}))
        # X's fit-time dims swap with the axes (the include_all_X gate)
        new._m_orig = getattr(self, "_n_orig", None)
        new._n_orig = getattr(self, "_m_orig", None)
        new.U_colmeans_, new.I_colmeans_ = self.I_colmeans_, self.U_colmeans_
        for a, b in (("k_user", "k_item"), ("w_user", "w_item"),
                     ("user_bias", "item_bias"),
                     ("NA_as_zero_user", "NA_as_zero_item"),
                     ("nonneg_C", "nonneg_D"), ("center_U", "center_I")):
            if hasattr(self, a) and hasattr(self, b):
                setattr(new, a, getattr(self, b))
                setattr(new, b, getattr(self, a))
        new._device_cache = {}
        new._precomputed = {}
        new._cache_stats = {}
        if precompute and hasattr(new, "force_precompute_for_predictions"):
            new.force_precompute_for_predictions()
        return new

    def drop_nonessential_matrices(self, drop_precomputed=True):
        """Free what new-user factors (factors_warm / factors_cold /
        factors_multiple / topN_warm / topN_cold) do not need, as the
        reference's production-memory trim (upstream
        cmfrec/__init__.py:2366-2440): the user-side matrices (A, Ai, D,
        the user biases and id mapping) go, the item-side ones stay, and
        so do the device copies of what stays.  ``predict``, ``topN`` and
        ``swap_users_and_items`` stop working.  With ``drop_precomputed``
        the less-used solve caches (TransBtBinvBt, TransCtCinvCt,
        BeTBeChol) go too."""
        if not self.is_fitted_:
            raise RuntimeError("Model is not fitted")
        from .cmf import CMF, CMF_implicit

        if not isinstance(self, (CMF, CMF_implicit)):
            raise ValueError(
                "Method is only applicable to 'CMF' and 'CMF_implicit'.")
        self._only_prediction_info = True
        self.user_mapping_ = np.array([], dtype=object)
        self.user_dict_ = {}
        self.item_dict_ = {}
        self.A_ = None
        self.Ai_ = None
        self.D_ = None
        self.user_bias_ = None
        self.I_colmeans_ = None
        dropped = ("TransBtBinvBt", "TransCtCinvCt", "BeTBeChol")
        cache = self.__dict__.get("_device_cache", {})
        for name in ("A_", "Ai_", "D_", "user_bias_") + tuple(
                "warm:" + key for key in dropped if drop_precomputed):
            cache.pop(name, None)
        if drop_precomputed:
            for key in dropped:
                self._precomputed.pop(key, None)
        return self

    # ------------------------------------------------------------------ #
    # serialization: the cmfrec_tpu .npz format                           #
    # ------------------------------------------------------------------ #

    _ARRAY_ATTRS = (
        "A_", "B_", "C_", "D_", "Ai_", "Bi_", "Am_", "Bm_",
        "C_bias_", "D_bias_", "Cb_", "Db_",
        "user_bias_", "item_bias_", "U_colmeans_", "I_colmeans_",
        "user_mapping_", "item_mapping_",
    )

    def save(self, path):
        """Serialize fitted state + hyperparameters to one .npz file.  The
        device is a placement, not a hyperparameter, and is not written, so
        cmfrec_tpu can load the file."""
        import json

        arrays = {}
        for name in self._ARRAY_ATTRS:
            v = getattr(self, name, None)
            if v is not None:
                v = np.asarray(v)
                if v.dtype == object:  # string id mappings
                    v = v.astype(str)
                arrays[name] = v
        params = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                  for k, v in self.get_params().items() if k != "device"}
        meta = {
            "class": self.__class__.__name__,
            "params": params,
            "glob_mean": float(getattr(self, "glob_mean_", 0.0)),
            "reindex": bool(getattr(self, "reindex_", False)),
            "is_fitted": bool(getattr(self, "is_fitted_", False)),
            "w_main_multiplier": float(
                getattr(self, "w_main_multiplier_", 1.0)
            ),
            "scaling_biasA": float(getattr(self, "scaling_biasA_", 0.0)),
            "scaling_biasB": float(getattr(self, "scaling_biasB_", 0.0)),
            "m_orig": getattr(self, "_m_orig", None),
            "n_orig": getattr(self, "_n_orig", None),
        }
        np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)
        return self

    @classmethod
    def load(cls, path, device="cuda"):
        """Restore a model saved with .save() by either package, placed on
        ``device`` for predict/topN."""
        import json

        import cmfrec_torch

        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            klass = getattr(cmfrec_torch, meta["class"], None)
            if klass is None:
                raise ValueError(f"cmfrec_torch has no model class "
                                 f"{meta['class']!r} yet (see ROADMAP.md)")
            model = klass(**meta["params"], device=device)
            model._reset()
            model.dtype_ = resolve_dtype(meta["params"].get("use_float", True))
            for name in cls._ARRAY_ATTRS:
                if name in data:
                    setattr(model, name, data[name])
        model.glob_mean_ = meta["glob_mean"]
        model.reindex_ = meta["reindex"]
        model.is_fitted_ = meta["is_fitted"]
        model.w_main_multiplier_ = meta["w_main_multiplier"]
        model.scaling_biasA_ = float(meta.get("scaling_biasA", 0.0))
        model.scaling_biasB_ = float(meta.get("scaling_biasB", 0.0))
        if meta.get("m_orig") is not None:
            model._m_orig = int(meta["m_orig"])
        if meta.get("n_orig") is not None:
            model._n_orig = int(meta["n_orig"])
        return model
