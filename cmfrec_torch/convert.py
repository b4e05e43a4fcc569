"""Carry fitted state from cmfrec_tpu into cmfrec_torch, as plain arrays.

No function here imports JAX: they take the NumPy arrays (or anything
``np.asarray`` accepts) that a cmfrec_tpu fit returns or a fitted
cmfrec_tpu model holds.  ``load`` of a file written by cmfrec_tpu's
``save`` is the on-disk form of the same hand-over.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device, resolve_dtype
from .models.base import _BaseModel
from .models.cmf import CMF, CMF_implicit
from .models.imputer import CMF_imputer
from .models.most_popular import MostPopular
from .models.omf import OMF_explicit, OMF_implicit, ContentBased


def init_from_arrays(d: dict, device="cuda") -> dict:
    """A cmfrec_tpu fit result, or any dict with A/B[/biasA/biasB], as the
    port's ``init=`` dict: tensors on ``device`` in the arrays' own dtype
    (None where absent), which the fit drivers cast to the fit's dtype, as
    cmfrec_tpu's do.  A collective result's C/D/Ai/Bi are left out: the
    dense engine solves them from A/B before their first use."""
    dev = resolve_device(device)
    return {key: None if d.get(key) is None else
            torch.as_tensor(np.asarray(d[key]), device=dev)
            for key in ("A", "B", "biasA", "biasB")}


def cmf_from_arrays(*, A, B, user_bias=None, item_bias=None, glob_mean=0.0,
                    user_mapping=None, item_mapping=None, params=None,
                    w_main_multiplier=1.0, C=None, D=None, Ai=None, Bi=None,
                    Cb=None, Db=None, U_colmeans=None, I_colmeans=None,
                    scaling_biasA=0.0, scaling_biasB=0.0, cls=CMF,
                    device="cuda"):
    """A fitted port model of class ``cls`` (``CMF``, ``CMF_implicit`` or
    ``CMF_imputer``) from a fitted cmfrec_tpu model's attributes (A_, B_,
    user_bias_, item_bias_, glob_mean_, user_mapping_, item_mapping_,
    w_main_multiplier_ of an implicit model, a collective model's C_, D_,
    Ai_, Bi_, U_colmeans_ and I_colmeans_, an L-BFGS model's binary side
    factors Cb_ and Db_, scaling_biasA_ and scaling_biasB_, and
    get_params(), which carries scale_bias_const).  ``dtype_`` follows
    ``params["use_float"]`` (the class default without it), as in ``load``,
    and the arrays are kept in it.  Like ``load``, it builds no prediction
    caches (``force_precompute_for_predictions`` does)."""
    if cls not in (CMF, CMF_implicit, CMF_imputer):
        raise ValueError("cls must be CMF, CMF_implicit or CMF_imputer, "
                         f"got {cls!r}")
    model = cls(**{**(params or {}), "device": device})
    model._reset()
    model.dtype_ = resolve_dtype(model.use_float)

    def arr(a):
        return None if a is None else np.asarray(a, model.dtype_)

    model.A_, model.B_ = arr(A), arr(B)
    model.user_bias_, model.item_bias_ = arr(user_bias), arr(item_bias)
    model.C_, model.D_, model.Ai_, model.Bi_ = (arr(C), arr(D), arr(Ai),
                                                arr(Bi))
    model.Cb_, model.Db_ = arr(Cb), arr(Db)
    # the side-info column means stay f64, as a fit stores them
    model.U_colmeans_ = None if U_colmeans is None else np.asarray(
        U_colmeans, np.float64)
    model.I_colmeans_ = None if I_colmeans is None else np.asarray(
        I_colmeans, np.float64)
    model.glob_mean_ = float(glob_mean)
    model.w_main_multiplier_ = float(w_main_multiplier)
    # the constant bias penalty of scale_bias_const serving (fit-time mean
    # observation weight a row and a column)
    model.scaling_biasA_ = float(scaling_biasA)
    model.scaling_biasB_ = float(scaling_biasB)
    if user_mapping is not None and len(user_mapping):
        model.user_mapping_ = np.asarray(user_mapping)
        model.item_mapping_ = np.asarray(item_mapping)
        model.reindex_ = True
    model._m_orig, model._n_orig = model.A_.shape[0], model.B_.shape[0]
    model.is_fitted_ = True
    model._build_dicts()
    return model


OTHER_MODELS = (OMF_explicit, OMF_implicit, ContentBased, MostPopular)


def model_from_arrays(cls, arrays: dict, *, params=None, glob_mean=0.0,
                      w_main_multiplier=1.0, m_orig=None, n_orig=None,
                      device="cuda"):
    """A fitted ``OMF_explicit``, ``OMF_implicit``, ``ContentBased`` or
    ``MostPopular`` from a fitted cmfrec_tpu model of the same class:
    ``arrays`` maps attribute names of ``_BaseModel._ARRAY_ATTRS`` (A_, B_,
    C_, D_, Am_, Bm_, C_bias_, D_bias_, Cb_, Db_, the biases, column
    means and id mappings) to arrays, None or absent where the model has
    none; ``params`` is its get_params().  The arrays keep their dtype,
    and ``dtype_`` follows ``use_float`` as in ``load``.  Like ``load``, it
    builds no prediction caches (``force_precompute_for_predictions``
    does, where the class has one)."""
    if cls not in OTHER_MODELS:
        raise ValueError("cls must be one of "
                         f"{[c.__name__ for c in OTHER_MODELS]}, got {cls!r}")
    unknown = set(arrays) - set(_BaseModel._ARRAY_ATTRS)
    if unknown:
        raise ValueError(f"not fitted array attributes: {sorted(unknown)}")
    params = dict(params or {})
    model = cls(**{**params, "device": device})
    model._reset()
    model.dtype_ = resolve_dtype(params.get("use_float",
                                            model.get_params()["use_float"]))
    for name, a in arrays.items():
        setattr(model, name, None if a is None else np.asarray(a))
    mapping = arrays.get("user_mapping_")
    if mapping is not None and len(mapping):
        model.reindex_ = True
    else:
        model.user_mapping_ = np.array([], dtype=object)
        model.item_mapping_ = np.array([], dtype=object)
    model.glob_mean_ = float(glob_mean)
    model.w_main_multiplier_ = float(w_main_multiplier)
    if m_orig is not None:
        model._m_orig, model._n_orig = int(m_orig), int(n_orig)
    model.is_fitted_ = True
    model._build_dicts()
    return model
