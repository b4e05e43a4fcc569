"""Carry fitted state from cmfrec_tpu into cmfrec_torch, as plain arrays.

Neither function imports JAX: they take the NumPy arrays (or anything
``np.asarray`` accepts) that a cmfrec_tpu fit returns or a fitted
cmfrec_tpu ``CMF`` or ``CMF_implicit`` holds.  ``load`` of a file written
by cmfrec_tpu's ``save`` is the on-disk form of the same hand-over.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .models.cmf import CMF, CMF_implicit
from .models.imputer import CMF_imputer


def init_from_arrays(d: dict, device="cuda") -> dict:
    """A cmfrec_tpu fit result, or any dict with A/B[/biasA/biasB], as the
    port's ``init=`` dict: f32 tensors on ``device`` (None where absent).
    A collective result's C/D/Ai/Bi are left out: the dense engine solves
    them from A/B before their first use."""
    dev = resolve_device(device)
    return {key: None if d.get(key) is None else
            torch.as_tensor(np.asarray(d[key], np.float32), device=dev)
            for key in ("A", "B", "biasA", "biasB")}


def cmf_from_arrays(*, A, B, user_bias=None, item_bias=None, glob_mean=0.0,
                    user_mapping=None, item_mapping=None, params=None,
                    w_main_multiplier=1.0, C=None, D=None, Ai=None, Bi=None,
                    U_colmeans=None, I_colmeans=None, scaling_biasA=0.0,
                    scaling_biasB=0.0, cls=CMF, device="cuda"):
    """A fitted port model of class ``cls`` (``CMF``, ``CMF_implicit`` or
    ``CMF_imputer``) from a fitted cmfrec_tpu model's attributes (A_, B_,
    user_bias_, item_bias_, glob_mean_, user_mapping_, item_mapping_,
    w_main_multiplier_ of an implicit model, a collective model's C_, D_,
    Ai_, Bi_, U_colmeans_ and I_colmeans_, scaling_biasA_ and
    scaling_biasB_, and get_params(), which carries scale_bias_const).
    Like ``load``, it builds no prediction caches
    (``force_precompute_for_predictions`` does)."""
    if cls not in (CMF, CMF_implicit, CMF_imputer):
        raise ValueError("cls must be CMF, CMF_implicit or CMF_imputer, "
                         f"got {cls!r}")
    model = cls(**{**(params or {}), "device": device})
    model._reset()
    model.dtype_ = np.dtype(np.float32)

    def arr(a):
        return None if a is None else np.asarray(a, np.float32)

    model.A_, model.B_ = arr(A), arr(B)
    model.user_bias_, model.item_bias_ = arr(user_bias), arr(item_bias)
    model.C_, model.D_, model.Ai_, model.Bi_ = (arr(C), arr(D), arr(Ai),
                                                arr(Bi))
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
