"""Carry fitted state from cmfrec_tpu into cmfrec_torch, as plain arrays.

Neither function imports JAX: they take the NumPy arrays (or anything
``np.asarray`` accepts) that a cmfrec_tpu fit returns or a fitted
cmfrec_tpu ``CMF`` holds.  ``CMF.load`` of a file written by
``cmfrec_tpu.CMF.save`` is the on-disk form of the same hand-over.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .models.cmf import CMF


def init_from_arrays(d: dict, device="cuda") -> dict:
    """A cmfrec_tpu fit result, or any dict with A/B[/biasA/biasB], as the
    port's ``init=`` dict: f32 tensors on ``device`` (None where absent)."""
    dev = resolve_device(device)
    return {key: None if d.get(key) is None else
            torch.as_tensor(np.asarray(d[key], np.float32), device=dev)
            for key in ("A", "B", "biasA", "biasB")}


def cmf_from_arrays(*, A, B, user_bias=None, item_bias=None, glob_mean=0.0,
                    user_mapping=None, item_mapping=None, params=None,
                    device="cuda") -> CMF:
    """A fitted port ``CMF`` from a fitted cmfrec_tpu ``CMF``'s attributes
    (A_, B_, user_bias_, item_bias_, glob_mean_, user_mapping_,
    item_mapping_ and get_params())."""
    model = CMF(**(params or {}), device=device)
    model._reset()
    model.dtype_ = np.dtype(np.float32)

    def arr(a):
        return None if a is None else np.asarray(a, np.float32)

    model.A_, model.B_ = arr(A), arr(B)
    model.user_bias_, model.item_bias_ = arr(user_bias), arr(item_bias)
    model.glob_mean_ = float(glob_mean)
    if user_mapping is not None and len(user_mapping):
        model.user_mapping_ = np.asarray(user_mapping)
        model.item_mapping_ = np.asarray(item_mapping)
        model.reindex_ = True
    model._m_orig, model._n_orig = model.A_.shape[0], model.B_.shape[0]
    model.is_fitted_ = True
    model._build_dicts()
    return model
