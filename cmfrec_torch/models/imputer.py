"""CMF_imputer — the sklearn-imputer-style CMF (port of
cmfrec_tpu/models/imputer.py; reference: upstream cmfrec/__init__.py:8667)."""

from __future__ import annotations

import numpy as np

from ..utils import profiling
from .cmf import CMF


class CMF_imputer(CMF):
    """Drop-in sklearn transformer: ``fit`` on a dense matrix with NaNs,
    ``transform`` fills them with the model's predictions."""

    @profiling.recorded_fit
    def fit(self, X, y=None, U=None, I=None, U_bin=None, I_bin=None,
            W=None):
        """sklearn-style fit (y is ignored)."""
        return super().fit(np.asarray(X, np.float64), U=U, I=I,
                           U_bin=U_bin, I_bin=I_bin, W=W)

    def fit_transform(self, X, y=None, **fit_params):
        """fit, then transform: the imputed values come from warm factors
        solved against the final B (not the training A_, which was solved
        against the B before the last update)."""
        X = np.asarray(X, np.float64)
        self.fit(X, **fit_params)
        return self.transform(X)
