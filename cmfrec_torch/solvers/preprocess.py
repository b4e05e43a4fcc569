"""Host-side preprocessing (port of cmfrec_tpu/solvers/preprocess.py).

Only the global mean lives here: the dense-masked engine computes its
starting biases on the device (dense_masked._device_bias_init).  The mean
follows the reference's calc_mean_and_center
(upstream cmfrec src/common.c:3423), accumulated in float64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def weighted_global_mean(
    vals: np.ndarray, wgt: Optional[np.ndarray] = None
) -> float:
    if wgt is None:
        return float(np.mean(vals, dtype=np.float64))
    sw = float(np.sum(wgt, dtype=np.float64))
    return float(np.sum(vals * wgt, dtype=np.float64) / max(sw, 1e-300))
