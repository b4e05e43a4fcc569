"""Global configuration helpers for cmfrec_torch (port of cmfrec_tpu/config.py).

dtype follows the reference's ``use_float`` flag
(upstream cmfrec src/cmfrec.h:232-313).  The device is explicit: every fit
and model takes ``device=``, ``"cuda"`` by default, and a CUDA request on a
machine without a card raises instead of falling back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_dtype(use_float: bool | str | np.dtype) -> np.dtype:
    """Map the reference's ``use_float`` flag (or a dtype-ish) to a numpy dtype."""
    if isinstance(use_float, (bool, np.bool_)):
        return np.dtype(np.float32 if use_float else np.float64)
    return np.dtype(np.dtype(use_float).type)


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a fit's numpy dtype (float32 or float64)."""
    return torch.float64 if np.dtype(dtype) == np.float64 else torch.float32


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device a fit or model runs on; raises if it is unusable."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} was requested but torch sees no CUDA "
                "device; pass device='cpu' to run the plain torch path")
        # The polish iteration, exact mode, the NA-as-zero solves and the
        # kernels' plain twins rely on true f32 matrix products (TF32 keeps
        # ~3 decimal digits, too few for the f32 fixed point).
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev


# ----------------------------------------------------------------------- #
# interrupt handling (the reference's handle_interrupt flag,               #
# upstream cmfrec src/helpers.c:1493 act_on_interrupt)                     #
# ----------------------------------------------------------------------- #

_HANDLE_INTERRUPT = True


def set_handle_interrupt(flag: bool) -> bool:
    """Set whether fit loops catch SIGINT and return the partial model
    (True, reference default) or re-raise (False).  Returns the old value."""
    global _HANDLE_INTERRUPT
    old = _HANDLE_INTERRUPT
    _HANDLE_INTERRUPT = bool(flag)
    return old


def should_handle_interrupt() -> bool:
    return _HANDLE_INTERRUPT
