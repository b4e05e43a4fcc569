"""Mid-fit periodic checkpointing (SURVEY §5.4).

The reference has no serialization in its C core — model state is plain
arrays owned by the host language, and ``reset_values=false`` restarts a
fit from caller-passed matrices (upstream cmfrec src/cmfrec.h:1858).  On
TPU the analogous production need is stronger: long fits on preemptible
hardware.  Every fit function accepts

    checkpoint_path="ckpt.npz", checkpoint_every=N

and writes the CURRENT factor state every N completed iterations (atomic
rename, so a preemption mid-write never corrupts the previous file).  The
saved dict maps 1:1 onto the fit functions' ``init=`` warm-start argument, so

    init, done = load_fit_checkpoint("ckpt.npz")
    fit_*(..., niter=total - done, init=init)

resumes bit-exactly: given identical data and hyperparameters the fits
are deterministic functions of the factor state (glob_mean/centering are
recomputed identically from the data), which tests pin.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..parallel.mesh import barrier, is_writer


def save_fit_checkpoint(path: str, arrays: dict, iterations_done: int,
                        niter_total: int) -> None:
    """Atomically write factor state; None entries are skipped.  Device
    arrays are downloaded here (np.asarray) — the only host<->device
    traffic checkpointing adds."""
    payload = {k: np.asarray(v) for k, v in arrays.items() if v is not None}
    payload["__iterations_done__"] = np.asarray(iterations_done)
    payload["__niter_total__"] = np.asarray(niter_total)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        # rename-without-fsync can leave a zero-length file after power
        # loss / VM preemption — exactly the event this module guards
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def load_fit_checkpoint(path: str):
    """Returns (init_dict, iterations_done).  ``init_dict`` plugs directly
    into any fit function's ``init=``."""
    with np.load(path) as z:
        done = int(z["__iterations_done__"])
        init = {k: z[k] for k in z.files if not k.startswith("__")}
    return init, done


class FitCheckpointer:
    """Per-fit helper: call ``maybe_save(it, state_fn)`` at the end of
    each iteration; ``state_fn`` is only invoked (and state only
    downloaded) when this iteration actually checkpoints.  Under a mesh
    (parallel/mesh.py) every rank calls ``state_fn`` (under the big-axis
    ring it makes the state whole by collectives): rank 0 writes the file
    and the others wait at a barrier until it is in place."""

    def __init__(self, path: Optional[str], every: int, niter: int,
                 mesh=None):
        self.path = path
        self.mesh = mesh
        self.every = int(every) if path else 0
        self.niter = niter
        if path and self.every <= 0:
            raise ValueError(
                "checkpoint_path was given but checkpoint_every is "
                f"{every!r}; pass checkpoint_every=N (N >= 1) or no "
                "checkpoint is ever written")
        if path and self.every >= niter and niter > 1:
            import warnings
            warnings.warn(
                f"checkpoint_every={self.every} >= niter={niter}: the only "
                "checkpointable iteration is the last one, whose state is "
                "the fit's own return value — no checkpoint file will be "
                "written", stacklevel=3)

    def maybe_save(self, it_done: int, state_fn) -> None:
        if self.every <= 0:
            return
        # the final iteration's state is the fit's own return value —
        # don't pay a redundant download for it
        if it_done % self.every == 0 and it_done < self.niter:
            state = state_fn()
            if is_writer(self.mesh):
                save_fit_checkpoint(self.path, state, it_done, self.niter)
            barrier(self.mesh)
