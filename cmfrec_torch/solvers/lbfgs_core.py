"""L-BFGS with the zoom line search: the counterpart of the optax optimizer
that cmfrec_tpu's L-BFGS fits call (``optax.lbfgs(memory_size=m)`` with
``scale_init_precond=True``, its default line search
``scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')``, and ``optax.value_and_grad_from_state``,
which reuses the line search's last value and gradient), transcribed from
optax 0.2.6: ``scale_by_lbfgs`` (optax/_src/transform.py), the zoom line
search (optax/_src/linesearch.py) and the chain of ``optax.lbfgs``
(optax/_src/alias.py).  ``torch.optim.LBFGS`` is another algorithm, with
other steps and stops, and is not used.

The parameters are one flat vector: a fit lays its dict of tensors out
in sorted key order (the order a JAX pytree flattens a dict in) with
``FlatParams``, so each inner product and norm is one reduction where
optax sums leaf by leaf; a float64 trajectory follows optax's all the same
(tests/test_torch_lbfgs.py), and an iteration launches a few dozen kernels
instead of a few hundred.  The line search's branch decisions run on the
host: each trial reads its value and slope in one device-to-host copy
(``host_syncs`` counts the copies), and the curvature and
sufficient-decrease tests, the cubic and quadratic interpolation and the
interval updates are Python floating-point arithmetic, float64 as optax's
under x64.  The L-BFGS memory, its two-loop recursion and the initial
scaling stay on the parameters' device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

# scale_by_zoom_linesearch's defaults, as optax.lbfgs sets them
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5  # stepsize_precision
INCREASE_FACTOR = 2.0
TOL = 0.0


class FlatParams:
    """A dict of tensors laid out in one flat vector, keys in sorted
    order: ``flatten(dict)`` -> vector, ``views(vector)`` -> dict of views
    of it."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.keys = sorted(params)
        self.shapes = [tuple(params[key].shape) for key in self.keys]
        self.sizes = [params[key].numel() for key in self.keys]

    def flatten(self, params):
        return torch.cat([params[key].reshape(-1) for key in self.keys])

    def views(self, x):
        return {key: part.view(shape) for key, part, shape in zip(
            self.keys, torch.split(x, self.sizes), self.shapes)}


def _add_scale(x, s, y):
    """x + s * y (s a float or a 0-d tensor)."""
    return x + s * y


# --------------------------------------------------------------------- #
# host-side scalar arithmetic of the zoom line search                   #
# --------------------------------------------------------------------- #


def _nan(*xs) -> bool:
    return any(x != x for x in xs)


def _fmax(a: float, b: float) -> float:
    """jnp.maximum: NaN if either is NaN."""
    return math.nan if _nan(a, b) else max(a, b)


def _fmin(a: float, b: float) -> float:
    return math.nan if _nan(a, b) else min(a, b)


def _violation(err: float) -> float:
    """An error clipped at 0, NaN turned into inf."""
    err = _fmax(err, 0.0)
    return math.inf if _nan(err) else err


def _f64(fn):
    """Run ``fn`` in numpy float64 scalars with IEEE semantics (division
    by zero gives inf or NaN, the square root of a negative NaN), as the
    jnp arithmetic it transcribes."""
    def wrapped(*args):
        with np.errstate(all="ignore"):
            return float(fn(*(np.float64(a) for a in args)))
    return wrapped


@_f64
def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a (optax's _cubicmin); NaN when there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * dc * dc) * v0 + db * db * db * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


@_f64
def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init) -> float:
    """Armijo's sufficient decrease, or Hager and Zhang's approximate one
    close to a minimum, whichever is the smaller violation."""
    dec = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value - value_init - APPROX_DEC_RTOL * abs(value_init)
    approx = _fmax(approx, delta_values)
    return _violation(_fmin(approx, dec))


def _curvature_error(slope, slope_init) -> float:
    return _violation(abs(slope) - CURV_RTOL * abs(slope_init))


class _LineSearch:
    """One zoom line search along ``updates`` from ``params``: the state
    of optax's ZoomLinesearchState, scalars on the host."""

    def __init__(self, core, params, updates, value, grad, slope):
        self.core, self.params, self.updates = core, params, updates
        self.count = 0
        self.value_init, self.slope_init = value, slope
        self.stepsize, self.value, self.grad, self.slope = 0.0, value, grad, slope
        self.decrease_error = self.curvature_error = math.inf
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = 0.0, value, slope
        self.high, self.value_high, self.slope_high = 0.0, value, slope
        self.cubic_ref, self.value_cubic_ref = 0.0, value
        self.safe_stepsize, self.safe_value, self.safe_grad = 0.0, value, grad

    def _on_line(self, stepsize):
        """(value, grad, slope) at params + stepsize * updates."""
        step = _add_scale(self.params, stepsize, self.updates)
        value, grad = self.core.evaluate(step)
        slope = torch.dot(grad, self.updates)
        value, slope = self.core.read(torch.stack([value.to(slope.dtype),
                                                   slope]))
        return value, grad, slope

    def run(self):
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom()
            else:
                self._search()
            if self.failed:
                self._try_safe_step()
        return self.stepsize, self.value, self.grad

    def _search(self):
        it = self.count
        prev_step, prev_value, prev_slope = self.stepsize, self.value, self.slope
        new_step = 1.0 if it == 0 else INCREASE_FACTOR * prev_step
        value, grad, slope = self._on_line(new_step)
        dec = _decrease_error(new_step, value, slope, self.value_init,
                              self.slope_init)
        curv = _curvature_error(slope, self.slope_init)
        error = _fmax(dec, curv)
        if dec <= TOL:
            self.safe_stepsize, self.safe_value, self.safe_grad = (
                new_step, value, grad)
        set_high = (dec > 0.0) or (value >= prev_value and it > 0)
        set_low = slope >= 0.0 and not set_high
        if set_low:
            lo, hi = (new_step, value, slope), (prev_step, prev_value,
                                                 prev_slope)
        else:
            lo, hi = (prev_step, prev_value, prev_slope), (new_step, value,
                                                            slope)
        self.low, self.value_low, self.slope_low = lo
        self.high, self.value_high, self.slope_high = hi
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self.interval_found = set_high or set_low or error <= TOL
        # no max_stepsize: done only when both conditions hold
        self.done = error <= TOL
        self.failed = it + 1 >= MAX_LINESEARCH_STEPS and not self.done
        self._advance(new_step, value, grad, slope, dec, curv)

    def _zoom(self):
        it = self.count
        low, high = self.low, self.high
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
        too_small = delta <= INTERVAL_THRESHOLD
        mid_cubic = _cubicmin(low, self.value_low, self.slope_low, high,
                              self.value_high, self.cubic_ref,
                              self.value_cubic_ref)
        use_cubic = left + cubic_chk < mid_cubic < right - cubic_chk
        mid_quad = _quadmin(low, self.value_low, self.slope_low, high,
                            self.value_high)
        use_quad = (not use_cubic
                    and left + quad_chk < mid_quad < right - quad_chk)
        if use_cubic:
            middle = mid_cubic
        elif use_quad:
            middle = mid_quad
        else:
            middle = (low + high) / 2.0
        value, grad, slope = self._on_line(middle)
        dec = _decrease_error(middle, value, slope, self.value_init,
                              self.slope_init)
        curv = _curvature_error(slope, self.slope_init)
        error = _fmax(dec, curv)
        if dec <= TOL and value < self.safe_value:
            self.safe_stepsize, self.safe_value, self.safe_grad = (
                middle, value, grad)
        done = error <= TOL
        set_high_to_mid = dec > 0.0 or value >= self.value_low
        set_high_to_low = slope * (high - low) >= 0.0 and not set_high_to_mid
        old_low = (low, self.value_low, self.slope_low)
        old_high = (high, self.value_high, self.slope_high)
        new_high = (middle, value, slope) if set_high_to_mid else old_high
        if set_high_to_low:
            new_high = old_low
        new_low = old_low if set_high_to_mid else (middle, value, slope)
        self.cubic_ref, self.value_cubic_ref = (
            old_high[:2] if (set_high_to_mid or set_high_to_low)
            else old_low[:2])
        self.low, self.value_low, self.slope_low = new_low
        self.high, self.value_high, self.slope_high = new_high
        self.done = done
        self.failed = ((it + 1 >= MAX_LINESEARCH_STEPS
                        or (too_small and self.safe_stepsize > 0.0))
                       and not done)
        self._advance(middle, value, grad, slope, dec, curv)

    def _advance(self, step, value, grad, slope, dec, curv):
        self.count += 1
        self.stepsize, self.value, self.grad, self.slope = (step, value, grad,
                                                            slope)
        self.decrease_error, self.curvature_error = dec, curv

    def _try_safe_step(self):
        """A failed search takes the best step that decreased enough, if
        any; the last trial otherwise (optax's _try_safe_step)."""
        if self.safe_stepsize > 0.0 or math.isinf(self.decrease_error):
            self.stepsize, self.value, self.grad = (
                self.safe_stepsize, self.safe_value, self.safe_grad)


class Lbfgs:
    """optax.lbfgs(memory_size) chained with value_and_grad_from_state, on
    a flat parameter vector.

    ``value_and_grad(x) -> (value, grad)`` returns a 0-d tensor and a
    vector shaped as ``x``.  ``step(x)`` takes one iteration and returns
    (the new x, the value at the old one).  Counters: ``n_evals``
    objective evaluations, ``host_syncs`` device-to-host reads of scalars,
    ``linesearch_steps`` trials."""

    def __init__(self, value_and_grad: Callable, params: torch.Tensor,
                 memory_size: int):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self._vg = value_and_grad
        self.memory_size = int(memory_size)
        self.count = 0
        self.prev_params = torch.zeros_like(params)
        self.prev_grad = torch.zeros_like(params)
        self.diff_params = [torch.zeros_like(params)
                            for _ in range(self.memory_size)]
        self.diff_grads = [torch.zeros_like(params)
                           for _ in range(self.memory_size)]
        self.rhos = [params.new_zeros(()) for _ in range(self.memory_size)]
        # the line search's last value and gradient (value_and_grad_from_state)
        self.value = math.inf
        self.grad = None
        self.n_evals = 0
        self.host_syncs = 0
        self.linesearch_steps = 0

    def evaluate(self, params):
        self.n_evals += 1
        return self._vg(params)

    def read(self, t: torch.Tensor):
        """Scalars to the host: one sync."""
        self.host_syncs += 1
        return t.tolist()

    def _precondition(self, grad, gamma, memory_idx):
        """The two-loop recursion (optax's _precondition_by_lbfgs)."""
        m = self.memory_size
        indices = [(memory_idx + j) % m for j in range(m)]
        vec = grad
        alphas = {}
        for idx in reversed(indices):
            alpha = self.rhos[idx] * torch.dot(self.diff_params[idx], vec)
            vec = _add_scale(vec, -alpha, self.diff_grads[idx])
            alphas[idx] = alpha
        vec = gamma * vec
        for idx in indices:
            beta = self.rhos[idx] * torch.dot(self.diff_grads[idx], vec)
            vec = _add_scale(vec, alphas[idx] - beta, self.diff_params[idx])
        return vec

    def step(self, params):
        if math.isinf(self.value) or math.isnan(self.value):
            value, grad = self.evaluate(params)
            self.value = self.read(value)
            self.grad = grad
        value, grad = self.value, self.grad

        # scale_by_lbfgs: the memory, then the scaled identity
        m = self.memory_size
        memory_idx = self.count % m
        prev_idx = (self.count - 1) % m
        if self.count > 0:
            dp = params - self.prev_params
            du = grad - self.prev_grad
            vd = torch.dot(du, dp)
            self.diff_params[prev_idx] = dp
            self.diff_grads[prev_idx] = du
            self.rhos[prev_idx] = torch.where(vd == 0.0, torch.zeros_like(vd),
                                              1.0 / vd)
            den = torch.dot(du, du)
            gamma = torch.where(den > 0.0, vd / den, torch.ones_like(den))
        else:
            norm = torch.sqrt(torch.dot(grad, grad))
            gamma = torch.minimum(torch.ones_like(norm), 1.0 / norm)
        precond = self._precondition(grad, gamma, memory_idx)
        self.count += 1
        self.prev_params, self.prev_grad = params, grad

        # scale(-1.0), then the zoom line search from stepsize 1
        updates = -1.0 * precond
        slope = self.read(torch.dot(updates, grad))
        ls = _LineSearch(self, params, updates, value, grad, slope)
        stepsize, self.value, self.grad = ls.run()
        self.linesearch_steps += ls.count
        return _add_scale(params, stepsize, updates), value
