"""`zoom_step`: one step of optax's zoom line search as a CUDA kernel.

The JAX package runs `optax.lbfgs()`'s line search
(`scale_by_zoom_linesearch`) as a `lax.while_loop` inside the jitted step
(`neuralpde_tpu/train.py:86-96`): its state never leaves the device.  Here
the search's state is one packed 1-D tensor of the parameters' real dtype
(the fields below), and one search step is a transition of it:
`zoom_transition` on host scalars (the plain version, the CPU path and the
kernel's oracle) or the `zoom_step` kernel of `csrc/lbfgs_zoom.cu` on the
card, which reads the state and the trial's value and slope from device
memory and writes the next state, the next trial stepsize and the
``searching`` flag, so that `train.LBFGS` runs a whole step with no host
read (the flag guards each trial's CUDA-graph IF body).

`zoom_init` starts a search from the value and slope at stepsize 0;
`zoom_transition` takes the value and slope at the trial stepsize
``state[NEXT]``.  Once the search ends, ``state[STEPSIZE]`` holds its final
stepsize (the safe stepsize where it failed with one), ``state[NEXT]``
the same, and `zoom_step` writes optax's info (stepsize, steps, decrease
and curvature errors).

Dispatch is by the device of the state: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.
`zoom_step_cuda.launches` counts kernel launches; graph runners report the
launches of replays with `add_replayed`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ._build import check, load_library

# optax.lbfgs()'s line search: scale_by_zoom_linesearch(
# max_linesearch_steps=20, initial_guess_strategy="one") with the defaults
# of its other arguments (no largest stepsize)
LINESEARCH_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
STEPSIZE_PRECISION, INCREASE_FACTOR, TOL = 1e-5, 2.0, 0.0

# The packed state, field by field (the kernel reads the same layout):
# the search's step count and flags (0 or 1), the last stepsize tried (the
# final one once the search ends), the interval's ends and the cubic's
# third point, the safe stepsize (sufficient decrease met), each with its
# value and slope where the search keeps one, the values at stepsize 0, the
# last step's decrease and curvature errors, and the next trial stepsize.
COUNT, INTERVAL_FOUND, DONE, FAILED = 0, 1, 2, 3
STEPSIZE, LOW, HIGH, CUBIC_REF, SAFE_STEPSIZE = 4, 5, 6, 7, 8
VALUE, VALUE_LOW, VALUE_HIGH, VALUE_CUBIC_REF, SAFE_VALUE, VALUE_INIT = (
    9, 10, 11, 12, 13, 14)
SLOPE, SLOPE_LOW, SLOPE_HIGH, SLOPE_INIT = 15, 16, 17, 18
DEC_ERR, CURV_ERR, NEXT = 19, 20, 21
STATE_SIZE = 22

_LAUNCHER_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


# ---------------------------------------------------------------------------
# Plain version (the CPU path and the kernel's oracle): numpy scalars of the
# state's dtype, every constant cast to it first.  `_maximum`/`_minimum` are
# numpy's `maximum`/`minimum` on scalars: NaN if the first is NaN, else the
# first if it is larger (smaller), else the second.
# ---------------------------------------------------------------------------

def _maximum(a, b):
    return a if (a > b or np.isnan(a)) else b


def _minimum(a, b):
    return a if (a < b or np.isnan(a)) else b


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's ``_cubicmin``: the critical point of the cubic through (a,
    fa), (b, fb), (c, fc) with slope fpa at a; NaN where there is none."""
    f = type(a)
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * (dc * dc))) * v0 + db * (db * db) * v1) / denom
    radical = B * B - f(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (f(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's ``_quadmin``: the critical point of the quadratic through
    (a, fa), (b, fb) with slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (type(a)(2.0) * B)


def zoom_init(value0, slope0) -> np.ndarray:
    """The packed state of a search from value ``value0`` and slope
    ``slope0`` (numpy scalars of one float dtype) at stepsize 0; its first
    trial is stepsize 1."""
    state = np.zeros(STATE_SIZE, dtype=type(value0))
    state[VALUE:VALUE_INIT + 1] = value0
    state[SLOPE:SLOPE_INIT + 1] = slope0
    state[DEC_ERR:CURV_ERR + 1] = np.inf
    state[NEXT] = 1.0
    return state


def _next_stepsize(interval_found, stepsize, low, value_low, slope_low, high,
                   value_high, cubic_ref, value_cubic_ref):
    """The trial after a step that did not end the search: the stepsize
    doubled while the interval is searched, then a cubic, else quadratic,
    else bisection step into the interval."""
    f = type(stepsize)
    if not interval_found:
        return f(INCREASE_FACTOR) * stepsize
    delta = np.abs(high - low)
    left, right = _minimum(high, low), _maximum(high, low)
    cubic = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref,
                      value_cubic_ref)
    quad = _quadmin(low, value_low, slope_low, high, value_high)
    if left + f(0.2) * delta < cubic < right - f(0.2) * delta:
        return cubic
    if left + f(0.1) * delta < quad < right - f(0.1) * delta:
        return quad
    return (low + high) / f(2.0)


def zoom_transition(state: np.ndarray, value, slope):
    """One step of the search: ``value`` and ``slope`` (numpy scalars of the
    state's dtype) are those at the trial stepsize ``state[NEXT]``.  The
    interval search (stepsize 1, then doubled) runs until an interval holds
    a stepsize that meets both the sufficient decrease (Armijo, or Hager
    and Zhang's approximate decrease once the value is within 1e-6 of the
    start) and the curvature criteria; then the zoom (a cubic, else
    quadratic, else bisection step) into it.  A search that reaches the
    step bound, or whose interval falls below 1e-5 with a stepsize of
    sufficient decrease known, fails and ends at that safe stepsize where
    there is one (or where the last value was not finite), else at the last
    stepsize tried.

    Returns ``(new state, next trial stepsize, searching)``; once the search
    ends the next stepsize is the final one."""
    f = state.dtype.type
    zero, inf, tol = f(0.0), f(np.inf), f(TOL)
    (count, interval_found, done, failed, stepsize, low, high, cubic_ref,
     safe_stepsize, value_prev, value_low, value_high, value_cubic_ref,
     safe_value, value_init, slope_prev, slope_low, slope_high, slope_init,
     dec_err, curv_err, new) = state
    count = int(count)
    interval_found, done, failed = bool(interval_found), bool(done), False
    v, s = f(value), f(slope)

    def errors(stepsize, value, slope):
        dec = value - value_init - f(SLOPE_RTOL) * stepsize * slope_init
        approx = slope - f(2 * SLOPE_RTOL - 1.0) * slope_init
        delta = value - value_init - f(APPROX_DEC_RTOL) * np.abs(value_init)
        dec = _maximum(_minimum(_maximum(approx, delta), dec), zero)
        curv = _maximum(np.abs(slope) - f(CURV_RTOL) * np.abs(slope_init),
                        zero)
        return (inf if np.isnan(dec) else dec,
                inf if np.isnan(curv) else curv)

    with np.errstate(all="ignore"):
        if not interval_found:
            dec_err, curv_err = errors(new, v, s)
            if dec_err <= tol:
                safe_stepsize, safe_value = new, v
            set_high = dec_err > zero or (v >= value_prev and count > 0)
            set_low = s >= zero and not set_high
            if set_low:
                low, value_low, slope_low = new, v, s
                high, value_high, slope_high = stepsize, value_prev, slope_prev
            else:
                low, value_low, slope_low = stepsize, value_prev, slope_prev
                high, value_high, slope_high = new, v, s
            done = max(dec_err, curv_err) <= tol
            interval_found = set_high or set_low or done
            failed = count + 1 >= LINESEARCH_STEPS and not done
            cubic_ref, value_cubic_ref = low, value_low
        else:
            too_small = np.abs(high - low) <= f(STEPSIZE_PRECISION)
            dec_err, curv_err = errors(new, v, s)
            if dec_err <= tol and v < safe_value:
                safe_stepsize, safe_value = new, v
            done = max(dec_err, curv_err) <= tol
            high_to_new = dec_err > zero or v >= value_low
            high_to_low = s * (high - low) >= zero and not high_to_new
            if high_to_new or high_to_low:
                cubic_ref, value_cubic_ref = high, value_high
            else:
                cubic_ref, value_cubic_ref = low, value_low
            if high_to_new:
                high, value_high, slope_high = new, v, s
            elif high_to_low:
                high, value_high, slope_high = low, value_low, slope_low
            if not high_to_new:
                low, value_low, slope_low = new, v, s
            failed = ((count + 1 >= LINESEARCH_STEPS
                       or (too_small and safe_stepsize > zero))
                      and not done)
        count += 1
        stepsize, value_prev, slope_prev = new, v, s
        if failed and (safe_stepsize > zero or np.isinf(dec_err)):
            stepsize, value_prev = safe_stepsize, safe_value
        searching = not (done or failed)
        new = (_next_stepsize(interval_found, stepsize, low, value_low,
                              slope_low, high, value_high, cubic_ref,
                              value_cubic_ref)
               if searching else stepsize)
    out = np.array([count, interval_found, done, failed, stepsize, low, high,
                    cubic_ref, safe_stepsize, value_prev, value_low,
                    value_high, value_cubic_ref, safe_value, value_init,
                    slope_prev, slope_low, slope_high, slope_init, dec_err,
                    curv_err, new], dtype=state.dtype)
    return out, out[NEXT], searching


def transition_cases(dtype, seed: int = 0, searches: int = 300) -> list:
    """``(state, value, slope)`` inputs of `zoom_transition` in ``dtype``
    (np.float32 or np.float64), to hold the kernel to the plain version:
    every step of ``searches`` searches along random one-dimensional
    functions (quadratics, quartics, cosines, a flat value that rounds to
    the start's, an unbounded one, ascent directions, a value that turns
    infinite), then each of their steps again with a value or slope of
    NaN, +-inf, +-0 or a subnormal."""
    f = np.dtype(dtype).type
    rng = np.random.default_rng(seed)
    kinds = (
        lambda x, a, b: (a * (x - b) ** 2, 2 * a * (x - b)),
        lambda x, a, b: ((x - b) ** 4, 4 * (x - b) ** 3),
        lambda x, a, b: (-np.cos(a * (x - b)), a * np.sin(a * (x - b))),
        lambda x, a, b: (1e8 + a * x ** 2, 2 * a * x),
        lambda x, a, b: (x ** 3 - 3 * x + np.exp(x), 3 * x ** 2 - 3
                         + np.exp(x)),
        lambda x, a, b: (np.where(x > b, a * x ** 2, np.inf),
                         np.where(x > b, 2 * a * x, np.nan)),
    )
    cases = []
    with np.errstate(all="ignore"):
        for i in range(searches):
            fn = kinds[i % len(kinds)]
            a, b = rng.uniform(0.2, 5.0), rng.normal()
            x0 = rng.normal(scale=2.0)
            u = rng.choice([-1.0, 1.0]) * rng.uniform(1e-3, 10.0)

            def evaluate(t):
                value, grad = fn(float(x0) + float(t) * u, a, b)
                return f(value), f(grad * u)

            state, searching = zoom_init(*evaluate(0.0)), True
            while searching:
                value, slope = evaluate(state[NEXT])
                cases.append((state, value, slope))
                state, _, searching = zoom_transition(state, value, slope)
        odd = [f(x) for x in (np.nan, np.inf, -np.inf, 0.0, -0.0,
                              np.finfo(dtype).smallest_subnormal)]
        for state, value, slope in list(cases):
            if rng.random() < 0.5:
                value = odd[rng.integers(len(odd))]
            else:
                slope = odd[rng.integers(len(odd))]
            cases.append((state, value, slope))
    return cases


def zoom_step_reference(state, value, slope, searching, learning_rate,
                        num_steps, decrease_error, curvature_error) -> None:
    """`zoom_transition` on tensors, in place: the state, the flag and, once
    the search ends, optax's info (the kernel's contract)."""
    new, _, go = zoom_transition(state.cpu().numpy(),
                                 value.detach().cpu().numpy()[()],
                                 slope.detach().cpu().numpy()[()])
    state.copy_(torch.from_numpy(new))
    searching.fill_(go)
    if not go:
        learning_rate.fill_(float(new[STEPSIZE]))
        num_steps.fill_(int(new[COUNT]))
        decrease_error.fill_(float(new[DEC_ERR]))
        curvature_error.fill_(float(new[CURV_ERR]))


# ---------------------------------------------------------------------------
# Kernel launcher
# ---------------------------------------------------------------------------

@functools.cache
def _launchers() -> ctypes.CDLL:
    lib = load_library()
    for sfx in _LAUNCHER_SUFFIX.values():
        fn = getattr(lib, f"zoom_step_{sfx}")
        fn.argtypes = [ctypes.c_void_p] * 9
        fn.restype = ctypes.c_int
    return lib


def _check(state, value, slope, searching, learning_rate, num_steps,
           decrease_error, curvature_error) -> str:
    """Validate what the kernel takes; returns the launcher's suffix."""
    real = (state, value, slope, learning_rate, decrease_error,
            curvature_error)
    if (any(t.dtype != state.dtype for t in real)
            or searching.dtype != torch.bool or num_steps.dtype != torch.int64):
        raise ValueError(
            "zoom_step: state, value, slope, learning_rate and the errors "
            "share one float dtype, searching is bool, num_steps int64; got "
            f"{[t.dtype for t in real]}, {searching.dtype}, {num_steps.dtype}")
    if state.shape != (STATE_SIZE,) or not state.is_contiguous():
        raise ValueError(f"zoom_step: state must be a contiguous "
                         f"({STATE_SIZE},) tensor, got {tuple(state.shape)}")
    scalars = (value, slope, searching, learning_rate, num_steps,
               decrease_error, curvature_error)
    if any(t.numel() != 1 for t in scalars):
        raise ValueError("zoom_step: value, slope, the flag and the info "
                         "are one element each")
    tensors = (state, *scalars)
    if any(t.device != state.device for t in tensors) or not state.is_cuda:
        raise ValueError("zoom_step kernel: every tensor on one CUDA device")
    if state.dtype not in _LAUNCHER_SUFFIX:
        raise ValueError(f"zoom_step kernel: dtype {state.dtype} unsupported "
                         "(float32 or float64)")
    return _LAUNCHER_SUFFIX[state.dtype]


def zoom_step_cuda(state, value, slope, searching, learning_rate, num_steps,
                   decrease_error, curvature_error) -> None:
    """One `zoom_transition` by the kernel, in place, on the current
    stream."""
    tensors = (state, value, slope, searching, learning_rate, num_steps,
               decrease_error, curvature_error)
    sfx = _check(*tensors)
    lib = _launchers()
    with torch.cuda.device(state.device):
        code = getattr(lib, f"zoom_step_{sfx}")(
            *(t.data_ptr() for t in tensors),
            torch.cuda.current_stream(state.device).cuda_stream)
    check(lib, code, "zoom_step launch")
    zoom_step_cuda.launches += 1


def zoom_step(state, value, slope, searching, learning_rate, num_steps,
              decrease_error, curvature_error) -> None:
    """One search step in place: the kernel for CUDA tensors, the plain
    version for CPU tensors (module note)."""
    if state.device.type not in ("cuda", "cpu"):
        raise ValueError(f"zoom_step: unsupported device {state.device}")
    fn = zoom_step_cuda if state.is_cuda else zoom_step_reference
    fn(state, value, slope, searching, learning_rate, num_steps,
       decrease_error, curvature_error)


_REPLAYED = {"zoom_step": 0}


def reset_launch_counts() -> None:
    zoom_step_cuda.launches = 0


def add_replayed(launches: int) -> None:
    """Count kernel launches made by replays of captured CUDA graphs."""
    _REPLAYED["zoom_step"] += launches


def reset_replayed_counts() -> None:
    _REPLAYED["zoom_step"] = 0


def replayed_counts() -> dict:
    return dict(_REPLAYED)


reset_launch_counts()
