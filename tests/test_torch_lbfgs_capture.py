"""The device form of the port's L-BFGS step (`train.LBFGS`), on the CPU.

On the card an L-BFGS step reads nothing on the host: the zoom line search
is a packed state that the `zoom_step` kernel advances one transition a
trial, and the two-loop recursion indexes its memory slots with the device
count.  The CPU runs the same step with the kernel's plain version
(`kernels.lbfgs_zoom.zoom_transition` on numpy scalars) and each trial's
CUDA-graph IF body as a Python conditional on the ``searching`` flag.  These
tests hold that form to what it replaces:

* the transition, composed step by step, against `train.zoom_linesearch`
  (bit for bit) and optax's `zoom_linesearch` (float64 1e-9 relative, as
  `tests/test_torch_lbfgs.py`; float32 1e-5 against optax in float32, whose
  line-search scalars JAX's x64 keeps partly in float64), on that file's
  one-dimensional functions and on one whose values are NaN past the start,
  whose search fails on an infinite decrease error;
* the device-index recursion against the host-index one (the count read on
  the host, Python slot indices), bit for bit, for counts 0 to
  2 * memory_size, so the slot wraps;
* `LBFGS.step` against optax's on the 2-D Poisson grid problem, plain and
  reweighted, with every search step one plain `zoom_step` and the numpy
  loop never run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralpde_tpu_torch import train
from neuralpde_tpu_torch.kernels import lbfgs_zoom
from test_torch_lbfgs import (
    FUNCTIONS, TOL, _assert_steps_match, _optax_search, _poisson_pair,
)

# values NaN wherever the search looks: every trial's decrease error is
# infinite, so the search fails at its bound and returns stepsize 0 (the
# safe stepsize, found never) by the `np.isinf(dec_err)` rule
CASES = {**{k: v[:3] for k, v in FUNCTIONS.items()},
         "nan_wall": (lambda x, xp: xp.where(x < 1.0, np.nan, x ** 2), 1.0,
                      -1.0)}


def _composed(value, slope, evaluate):
    """`zoom_init`, then `zoom_transition` until the flag drops."""
    state, searching, trials = lbfgs_zoom.zoom_init(value, slope), True, []
    while searching:
        trials.append(state[lbfgs_zoom.NEXT])
        state, nxt, searching = lbfgs_zoom.zoom_transition(
            state, *evaluate(state[lbfgs_zoom.NEXT]))
        assert nxt == state[lbfgs_zoom.NEXT] or np.isnan(nxt)
    return trials, state


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_transition_composes_to_zoom_linesearch_and_optax(name, dtype):
    fn, x0, u = CASES[name]
    tdt, ndt = getattr(torch, dtype), getattr(np, dtype)
    x0t, ut = torch.tensor(x0, dtype=tdt), torch.tensor(u, dtype=tdt)

    def evaluate(eta):
        x = (x0t + float(eta) * ut).requires_grad_(True)
        value = fn(x, torch)
        (g,) = torch.autograd.grad(value, x)
        return value.detach().numpy()[()], (g * ut).numpy()[()]

    value, slope = evaluate(0.0)
    seen = []
    got = train.zoom_linesearch(value, slope,
                                lambda e: (seen.append(e), evaluate(e))[1])
    trials, state = _composed(value, slope, evaluate)
    assert state.dtype == ndt
    assert np.array_equal(np.asarray(trials), np.asarray(seen))
    assert (state[lbfgs_zoom.STEPSIZE], int(state[lbfgs_zoom.COUNT]),
            state[lbfgs_zoom.DEC_ERR], state[lbfgs_zoom.CURV_ERR]) == got

    cast = jnp.float32 if dtype == "float32" else jnp.float64
    want = _optax_search(lambda x: fn(x, jnp), cast(x0), cast(u))
    tol = TOL if dtype == "float64" else 1e-5
    assert int(state[lbfgs_zoom.COUNT]) == want[3]
    assert abs(float(state[lbfgs_zoom.STEPSIZE]) - want[2]) <= (
        tol * abs(want[2]))
    if name == "nan_wall":
        assert want[2] == 0.0 and np.isinf(want[4])
        assert state[lbfgs_zoom.STEPSIZE] == 0.0
        assert np.isinf(state[lbfgs_zoom.DEC_ERR])
        assert state[lbfgs_zoom.FAILED] == 1
        assert state[lbfgs_zoom.COUNT] == train.LBFGS_LINESEARCH_STEPS


def _host_direction(g, params, prev_params, prev_updates, dw_mem, du_mem,
                    weights, count, memory_size):
    """The recursion with the count read on the host and Python slot
    indices (the port's L-BFGS before its device form)."""
    flat, leaves, flat_memory = train._flat, train._leaves, train._flat_memory
    idx, prev = count % memory_size, (count - 1) % memory_size
    if count > 0:
        dw = flat(params) - flat(prev_params)
        du = g - flat(prev_updates)
        curv = torch.dot(du, dw)
        weights[prev] = torch.where(curv == 0.0, 0.0, 1.0 / curv)
    else:
        dw = du = torch.zeros_like(g)
        weights[prev] = 0.0
    for buf, d in zip(dw_mem, leaves(dw, params)):
        buf[prev].copy_(d)
    for buf, d in zip(du_mem, leaves(du, params)):
        buf[prev].copy_(d)
    if count > 0:
        den = torch.dot(du, du)
        gamma = torch.where(den > 0.0, torch.dot(du, dw) / den, 1.0)
    else:
        gamma = torch.clamp(1.0 / torch.sqrt(torch.dot(g, g)), max=1.0)
    order = [(idx + j) % memory_size for j in range(memory_size)]
    dws, dus = flat_memory(dw_mem), flat_memory(du_mem)
    vec, alphas = g, {}
    for i in reversed(order):
        alphas[i] = weights[i] * torch.dot(dws[i], vec)
        vec = vec + (-alphas[i]) * dus[i]
    vec = gamma * vec
    for i in order:
        beta = weights[i] * torch.dot(dus[i], vec)
        vec = vec + (alphas[i] - beta) * dws[i]
    return -vec


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128],
                         ids=["float32", "complex128"])
def test_device_index_recursion_equals_host_index(dtype):
    memory_size = 3
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (5,)]

    def draw():
        return [torch.tensor(rng.normal(size=s) + (1j * rng.normal(size=s)
                             if dtype.is_complex else 0), dtype=dtype)
                for s in shapes]

    real = dtype.to_real()
    sides = []
    for _ in range(2):
        sides.append(dict(
            prev_params=[torch.zeros(s, dtype=dtype) for s in shapes],
            prev_updates=[torch.zeros(s, dtype=dtype) for s in shapes],
            dw_mem=[torch.zeros((memory_size,) + s, dtype=dtype)
                    for s in shapes],
            du_mem=[torch.zeros((memory_size,) + s, dtype=dtype)
                    for s in shapes],
            weights=torch.zeros(memory_size, dtype=real)))
    device, host = sides
    count = torch.zeros((), dtype=torch.int64)
    for n in range(2 * memory_size + 1):
        params, grads = draw(), draw()
        g = train._flat(grads)
        got = train._lbfgs_direction(g, params, scale_init=True, count=count,
                                     **device)
        want = _host_direction(g, params, memory_size=memory_size, count=n,
                               **host)
        assert torch.equal(got, want), n
        for k in ("dw_mem", "du_mem"):
            for a, b in zip(device[k], host[k]):
                assert torch.equal(a, b), (n, k)
        assert torch.equal(device["weights"], host["weights"]), n
        for side in sides:
            for q, p in zip(side["prev_params"], params):
                q.copy_(p)
            for q, x in zip(side["prev_updates"], grads):
                q.copy_(x)
        count.add_(1)
    assert int(count) == 2 * memory_size + 1


@pytest.mark.parametrize("adaptive", [False, True], ids=["plain", "gradscale"])
def test_device_form_step_follows_optax(adaptive, monkeypatch):
    """`LBFGS.step` on CPU tensors: each trial a Python conditional on the
    flag and one plain `zoom_step`; steps held to optax's (the parameters,
    stepsize and search steps, `tests/test_torch_lbfgs.py`'s tolerance)."""
    transitions = []
    plain = lbfgs_zoom.zoom_step_reference

    def counted(*args):
        transitions.append(1)
        return plain(*args)

    def numpy_loop(*args):
        raise AssertionError("the numpy loop ran")

    monkeypatch.setattr(lbfgs_zoom, "zoom_step_reference", counted)
    monkeypatch.setattr(train, "zoom_linesearch", numpy_loop)
    jprob, tprob = _poisson_pair(adaptive)
    got = _assert_steps_match(jprob, tprob, 4, jax_solve=False)
    # `_assert_steps_match` runs the steps, then `solve` over as many
    assert len(transitions) == 2 * sum(count for _, _, count in got)
