"""Training loop (`neuralpde_tpu.train`; Optimization.jl replacement).

`make_step` builds one optimizer step: the weighted loss and its gradient
(forward and backward under the discretization's matmul precision), the
adaptive reweighting every ``reweight_every`` iterations (with the
per-equation gradients where the scheme needs them), and a `torch.optim`
update.  The port's optimizers are the JAX package's two: `Adam`
(optax.adam's rule) and `LBFGS` (optax.lbfgs()'s two-loop recursion and
zoom line search, which evaluates the loss again at each trial point, on
the step's points and with the weights from before its reweighting, as
the JAX package's ``value_fn``).  Parameters, optimizer state and adaptive state are updated in
place.  `solve` runs blocks of ``inner_steps`` steps with no host read
inside a block, and keeps the callback / abstol-stop protocol (reference
semantics: src/ode_solve.jl:469-481) and logging at `log_frequency`
(reference: src/discretize.jl:598-643) once per block.

Under an active mesh (`parallel.mesh`) a problem whose losses return rank
shares (``mesh_shares``: `discretize`'s and the PINO solvers') trains data
parallel: after the backward pass the step sums the gradients, the loss and
its aux over the data axis with one collective (one flat bucket a dtype),
so that every rank reweights and steps from the global values.  A problem
without shares computes everything on every rank, as without a mesh.

On a CUDA problem `solve` is the counterpart of the JAX package's
``lax.scan`` under ``jit``: each kind of step (plain, and the one that
reweights) runs once as it is, then is captured as one CUDA graph
(forward, backward, update; the stochastic strategies' draws come from the
solve's generator, registered with the graph, so every replay draws fresh
points) and replayed for every later step of that kind.  A step that fails
to capture raises.  `LBFGS` (and a user's `torch.optim.LBFGS`) reads
scalars on the host in its line search and cannot be captured: it is the
one optimizer whose steps run eagerly on the card.  On the CPU every step
runs eagerly.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from .config import matmul_precision
from .kernels.tanh_jet import add_replayed, counts_since, launch_counts
from .logging_utils import logscalar, logvector
from .parallel.mesh import BATCH_AXIS, all_reduce_flat, get_mesh


class Adam(torch.optim.Optimizer):
    """optax.adam's rule, updated in place with no host read, so that the
    step can be captured as a CUDA graph:

        mu <- b1 mu + (1 - b1) g,   nu <- b2 nu + (1 - b2) g^2,   t <- t + 1
        p  <- p - lr / (1 - b1^t) * mu / (sqrt(nu) / sqrt(1 - b2^t) + eps)

    in the arithmetic of `torch.optim.Adam` (foreach, not capturable), which
    the port used before its steps were captured: the same moment updates
    (lerp, addcmul; for complex parameters the second moment takes
    ``g·conj(g)``, optax's rule, where torch's treats real and imaginary
    parts apart) and, for the bias corrections, float64 values rounded
    to the parameters' dtype, as torch computes them on the host; here the
    step count is a float64 tensor on the device.  (`torch.optim.Adam` with
    ``capturable=True`` keeps its count on the device too, but computes the
    corrections in float32, another rounding that moves float32 runs.)
    Parameters without a gradient are skipped."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam takes no closure")
        for group in self.param_groups:
            lr, b1, b2, eps = (group[k] for k in ("lr", "b1", "b2", "eps"))
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(
                        count=torch.zeros((), dtype=torch.float64,
                                          device=p.device),
                        mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            states = [self.state[p] for p in params]
            grads = [p.grad for p in params]
            mus = [st["mu"] for st in states]
            nus = [st["nu"] for st in states]
            torch._foreach_lerp_(mus, grads, 1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(
                nus, grads, [g.conj() if g.is_complex() else g for g in grads],
                1 - b2)
            torch._foreach_add_([st["count"] for st in states], 1)
            # every parameter with a gradient steps together (the trainer
            # sets all gradients each step), so one count gives the bias
            # corrections; float64 even where load_state_dict cast the
            # counts to the parameters' dtype (it does so for every state
            # tensor but torch's own "step")
            t = states[0]["count"].to(torch.float64)
            dtype = params[0].dtype
            step_size = (-lr / (1 - torch.pow(b1, t))).to(dtype)
            bc2_sqrt = torch.sqrt(1 - torch.pow(b2, t)).to(dtype)
            denoms = torch._foreach_sqrt(nus)
            torch._foreach_div_(denoms, [bc2_sqrt] * len(denoms))
            torch._foreach_add_(denoms, eps)
            for p, q in zip(params, torch._foreach_div(mus, denoms)):
                p.addcmul_(step_size, q)


def adam(lr: float = 1e-3) -> Callable:
    """Optimizer factory: `Adam`, optax.adam's rule and defaults (b1 0.9,
    b2 0.999, eps 1e-8)."""
    return lambda params: Adam(params, lr=lr)


# optax.lbfgs()'s line search: scale_by_zoom_linesearch(
# max_linesearch_steps=20, initial_guess_strategy="one") with the defaults
# of its other arguments (no largest stepsize)
LBFGS_LINESEARCH_STEPS = 20
_SLOPE_RTOL, _CURV_RTOL, _APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
_STEPSIZE_PRECISION, _INCREASE_FACTOR, _TOL = 1e-5, 2.0, 0.0


def _flat(xs):
    """The tensors as one real vector, a complex one as its real and
    imaginary parts in turn: the real part of <x, y> summed over the
    tensors (optax.tree.vdot's) is then one dot product."""
    return torch.cat([(torch.view_as_real(x) if x.is_complex() else x)
                      .reshape(-1) for x in xs])


def _flat_memory(bufs):
    """Stacked ``(memory, *shape)`` buffers as one ``(memory, n)`` real
    matrix, row i `_flat` of their entries i."""
    return torch.cat([(torch.view_as_real(b) if b.is_complex() else b)
                      .reshape(b.shape[0], -1) for b in bufs], dim=1)


def _leaves(vec, likes):
    """A `_flat` vector cut back into tensors shaped like ``likes``."""
    out, at = [], 0
    for like in likes:
        n = like.numel() * (2 if like.is_complex() else 1)
        piece = vec[at:at + n]
        at += n
        out.append(torch.view_as_complex(piece.reshape(*like.shape, 2)
                                         .clone())
                   if like.is_complex() else piece.view(like.shape))
    return out


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's ``_cubicmin``: the critical point of the cubic through (a,
    fa), (b, fb), (c, fc) with slope fpa at a; NaN where there is none."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * (dc * dc))) * v0 + db * (db * db) * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """optax's ``_quadmin``: the critical point of the quadratic through
    (a, fa), (b, fb) with slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


def zoom_linesearch(value_init, slope_init, evaluate):
    """optax's zoom line search (`scale_by_zoom_linesearch` with
    `LBFGS_LINESEARCH_STEPS` and its defaults) along one direction, on host
    scalars.

    ``value_init``/``slope_init`` are numpy scalars of one float dtype, the
    value at stepsize 0 and the slope there; ``evaluate(stepsize)`` returns
    the value and the slope at a stepsize as numpy scalars of that dtype.
    Each call to it is one step of the search: first the interval search
    (stepsize 1, then doubled) until an interval holds a stepsize that
    meets both the sufficient decrease (Armijo, or Hager and Zhang's
    approximate decrease once the value is within 1e-6 of the start) and the
    curvature criteria, then the zoom (a cubic, else quadratic, else
    bisection step) into it.  A search that reaches the step bound, or whose
    interval falls below 1e-5 with a stepsize of sufficient decrease known,
    fails and returns that safe stepsize where there is one (or where the
    last value was not finite), else the last stepsize tried.

    Returns ``(stepsize, steps, decrease_error, curvature_error)``, optax's
    ``ZoomLinesearchInfo``."""
    f = type(value_init)
    zero, inf = f(0.0), f(np.inf)

    def errors(stepsize, value, slope):
        dec = value - value_init - _SLOPE_RTOL * stepsize * slope_init
        approx = slope - (2 * _SLOPE_RTOL - 1.0) * slope_init
        delta = value - value_init - _APPROX_DEC_RTOL * np.abs(value_init)
        dec = np.maximum(np.minimum(np.maximum(approx, delta), dec), zero)
        curv = np.maximum(np.abs(slope) - _CURV_RTOL * np.abs(slope_init),
                          zero)
        return (inf if np.isnan(dec) else dec,
                inf if np.isnan(curv) else curv)

    count, stepsize, value, slope = 0, zero, value_init, slope_init
    dec_err = curv_err = inf
    interval_found = done = failed = False
    low = high = cubic_ref = zero
    value_low = value_high = value_cubic_ref = value_init
    slope_low = slope_high = slope_init
    safe_stepsize, safe_value = zero, value_init
    with np.errstate(all="ignore"):
        while not (done or failed):
            if not interval_found:
                new = f(1.0) if count == 0 else f(_INCREASE_FACTOR * stepsize)
                v, s = evaluate(new)
                dec_err, curv_err = errors(new, v, s)
                if dec_err <= _TOL:
                    safe_stepsize, safe_value = new, v
                set_high = dec_err > 0.0 or (v >= value and count > 0)
                set_low = s >= 0.0 and not set_high
                if set_low:
                    low, value_low, slope_low = new, v, s
                    high, value_high, slope_high = stepsize, value, slope
                else:
                    low, value_low, slope_low = stepsize, value, slope
                    high, value_high, slope_high = new, v, s
                done = max(dec_err, curv_err) <= _TOL
                interval_found = set_high or set_low or done
                failed = count + 1 >= LBFGS_LINESEARCH_STEPS and not done
                cubic_ref, value_cubic_ref = low, value_low
            else:
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                too_small = delta <= _STEPSIZE_PRECISION
                cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                  cubic_ref, value_cubic_ref)
                quad = _quadmin(low, value_low, slope_low, high, value_high)
                if left + 0.2 * delta < cubic < right - 0.2 * delta:
                    new = cubic
                elif left + 0.1 * delta < quad < right - 0.1 * delta:
                    new = quad
                else:
                    new = (low + high) / 2.0
                v, s = evaluate(new)
                dec_err, curv_err = errors(new, v, s)
                if dec_err <= _TOL and v < safe_value:
                    safe_stepsize, safe_value = new, v
                done = max(dec_err, curv_err) <= _TOL
                high_to_new = dec_err > 0.0 or v >= value_low
                high_to_low = s * (high - low) >= 0.0 and not high_to_new
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
                failed = ((count + 1 >= LBFGS_LINESEARCH_STEPS
                           or (too_small and safe_stepsize > 0.0))
                          and not done)
            count += 1
            stepsize, value, slope = new, v, s
            if failed and (safe_stepsize > 0.0 or np.isinf(dec_err)):
                stepsize, value = safe_stepsize, safe_value
    return stepsize, count, dec_err, curv_err


class LBFGS(torch.optim.Optimizer):
    """`optax.lbfgs()`'s rule: `scale_by_lbfgs(memory_size,
    scale_init_precond)`, `scale(-1)` and `scale_by_zoom_linesearch(
    max_linesearch_steps=20, initial_guess_strategy="one")`, one update a
    step.

    ``step(closure)``: ``closure()`` evaluates the loss at the parameters as
    they are and sets their gradients.  Its first call gives the step's
    value and gradient g.  The memory then takes the pair (parameters minus
    the previous step's, g minus the previous gradient) at slot
    ``(count - 1) % memory_size`` with weight 1/<dg, dw> (0 where that is
    0; nothing at the first step), and the two-loop recursion from slot
    ``count % memory_size`` preconditions g with the initial scale
    <dg, dw>/<dg, dg> (1 where dg = 0; min(1, 1/||g||) at the first step).
    The direction u is minus that; `zoom_linesearch` picks the stepsize,
    each of its steps one more call of ``closure`` at w + stepsize u, and
    the parameters end at w + stepsize u.  For complex parameters every
    inner product is the real part of <x, y> (the gradient is torch's, the
    conjugate of `jax.grad`'s, which the JAX package's trainer conjugates
    before optax sees it).  The recursion runs on the parameters laid end
    to end as one real vector (`_flat`), a dot product a memory slot.

    The state holds, a parameter, the previous parameters and gradient and
    the stacked ``(memory_size, *shape)`` differences; with the first
    parameter, the count, the ``(memory_size,)`` weights, the last stepsize
    and the last search's steps and errors (``num_linesearch_steps``,
    ``decrease_error``, ``curvature_error``).  The weights, the stepsize and
    every scalar of the line search are in the parameters' real dtype,
    which is optax's arithmetic with JAX's x64 off; with it on, optax keeps
    the weights and some scalars of the search in float64 also for float32
    parameters.  The line search reads two scalars (value and slope) on the
    host a call, so its steps run eagerly, also on the card.

    ``step(closure, member=m)`` (`solve_ensemble`) treats the parameters'
    leading axis as members: it steps member m alone, with its own memory,
    count and line search, reading the gradients' slice m; the state then
    holds a leading member axis (the stacked differences after the memory
    axis)."""

    def __init__(self, params, memory_size: int = 10,
                 scale_init_precond: bool = True):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        super().__init__(params, dict(memory_size=memory_size,
                                      scale_init_precond=scale_init_precond))
        self._params = [p for g in self.param_groups for p in g["params"]]

    def _init_state(self, member) -> None:
        p0 = self._params[0]
        m = self.param_groups[0]["memory_size"]
        lead = () if member is None else (p0.shape[0],)
        real = p0.dtype.to_real()
        for p in self._params:
            self.state[p].update(
                params=torch.zeros_like(p), updates=torch.zeros_like(p),
                diff_params_memory=p.new_zeros((m,) + p.shape),
                diff_updates_memory=p.new_zeros((m,) + p.shape))
        self.state[p0].update(
            count=torch.zeros(lead, dtype=torch.int64, device=p0.device),
            weights_memory=torch.zeros(lead + (m,), dtype=real,
                                       device=p0.device),
            learning_rate=torch.ones(lead, dtype=real, device=p0.device),
            num_linesearch_steps=torch.zeros(lead, dtype=torch.int64,
                                             device=p0.device),
            decrease_error=torch.full(lead, math.inf, dtype=real,
                                      device=p0.device),
            curvature_error=torch.full(lead, math.inf, dtype=real,
                                       device=p0.device))

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        # torch casts every state tensor of a float parameter to its dtype
        st = self.state[self._params[0]]
        for k in ("count", "num_linesearch_steps"):
            if k in st:
                st[k] = st[k].to(torch.int64)

    @torch.no_grad()
    def step(self, closure=None, member: int | None = None):
        if closure is None:
            raise ValueError("LBFGS needs a closure that evaluates the loss")
        closure = torch.enable_grad()(closure)
        if not self.state[self._params[0]]:
            self._init_state(member)
        memory_size = self.param_groups[0]["memory_size"]
        scale_init = self.param_groups[0]["scale_init_precond"]
        if member is None:
            at, mem = (lambda t: t), (lambda t: t)
        else:
            at, mem = (lambda t: t[member]), (lambda t: t[:, member])
        params = [at(p) for p in self._params]
        per = [self.state[p] for p in self._params]
        glob = {k: at(v) for k, v in per[0].items()
                if k in ("count", "weights_memory", "learning_rate",
                         "num_linesearch_steps", "decrease_error",
                         "curvature_error")}
        prev_params = [at(s["params"]) for s in per]
        prev_updates = [at(s["updates"]) for s in per]
        dw_mem = [mem(s["diff_params_memory"]) for s in per]
        du_mem = [mem(s["diff_updates_memory"]) for s in per]

        def grads():
            return [torch.zeros_like(q) if p.grad is None else at(p.grad)
                    for p, q in zip(self._params, params)]

        loss = closure()
        g = _flat(grads())
        count = int(glob["count"])
        idx, prev = count % memory_size, (count - 1) % memory_size
        weights = glob["weights_memory"]
        if count > 0:
            dw = _flat(params) - _flat(prev_params)
            du = g - _flat(prev_updates)
            curv = torch.dot(du, dw)
            weights[prev] = torch.where(curv == 0.0, 0.0, 1.0 / curv)
        else:
            dw = du = torch.zeros_like(g)
            weights[prev] = 0.0
        for buf, d in zip(dw_mem, _leaves(dw, params)):
            buf[prev].copy_(d)
        for buf, d in zip(du_mem, _leaves(du, params)):
            buf[prev].copy_(d)
        if not scale_init:
            gamma = 1.0
        elif count > 0:
            den = torch.dot(du, du)
            gamma = torch.where(den > 0.0, torch.dot(du, dw) / den, 1.0)
        else:
            gamma = torch.clamp(1.0 / torch.sqrt(torch.dot(g, g)), max=1.0)
        # the two-loop recursion, newest pair first, then oldest first
        order = [(idx + j) % memory_size for j in range(memory_size)]
        dws, dus = _flat_memory(dw_mem), _flat_memory(du_mem)
        vec, alphas = g, {}
        for i in reversed(order):
            alphas[i] = weights[i] * torch.dot(dws[i], vec)
            vec = vec + (-alphas[i]) * dus[i]
        vec = gamma * vec
        for i in order:
            beta = weights[i] * torch.dot(dus[i], vec)
            vec = vec + (alphas[i] - beta) * dws[i]
        u = -vec
        start = _flat(params)
        for q, p in zip(prev_params, params):
            q.copy_(p)
        for q, x in zip(prev_updates, _leaves(g, params)):
            q.copy_(x)
        glob["count"].add_(1)

        real = weights.dtype
        host = torch.stack([loss.detach().to(real),
                            torch.dot(u, g)]).cpu().numpy()

        def move(stepsize):
            for p, x in zip(params, _leaves(start + float(stepsize) * u,
                                            params)):
                p.copy_(x)

        def evaluate(stepsize):
            move(stepsize)
            value = closure()
            pair = torch.stack([value.detach().to(real),
                                torch.dot(_flat(grads()), u)])
            return tuple(pair.cpu().numpy())

        stepsize, steps, dec, curv = zoom_linesearch(host[0], host[1],
                                                     evaluate)
        move(stepsize)
        glob["learning_rate"].fill_(float(stepsize))
        glob["num_linesearch_steps"].fill_(steps)
        glob["decrease_error"].fill_(float(dec))
        glob["curvature_error"].fill_(float(curv))
        return loss


def lbfgs(memory_size: int = 10, scale_init_precond: bool = True
          ) -> Callable:
    """Optimizer factory: `LBFGS`, `optax.lbfgs()`'s rule (its two-loop
    recursion and zoom line search) with its defaults.  Its steps run
    eagerly, also on the card (see the module note)."""
    return lambda params: LBFGS(params, memory_size=memory_size,
                                scale_init_precond=scale_init_precond)


@dataclass
class SolveResult:
    """OptimizationSolution analog: `u` = trained parameters."""

    u: Any
    objective: float
    iterations: int
    aux: dict
    history: list

    @property
    def params(self):
        return self.u


def _component_grads(loss_fns, theta: dict, generator) -> list:
    """Per-equation gradients: for each loss, one gradient per parameter in
    ``theta``'s order, zeros where the loss does not reach a parameter (as
    `jax.grad` gives them)."""
    params = list(theta.values())
    out = []
    for f in loss_fns:
        grads = torch.autograd.grad(f(theta, generator), params,
                                    allow_unused=True)
        out.append([torch.zeros_like(p) if g is None else g
                    for p, g in zip(params, grads)])
    return out


class TrainStep:
    """One training step; see `make_step`."""

    def __init__(self, loss_fn, optimizer, adaloss=None, pde_loss_fns=(),
                 bc_loss_fns=(), precision=None, mesh_shares=False):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.adaloss = adaloss
        self.pde_loss_fns = list(pde_loss_fns)
        self.bc_loss_fns = list(bc_loss_fns)
        self.precision = precision
        self.mesh_shares = mesh_shares
        self.every = getattr(adaloss, "reweight_every", 0) if adaloss else 0

    def _data_group(self):
        """The data-axis group whose ranks' shares this step sums, or None
        (no active mesh with a data axis, or a loss without shares)."""
        mesh = get_mesh()
        if (not self.mesh_shares or mesh is None
                or BATCH_AXIS not in mesh.shape):
            return None
        return mesh.groups[BATCH_AXIS]

    @staticmethod
    def _sum_shares(group, theta, loss, aux):
        """Sum the gradients (in place), the loss and aux over ``group``."""
        params = [p for p in theta.values() if p.grad is not None]
        keys = list(aux)
        summed = all_reduce_flat([p.grad for p in params] + [loss]
                                 + [aux[k] for k in keys], group)
        for p, g in zip(params, summed):
            p.grad.copy_(g)
        rest = summed[len(params):]
        return rest[0], dict(zip(keys, rest[1:]))

    @staticmethod
    def _slice(tree, m):
        """Member ``m`` of stacked parameters or state."""
        return {k: v[m] for k, v in tree.items()}

    @staticmethod
    def needs_closure(opt) -> bool:
        """Whether ``opt`` evaluates the loss itself through a closure (and
        so reads the host, and runs eagerly also on the card)."""
        return isinstance(opt, (LBFGS, torch.optim.LBFGS))

    def init(self, params: dict, ada_state: dict, iteration: int = 0):
        """The carry ``(theta, optimizer, ada_state, iteration)``: trainable
        copies of ``params``, the optimizer built over them, and a copy of
        ``ada_state`` that the steps update in place."""
        theta = {k: v.detach().clone().requires_grad_(True)
                 for k, v in params.items()}
        ada_state = {k: v.clone() for k, v in ada_state.items()}
        return (theta, self.optimizer(list(theta.values())), ada_state,
                iteration)

    def reweights(self, iteration: int) -> bool:
        """Whether the step at ``iteration`` (0-based) reweights."""
        return bool(self.every) and (iteration + 1) % self.every == 0

    def run(self, theta: dict, opt, ada_state: dict, generator,
            reweight: bool):
        """One step in place -> ``(loss, aux)``, detached tensors on the
        device.  Reads nothing back to the host (except under LBFGS), so it
        can be captured."""
        if self.needs_closure(opt):
            return self._run_closure(theta, opt, ada_state, generator, reweight)
        opt.zero_grad(set_to_none=True)
        group = self._data_group()
        with matmul_precision(self.precision):
            loss, aux = self.loss_fn(theta, {"generator": generator,
                                             "adaptive": ada_state})
            loss.backward()
            loss = loss.detach()
            aux = {k: v.detach() for k, v in aux.items()}
            if group is not None:
                loss, aux = self._sum_shares(group, theta, loss, aux)
            if reweight:
                self._reweight(theta, ada_state, aux, generator)
        opt.step()
        return loss, aux

    def _reweight(self, theta, ada_state, aux, generator) -> None:
        comp = None
        if self.adaloss.needs_component_grads:
            comp = (_component_grads(self.pde_loss_fns, theta, generator),
                    _component_grads(self.bc_loss_fns, theta, generator))
            group = self._data_group()
            if group is not None:
                flat = [g for grads in comp[0] + comp[1] for g in grads]
                it = iter(all_reduce_flat(flat, group))
                comp = tuple([[next(it) for _ in grads] for grads in part]
                             for part in comp)
        new = self.adaloss.reweight(ada_state, theta, aux["pde_losses"],
                                    aux["bc_losses"], comp, generator)
        with torch.no_grad():
            for k, v in new.items():
                ada_state[k].copy_(v)

    def _run_closure(self, theta, opt, ada_state, generator, reweight,
                     member=None):
        """L-BFGS: every evaluation of its line search draws the step's
        points again (the generator is rewound to the step's start, as the
        JAX package's ``value_fn`` reuses the step's key) and sees the
        weights from before this step's reweighting.  ``member``: step that
        member of stacked parameters alone (`LBFGS.step`'s ``member``)."""
        start = generator.get_state() if generator is not None else None
        kw = {} if member is None else {"member": member}

        def at(tree):
            return tree if member is None else self._slice(tree, member)

        weights = ({k: v.clone() for k, v in at(ada_state).items()}
                   if reweight else at(ada_state))
        first = []
        group = self._data_group()

        def closure():
            if start is not None:
                generator.set_state(start)
            opt.zero_grad(set_to_none=True)
            with matmul_precision(self.precision):
                loss, aux = self.loss_fn(at(theta), {"generator": generator,
                                                     "adaptive": weights})
                loss.backward()
                loss = loss.detach()
                aux = {k: v.detach() for k, v in aux.items()}
                if group is not None:
                    loss, aux = self._sum_shares(group, theta, loss, aux)
                if not first:
                    first.append((loss, aux))
                    if reweight:
                        self._reweight(at(theta), at(ada_state), first[0][1],
                                       generator)
            return loss

        opt.step(closure, **kw)
        return first[0]

    def __call__(self, carry, generator: torch.Generator):
        """-> (new carry, (loss, aux)); ``loss`` and ``aux`` are detached
        tensors on the device (reading them waits for the step to finish)."""
        theta, opt, ada_state, it = carry
        loss, aux = self.run(theta, opt, ada_state, generator,
                             self.reweights(it))
        return (theta, opt, ada_state, it + 1), (loss, aux)


def make_step(loss_fn, optimizer, adaloss=None, pde_loss_fns=(),
              bc_loss_fns=(), *, matmul_precision: str | None = None,
              mesh_shares: bool = False):
    """Build the train step.

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer`` (e.g.
    `adam(1e-3)`); ``step.init(params, ada_state)`` builds the carry
    ``(theta, optimizer, ada_state, iteration)`` and
    ``step(carry, generator)`` returns ``(carry, (loss, aux))``.  The
    generator is advanced by every step's sampling, in place of the JAX
    package's per-iteration key fold-in.  ``pde_loss_fns``/``bc_loss_fns``
    give the per-equation gradients of the schemes that need them.
    ``mesh_shares``: the losses return rank shares under an active mesh
    (module note), so the step sums them over the data axis.
    """
    return TrainStep(loss_fn, optimizer, adaloss, pde_loss_fns, bc_loss_fns,
                     matmul_precision, mesh_shares)


_SIDE_STREAMS: dict = {}


@contextlib.contextmanager
def _side_stream(like: torch.Tensor):
    """Run the body on the side stream of ``like``'s CUDA device (a CUDA
    graph cannot be captured on the default stream, and the backward passes
    it captures run on their forwards' stream); nothing for CPU tensors.

    One side stream a device serves every solve of the process: PyTorch
    keeps a cuBLAS and a cuBLASLt workspace (32 MiB each on Hopper) for
    every stream that ran a GEMM and never frees them, so a new stream a
    solve would leave 64 MiB allocated after each."""
    if not like.is_cuda:
        yield
        return
    caller = torch.cuda.current_stream(like.device)
    side = _SIDE_STREAMS.get(like.device.index)
    if side is None:
        side = _SIDE_STREAMS[like.device.index] = torch.cuda.Stream(
            device=like.device)
    side.wait_stream(caller)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        caller.wait_stream(side)


class GraphedSteps:
    """Steps of a `TrainStep` on the card through CUDA graphs.

    Each kind of step (plain, reweighting) runs once as it is, which
    initializes what the step allocates lazily (optimizer state, library
    handles); its next occurrence is captured as a CUDA graph on the
    current stream (a side stream) and replayed from then on.  The graph
    holds the parameters, gradients, optimizer and adaptive state, and the
    returned loss and aux, at fixed addresses; the solve's generator is
    registered with it, so each replay draws fresh points.  The kernels'
    wrappers count a captured step's launches once; each replay reports
    them again to `kernels.tanh_jet.add_replayed`.
    """

    def __init__(self, step: TrainStep, carry, generator: torch.Generator):
        self.step = step
        self.theta, self.opt, self.ada_state, _ = carry
        self.generator = generator
        self.eager = step.needs_closure(self.opt)
        self._seen: set = set()
        self._graphs: dict = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0

    def __call__(self, iteration: int):
        """Run the step at ``iteration`` -> ``(loss, aux)`` (tensors that a
        later replay of the same graph overwrites)."""
        kind = self.step.reweights(iteration)
        if self.eager or kind not in self._seen:
            self._seen.add(kind)
            return self.step.run(self.theta, self.opt, self.ada_state,
                                 self.generator, kind)
        if kind not in self._graphs:
            self._graphs[kind] = self._capture(kind)
        graph, out, launched = self._graphs[kind]
        graph.replay()
        add_replayed(launched)
        self.replays += 1
        return out

    def _capture(self, reweight: bool):
        t0 = time.perf_counter()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        try:
            with torch.cuda.graph(graph,
                                  stream=torch.cuda.current_stream()):
                out = self.step.run(self.theta, self.opt, self.ada_state,
                                    self.generator, reweight)
        except RuntimeError as e:
            raise RuntimeError(
                "solve: the training step could not be captured as a CUDA "
                f"graph ({type(self.opt).__name__}"
                f"{', reweighting' if reweight else ''}): {e}") from e
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        return graph, out, counts_since(before)

    def stats(self) -> dict:
        return {"captures": self.captures,
                "capture_seconds": self.capture_seconds,
                "replays": self.replays}


def solve(prob, optimizer=None, maxiters: int = 1000, *,
          callback: Callable | None = None, abstol: float | None = None,
          generator: torch.Generator | None = None, seed: int = 0,
          inner_steps: int = 1, verbose: bool = False,
          checkpoint_dir: str | None = None, checkpoint_every: int = 1000,
          profile_dir: str | None = None, quad_adapt: bool = False,
          quad_adapt_rounds: int = 3):
    """Train a `TrainingProblem` (from `discretize`), or any object with
    ``loss(theta, lstate) -> (total, aux)`` and ``init_params`` whose
    ``pinnrep`` is None (the ODE solvers' and `neural_adapter`'s problems):
    such a problem trains on the device and in the dtype of its
    parameters, with unit loss weights, no reweighting and no logger.

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer``
    (default `adam(1e-3)`).  ``generator`` (default: seeded with ``seed``
    on the problem's device) supplies the stochastic strategies' points.

    Steps run in blocks of ``inner_steps``, with no host read inside a
    block; on the card they replay captured CUDA graphs (module note).
    After each block the iteration count grows by ``inner_steps`` and, on
    the block's last loss and aux, the history gains one entry,
    ``callback(it, loss, aux)`` runs (True stops the run), logging happens
    at multiples of the log frequency, and ``loss < abstol`` or a non-finite
    loss stops the run.  As in the JAX package whole blocks run, so the
    count passes ``maxiters`` when that is not a multiple of the block.

    ``checkpoint_dir`` makes the run preemption-safe: parameters, optimizer
    state, adaptive state, the generator's state and the iteration are
    saved every ``checkpoint_every`` iterations and at the end, and a
    directory that holds a checkpoint is resumed from, so ``maxiters``
    counts iterations across restarts and a resumed run draws the points of
    one that never stopped.  Under a mesh of several ranks each rank keeps
    its own ``rank<r>`` directory inside it.  ``profile_dir`` writes a
    `torch.profiler` trace of the run there.

    ``quad_adapt``: an auto-refined `QuadratureTraining` rule met its
    tolerances on the initial-params integrand; after training,
    `validate_trained` checks it again on the trained solution (and warns).
    With ``quad_adapt=True`` a failing check instead triggers up to
    ``quad_adapt_rounds`` warm-started re-solves (each with a fresh
    ``maxiters`` budget and, on the card, its own captured graphs) with the
    rule refined against the trained params (reference semantics:
    src/training_strategies.jl:406-436).  The callback is passed on to the
    re-solves; checkpointing and profiling are not.

    On the card, ``result.aux["cuda_graph"]`` counts the captures, their
    seconds and the replays.
    """
    optimizer = optimizer or adam(1e-3)
    pinnrep = getattr(prob, "pinnrep", None)
    if pinnrep is not None:
        adaloss = pinnrep.adaloss
        lf = pinnrep.loss_functions
        device, dtype = pinnrep.device, pinnrep.dtype
        pde_fns, bc_fns = lf.pde_loss_functions, lf.bc_loss_functions
        ada_state = adaloss.init_state(len(pde_fns), len(bc_fns), dtype,
                                       device)
        precision = pinnrep.matmul_precision
    else:
        from .adaptive import NonAdaptiveLoss

        like = next(iter(prob.init_params.values()))
        adaloss, pde_fns, bc_fns = None, (), ()
        precision = getattr(prob, "matmul_precision", None)
        device, dtype = like.device, like.dtype.to_real()
        ada_state = NonAdaptiveLoss().init_state(0, 0, dtype, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)

    step = make_step(prob.loss, optimizer, adaloss, pde_fns, bc_fns,
                     matmul_precision=precision,
                     mesh_shares=getattr(prob, "mesh_shares", False))
    carry = step.init(prob.init_params, ada_state)
    theta, opt, ada_state, _ = carry
    it = 0
    if checkpoint_dir is not None:
        from .utils.checkpoint import has_checkpoint, restore_checkpoint

        mesh = get_mesh()
        if mesh is not None and mesh.size > 1:
            # each rank its own directory: tensor-parallel ranks hold
            # different slices, and no two ranks write one file
            checkpoint_dir = os.path.join(checkpoint_dir,
                                          f"rank{torch.distributed.get_rank()}")
        if has_checkpoint(checkpoint_dir):
            it = restore_checkpoint(checkpoint_dir, theta, opt, generator,
                                    ada_state)[2]
            if verbose:
                print(f"[solve] resumed from {checkpoint_dir} at iteration "
                      f"{it}")

    logger = pinnrep.logger if pinnrep is not None else None
    log_frequency = (pinnrep.log_options.log_frequency
                     if pinnrep is not None else 50)
    history = []
    loss_val, aux = None, {}
    graphed = (GraphedSteps(step, carry, generator)
               if torch.device(device).type == "cuda" else None)
    if profile_dir is not None:
        from .utils.profiling import trace

        profiling = trace(profile_dir)
    else:
        profiling = contextlib.nullcontext()
    like = next(iter(theta.values()))
    with profiling, _side_stream(like):
        while it < maxiters:
            for i in range(it, it + inner_steps):
                if graphed is not None:
                    loss, aux = graphed(i)
                else:
                    loss, aux = step.run(theta, opt, ada_state, generator,
                                         step.reweights(i))
            it += inner_steps
            loss_val = float(loss)
            aux = {k: v.clone() for k, v in aux.items()}
            history.append(loss_val)
            if verbose:
                print(f"[solve] iter {it:6d}  loss {loss_val:.6g}")
            if logger is not None and it % log_frequency == 0:
                _log_metrics(logger, aux, it, ada_state)
            if callback is not None and callback(it, loss_val, aux):
                break
            if checkpoint_dir is not None and it % checkpoint_every < inner_steps:
                _save(checkpoint_dir, theta, opt, generator, ada_state, it)
            if abstol is not None and loss_val < abstol:
                break
            if not math.isfinite(loss_val):
                warnings.warn(
                    f"training diverged (loss={loss_val}) at iteration {it}; "
                    "stopping — consider a lower learning rate, remat=True, "
                    "or utils.profiling.enable_nan_debugging() to locate the "
                    "source")
                break

    if checkpoint_dir is not None:
        _save(checkpoint_dir, theta, opt, generator, ada_state, it)
    result_aux = {**aux, "adaptive_state": ada_state}
    if graphed is not None:
        result_aux["cuda_graph"] = graphed.stats()
        # the graphs go with this run: a re-solve below captures its own,
        # and this run's memory pool is free before it does
        graphed = None
    result = SolveResult(u={k: v.detach() for k, v in theta.items()},
                         objective=loss_val, iterations=it, aux=result_aux,
                         history=history)
    # an auto-refined QuadratureTraining rule was tuned on the initial
    # params: check it on the trained ones, outside any step, and warn, or
    # with quad_adapt=True refine it against them and solve again
    strategy = pinnrep.strategy if pinnrep is not None else None
    if (getattr(strategy, "_trained_checks", None)
            and math.isfinite(loss_val if loss_val is not None else math.nan)):
        if not quad_adapt:
            strategy.validate_trained(result.u)
        else:
            result = _quad_adapt_resolve(
                result, prob, strategy, optimizer, maxiters,
                rounds=quad_adapt_rounds, abstol=abstol, generator=generator,
                inner_steps=inner_steps, verbose=verbose, callback=callback)
    return result


def _quad_adapt_resolve(result, prob, strategy, optimizer, maxiters, *,
                        rounds, abstol, generator, inner_steps, verbose,
                        callback=None):
    """The quadrature-adaptivity loop: while the trained solution outruns
    the frozen rule, rebuild every equation's rule against the trained
    params (`rebuild_strategy_losses`) and warm-start a re-solve."""
    from .compile.discretize import rebuild_strategy_losses

    pinnrep = prob.pinnrep
    for r in range(rounds):
        reports = strategy.validate_trained(result.u, warn=False)
        if all(rep["ok"] for rep in reports):
            return result
        if verbose:
            bad = sum(1 for rep in reports if not rep["ok"])
            print(f"[solve] quad_adapt round {r + 1}/{rounds}: {bad} "
                  f"equation rule(s) no longer meet tolerances on the "
                  f"trained solution; re-refining and re-solving")
        full_loss = rebuild_strategy_losses(pinnrep, at_params=result.u)
        prob = type(prob)(full_loss, result.u, pinnrep)
        # the rebuild registered the refined rule's checks; stash them so
        # that the inner solve's own end-of-run check does not warn mid-loop
        checks = strategy._trained_checks
        strategy._trained_checks = []
        try:
            res2 = solve(prob, optimizer, maxiters=maxiters, abstol=abstol,
                         generator=generator, inner_steps=inner_steps,
                         verbose=verbose, callback=callback)
        finally:
            strategy._trained_checks = checks
        aux = dict(res2.aux)
        if "cuda_graph" in aux and "cuda_graph" in result.aux:
            aux["cuda_graph"] = {k: v + result.aux["cuda_graph"][k]
                                 for k, v in aux["cuda_graph"].items()}
        result = SolveResult(u=res2.u, objective=res2.objective,
                             iterations=result.iterations + res2.iterations,
                             aux=aux, history=result.history + res2.history)
    # final honest recheck (warns if the rounds ran out while failing)
    strategy.validate_trained(result.u)
    return result


def _save(path, theta, opt, generator, ada_state, it) -> None:
    from .utils.checkpoint import save_checkpoint

    save_checkpoint(path, theta, opt, iteration=it, generator=generator,
                    adaptive_state=ada_state)


def solve_hybrid(prob, *, adam_iters: int = 2000, lbfgs_iters: int = 1000,
                 adam_lr: float = 2e-3, inner_steps: int = 50,
                 abstol: float | None = None,
                 generator: torch.Generator | None = None, seed: int = 0,
                 verbose: bool = False, **kw):
    """Adam, then L-BFGS: the reference docs' wall-clock-to-accuracy pattern
    (docs/src/tutorials/low_level.md).  Adam escapes the rough early
    landscape; L-BFGS's curvature steps polish to low loss in far fewer
    iterations.  The Adam stage replays captured CUDA graphs on the card;
    the L-BFGS stage (`lbfgs`, optax.lbfgs()'s rule as in the JAX package)
    runs its steps eagerly, since its line search reads the loss on the
    host.

    Works best with deterministic strategies (Grid, Quadrature) in the
    L-BFGS stage: the line search assumes a fixed objective.  Returns a
    SolveResult whose history concatenates both stages.
    """
    r1 = solve(prob, adam(adam_lr), maxiters=adam_iters,
               inner_steps=inner_steps, generator=generator, seed=seed,
               verbose=verbose, **kw)
    r2 = solve(prob.with_params(r1.u), lbfgs(), maxiters=lbfgs_iters,
               inner_steps=inner_steps, generator=generator, seed=seed,
               abstol=abstol, verbose=verbose, **kw)
    return SolveResult(u=r2.u, objective=r2.objective,
                       iterations=r1.iterations + r2.iterations,
                       aux=r2.aux, history=r1.history + r2.history)


def _log_metrics(logger, aux, step: int, ada_state=None):
    logvector(logger, aux["pde_losses"], "unweighted_loss/pde_losses", step)
    logvector(logger, aux["bc_losses"], "unweighted_loss/bc_losses", step)
    logvector(logger, aux["weighted_pde_losses"],
              "weighted_loss/weighted_pde_losses", step)
    logvector(logger, aux["weighted_bc_losses"],
              "weighted_loss/weighted_bc_losses", step)
    logscalar(logger, float(torch.sum(aux["weighted_pde_losses"])),
              "weighted_loss/sum_weighted_pde_losses", step)
    logscalar(logger, float(torch.sum(aux["weighted_bc_losses"])),
              "weighted_loss/sum_weighted_bc_losses", step)
    logscalar(logger, float(aux["full_weighted_loss"]),
              "weighted_loss/full_weighted_loss", step)
    if "additional_loss" in aux:
        logscalar(logger, float(aux["additional_loss"]),
                  "weighted_loss/weighted_additional_loss", step)
    if ada_state is not None:
        logvector(logger, ada_state["pde_weights"],
                  "adaptive_loss/pde_loss_weights", step)
        logvector(logger, ada_state["bc_weights"],
                  "adaptive_loss/bc_loss_weights", step)
