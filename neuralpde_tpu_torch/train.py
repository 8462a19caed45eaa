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
to capture raises.  An `LBFGS` step is captured whole, as optax's
``while_loop`` is compiled into the JAX package's step: its zoom line
search keeps its state on the device, each search step one `zoom_step`
kernel, and each trial is an IF node of the graph on the search's flag
(`GraphedSteps`).  A user's `torch.optim.LBFGS` reads scalars on the host
in its line search and runs eagerly.  On the CPU every step runs eagerly.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
import warnings
import weakref
from dataclasses import dataclass
from typing import Any, Callable

import torch

from .config import matmul_precision
from .kernels import lbfgs_zoom
from .kernels.lbfgs_zoom import (
    COUNT, CURV_ERR, DEC_ERR, LINESEARCH_STEPS, NEXT, SLOPE, SLOPE_INIT,
    SLOPE_RTOL, STEPSIZE, VALUE, VALUE_INIT, zoom_init, zoom_step,
    zoom_transition,
)
from .kernels.graph_if import BodyPool, body_stream, if_body
from .kernels.lbfgs_zoom import STATE_SIZE as ZOOM_STATE_SIZE
from .kernels.tanh_jet import add_replayed, counts_since, launch_counts
from .logging_utils import logscalar, logvector
from .parallel.mesh import BATCH_AXIS, all_reduce_flat, get_mesh
from .utils.profiling import PhaseTimer, merge_summaries, spans_enabled


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


LBFGS_LINESEARCH_STEPS = LINESEARCH_STEPS
_SLOPE_RTOL = SLOPE_RTOL


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


def zoom_linesearch(value_init, slope_init, evaluate):
    """optax's zoom line search (`scale_by_zoom_linesearch` with
    `LBFGS_LINESEARCH_STEPS` and its defaults) along one direction, on host
    scalars: `zoom_init`, then `zoom_transition` until the search ends.

    ``value_init``/``slope_init`` are numpy scalars of one float dtype, the
    value at stepsize 0 and the slope there; ``evaluate(stepsize)`` returns
    the value and the slope at a stepsize as numpy scalars of that dtype.
    Each call to it is one step of the search (`zoom_transition` says which).

    Returns ``(stepsize, steps, decrease_error, curvature_error)``, optax's
    ``ZoomLinesearchInfo``."""
    state, searching = zoom_init(value_init, slope_init), True
    while searching:
        state, _, searching = zoom_transition(state,
                                              *evaluate(state[NEXT]))
    return (state[STEPSIZE], int(state[COUNT]), state[DEC_ERR],
            state[CURV_ERR])


def _lbfgs_direction(g, params, prev_params, prev_updates, dw_mem, du_mem,
                     weights, count, scale_init: bool):
    """`scale_by_lbfgs`'s update of the memory and its two-loop recursion ->
    the direction u = -H g, with the count a device tensor.

    ``g`` is the gradient as one `_flat` vector; ``params``,
    ``prev_params``/``prev_updates`` (the previous step's parameters and
    gradient) and the stacked differences ``dw_mem``/``du_mem`` are lists a
    parameter, ``weights`` the ``(memory_size,)`` weights; the memory and
    weights are written in place at slot ``(count - 1) % memory_size``.
    The first step (count 0) is selected by `torch.where`, the slots by
    device indices, so nothing is read on the host."""
    memory_size = weights.shape[0]
    first = count == 0
    prev = torch.remainder(count - 1, memory_size).reshape(1)
    dw = torch.where(first, 0.0, _flat(params) - _flat(prev_params))
    du = torch.where(first, 0.0, g - _flat(prev_updates))
    curv = torch.dot(du, dw)
    weights.index_copy_(0, prev, torch.where(curv == 0.0, 0.0,
                                             1.0 / curv).reshape(1))
    for buf, d in zip(dw_mem, _leaves(dw, params)):
        buf.index_copy_(0, prev, d.unsqueeze(0))
    for buf, d in zip(du_mem, _leaves(du, params)):
        buf.index_copy_(0, prev, d.unsqueeze(0))
    if not scale_init:
        gamma = 1.0
    else:
        den = torch.dot(du, du)
        gamma = torch.where(
            first, torch.clamp(1.0 / torch.sqrt(torch.dot(g, g)), max=1.0),
            torch.where(den > 0.0, torch.dot(du, dw) / den, 1.0))
    # the recursion from slot count % memory_size: newest pair first, then
    # oldest first
    order = torch.remainder(
        count + torch.arange(memory_size, device=count.device), memory_size)
    dws = _flat_memory(dw_mem).index_select(0, order)
    dus = _flat_memory(du_mem).index_select(0, order)
    ws = weights.index_select(0, order)
    vec, alphas = g, [None] * memory_size
    for j in reversed(range(memory_size)):
        alphas[j] = ws[j] * torch.dot(dws[j], vec)
        vec = vec + (-alphas[j]) * dus[j]
    vec = gamma * vec
    for j in range(memory_size):
        beta = ws[j] * torch.dot(dus[j], vec)
        vec = vec + (alphas[j] - beta) * dws[j]
    return -vec


@contextlib.contextmanager
def _trial(flag: torch.Tensor, pool):
    """A line-search trial guarded by ``flag`` (a bool scalar): the ``as``
    value says whether to run the body.  Under CUDA-graph capture the body
    is captured into an IF node on the flag (`kernels.graph_if`, its
    allocations from ``pool``), and the value is True; otherwise the flag
    is read (one host read), and on the card a body that runs runs on the
    IF bodies' stream, as it will in the graph."""
    if not flag.is_cuda:
        yield bool(flag)
    elif torch.cuda.is_current_stream_capturing():
        if pool is None:
            raise RuntimeError("an LBFGS step is captured by solve's "
                               "GraphedSteps, which gives its trials a pool")
        with if_body(flag, pool):
            yield True
    elif not bool(flag):
        yield False
    else:
        outer, body = torch.cuda.current_stream(flag.device), body_stream(
            flag.device)
        body.wait_stream(outer)
        try:
            with torch.cuda.stream(body):
                yield True
        finally:
            outer.wait_stream(body)


class LBFGS(torch.optim.Optimizer):
    """`optax.lbfgs()`'s rule: `scale_by_lbfgs(memory_size,
    scale_init_precond)`, `scale(-1)` and `scale_by_zoom_linesearch(
    max_linesearch_steps=20, initial_guess_strategy="one")`, one update a
    step, with no host read on the card.

    ``step(closure)``: ``closure()`` evaluates the loss at the parameters as
    they are and sets their gradients.  Its first call gives the step's
    value and gradient g.  The memory then takes the pair (parameters minus
    the previous step's, g minus the previous gradient) at slot
    ``(count - 1) % memory_size`` with weight 1/<dg, dw> (0 where that is
    0; nothing at the first step), and the two-loop recursion from slot
    ``count % memory_size`` preconditions g with the initial scale
    <dg, dw>/<dg, dg> (1 where dg = 0; min(1, 1/||g||) at the first step).
    The count stays on the device: the slots are indexed by device tensors
    and the first step is selected by `torch.where`.  The direction u is
    minus the result; the zoom line search picks the stepsize, each of its
    steps one more call of ``closure`` at w + stepsize u, and the parameters
    end at w + stepsize u.  For complex parameters every inner product is
    the real part of <x, y> (the gradient is torch's, the conjugate of
    `jax.grad`'s, which the JAX package's trainer conjugates before optax
    sees it).  The recursion runs on the parameters laid end to end as one
    real vector (`_flat`), a dot product a memory slot.

    The line search keeps its state on the device (`kernels.lbfgs_zoom`):
    `LBFGS_LINESEARCH_STEPS` trials, each guarded by the ``searching`` flag
    and each a move, a call of ``closure`` (its gradients zeroed in place,
    not set to None), the slope <g, u> and one `zoom_step`, which on the
    card is a kernel that writes the next state, stepsize and flag.  Under
    CUDA-graph capture each trial is an IF node on the flag, so `solve`
    captures the whole step (module note); run eagerly, the flag is read
    once a trial, the one host read of the step.  On the CPU `zoom_step`
    is the plain transition on numpy scalars.

    The state holds, a parameter, the previous parameters and gradient and
    the stacked ``(memory_size, *shape)`` differences; with the first
    parameter, the count, the ``(memory_size,)`` weights, the last stepsize
    and the last search's steps and errors (``num_linesearch_steps``,
    ``decrease_error``, ``curvature_error``).  The weights, the stepsize and
    every scalar of the line search are in the parameters' real dtype,
    which is optax's arithmetic with JAX's x64 off; with it on, optax keeps
    the weights and some scalars of the search in float64 also for float32
    parameters.  The search's packed state and flag are scratch, rebuilt
    at the first step and not saved.

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
        self._search = None
        # set by `GraphedSteps` around a capture: the allocator pool of the
        # trials' IF bodies, and the kernels' launches in each body captured
        # (it reports a replay's from the bodies the replay ran)
        self.body_pool = None
        self.trial_launches: list = []

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

    def _scratch(self, real, device):
        """The line search's packed state and ``searching`` flag, made
        once, so that a captured step finds them at fixed addresses."""
        if self._search is None:
            self._search = (
                torch.zeros(ZOOM_STATE_SIZE, dtype=real, device=device),
                torch.zeros((), dtype=torch.bool, device=device))
        return self._search

    @torch.no_grad()
    def step(self, closure=None, member: int | None = None):
        if closure is None:
            raise ValueError("LBFGS needs a closure that evaluates the loss")
        closure = torch.enable_grad()(closure)
        if not self.state[self._params[0]]:
            self._init_state(member)
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
        count = glob["count"]
        weights = glob["weights_memory"]
        u = _lbfgs_direction(g, params, prev_params, prev_updates, dw_mem,
                             du_mem, weights, count, scale_init)
        start = _flat(params)
        for q, p in zip(prev_params, params):
            q.copy_(p)
        for q, x in zip(prev_updates, _leaves(g, params)):
            q.copy_(x)
        count.add_(1)

        real = weights.dtype
        state, searching = self._scratch(real, g.device)
        # zoom_init on device scalars
        state[:VALUE].zero_()
        state[VALUE:VALUE_INIT + 1].copy_(loss.detach().to(real).expand(
            VALUE_INIT + 1 - VALUE))
        state[SLOPE:SLOPE_INIT + 1].copy_(torch.dot(u, g).expand(
            SLOPE_INIT + 1 - SLOPE))
        state[DEC_ERR:CURV_ERR + 1].fill_(math.inf)
        state[NEXT].fill_(1.0)
        searching.fill_(True)

        def move(stepsize):
            for p, x in zip(params, _leaves(start + stepsize * u, params)):
                p.copy_(x)

        info = [glob[k] for k in ("learning_rate", "num_linesearch_steps",
                                  "decrease_error", "curvature_error")]
        capturing = g.is_cuda and torch.cuda.is_current_stream_capturing()
        for _ in range(LBFGS_LINESEARCH_STEPS):
            with _trial(searching, self.body_pool) as run:
                if run:
                    before = launch_counts()
                    move(state[NEXT])
                    value = closure().detach().to(real)
                    zoom_step(state, value, torch.dot(_flat(grads()), u),
                              searching, *info)
                    if capturing:
                        self.trial_launches.append(counts_since(before))
            if not run:
                break
        move(state[STEPSIZE])
        return loss


def lbfgs(memory_size: int = 10, scale_init_precond: bool = True
          ) -> Callable:
    """Optimizer factory: `LBFGS`, `optax.lbfgs()`'s rule (its two-loop
    recursion and zoom line search) with its defaults.  On the card `solve`
    captures its steps as CUDA graphs (see the module note)."""
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

    # `_run_closure` appends the generator's offset at each eager run's
    # start to a list here (`GraphedSteps` sets one to learn the offsets)
    closure_offsets: list | None = None

    @staticmethod
    def needs_closure(opt) -> bool:
        """Whether ``opt`` evaluates the loss itself through a closure."""
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
            reweight: bool, generators=None):
        """One step in place -> ``(loss, aux)``, detached tensors on the
        device.  Reads nothing back to the host (except under a
        `torch.optim.LBFGS`, and `LBFGS` run eagerly on the card, which
        reads its search's flag once a trial), so it can be captured.
        ``generators``: under capture, the graph-safe states of the line
        search's evaluations (`_run_closure`), in a list of one."""
        if self.needs_closure(opt):
            return self._run_closure(theta, opt, ada_state, generator,
                                     reweight, generators=(
                                         generators[0] if generators
                                         else None))
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
                     member=None, generators=None):
        """L-BFGS: every evaluation of its line search draws the step's
        points again, as the JAX package's ``value_fn`` reuses the step's
        key, and sees the weights from before this step's reweighting.  Run
        eagerly, the generator is rewound to the step's start before each
        evaluation (and its offset there is appended to ``closure_offsets``
        when that is a list).  Under CUDA-graph capture, where a generator's
        state cannot be set, evaluation i (0 the first) draws from
        ``generators[i]``, a graph-safe state that `GraphedSteps` sets to
        the step's start before each replay (None: the step draws nothing).
        ``member``: step that member of stacked parameters alone
        (`LBFGS.step`'s ``member``)."""
        like = next(iter(theta.values()))
        capturing = like.is_cuda and torch.cuda.is_current_stream_capturing()
        start = None
        if generator is not None and not capturing:
            start = generator.get_state()
            if self.closure_offsets is not None:
                self.closure_offsets.append(generator.get_offset())
        main = generator.graphsafe_get_state() if generators else None
        states = iter(generators or ())
        kw = {} if member is None else {"member": member}

        def at(tree):
            return tree if member is None else self._slice(tree, member)

        weights = ({k: v.clone() for k, v in at(ada_state).items()}
                   if reweight else at(ada_state))
        first = []
        group = self._data_group()

        def closure():
            trial = bool(first)
            if start is not None:
                generator.set_state(start)
            elif main is not None:
                generator.graphsafe_set_state(next(states))
            # a trial's gradients go into the buffers of the first
            # evaluation, which a captured step holds at fixed addresses
            opt.zero_grad(set_to_none=not trial)
            try:
                with matmul_precision(self.precision):
                    loss, aux = self.loss_fn(at(theta),
                                             {"generator": generator,
                                              "adaptive": weights})
                    loss.backward()
                    loss = loss.detach()
                    aux = {k: v.detach() for k, v in aux.items()}
                    if group is not None:
                        loss, aux = self._sum_shares(group, theta, loss, aux)
                    if not trial:
                        first.append((loss, aux))
                        if reweight:
                            self._reweight(at(theta), at(ada_state), aux,
                                           generator)
            finally:
                if main is not None:
                    generator.graphsafe_set_state(main)
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


def _segments(device) -> int:
    """The allocator segments created on ``device`` so far."""
    return torch.cuda.memory_stats(device).get("segment.all.allocated", 0)


class _SpannedCapture:
    """A `torch.cuda.graph` context with its entry (synchronize, emptying
    the cache, the stream switch, ``capture_begin``), the captured body and
    its exit (the end of capture and the graph's instantiation) as the
    spans ``solve.capture.enter``, ``.record`` and ``.instantiate``."""

    def __init__(self, capture, spans: PhaseTimer):
        self.capture, self.spans = capture, spans

    def __enter__(self):
        with self.spans.phase("solve.capture.enter"):
            self.capture.__enter__()
        self.spans.open("solve.capture.record")

    def __exit__(self, *exc):
        self.spans.close()
        with self.spans.phase("solve.capture.instantiate"):
            return self.capture.__exit__(*exc)


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

    An `LBFGS` step is captured whole: its line-search trials are IF nodes
    on the search's device flag (`LBFGS.step`).  Where the step draws
    points, its eager run gives the generator's offset at the start of each
    line search (one a member in `solve_ensemble`) and the step's advance;
    in the graph every evaluation draws from a graph-safe generator state
    of its own, set before each replay to the offset at which the eager
    step drew its points, and after the replay the solve's generator
    advances as the eager step advanced it, so that captured and eager
    steps draw alike.  A replay runs the trials its searches need, so the
    launches inside the trial bodies are reported from the device's count
    of them when `stats` is read.  A user's `torch.optim.LBFGS` reads the
    host and runs eagerly.

    ``spans``: a `utils.profiling.PhaseTimer` (`solve`'s) that records
    each eager step (``solve.eager_step``), capture (``solve.capture``,
    with its children ``.enter``, ``.record`` and ``.instantiate`` and the
    allocator segments it created, ``segments``) and replay
    (``solve.replay``); None records nothing.
    """

    def __init__(self, step: TrainStep, carry, generator: torch.Generator,
                 spans: PhaseTimer | None = None):
        self.step = step
        self.spans = spans
        self.theta, self.opt, self.ada_state, _ = carry
        self.generator = generator
        self.eager = isinstance(self.opt, torch.optim.LBFGS)
        self.lbfgs = isinstance(self.opt, LBFGS)
        self._seen: set = set()
        # per kind of LBFGS step: each line search's start offset relative
        # to the step's, and the step's advance of the generator
        self._draws: dict = {}
        self._graphs: dict = {}
        # trial bodies run by replays (a device count), those reported, and
        # the launches of one body
        self._entered = None
        self._reported = 0
        self._body: dict = {}
        self.captures = 0
        self.capture_seconds = 0.0
        self.replays = 0

    def __call__(self, iteration: int):
        """Run the step at ``iteration`` -> ``(loss, aux)`` (tensors that a
        later replay of the same graph overwrites)."""
        kind = self.step.reweights(iteration)
        spans = self.spans
        if self.eager or kind not in self._seen:
            self._seen.add(kind)
            if spans is not None:
                spans.open("solve.eager_step")
            out = self._run_eager(kind)
            if spans is not None:
                spans.close()
            return out
        if kind not in self._graphs:
            self._graphs[kind] = self._capture(kind)
        graph, out, launched, generators = self._graphs[kind]
        if spans is not None:
            spans.open("solve.replay")
        if generators:
            offset = self.generator.get_offset()
            for states, start in zip(generators, self._draws[kind][0]):
                for state in states:
                    state.set_offset(offset + start)
        graph.replay()
        if generators:
            self.generator.set_offset(offset + self._draws[kind][1])
        if spans is not None:
            spans.close()
        add_replayed(launched)
        self.replays += 1
        return out

    def _run_eager(self, kind: bool):
        if not self.lbfgs:
            return self.step.run(self.theta, self.opt, self.ada_state,
                                 self.generator, kind)
        offset = self.generator.get_offset()
        self.step.closure_offsets = []
        try:
            out = self.step.run(self.theta, self.opt, self.ada_state,
                                self.generator, kind)
            self._draws[kind] = (
                [o - offset for o in self.step.closure_offsets],
                self.generator.get_offset() - offset)
        finally:
            self.step.closure_offsets = None
        return out

    def _capture(self, reweight: bool):
        spans = self.spans
        if spans is None:
            t0 = time.perf_counter()
        else:
            segments = _segments(self.generator.device)
            spans.open("solve.capture")
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        kw, generators = {}, None
        if self.lbfgs:
            starts, advance = self._draws[reweight]
            if advance:
                # the first evaluation and each trial of each line search
                generators = [[self.generator.clone_state()
                               for _ in range(1 + LBFGS_LINESEARCH_STEPS)]
                              for _ in starts]
                for state in (s for states in generators for s in states):
                    graph.register_generator_state(state)
                kw = {"generators": generators}
            if self._entered is None:
                self._entered = torch.zeros((), dtype=torch.int64,
                                            device=self.generator.device)
            self.opt.trial_launches = []
            self.opt.body_pool = BodyPool(self.generator.device)
            weakref.finalize(graph, self.opt.body_pool.release)
        try:
            capture = torch.cuda.graph(graph,
                                       stream=torch.cuda.current_stream())
            with (capture if spans is None
                  else _SpannedCapture(capture, spans)):
                out = self.step.run(self.theta, self.opt, self.ada_state,
                                    self.generator, reweight, **kw)
                if self.lbfgs:
                    self._entered.add_(self.opt.state[self.opt._params[0]][
                        "num_linesearch_steps"].sum())
        except RuntimeError as e:
            raise RuntimeError(
                "solve: the training step could not be captured as a CUDA "
                f"graph ({type(self.opt).__name__}"
                f"{', reweighting' if reweight else ''}): {e}") from e
        finally:
            if self.lbfgs:
                self.opt.body_pool = None
        self.captures += 1
        if spans is None:
            self.capture_seconds += time.perf_counter() - t0
        else:
            self.capture_seconds += spans.close()
            spans.add("solve.capture", "segments",
                      _segments(self.generator.device) - segments)
        launched = counts_since(before)
        if self.lbfgs:
            # the launches outside the trial bodies run at every replay
            bodies = self.opt.trial_launches
            self._body = bodies[0]
            launched = {k: n - sum(b[k] for b in bodies)
                        for k, n in launched.items()}
        return graph, out, launched, generators

    def stats(self) -> dict:
        """The capture and replay counts; reports the launches of the trial
        bodies that replays ran (one host read)."""
        if self._entered is not None:
            entered = int(self._entered) - self._reported
            self._reported += entered
            add_replayed(self._body, entered)
            lbfgs_zoom.add_replayed(entered)
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

    With spans on (`utils.profiling.enable_spans`, or ``profile_dir``
    given) the run records its phases in a `utils.profiling.PhaseTimer`
    of its own, whose summary is ``result.aux["spans"]``: ``solve``, and
    inside it ``solve.build`` (everything before the first step),
    ``solve.eager_step``, ``solve.capture`` (its children ``.enter``,
    ``.record``, ``.instantiate``; the counter ``segments``),
    ``solve.replay``, ``solve.read`` (the host's wait for a block's
    loss), ``solve.block_end`` (the work after it but the callback),
    ``solve.callback`` and ``solve.finish``.  A profiler's trace then holds
    each as a range.  With spans off the key is absent.
    """
    spans = (PhaseTimer() if profile_dir is not None or spans_enabled()
             else None)
    if spans is not None:
        spans.open("solve")
        spans.open("solve.build")
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
    graphed = (GraphedSteps(step, carry, generator, spans)
               if torch.device(device).type == "cuda" else None)
    if profile_dir is not None:
        from .utils.profiling import trace

        profiling = trace(profile_dir)
    else:
        profiling = contextlib.nullcontext()
    like = next(iter(theta.values()))
    if spans is not None:
        spans.close()
    with profiling, _side_stream(like):
        while it < maxiters:
            for i in range(it, it + inner_steps):
                if graphed is not None:
                    loss, aux = graphed(i)
                else:
                    if spans is not None:
                        spans.open("solve.eager_step")
                    loss, aux = step.run(theta, opt, ada_state, generator,
                                         step.reweights(i))
                    if spans is not None:
                        spans.close()
            it += inner_steps
            if spans is not None:
                spans.open("solve.read")
            loss_val = float(loss)
            if spans is not None:
                spans.close()
                spans.open("solve.block_end")
            aux = {k: v.clone() for k, v in aux.items()}
            history.append(loss_val)
            if verbose:
                print(f"[solve] iter {it:6d}  loss {loss_val:.6g}")
            if logger is not None and it % log_frequency == 0:
                _log_metrics(logger, aux, it, ada_state)
            if checkpoint_dir is not None and it % checkpoint_every < inner_steps:
                _save(checkpoint_dir, theta, opt, generator, ada_state, it)
            reached = abstol is not None and loss_val < abstol
            diverged = not math.isfinite(loss_val)
            if spans is not None:
                spans.close()
            if callback is not None:
                if spans is not None:
                    spans.open("solve.callback")
                stop = callback(it, loss_val, aux)
                if spans is not None:
                    spans.close()
                if stop:
                    break
            if reached:
                break
            if diverged:
                warnings.warn(
                    f"training diverged (loss={loss_val}) at iteration {it}; "
                    "stopping — consider a lower learning rate, remat=True, "
                    "or utils.profiling.enable_nan_debugging() to locate the "
                    "source")
                break

    if spans is not None:
        spans.open("solve.finish")
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
    trained_checks = (
        getattr(strategy, "_trained_checks", None)
        and math.isfinite(loss_val if loss_val is not None else math.nan))
    if trained_checks and not quad_adapt:
        strategy.validate_trained(result.u)
    if spans is not None:
        spans.close()                   # solve.finish
        spans.close()                   # solve
        result_aux["spans"] = spans.summary()
    if trained_checks and quad_adapt:
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
        if "spans" in result.aux:
            aux["spans"] = merge_summaries(result.aux["spans"],
                                           aux.get("spans", {}))
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
    replays one too, its line-search trials IF nodes of the graph.

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
