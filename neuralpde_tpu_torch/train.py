"""Training loop (`neuralpde_tpu.train`; Optimization.jl replacement).

`make_step` builds one optimizer step: the weighted loss and its gradient
(forward and backward under the discretization's matmul precision), the
adaptive-weight hook, and a `torch.optim` update.  Parameters are updated in
place: the carry holds leaf tensors that the optimizer owns.  `solve` runs
blocks of ``inner_steps`` steps with no host read inside a block, and keeps
the callback / abstol-stop protocol (reference semantics:
src/ode_solve.jl:469-481) and logging at `log_frequency` (reference:
src/discretize.jl:598-643) once per block.

Not ported yet: a block as one CUDA graph (it is a plain loop of eager
steps), checkpoint/resume, profiling, quadrature re-solves and
`solve_hybrid`.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Any, Callable

import torch

from .config import matmul_precision
from .logging_utils import logscalar, logvector


def adam(lr: float = 1e-3) -> Callable:
    """Optimizer factory: `torch.optim.Adam` with optax.adam's defaults
    (betas 0.9/0.999, eps 1e-8), the same update rule."""
    return lambda params: torch.optim.Adam(params, lr=lr, eps=1e-8)


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


class TrainStep:
    """One training step; see `make_step`."""

    def __init__(self, loss_fn, optimizer, adaloss=None, precision=None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.adaloss = adaloss
        self.precision = precision
        self.every = getattr(adaloss, "reweight_every", 0) if adaloss else 0
        if self.every and adaloss.needs_component_grads:
            raise NotImplementedError(
                "adaptive losses that need per-component gradients are not "
                "ported yet")

    def init(self, params: dict, ada_state: dict, iteration: int = 0):
        """The carry ``(theta, optimizer, ada_state, iteration)``: trainable
        copies of ``params`` and the optimizer built over them."""
        theta = {k: v.detach().clone().requires_grad_(True)
                 for k, v in params.items()}
        return (theta, self.optimizer(list(theta.values())), ada_state,
                iteration)

    def __call__(self, carry, generator: torch.Generator):
        """-> (new carry, (loss, aux)); ``loss`` and ``aux`` are detached
        tensors on the device (reading them waits for the step to finish)."""
        theta, opt, ada_state, it = carry
        lstate = {"generator": generator, "adaptive": ada_state}
        opt.zero_grad(set_to_none=True)
        with matmul_precision(self.precision):
            loss, aux = self.loss_fn(theta, lstate)
            loss.backward()
        aux = {k: v.detach() for k, v in aux.items()}
        if self.every and (it + 1) % self.every == 0:
            ada_state = self.adaloss.reweight(
                ada_state, theta, aux["pde_losses"], aux["bc_losses"], None,
                generator)
        opt.step()
        return (theta, opt, ada_state, it + 1), (loss.detach(), aux)


def make_step(loss_fn, optimizer, adaloss=None, pde_loss_fns=(),
              bc_loss_fns=(), *, matmul_precision: str | None = None):
    """Build the train step.

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer`` (e.g.
    `adam(1e-3)`); ``step.init(params, ada_state)`` builds the carry
    ``(theta, optimizer, ada_state, iteration)`` and
    ``step(carry, generator)`` returns ``(carry, (loss, aux))``.  The
    generator is advanced by every step's sampling, in place of the JAX
    package's per-iteration key fold-in.  ``pde_loss_fns``/``bc_loss_fns``
    are kept for the JAX signature; the schemes that read them are not
    ported yet.
    """
    del pde_loss_fns, bc_loss_fns
    return TrainStep(loss_fn, optimizer, adaloss, matmul_precision)


def solve(prob, optimizer=None, maxiters: int = 1000, *,
          callback: Callable | None = None, abstol: float | None = None,
          generator: torch.Generator | None = None, seed: int = 0,
          inner_steps: int = 1, verbose: bool = False):
    """Train a `TrainingProblem` (from `discretize`).

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer``
    (default `adam(1e-3)`).  ``generator`` (default: seeded with ``seed``
    on the problem's device) supplies the stochastic strategies' points.

    Steps run in blocks of ``inner_steps``, with no host read inside a
    block.  After each block the iteration count grows by ``inner_steps``
    and, on the block's last loss and aux, the history gains one entry,
    ``callback(it, loss, aux)`` runs (True stops the run), logging happens
    at multiples of the log frequency, and ``loss < abstol`` or a non-finite
    loss stops the run.  As in the JAX package whole blocks run, so the
    count passes ``maxiters`` when that is not a multiple of the block.
    """
    optimizer = optimizer or adam(1e-3)
    pinnrep = prob.pinnrep
    adaloss = pinnrep.adaloss
    lf = pinnrep.loss_functions
    device = pinnrep.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)

    ada_state = adaloss.init_state(len(lf.pde_loss_functions),
                                   len(lf.bc_loss_functions), pinnrep.dtype,
                                   device)
    step = make_step(prob.loss, optimizer, adaloss,
                     matmul_precision=pinnrep.matmul_precision)
    carry = step.init(prob.init_params, ada_state)

    logger = pinnrep.logger
    log_frequency = pinnrep.log_options.log_frequency
    history = []
    loss_val, aux = None, {}
    it = 0
    while it < maxiters:
        for _ in range(inner_steps):
            carry, (loss, aux) = step(carry, generator)
        it += inner_steps
        loss_val = float(loss)
        history.append(loss_val)
        if verbose:
            print(f"[solve] iter {it:6d}  loss {loss_val:.6g}")
        if logger is not None and it % log_frequency == 0:
            _log_metrics(logger, aux, it, carry[2])
        if callback is not None and callback(it, loss_val, aux):
            break
        if abstol is not None and loss_val < abstol:
            break
        if not math.isfinite(loss_val):
            warnings.warn(
                f"training diverged (loss={loss_val}) at iteration {it}; "
                "stopping — consider a lower learning rate")
            break

    theta, _, ada_state, _ = carry
    theta = {k: v.detach() for k, v in theta.items()}
    return SolveResult(u=theta, objective=loss_val, iterations=it,
                       aux={**aux, "adaptive_state": ada_state},
                       history=history)


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
