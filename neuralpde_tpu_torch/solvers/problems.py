"""Problem types (`neuralpde_tpu.solvers.problems`; SciMLBase
ODEProblem/solution analogs).  Numpy only."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable

import numpy as np


@dataclass
class ODEProblem:
    """du/dt = f(u, p, t), out-of-place (the only form NNODE supports,
    reference: src/ode_solve.jl:399).

    * f: (u, p, t) -> du, written with `torch`, with u an (n,) tensor and t
      a 0-d tensor (a single time point; the solvers batch it with
      `torch.func.vmap`); it may return a tensor, a number, or a list of
      either
    * u0: scalar or (n,) array
    * tspan: (t0, t1)
    * p: parameter vector (or None)
    * analytic: optional (u0, p, t) -> u exact solution for error reporting
    """

    f: Callable
    u0: Any
    tspan: tuple
    p: Any = None
    analytic: Callable | None = None

    def remake(self, **kw):
        return replace(self, **kw)


@dataclass
class SDEProblem:
    """du = f(u,p,t) dt + g(u,p,t) dW (scalar diffusion)."""

    f: Callable
    g: Callable
    u0: Any
    tspan: tuple
    p: Any = None
    analytic: Callable | None = None

    def remake(self, **kw):
        return replace(self, **kw)


@dataclass
class ODESolution:
    """Dense NN-interpolated solution (reference: src/ode_solve.jl:344-363,
    484-513).  `sol(t)` evaluates the trained trial function at arbitrary t."""

    ts: Any
    us: Any                      # (N, n_out) saved values
    interp: Callable             # t (scalar or vector) -> u
    original: Any                # SolveResult from the optimizer
    retcode: str = "Success"
    errors: dict = field(default_factory=dict)
    k: Any = None

    def __call__(self, t):
        return self.interp(t)

    @property
    def u(self):
        return self.us

    @property
    def resid(self):
        return self.original.objective


def compute_ode_errors(sol_vals, exact_vals):
    diff = np.abs(np.asarray(sol_vals) - np.asarray(exact_vals))
    return {
        "l2": float(np.sqrt(np.mean(diff**2))),
        "l_inf": float(np.max(diff)),
        "final": float(np.sqrt(np.sum(diff[-1] ** 2))),
    }
