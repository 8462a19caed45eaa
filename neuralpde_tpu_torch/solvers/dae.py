"""NNDAE: DAE PINN solver (`neuralpde_tpu.solvers.dae`; reference:
src/dae_solve.jl).

DAE form: ``f(du, u, p, t) = 0`` out-of-place, written with `torch` for one
time point; algebraic rows (where ``differential_vars[i] == False``) get a
zero derivative in the residual (reference: src/dae_solve.jl:48-62).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np
import torch
from torch.func import vmap

from ..config import default_float
from ..strategies import GridTraining, TrainingStrategy, julia_range
from ..train import adam, solve as train_solve
from .ode import (
    ODEPhi, _SimpleProblem, _as_vector, _problem_p, build_ode_solution,
    initial_theta, make_phi,
)
from .problems import ODESolution


@dataclass
class DAEProblem:
    """f(du, u, p, t) = 0 with consistent u0, du0."""

    f: Callable
    u0: Any
    du0: Any
    tspan: tuple
    p: Any = None
    differential_vars: Any = None
    analytic: Callable | None = None

    def remake(self, **kw):
        return replace(self, **kw)


@dataclass
class NNDAE:
    chain: Any
    opt: Any = None
    init_params: Any = None
    autodiff: bool = False
    strategy: TrainingStrategy | None = None
    seed: int = 0


def dae_dfdx(phi: ODEPhi, ts, theta, autodiff: bool, differential_vars):
    """Masked forward-difference du/dt (reference: src/dae_solve.jl:48-62).
    ``differential_vars`` is a tensor mask on the device of ``ts``, or a
    list of booleans."""
    if autodiff:
        raise ValueError("autodiff not supported for DAE problem.")
    eps = float(torch.finfo(ts.dtype).eps) ** 0.5
    dphi = (phi(ts + eps, theta) - phi(ts, theta)) / eps
    mask = torch.as_tensor(differential_vars, device=dphi.device).to(dphi.dtype)
    return dphi * mask[:, None]


def build_dae_loss(prob: DAEProblem, alg: NNDAE, *, dt=None, device=None):
    """The NNDAE objective of `solve_dae`: ``(total_loss(theta, generator),
    theta0, phi)`` on ``device`` (default ``"cuda"``)."""
    dtype = default_float()
    device = torch.device(device if device is not None else "cuda")
    t0 = float(prob.tspan[0])
    n = np.atleast_1d(np.asarray(prob.u0)).shape[0]
    dvars = torch.as_tensor(
        np.asarray(prob.differential_vars, dtype=bool)
        if prob.differential_vars is not None else np.ones(n, dtype=bool),
        device=device)

    theta0 = initial_theta(prob, alg, dtype, device)
    phi = make_phi(prob.remake(u0=np.atleast_1d(np.asarray(prob.u0))), alg,
                   theta0)
    p_fixed = _problem_p(prob.p, dtype, device)

    strategy = alg.strategy
    if strategy is None:
        if dt is None:
            raise ValueError("`dt` is not defined")
        strategy = GridTraining(dt)
    if not isinstance(strategy, GridTraining):
        raise ValueError("NNDAE currently supports GridTraining only "
                         "(reference: src/dae_solve.jl:75-82)")

    ts = torch.as_tensor(julia_range(t0, float(prob.tspan[1]), strategy.dx),
                         dtype=dtype, device=device)
    f_b = vmap(lambda du, u, p, t: _as_vector(prob.f(du, u, p, t), t),
               in_dims=(1, 1, None, 0), out_dims=1)

    def total_loss(theta, generator=None):
        out = phi(ts, theta)
        dphi = dae_dfdx(phi, ts, theta, alg.autodiff, dvars)
        res = f_b(dphi, out, p_fixed, ts)
        return torch.sum(res**2) / ts.shape[0]

    return total_loss, theta0, phi


def solve_dae(prob: DAEProblem, alg: NNDAE, *, dt=None, abstol: float = 1e-6,
              verbose: bool = False, saveat=None, maxiters: int = 1000,
              save_everystep: bool = True, generator=None, seed: int = 0,
              inner_steps: int = 1, device=None) -> ODESolution:
    """`solve(DAEProblem, NNDAE(...))` (reference: src/dae_solve.jl:64-140),
    on ``device`` (``"cuda"`` unless given)."""
    total_loss, theta0, phi = build_dae_loss(prob, alg, dt=dt, device=device)
    res = train_solve(_SimpleProblem(total_loss, theta0),
                      alg.opt or adam(1e-3), maxiters=maxiters, abstol=abstol,
                      verbose=verbose, generator=generator, seed=seed,
                      inner_steps=inner_steps)
    return build_ode_solution(prob, phi, res, dt=dt, saveat=saveat,
                              save_everystep=save_everystep, scalar=False)
