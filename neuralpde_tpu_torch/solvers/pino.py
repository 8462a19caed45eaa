"""PINOODE: physics-informed neural operator for parametric ODE families
(`neuralpde_tpu.solvers.pino`; reference: src/pino_ode_solve.jl).

Learns ``u(p, t)`` over parameter bounds with a DeepONet (branch = p,
trunk = t), an `FNO1D` over the time grid, or a plain MLP on stacked
``(p, t)`` columns.  The loss is the physics-residual MSE plus the
initial-condition MSE over a (parameters × time) product train set
(reference: src/pino_ode_solve.jl:106-196).  The user's ``f(u, p, t)``,
written with `torch` for one point, is batched by `torch.func.vmap`.

`solve_pino_ode` trains through `train.solve`, so on the card its steps
replay a captured CUDA graph; `StochasticTraining` draws each step's
``(p, t)`` from the solve's generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call, vmap

from ..compile.lower import depvar_params
from ..config import default_float
from ..nn.deeponet import DeepONet
from ..nn.fno import FNO1D
from ..strategies import (
    GridTraining, StochasticTraining, TrainingStrategy, julia_range,
)
from ..train import adam, solve as train_solve
from .ode import _SimpleProblem, _as_vector, initial_theta
from .problems import ODEProblem


@dataclass
class PINOODE:
    """chain: DeepONet, FNO1D or a Module (MLP on stacked (p, t));
    opt: optimizer factory (default ``adam(1e-3)``);
    bounds: list of (lb, ub) per ODE parameter;
    number_of_parameters: train-set size along the parameter axis;
    init_params: the chain's parameters under its own names, else drawn
    from a CPU generator seeded with ``seed``."""

    chain: Any
    opt: Any = None
    bounds: Any = None
    number_of_parameters: int = 100
    init_params: Any = None
    strategy: TrainingStrategy | None = None
    additional_loss: Callable | None = None
    seed: int = 0


class PINOPhi:
    """Operator wrapper (reference: src/pino_ode_solve.jl:61-87); no IC
    shift.  ``phi(x, theta)`` with ``theta`` the flat parameter dict."""

    def __init__(self, module):
        self.module = module
        # tuple-input operators share the DeepONet calling convention
        # ((p, t) -> (T, P)); plain Modules consume stacked (p, t) columns
        self.is_deeponet = isinstance(module, (DeepONet, FNO1D))
        # an FNO evaluates fields, not points: the IC is read off the
        # training grid
        self.is_fno = isinstance(module, FNO1D)

    def __call__(self, x, theta):
        return functional_call(self.module, depvar_params(theta), (x,),
                               strict=True)


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps) ** 0.5


def _dfdt(phi: PINOPhi, x, theta):
    """Forward-difference du/dt (reference: src/pino_ode_solve.jl:89-104)."""
    if phi.is_deeponet:
        p, t = x
        eps = _eps(t.dtype)
        return (phi((p, t + eps), theta) - phi((p, t), theta)) / eps
    eps = _eps(x.dtype)
    shift = torch.cat([x[:-1], x[-1:] + eps])
    return (phi(shift, theta) - phi(x, theta)) / eps


def _grid_dfdt(u, tt):
    """Second-order FD of a field along its uniform grid axis (axis 0):
    central interior, one-sided second-order ends.  The derivative an FNO
    trains with: differentiating the evaluated field itself ties the
    physics to what the solution returns (Li et al. 2021)."""
    h = tt[1] - tt[0]
    interior = (u[2:] - u[:-2]) / (2 * h)
    first = (-3 * u[0:1] + 4 * u[1:2] - u[2:3]) / (2 * h)
    last = (3 * u[-1:] - 4 * u[-2:-1] + u[-3:-2]) / (2 * h)
    return torch.cat([first, interior, last], dim=0)


def _grid_trainset(bounds, n_params, tspan, dt, dtype, device=None):
    p_axes = [np.linspace(b[0], b[1], n_params) for b in bounds]
    p = torch.as_tensor(np.stack(p_axes), dtype=dtype, device=device)
    t = torch.as_tensor(julia_range(tspan[0], tspan[1], dt)[None, :],
                        dtype=dtype, device=device)
    return p, t


def _stochastic_trainset(generator, lb, ub, n_params, tspan, n_t):
    """Uniform ``p`` ``(n_b, P)`` in [lb, ub] (``(n_b, 1)`` tensors), then
    uniform ``t`` ``(1, n_t)`` in tspan, from ``generator``."""
    p = lb + (ub - lb) * torch.rand((lb.shape[0], n_params),
                                    generator=generator, dtype=lb.dtype,
                                    device=lb.device)
    t = tspan[0] + (tspan[1] - tspan[0]) * torch.rand(
        (1, n_t), generator=generator, dtype=lb.dtype, device=lb.device)
    return p, t


def _residuals(phi: PINOPhi, prob: ODEProblem, p, t, theta):
    """Pointwise (physics, initial-condition) residual fields at the train
    set (p, t), the least-squares structure behind `_losses` (also read by
    `gauss_newton.build_pino_residual_vector`).

    DeepONet/FNO mode: scalar u only (u(p, t) shaped (T, P)).  MLP mode
    takes vector u0 (chain out_dim = n_out): outputs shaped (n_out, P, T)."""
    n_b, P = p.shape
    T = t.shape[1]
    u0_arr = np.atleast_1d(np.asarray(prob.u0, dtype=np.float64))
    n_out = u0_arr.shape[0]
    scalar_u = np.ndim(prob.u0) == 0

    if phi.is_deeponet:
        if n_out != 1:
            raise ValueError("DeepONet PINOODE supports scalar u0; use an "
                             "MLP chain for ODE systems")
        out = phi((p, t), theta)                              # (T, P)
        if phi.is_fno:
            # grid-axis FD of the evaluated field, and the IC read off the
            # first grid row (GridTraining's t grid starts at tspan[0])
            du = _grid_dfdt(out, t[0])
            u_at_t0 = out[0:1, :]
        else:
            du = _dfdt(phi, (p, t), theta)
            t0 = torch.full((1, 1), float(prob.tspan[0]), dtype=t.dtype,
                            device=t.device)
            u_at_t0 = phi((p, t0), theta)                     # (1, P)

        def f_one(u_scalar, p_col, t_scalar):
            p_arg = p_col[0] if n_b == 1 else p_col
            return _as_vector(prob.f(u_scalar, p_arg, t_scalar),
                              t_scalar).reshape(())

        f_pt = vmap(vmap(f_one, in_dims=(0, None, 0)),      # over T
                    in_dims=(1, 1, None), out_dims=1)        # over P
        f_vec = f_pt(out, p, t[0])                           # (T, P)
        return du - f_vec, u_at_t0 - float(u0_arr[0])

    pp = p[:, :, None].expand(n_b, P, T)
    tt = t[0][None, None, :].expand(1, P, T)
    x = torch.cat([pp, tt], dim=0).reshape(n_b + 1, P * T)
    out = phi(x, theta).reshape(n_out, P, T)
    du = _dfdt(phi, x, theta).reshape(n_out, P, T)
    x0 = torch.cat([x[:-1], torch.full_like(x[-1:], float(prob.tspan[0]))])
    u_at_t0 = phi(x0, theta).reshape(n_out, P, T)

    def f_one(u_col, p_col, t_scalar):
        p_arg = p_col[0] if n_b == 1 else p_col
        u_in = u_col[0] if scalar_u else u_col
        return _as_vector(prob.f(u_in, p_arg, t_scalar), t_scalar)

    # map over P then T: u_col (n_out,) per (p, t)
    f_pt = vmap(vmap(f_one, in_dims=(1, None, 0), out_dims=1),
                in_dims=(1, 1, None), out_dims=1)    # (n_out, P, T)
    f_vec = f_pt(out, p, t[0])
    # u0 enters as Python numbers: a tensor made here from the host array
    # would be a host-to-device copy inside the captured step
    return du - f_vec, torch.stack([u_at_t0[i] - float(u0_arr[i])
                                    for i in range(n_out)])


def _losses(phi: PINOPhi, prob: ODEProblem, p, t, theta):
    """Physics + IC loss at the train set (p, t) (reference:
    src/pino_ode_solve.jl:106-196)."""
    r_phys, r_ic = _residuals(phi, prob, p, t, theta)
    return torch.mean(r_phys ** 2) + torch.mean(r_ic ** 2)


def make_pino_interp(phi: PINOPhi, theta, n_out: int):
    """``interp(p, t)`` for a trained operator, the layout shared by
    `solve_pino_ode` and `gauss_newton.solve_pino_gauss_newton` (DeepONet
    and FNO: (T, P); MLP scalar: (T, P); MLP vector: (T, n_out, P))."""

    @torch.no_grad()
    def interp(p, t):
        if phi.is_deeponet:
            return phi((p, t), theta)
        P, T = p.shape[1], t.shape[1]
        pp = p[:, :, None].expand(p.shape[0], P, T)
        tt = t[0][None, None, :].expand(1, P, T)
        x = torch.cat([pp, tt], dim=0).reshape(p.shape[0] + 1, P * T)
        out = phi(x, theta).reshape(n_out, P, T)
        if n_out == 1:
            return out[0].T
        return torch.movedim(out, 2, 0)

    return interp


@dataclass
class PINOODESolution:
    """``sol(p, t)`` dispatches to the trained operator (reference:
    PDETimeSeriesSolution + PINOODEMetadata, src/pino_ode_solve.jl:362-426).
    ``p`` and ``t`` may be arrays; they take the parameters' dtype and
    device."""

    u: Any
    t: Any
    p: Any                     # training-set parameter tensor
    interp: Any
    original: Any
    retcode: str = "Success"

    def __call__(self, p=None, t=None):
        if t is None:          # sol(t): reuse the training p
            t, p = p, self.p
        like = self.p
        t = torch.atleast_2d(torch.as_tensor(t, dtype=like.dtype,
                                             device=like.device))
        p = torch.atleast_2d(torch.as_tensor(p, dtype=like.dtype,
                                             device=like.device))
        return self.interp(p, t)


def _n_out(prob) -> int:
    return 1 if np.ndim(prob.u0) == 0 else int(np.prod(np.shape(prob.u0)))


def solve_pino_ode(prob: ODEProblem, alg: PINOODE, *, dt=None,
                   abstol: float = 1e-8, verbose: bool = False,
                   maxiters: int = 1000, generator=None, seed: int = 0,
                   inner_steps: int = 1, device=None) -> PINOODESolution:
    """Train the operator on ``device`` (``"cuda"`` unless given).
    ``generator``/``seed`` feed `StochasticTraining`'s draws."""
    dtype = default_float()
    device = torch.device(device if device is not None else "cuda")
    if alg.bounds is None:
        raise ValueError("PINOODE requires parameter bounds")
    bounds = [tuple(map(float, b)) for b in alg.bounds]
    tspan = (float(prob.tspan[0]), float(prob.tspan[1]))

    phi = PINOPhi(alg.chain)
    theta0 = initial_theta(prob, alg, dtype, device)

    strategy = alg.strategy or StochasticTraining(100)
    if isinstance(alg.chain, FNO1D) and not isinstance(strategy, GridTraining):
        raise ValueError("FNO1D requires GridTraining: the FFT along the "
                         "time axis needs a uniform grid (pass "
                         "strategy=GridTraining(dt))")
    if isinstance(strategy, GridTraining):
        if strategy.dx is None and dt is None:
            raise ValueError("GridTraining requires dx")
        p_tr, t_tr = _grid_trainset(bounds, alg.number_of_parameters, tspan,
                                    strategy.dx or dt, dtype, device)

        def trainset(generator):
            return p_tr, t_tr
    elif isinstance(strategy, StochasticTraining):
        lb = torch.tensor([[b[0]] for b in bounds], dtype=dtype,
                          device=device)
        ub = torch.tensor([[b[1]] for b in bounds], dtype=dtype,
                          device=device)

        def trainset(generator):
            return _stochastic_trainset(generator, lb, ub,
                                        alg.number_of_parameters, tspan,
                                        strategy.points)
    else:
        raise ValueError("Only GridTraining and StochasticTraining strategy "
                         "is supported")

    def total_loss(theta, generator):
        p, t = trainset(generator)
        loss = _losses(phi, prob, p, t, theta)
        if alg.additional_loss is not None:
            loss = loss + alg.additional_loss(phi, theta)
        return loss

    res = train_solve(_SimpleProblem(total_loss, theta0),
                      alg.opt or adam(1e-3), maxiters=maxiters,
                      abstol=abstol, verbose=verbose, generator=generator,
                      seed=seed, inner_steps=inner_steps)

    # the final train set for the solution object
    if isinstance(strategy, GridTraining):
        p_fin, t_fin = p_tr, t_tr
    else:
        cpu = torch.Generator().manual_seed(alg.seed + 1)
        p_fin, t_fin = _stochastic_trainset(cpu, lb.cpu(), ub.cpu(),
                                            alg.number_of_parameters, tspan,
                                            strategy.points)
        p_fin, t_fin = p_fin.to(device), t_fin.to(device)

    interp = make_pino_interp(phi, res.u, _n_out(prob))
    return PINOODESolution(u=interp(p_fin, t_fin), t=t_fin, p=p_fin,
                           interp=interp, original=res)
