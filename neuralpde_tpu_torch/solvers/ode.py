"""NNODE: Lagaris-style ODE PINN solver (`neuralpde_tpu.solvers.ode`;
reference: src/ode_solve.jl).

The trial function hard-enforces the initial condition:
``phi(t) = u0 + (t - t0) * NN(t)`` (reference: src/ode_solve.jl:123-159).
All strategy losses are functions ``(theta, generator) -> scalar`` evaluated
batched over the whole time grid: the user's ``f(u, p, t)``, written with
`torch` for one time point, is batched by `torch.func.vmap` instead of the
reference's per-point comprehension (src/ode_solve.jl:195-197).

``theta`` is the port's flat parameter dict: the chain's parameters under
``"depvar."`` and, with ``param_estim``, the ODE's parameters as ``"p"``.
`solve_ode` trains through `train.solve`, so on the card its steps replay a
captured CUDA graph; everything a loss reads (time grids, quadrature rules,
datasets, the fixed ``p``) is put on the device when the loss is built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call, jvp, vmap

from ..compile.lower import depvar_params
from ..config import default_float
from ..ops.quadrature import composite_gl_unit
from ..strategies import (
    GridTraining, QuadratureTraining, QuasiRandomTraining, StochasticTraining,
    TrainingStrategy, WeightedIntervalTraining, julia_range,
)
from ..train import adam, solve as train_solve
from .problems import ODEProblem, ODESolution, compute_ode_errors


class ODEPhi:
    """phi(t) = u0 + (t - t0) * NN(t) (reference: src/ode_solve.jl:123-159).

    ``u0`` takes the device of ``like`` (a parameter) and, unless it is
    complex, its dtype."""

    def __init__(self, module, t0, u0, like: torch.Tensor | None = None):
        self.module = module
        self.t0 = float(t0)
        u0_arr = np.atleast_1d(np.asarray(u0))
        dtype = None if np.iscomplexobj(u0_arr) else (
            like.dtype.to_real() if like is not None else default_float())
        self.u0 = torch.as_tensor(u0_arr, dtype=dtype,
                                  device=None if like is None else like.device)
        self.scalar_u0 = np.ndim(u0) == 0

    def __call__(self, t, theta):
        """t scalar or (N,); returns (n_out,) or (n_out, N).  ``t`` takes the
        parameters' device and (real) dtype."""
        params = depvar_params(theta)
        like = next(iter(params.values()))
        t = torch.as_tensor(t)
        t_arr = torch.atleast_1d(t).to(device=like.device,
                                       dtype=like.dtype.to_real())
        out = functional_call(self.module, params,
                              (t_arr[None, :].to(like.dtype),),
                              strict=True)                      # (n_out, N)
        val = self.u0[:, None] + (t_arr[None, :] - self.t0) * out
        if t.ndim == 0:
            return val[:, 0]
        return val


def ode_dfdx(phi: ODEPhi, ts, theta, autodiff: bool):
    """du/dt via forward-mode AD or forward difference
    (reference: src/ode_solve.jl:168-175)."""
    if autodiff:
        return jvp(lambda t: phi(t, theta), (ts,), (torch.ones_like(ts),))[1]
    eps = float(torch.finfo(ts.dtype).eps) ** 0.5
    return (phi(ts + eps, theta) - phi(ts, theta)) / eps


def _abs2(z):
    """|z|², a real tensor — correct for complex residuals (reference uses
    abs2 throughout; NNODE allows complex u, src/ode_solve.jl:363)."""
    return (z * z.conj()).real if z.is_complex() else z * z


def _as_vector(out, like: torch.Tensor) -> torch.Tensor:
    """What a user's ``f`` returned for one time point — a tensor, a
    number, or a list of either — as a 1-D tensor.  A number is filled in
    on ``like``'s device (no copy from the host, so a step that makes one
    can be captured as a CUDA graph)."""
    def tensor(o):
        return o if isinstance(o, torch.Tensor) else torch.full(
            (), o, dtype=None if isinstance(o, complex) else like.dtype,
            device=like.device)

    if isinstance(out, (list, tuple)):
        out = torch.stack([tensor(o).reshape(()) for o in out])
    return torch.atleast_1d(tensor(out))


def _batched_f(f):
    """``f(u, p, t)`` over time: u (n, N), p shared, t (N,) -> (n_out, N)."""
    return vmap(lambda u, p, t: _as_vector(f(u, p, t), t),
                in_dims=(1, None, 0), out_dims=1)


def _problem_p(p, dtype, device):
    """The problem's fixed parameters on the device (None stays None)."""
    if p is None:
        return None
    return torch.as_tensor(np.asarray(p), dtype=dtype, device=device)


def inner_loss(phi, f, autodiff, ts, theta, p, param_estim, scalar_u0):
    """Batched residual MSE at time points ts
    (reference: src/ode_solve.jl:189-201)."""
    p_ = theta["p"] if param_estim else p
    out = phi(ts, theta)  # (n, N)
    u_in = out[0] if scalar_u0 else out
    fs = _batched_f(f)(torch.atleast_2d(u_in), p_, ts)
    dxdt = ode_dfdx(phi, ts, theta, autodiff)
    return torch.sum(_abs2(fs - dxdt)) / ts.shape[0]


@dataclass
class NNODE:
    """Neural ODE-PINN algorithm config (reference: src/ode_solve.jl:91-115).

    * chain: a Module with 1-D input
    * opt: optimizer factory (default `adam(1e-3)`)
    * init_params: the chain's parameters under its own names
      (``"layer_0.weight"``, as `params_from_jax` gives them), else drawn
      from a generator seeded with ``seed``
    * strategy: TrainingStrategy or None (None -> GridTraining(dt) if dt
      given, else QuadratureTraining)
    * autodiff: forward-mode AD for du/dt (vs forward difference)
    * batch: kept for API parity; evaluation is always batched via vmap
    * dataset: [u_1.., t, W] nested list for inverse problems
    * estim_collocate: add the Data Quadrature loss
    """

    chain: Any
    opt: Any = None
    init_params: Any = None
    strategy: TrainingStrategy | None = None
    autodiff: bool = False
    batch: bool = True
    param_estim: bool = False
    additional_loss: Callable | None = None
    dataset: Any = None
    estim_collocate: bool = False
    seed: int = 0


def initial_theta(prob, alg, dtype, device) -> dict:
    """The flat initial parameters of an NNODE/NNDAE run on ``device``:
    the chain's (given, or drawn on the CPU from ``alg.seed`` so that a seed
    gives the same values on every device) under ``"depvar."``, real float
    leaves in ``dtype``, and ``"p"`` with ``param_estim``.  The chain's
    constant tensors are made there too (`Module.prepare`)."""
    alg.chain.prepare(dtype, device)
    if alg.init_params is None:
        generator = torch.Generator().manual_seed(alg.seed)
        alg.chain.reset_parameters(generator)
        params = {k: v.detach().clone()
                  for k, v in alg.chain.named_parameters()}
    else:
        params = alg.init_params
    theta0 = {}
    for k, v in params.items():
        v = torch.as_tensor(v).detach()
        theta0[f"depvar.{k}"] = v.to(
            device=device, dtype=dtype if v.is_floating_point() else v.dtype)
    if getattr(alg, "param_estim", False):
        theta0["p"] = _problem_p(prob.p, dtype, device)
    return theta0


def make_phi(prob, alg, theta0) -> ODEPhi:
    return ODEPhi(alg.chain, prob.tspan[0], prob.u0,
                  like=next(iter(depvar_params(theta0).values())))


def generate_l2_loss_data(dataset, phi, n_output, dtype=None, device=None):
    """Data L2 loss for inverse problems (reference: src/ode_solve.jl:300-309)."""
    if not dataset:
        return None
    t = torch.as_tensor(np.asarray(dataset[-2]), dtype=dtype, device=device)
    us = [torch.as_tensor(np.asarray(dataset[i]), dtype=dtype, device=device)
          for i in range(n_output)]

    def loss(theta, generator=None):
        pred = phi(t, theta)
        return sum(torch.sum(_abs2(pred[i] - us[i])) for i in range(n_output))

    return loss


def generate_l2_loss_collocate(f, autodiff, dataset, phi, n_output, scalar_u0,
                               dtype=None, device=None):
    """Data Quadrature loss (reference: src/ode_solve.jl:314-342)."""
    if not dataset:
        return None
    t = torch.as_tensor(np.asarray(dataset[-2]), dtype=dtype, device=device)
    w = torch.as_tensor(np.asarray(dataset[-1]), dtype=dtype, device=device)
    us = torch.stack([torch.as_tensor(np.asarray(dataset[i]), dtype=dtype,
                                      device=device)
                      for i in range(n_output)])  # (n, N)

    def loss(theta, generator=None):
        dxdt = ode_dfdx(phi, t, theta, autodiff)
        u_in = us[0] if scalar_u0 else us
        fs = _batched_f(f)(torch.atleast_2d(u_in), theta["p"], t)
        return torch.sum(_abs2(dxdt - fs) * w[None, :])

    return loss


def _strategy_loss(strategy, phi, f, autodiff, tspan, p, param_estim, scalar_u0,
                   dtype, device, theta0=None):
    t0, t1 = float(tspan[0]), float(tspan[1])

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if isinstance(strategy, GridTraining):
        ts = tensor(julia_range(t0, t1, strategy.dx))
        return lambda theta, generator: inner_loss(
            phi, f, autodiff, ts, theta, p, param_estim, scalar_u0)

    if isinstance(strategy, StochasticTraining):
        n = strategy.points
        lb, ub = tensor([t0]), tensor([t1])

        def loss(theta, generator):
            ts = strategy.sampler(n, lb, ub, generator)[0]
            return inner_loss(phi, f, autodiff, ts, theta, p, param_estim, scalar_u0)

        return loss

    if isinstance(strategy, WeightedIntervalTraining):
        ts = tensor(strategy.sample_times(t0, t1))
        return lambda theta, generator: inner_loss(
            phi, f, autodiff, ts, theta, p, param_estim, scalar_u0)

    if isinstance(strategy, QuadratureTraining):
        def rule(panels):
            nodes, weights = composite_gl_unit(strategy.order, panels)
            return (tensor(t0 + (t1 - t0) * nodes),
                    tensor(weights * (t1 - t0)))

        def make_loss(ts, w):
            def loss(theta, generator=None):
                p_ = theta["p"] if param_estim else p
                out = phi(ts, theta)
                u_in = out[0] if scalar_u0 else out
                fs = _batched_f(f)(torch.atleast_2d(u_in), p_, ts)
                dxdt = ode_dfdx(phi, ts, theta, autodiff)
                pointwise = torch.sum(_abs2(fs - dxdt), dim=0)  # |residual|²/t
                # reference integrates abs2(inner_loss) (src/ode_solve.jl:212-216)
                return torch.sum(pointwise**2 * w)

            return loss

        # static auto-refinement honoring reltol/abstol/maxiters (the
        # reference's QuadGKJL h-adaptive semantics, when the loss is built)
        integral_at = None
        if theta0 is not None and strategy.panels is None:
            def integral_at(panels):
                with torch.no_grad():
                    return float(make_loss(*rule(panels))(theta0))

        panels = strategy.resolve_panels(integral_at, dim=1)
        return make_loss(*rule(panels))

    if isinstance(strategy, QuasiRandomTraining):
        raise ValueError(
            "QuasiRandomTraining is not supported by NNODE since it's for high "
            "dimensional spaces only. Use StochasticTraining instead."
        )
    raise TypeError(f"unsupported strategy {type(strategy).__name__}")


class _SimpleProblem:
    """A bare ``(loss, init_params)`` problem for `train.solve`: no
    `PINNRepresentation`, so it trains on its parameters' device, under
    ``matmul_precision`` (None: TF32 off)."""

    def __init__(self, loss, init_params, matmul_precision=None,
                 mesh_shares=False):
        self._loss = loss
        self.init_params = init_params
        self.pinnrep = None
        self.matmul_precision = matmul_precision
        self.mesh_shares = mesh_shares

    def loss(self, theta, lstate):
        return self._loss(theta, lstate["generator"]), {}


def build_ode_loss(prob: ODEProblem, alg: NNODE, *, dt=None, tstops=None,
                   device=None):
    """The NNODE objective of `solve_ode`: ``(total_loss(theta, generator),
    theta0, phi)`` on ``device`` (default ``"cuda"``)."""
    dtype = default_float()
    device = torch.device(device if device is not None else "cuda")
    t0 = float(prob.tspan[0])
    scalar_u0 = np.ndim(prob.u0) == 0
    n_output = 1 if scalar_u0 else int(np.prod(np.shape(prob.u0)))
    dataset = alg.dataset or []

    if alg.param_estim and prob.p is None and not dataset:
        raise ValueError("param_estim requires prob.p initial values")
    theta0 = initial_theta(prob, alg, dtype, device)
    phi = make_phi(prob, alg, theta0)
    p_fixed = _problem_p(prob.p, dtype, device)

    strategy = alg.strategy
    if strategy is None:
        strategy = GridTraining(dt) if dt is not None else QuadratureTraining()
    if isinstance(strategy, GridTraining) and strategy.dx is None:
        raise ValueError("GridTraining requires dx (or pass dt to solve)")

    if dataset:
        if len(dataset) < 3:
            raise ValueError(
                "Invalid dataset. Expected [x̂_1, ..., t, W] "
                "(reference: src/ode_solve.jl:417-419)")
    if not dataset and alg.param_estim and alg.additional_loss is None:
        raise ValueError(
            "Dataset or an additional loss is required for inverse problems "
            "performing parameter estimation")
    if not dataset and alg.estim_collocate:
        raise ValueError(
            "Dataset is required for parameter estimation with the Data "
            "Quadrature loss")

    inner_f = _strategy_loss(strategy, phi, prob.f, alg.autodiff, prob.tspan,
                             p_fixed, alg.param_estim, scalar_u0, dtype,
                             device, theta0=theta0)
    l2_data = generate_l2_loss_data(dataset, phi, n_output, dtype, device)
    l2_coll = generate_l2_loss_collocate(prob.f, alg.autodiff, dataset, phi,
                                         n_output, scalar_u0, dtype, device)

    tstops_arr = None if tstops is None else torch.as_tensor(
        np.asarray(tstops), dtype=dtype, device=device)

    def total_loss(theta, generator):
        loss = inner_f(theta, generator)
        if alg.param_estim and alg.estim_collocate:
            loss = loss + l2_data(theta) + l2_coll(theta)
        elif alg.param_estim and dataset:
            loss = loss + l2_data(theta)
        if alg.additional_loss is not None:
            loss = loss + alg.additional_loss(phi, theta)
        if tstops_arr is not None:
            ts_loss = inner_loss(phi, prob.f, alg.autodiff, tstops_arr, theta,
                                 p_fixed, alg.param_estim, scalar_u0)
            n_ts = tstops_arr.shape[0]
            if isinstance(strategy, GridTraining):
                n_orig = len(julia_range(t0, float(prob.tspan[1]), strategy.dx))
            elif isinstance(strategy, (StochasticTraining, WeightedIntervalTraining)):
                n_orig = strategy.points
            else:
                return loss + ts_loss
            loss = (loss * n_orig + ts_loss * n_ts) / (n_orig + n_ts)
        return loss

    return total_loss, theta0, phi


def solve_ode(prob: ODEProblem, alg: NNODE, *, dt=None, abstol: float = 1e-6,
              reltol: float = 1e-3, verbose: bool = False, saveat=None,
              maxiters: int = 1000, tstops=None, save_everystep: bool = True,
              callback=None, generator=None, seed: int = 0,
              inner_steps: int = 1, device=None) -> ODESolution:
    """`solve(ODEProblem, NNODE(...))` (reference: src/ode_solve.jl:365-514).

    Runs on ``device``, ``"cuda"`` unless given (``device="cpu"`` for the
    CPU; without a card the default fails with torch's own error).
    ``generator``/``seed`` feed `StochasticTraining`'s draws."""
    del reltol
    total_loss, theta0, phi = build_ode_loss(prob, alg, dt=dt, tstops=tstops,
                                             device=device)
    res = train_solve(_SimpleProblem(total_loss, theta0),
                      alg.opt or adam(1e-3), maxiters=maxiters, abstol=abstol,
                      verbose=verbose, callback=callback, generator=generator,
                      seed=seed, inner_steps=inner_steps)
    return build_ode_solution(prob, phi, res, dt=dt, saveat=saveat,
                              save_everystep=save_everystep)


def save_times(tspan, dt=None, saveat=None, save_everystep: bool = True):
    """The time points of a dense solution (reference:
    src/ode_solve.jl:484-500)."""
    t0, t1 = float(tspan[0]), float(tspan[1])
    if isinstance(saveat, (int, float)):
        return julia_range(t0, t1, float(saveat))
    if saveat is not None:
        return np.asarray(saveat, dtype=np.float64)
    if dt is not None:
        return julia_range(t0, t1, float(dt))
    if save_everystep:
        return np.linspace(t0, t1, 100)
    return np.array([t0, t1])


def build_ode_solution(prob, phi: ODEPhi, res, *, dt=None, saveat=None,
                       save_everystep: bool = True,
                       scalar: bool | None = None) -> ODESolution:
    """Dense `ODESolution` from trained parameters ``res.u`` (the save-point
    + interpolation tail of `solve_ode`; reference: src/ode_solve.jl:484-513).
    Shared by the Adam/L-BFGS path, `solve_ode_gauss_newton` and NNDAE
    (``scalar=False``: a DAE's u is always a vector).  Saved values and
    errors are numpy; ``sol(t)`` gives a tensor on the parameters' device."""
    u0 = prob.u0
    scalar_u0 = (np.ndim(u0) == 0) if scalar is None else scalar
    ts = save_times(prob.tspan, dt, saveat, save_everystep)
    with torch.no_grad():
        us = phi(ts, res.u).cpu().numpy().T  # (N, n_out)
    if scalar_u0:
        us = us[:, 0]

    def interp(t):
        with torch.no_grad():
            out = phi(t, res.u)
        return out[0] if scalar_u0 else out

    errors = {}
    if prob.analytic is not None:
        exact = np.stack([np.atleast_1d(np.asarray(prob.analytic(u0, prob.p, t)))
                          for t in ts])  # (N, n_out)
        pred = us[:, None] if us.ndim == 1 else us
        errors = compute_ode_errors(pred, exact)

    return ODESolution(ts=ts, us=us, interp=interp, original=res,
                       retcode="Success", errors=errors, k=res)
