"""NNSDE: strong/weak SDE PINN via a truncated Karhunen-Loève expansion
(`neuralpde_tpu.solvers.sde`; reference: src/NN_SDE_solve.jl).

The Brownian path is represented by its KL expansion on the rescaled span
[0, 1]: dW ≈ √2 Σ_j z_j cos((j-1/2)πt) with z_j ~ N(0,1); the network input is
(t, z_1..z_n) and the trial function is phi = u0 + (t - t0)·NN(t, z)
(reference: src/NN_SDE_solve.jl:180-204,255-354).  The inputs are one tensor
(1+n_z, T, S) (T time points × S sub-batch samples) evaluated in a single
batched network call, as in the JAX package.

Weak training (default): fresh z per time point, per-time-point `mean` over
samples.  Strong training: fixed z per path, `sum` aggregation
(reference: src/NN_SDE_solve.jl:365-394,830-837).

The user's ``f(u, p, t)`` and ``g(u, p, t)``, written with `torch` for one
point, are batched by `torch.func.vmap`; either may return a number.  The
normal draws come from a `torch.Generator`: the JAX package's
`jax.random` draws cannot be reproduced, so the functions that draw take
their draws as an argument where a test needs to pass the JAX package's
(``inputs=``).  With `StochasticTraining` each step draws its time points
and z from the solve's generator, inside the captured step on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call, jvp, vmap

from ..compile.lower import depvar_params
from ..config import default_float
from ..ops.distributions import Particles
from ..ops.quadrature import composite_gl_unit
from ..strategies import (
    GridTraining, QuadratureTraining, QuasiRandomTraining, StochasticTraining,
    TrainingStrategy, WeightedIntervalTraining, julia_range,
)
from ..train import adam, solve as train_solve
from .ode import _as_vector, _SimpleProblem, initial_theta
from .problems import SDEProblem


class SDEPhi:
    """phi(inp) = u0 + (t - t0)·NN(inp) with inp = (1+n_z, N)
    (reference: src/NN_SDE_solve.jl:180-204); ``u0`` on the device and in
    the dtype of ``like``."""

    def __init__(self, module, t0, u0, like: torch.Tensor | None = None):
        self.module = module
        self.t0 = float(t0)
        self.u0 = torch.as_tensor(
            np.atleast_1d(np.asarray(u0, dtype=np.float64)),
            dtype=default_float() if like is None else like.dtype,
            device=None if like is None else like.device)

    def __call__(self, inp, theta):
        out = functional_call(self.module, depvar_params(theta), (inp,),
                              strict=True)                     # (n_out, N)
        return self.u0[:, None] + (inp[0][None, :] - self.t0) * out


def du_dt(phi: SDEPhi, inp, theta, autodiff: bool):
    """∂phi/∂t at inputs (1+n_z, N) (reference: src/NN_SDE_solve.jl:225-236)."""
    if autodiff:
        tangent = torch.zeros_like(inp)
        tangent[0] = 1.0
        return jvp(lambda x: phi(x, theta), (inp,), (tangent,))[1]
    eps = math.sqrt(torch.finfo(inp.dtype).eps)
    shifted = torch.cat([inp[:1] + eps, inp[1:]])
    return (phi(shifted, theta) - phi(inp, theta)) / eps


def add_rand_coeff(generator, ts, n_z: int, sub_batch: int, dtype):
    """Weak-training inputs: independent z per (time point, sample);
    returns (1+n_z, T, S) on ``ts``'s device (reference:
    src/NN_SDE_solve.jl:365-374)."""
    T = ts.shape[0]
    z = torch.randn((n_z, T, sub_batch), generator=generator, dtype=dtype,
                    device=ts.device)
    t = ts.to(dtype)[None, :, None].expand(1, T, sub_batch)
    return torch.cat([t, z], dim=0)


def add_rand_coeff_2(generator, ts, n_z: int, num_samples: int, dtype):
    """Strong-training inputs: fixed z per path across all time points
    (reference: src/NN_SDE_solve.jl:384-394)."""
    T = ts.shape[0]
    z = torch.randn((n_z, num_samples), generator=generator, dtype=dtype,
                    device=ts.device)
    z = z[:, None, :].expand(n_z, T, num_samples)
    t = ts.to(dtype)[None, :, None].expand(1, T, num_samples)
    return torch.cat([t, z], dim=0)


def _kl_drive(inp, n_z: int):
    """√2 Σ_j z_j cos((j-1/2)π t) at each column; inp (1+n_z, N) -> (N,)."""
    t = inp[0]
    j = torch.arange(1, n_z + 1, dtype=inp.dtype, device=inp.device)[:, None]
    basis = torch.cos((j - 0.5) * math.pi * t[None, :])       # (n_z, N)
    return math.sqrt(2.0) * torch.sum(inp[1:] * basis, dim=0)


def _drift_diffusion(f, g, u, t, p, scalar_u0: bool):
    """f and g at every column: u (n_out, N), t (N,) -> two (n_out, N)."""
    def one(u_col, t_i):
        u_in = u_col[0] if scalar_u0 else u_col
        return (_as_vector(f(u_in, p, t_i), t_i),
                _as_vector(g(u_in, p, t_i), t_i))

    fs, gs = vmap(one, in_dims=(1, 0), out_dims=1)(u, t)
    return fs.expand(u.shape), gs.expand(u.shape)


def _squared_residuals(phi, f, g, autodiff, inputs3, theta, p, param_estim,
                       strong, scalar_u0):
    """Per (output, time point) aggregate of the squared SDE residual:
    (n_out, T)."""
    p_ = theta["p"] if param_estim else p
    d, T, S = inputs3.shape
    inp = inputs3.reshape(d, T * S)
    u = phi(inp, theta)                                       # (n_out, T*S)
    drive = _kl_drive(inp, d - 1)                             # (T*S,)
    fs, gs = _drift_diffusion(f, g, u, inp[0], p_, scalar_u0)
    rhs = fs + gs * drive[None, :]
    dudt = du_dt(phi, inp, theta, autodiff)
    sq = ((rhs - dudt) ** 2).reshape(-1, T, S)
    return torch.sum(sq, dim=2) if strong else torch.mean(sq, dim=2)


def inner_sde_loss(phi: SDEPhi, f, g, autodiff, inputs3, theta, p,
                   param_estim, strong: bool, scalar_u0: bool):
    """inputs3: (1+n_z, T, S).  loss = (1/T) Σ_t Σ_out agg_s(residual²),
    agg = sum (strong) / mean (weak) (reference: src/NN_SDE_solve.jl:299-354)."""
    agg = _squared_residuals(phi, f, g, autodiff, inputs3, theta, p,
                             param_estim, strong, scalar_u0)
    return torch.sum(agg) / inputs3.shape[1]


def quadrature_sde_loss(phi, f, g, autodiff, inputs3, w, theta, p,
                        param_estim, strong, scalar_u0):
    """The `QuadratureTraining` loss: the per-time-point sum of squared
    residuals, squared again and integrated with weights ``w`` over
    [t0, 1].  The square of a sum of squares is the JAX package's
    (`neuralpde_tpu/solvers/sde.py:303`), kept as it is."""
    per_t = torch.sum(_squared_residuals(phi, f, g, autodiff, inputs3, theta,
                                         p, param_estim, strong, scalar_u0),
                      dim=0)                                  # (T,)
    return torch.sum(per_t ** 2 * w)


def _scalar_fg(f, g, p):
    """f and g of a scalar state at a scalar time, as 0-d tensors."""
    def fg(x, t):
        return (_as_vector(f(x, p, t), t).reshape(()),
                _as_vector(g(x, p, t), t).reshape(()))
    return fg


def generate_em_l2_loss(dataset, f, g, dtype, device=None):
    """Euler-Maruyama increment moment matching
    (reference: src/NN_SDE_solve.jl:464-496)."""
    xs = torch.as_tensor(np.stack(dataset[0]), dtype=dtype,
                         device=device)                       # (n_obs, T)
    ts = torch.as_tensor(np.asarray(dataset[1]), dtype=dtype, device=device)
    dts = ts[1:] - ts[:-1]
    x_inc = xs[:, 1:] - xs[:, :-1]                            # (n_obs, T-1)
    shape = x_inc.shape

    def loss(theta, generator=None):
        fx, gx = vmap(vmap(_scalar_fg(f, g, theta["p"]), in_dims=(0, 0)),
                      in_dims=(0, None))(xs[:, :-1], ts[:-1])
        fdt = fx.expand(shape) * dts[None, :]
        gdt = gx.expand(shape) ** 2 * dts[None, :]
        return (torch.sum((x_inc - fdt) ** 2)
                + torch.sum(((x_inc - fdt) ** 2 - gdt) ** 2))

    return loss


def generate_data_moments_loss(dataset, n_z, phi, f, g, autodiff, p,
                               param_estim, data_sub_batch, strong, scalar_u0,
                               dtype, seed=0, *, inputs=None, device=None):
    """Mean/variance matching of the SDEPINN against strong observations
    (reference: src/NN_SDE_solve.jl:403-449).  ``inputs`` (1+n_z, T, S)
    are the draws the loss is built on; without them they are drawn from a
    CPU generator seeded with ``seed``."""
    process = torch.as_tensor(np.stack(dataset[0]), dtype=dtype,
                              device=device).T                # (T, n_obs)
    ts = torch.as_tensor(np.asarray(dataset[1]), dtype=dtype)
    if inputs is None:
        mk = add_rand_coeff_2 if strong else add_rand_coeff
        inputs = mk(torch.Generator().manual_seed(seed), ts, n_z,
                    data_sub_batch, dtype)
    inputs3 = torch.as_tensor(inputs, dtype=dtype).to(device)
    d, T, S = inputs3.shape
    inp = inputs3.reshape(d, T * S)
    data_mean = torch.mean(process, dim=1)
    data_var = torch.sum((process - data_mean[:, None]) ** 2, dim=1)
    var_scale = T * max(data_sub_batch - 1, 1) ** 2

    def loss(theta, generator=None):
        u = phi(inp, theta)[0].reshape(T, S)
        pred_mean = torch.mean(u, dim=1)
        mean_term = torch.sum((data_mean - pred_mean) ** 2) / T
        phys = inner_sde_loss(phi, f, g, autodiff, inputs3, theta, p,
                              param_estim, strong, scalar_u0) ** 2
        pred_var = torch.sum((u - pred_mean[:, None]) ** 2, dim=1)
        var_term = torch.sum((data_var - pred_var) ** 2) / var_scale
        return mean_term + phys + var_term

    return loss


@dataclass
class NNSDE:
    """SDE PINN algorithm config (reference: src/NN_SDE_solve.jl:131-160).

    ``opt`` is an optimizer factory (default `adam(1e-3)`); ``init_params``
    the chain's parameters under its own names, else drawn from a generator
    seeded with ``seed``."""

    chain: Any
    opt: Any = None
    init_params: Any = None
    strategy: TrainingStrategy | None = None
    autodiff: bool = False
    batch: bool = True
    sub_batch: int = 1
    strong_loss: bool = False
    moment_loss: bool = False
    param_estim: bool = False
    dataset: Any = None
    data_sub_batch: int = 1
    numensemble: int = 10
    additional_loss: Callable | None = None
    seed: int = 0


@dataclass
class SDEsol:
    """(reference: src/NN_SDE_solve.jl:757-768)"""

    original: Any
    estimated_sol: list        # per-output list of Particles over time points
    timepoints: Any
    estimated_params: Any
    ensemble_fits: Any
    ensemble_inputs: Any
    numensemble: int
    training_sets: Any
    interp: Callable

    def __call__(self, inp):
        return self.interp(inp)


def _cpu_draw(seed: int, ts: np.ndarray, n_z: int, sub_batch: int, strong,
              dtype, device):
    """Inputs drawn once from a CPU generator seeded with ``seed`` (the same
    values on every device), then moved to ``device``."""
    mk = add_rand_coeff_2 if strong else add_rand_coeff
    return mk(torch.Generator().manual_seed(seed),
              torch.as_tensor(ts, dtype=dtype), n_z, sub_batch,
              dtype).to(device)


def build_sde_loss(prob: SDEProblem, alg: NNSDE, *, dt=None, tstops=None,
                   device=None):
    """The NNSDE objective of `solve_sde`: ``(total_loss(theta, generator),
    theta0, phi, training_sets)`` on ``device`` (default ``"cuda"``), with
    ``dt`` already rescaled to the span [t0/t_end, 1]."""
    dtype = default_float()
    device = torch.device(device if device is not None else "cuda")
    # tspan rescaled to [t0/t_end, 1] so the KL expansion applies
    # (reference: src/NN_SDE_solve.jl:786-791)
    t_end = float(prob.tspan[1])
    t0 = float(prob.tspan[0]) / t_end

    n_z = alg.chain.in_dim - 1
    scalar_u0 = np.ndim(prob.u0) == 0
    theta0 = initial_theta(prob, alg, dtype, device)
    phi = SDEPhi(alg.chain, t0, prob.u0,
                 like=next(iter(depvar_params(theta0).values())))
    p_fixed = (None if prob.p is None else torch.as_tensor(
        np.asarray(prob.p), dtype=dtype, device=device))

    strategy = alg.strategy
    if strategy is None:
        strategy = GridTraining(dt) if dt is not None else QuadratureTraining()
    strong = alg.strong_loss
    mk = add_rand_coeff_2 if strong else add_rand_coeff
    args = (prob.f, prob.g, alg.autodiff)
    rest = (p_fixed, alg.param_estim, strong, scalar_u0)
    training_sets = None

    def fixed_sets(ts):
        return _cpu_draw(alg.seed + 17, ts, n_z, alg.sub_batch, strong, dtype,
                         device)

    if isinstance(strategy, (GridTraining, WeightedIntervalTraining)):
        if isinstance(strategy, GridTraining):
            ts = julia_range(t0, 1.0, strategy.dx)
            n_orig = len(ts)
        else:
            ts = strategy.sample_times(t0, 1.0)
            n_orig = strategy.points
        training_sets = fixed_sets(ts)

        def inner_f(theta, generator):
            return inner_sde_loss(phi, *args, training_sets, theta, *rest)
    elif isinstance(strategy, StochasticTraining):
        n = strategy.points

        def inner_f(theta, generator):
            ts = t0 + (1.0 - t0) * torch.rand(
                (n,), generator=generator, dtype=dtype, device=device)
            inputs3 = mk(generator, ts, n_z, alg.sub_batch, dtype)
            return inner_sde_loss(phi, *args, inputs3, theta, *rest)
        n_orig = n
    elif isinstance(strategy, QuadratureTraining):
        # static panels: the loss is stochastic in the KL coefficients, so
        # successive-rule agreement is not defined; the panel count is pinned
        nodes, weights = composite_gl_unit(strategy.order,
                                           strategy.static_panels)
        training_sets = fixed_sets(t0 + (1.0 - t0) * nodes)
        w = torch.as_tensor(weights * (1.0 - t0), dtype=dtype, device=device)

        def inner_f(theta, generator):
            return quadrature_sde_loss(phi, *args, training_sets, w, theta,
                                       *rest)
        n_orig = None
    elif isinstance(strategy, QuasiRandomTraining):
        raise ValueError(
            "QuasiRandomTraining is not supported by NNSDE since it's for "
            "high dimensional spaces only. Use StochasticTraining instead.")
    else:
        raise TypeError(f"unsupported strategy {type(strategy).__name__}")

    dataset = alg.dataset or []
    if not dataset and alg.param_estim and alg.additional_loss is None:
        raise ValueError(
            "Dataset or an additional loss is required for Inverse problems "
            "performing Parameter Estimation.")
    em_loss = moments_loss = None
    if dataset:
        if len(dataset) < 2:
            raise ValueError(
                "Invalid dataset. Expected (x̂, t) with x̂ a list of "
                "observation series")
        em_loss = generate_em_l2_loss(dataset, prob.f, prob.g, dtype, device)
        if alg.moment_loss:
            dsb = max(alg.data_sub_batch, len(dataset[0]))
            moments_loss = generate_data_moments_loss(
                dataset, n_z, phi, prob.f, prob.g, alg.autodiff, p_fixed,
                alg.param_estim, dsb, strong, scalar_u0, dtype, alg.seed,
                device=device)

    tstops_inputs = None
    if tstops is not None:
        # extra time points blended into the physics loss, as NNODE's
        # (the reference's helper references an undefined `ts`)
        tstops_inputs = _cpu_draw(
            alg.seed + 29, np.asarray(tstops, dtype=np.float64) / t_end, n_z,
            alg.sub_batch, strong, dtype, device)

    def total_loss(theta, generator):
        loss = inner_f(theta, generator)
        if tstops_inputs is not None:
            ts_loss = inner_sde_loss(phi, *args, tstops_inputs, theta, *rest)
            n_ts = tstops_inputs.shape[1]
            if n_orig is not None:
                loss = (loss * n_orig + ts_loss * n_ts) / (n_orig + n_ts)
            else:
                loss = loss + ts_loss
        if alg.additional_loss is not None:
            loss = loss + alg.additional_loss(phi, theta)
        if alg.param_estim and em_loss is not None:
            loss = loss + em_loss(theta)
        if alg.param_estim and moments_loss is not None:
            loss = loss + moments_loss(theta)
        return loss

    return total_loss, theta0, phi, training_sets


def solve_sde(prob: SDEProblem, alg: NNSDE, *, dt=None, abstol: float = 1e-6,
              verbose: bool = False, saveat=None, maxiters: int = 1000,
              tstops=None, save_everystep: bool = True, generator=None,
              seed: int = 0, inner_steps: int = 1, device=None) -> SDEsol:
    """`solve(SDEProblem, NNSDE(...))` (reference: src/NN_SDE_solve.jl:770-955).

    Runs on ``device``, ``"cuda"`` unless given; trains through
    `train.solve` (a captured CUDA graph of the step on the card), whose
    ``generator``/``seed`` feed `StochasticTraining`'s draws."""
    dtype = default_float()
    device = torch.device(device if device is not None else "cuda")
    t_end = float(prob.tspan[1])
    t0 = float(prob.tspan[0]) / t_end
    if dt is not None:
        # mirror the reference's rescale (src/NN_SDE_solve.jl:788-790)
        dt = dt / abs(1.0 - t0)
    total_loss, theta0, phi, training_sets = build_sde_loss(
        prob, alg, dt=dt, tstops=tstops, device=device)
    n_z = alg.chain.in_dim - 1
    res = train_solve(_SimpleProblem(total_loss, theta0),
                      alg.opt or adam(1e-3), maxiters=maxiters, abstol=abstol,
                      verbose=verbose, generator=generator, seed=seed,
                      inner_steps=inner_steps)

    # --- ensemble weak solution over saveat (rescaled) time points ---------
    if isinstance(saveat, (int, float)):
        ts_out = julia_range(t0, 1.0, float(saveat) / t_end)
    elif saveat is not None:
        ts_out = np.asarray(saveat) / t_end
    elif dt is not None:
        ts_out = julia_range(t0, 1.0, float(dt))
    elif save_everystep:
        ts_out = np.linspace(t0, 1.0, 100)
    else:
        ts_out = np.array([t0, 1.0])
    val_inputs = _cpu_draw(alg.seed + 23, ts_out, n_z, alg.numensemble, False,
                           dtype, device)
    d, T, S = val_inputs.shape
    with torch.no_grad():
        u_val = phi(val_inputs.reshape(d, T * S), res.u).reshape(-1, T, S)
    estimated_sol = [[Particles(u_val[j, i, :]) for i in range(T)]
                     for j in range(u_val.shape[0])]
    est_params = res.u["p"].tolist() if alg.param_estim else None

    def interp(inp):
        with torch.no_grad():
            return phi(torch.as_tensor(inp, dtype=dtype, device=device), res.u)

    return SDEsol(original=res, estimated_sol=estimated_sol,
                  timepoints=np.asarray(ts_out) * t_end,
                  estimated_params=est_params, ensemble_fits=u_val,
                  ensemble_inputs=val_inputs, numensemble=alg.numensemble,
                  training_sets=training_sets, interp=interp)
