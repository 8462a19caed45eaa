"""SDEPINN: weak SDE solve via its Fokker-Planck PDE
(`neuralpde_tpu.solvers.sde_weak`; reference: src/NN_SDE_weaksolve.jl).

Builds ∂t p̂ = -∂x(f p̂) + ½ ∂xx(g² p̂) for the density p̂ in the symbolic
front end and hands it to the `PhysicsInformedNN` pipeline, with reflecting
(zero-flux) or absorbing boundary conditions and a PDF-normalization
additional loss by per-time-slice Gauss-Legendre quadrature (reference:
src/NN_SDE_weaksolve.jl:113-206).  ``f(x, p, t)`` and ``g(x, p, t)`` are
called on symbols here, so they must be plain arithmetic (or the port's
symbolic functions), as they are for `solve_sde` on tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..compile.discretize import PhysicsInformedNN, discretize
from ..compile.lower import depvar_params
from ..config import default_float
from ..ops.distributions import Normal
from ..ops.quadrature import gauss_legendre
from ..strategies import GridTraining
from ..symbolic.expr import (
    DepVar, Deriv, Differential, Eq, Sym, expand_derivatives, substitute, wrap,
)
from ..symbolic.system import Domain, Interval, PDESystem
from ..train import adam, solve as train_solve


@dataclass
class SDEPINN:
    """Fokker-Planck SDE solver config (reference: src/NN_SDE_weaksolve.jl:1-72).

    ``optimalg`` is an optimizer factory (default `adam(1e-3)`)."""

    chain: Any
    x_0: float
    x_end: float
    optimalg: Any = None
    initial_parameters: Any = None
    Nt: int = 20
    dx: float = 0.05
    sigma_var_bc: float = 0.05
    lambda_ic: float = 1.0
    lambda_norm: float = 1.0
    distrib: Any = None          # initial density; default Normal(0.5, 0.01)
    strategy: Any = None
    autodiff: bool = True
    batch: bool = False
    param_estim: bool = False
    dataset: Any = None
    additional_loss: Callable | None = None
    absorbing_bc: bool = False
    reflective_bc: bool = True
    norm_quad_order: int = 24
    seed: int = 0


def fokker_planck_system(prob, alg: SDEPINN) -> PDESystem:
    """The Fokker-Planck PDE of ``prob`` with ``alg``'s boundary conditions
    (reference: src/NN_SDE_weaksolve.jl:113-170)."""
    t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
    u0 = float(prob.u0)
    p = prob.p
    distrib = alg.distrib or Normal(0.5, 0.01)

    X, T = Sym("X"), Sym("T")
    p_hat = DepVar("p_hat")
    Dx = Differential(X)
    Dxx = Differential(X) ** 2
    Dt = Differential(T)

    f_expr = wrap(prob.f(X, p, T))
    g_expr = wrap(prob.g(X, p, T))
    g2 = g_expr * g_expr
    dg2 = expand_derivatives(Deriv(g2, (X,)))

    def J(x_val):
        """Probability flux at x = x_val, product rule applied so that no
        Dx falls on a constant (reference: src/NN_SDE_weaksolve.jl:121-125)."""
        ph = p_hat(x_val, T)
        dph = Deriv(p_hat(x_val, T), (X,))
        sub = {X: wrap(x_val)}
        return (substitute(f_expr, sub) * ph
                - 0.5 * (substitute(g2, sub) * dph
                         + ph * substitute(dg2, sub)))

    eq = Eq(Dt(p_hat(X, T)),
            -Dx(f_expr * p_hat(X, T)) + 0.5 * Dxx(g2 * p_hat(X, T)))
    bcs = [Eq(p_hat(u0, t0), float(np.exp(distrib.logpdf(u0))))]
    if alg.absorbing_bc:
        bcs += [Eq(p_hat(alg.x_0, T), 0.0), Eq(p_hat(alg.x_end, T), 0.0)]
    if alg.reflective_bc:
        bcs += [Eq(J(alg.x_0), 0.0), Eq(J(alg.x_end), 0.0)]
    domains = [Domain(X, Interval(alg.x_0, alg.x_end)),
               Domain(T, Interval(t0, t1))]
    return PDESystem(eq, bcs, domains, [X, T], [p_hat(X, T)])


def normalization_loss(alg: SDEPINN, ts, dtype, device) -> Callable:
    """``λ Σ_t (∫ p̂(x, t) dx - 1)²`` over the time slices ``ts``, one
    batched Gauss-Legendre rule whose nodes and weights stay on ``device``
    (the reference integrates each slice adaptively, :181-194)."""
    gx, gw = gauss_legendre(alg.norm_quad_order)
    half = (alg.x_end - alg.x_0) / 2.0
    xq = torch.as_tensor(alg.x_0 + (gx + 1.0) * half, dtype=dtype,
                         device=device)                       # (Q,)
    wq = torch.as_tensor(gw * half, dtype=dtype, device=device)
    ts_t = torch.as_tensor(ts, dtype=dtype, device=device)
    Q, Tn = xq.shape[0], ts_t.shape[0]
    cord = torch.stack([xq.repeat(Tn), ts_t.repeat_interleave(Q)])
    lam = alg.lambda_norm

    def loss(phi, theta, _p=None):
        params = (depvar_params(theta)
                  if any(k.startswith("depvar.") for k in theta) else theta)
        vals = phi(cord, params)
        integ = torch.sum(vals[0].reshape(Tn, Q) * wq[None, :], dim=1)
        return lam * torch.sum((integ - 1.0) ** 2)

    return loss


def solve_sde_weak(prob, alg: SDEPINN, *, maxiters: int = 200,
                   verbose: bool = False, generator=None, seed: int = 0,
                   inner_steps: int = 1, device=None):
    """Returns ``(SolveResult, phi, pinnrep)`` (reference:
    src/NN_SDE_weaksolve.jl:85-236 returns (res, phi)).  Runs on
    ``device``, ``"cuda"`` unless given."""
    dtype = default_float()
    device = torch.device(device if device is not None else "cuda")
    t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
    dt = (t1 - t0) / alg.Nt
    ts = np.arange(t0, t1 + dt / 2, dt)
    disc = PhysicsInformedNN(
        alg.chain, GridTraining([alg.dx, dt]),
        init_params=alg.initial_parameters,
        additional_loss=normalization_loss(alg, ts, dtype, device),
        seed=alg.seed, device=device)
    tprob = discretize(fokker_planck_system(prob, alg), disc)
    res = train_solve(tprob, alg.optimalg or adam(1e-3), maxiters=maxiters,
                      verbose=verbose, generator=generator, seed=seed,
                      inner_steps=inner_steps)
    return res, disc.phi, tprob.pinnrep
