"""Deep Ritz method — variational (energy-minimization) training
(`neuralpde_tpu.solvers.ritz`; beyond the reference).

For PDEs with a variational principle, minimize the energy functional
directly

    E[u] = |Ω| · mean_Ω e(x, u, ∇u)  +  Σ_i β·mean r_bc_i²

with ``e`` any symbolic expression of the dependent variables and their
derivatives (E & Yu 2018, "The Deep Ritz method").  The energy form needs
one derivative order less than the strong form (½|∇u|² vs Δu), so it
tolerates rougher solutions and cheaper trial functions; its minimizer is
the weak solution.

Built on the existing pipeline: the energy integrand is lowered by the
same recursive evaluator as every residual (`compile.lower`), the boundary
terms are ordinary penalized BC losses, and the result is a standard
`TrainingProblem`, so `solve` (its captured CUDA graph on the card) and
checkpointing work unchanged.  Energy collocation uses the strategy's
nodes: static grids (`GridTraining`) evaluate a deterministic uniform-mean
estimate; `StochasticTraining` draws fresh uniform points each step from
the step's one `torch.Generator` (Monte-Carlo energy, the paper's setting):
first the energy's points, then each boundary energy's, then each boundary
condition's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compile.discretize import (
    PhysicsInformedNN, PINNLossFunctions, TrainingProblem, symbolic_discretize,
)
from ..compile.lower import (
    LoweringContext, build_residual_function, get_argument,
)
from ..parallel.mesh import share, shard_batch
from ..strategies import GridTraining, StochasticTraining, generate_training_sets
from ..symbolic.expr import Eq, Expr, Sym
from ..symbolic.system import PDESystem, infimum, supremum


class DeepRitz:
    """Deep Ritz algorithm config.

    * chain: trial-function Module (or list for multioutput systems)
    * energy: symbolic energy density e(x, u, ∇u, …) — an `Expr`
    * boundary_energies: iterable of boundary-integral energy densities —
      Exprs whose dependent-variable calls pin one (or more) coordinates to
      a boundary value, e.g. ``0.5*alpha*u(1.0, y)**2 - g(y)*u(1.0, y)``
      for a Robin condition ``∂u/∂n + alpha·u = g`` on the face x=1.  Each
      contributes ``|Γ|·mean(e_b)`` over its face; Robin and inhomogeneous
      natural (Neumann) conditions then emerge from energy minimization
      with NO boundary equation and no penalty weight to tune (E & Yu 2018
      §2.3; the natural-BC generalization).
    * strategy: GridTraining (deterministic mean) or StochasticTraining
      (fresh uniform Monte-Carlo points per step); default
      StochasticTraining(4096)
    * bc_weight: penalty weight β on every (essential/Dirichlet) boundary
      loss that remains as an equation
    * kwargs forwarded to PhysicsInformedNN (dtype, device, seed,
      derivative, ...)
    """

    def __init__(self, chain, energy: Expr, *, boundary_energies=(),
                 strategy=None, bc_weight: float = 500.0, **kwargs):
        if not isinstance(energy, Expr):
            raise TypeError("energy must be a symbolic Expr")
        self.boundary_energies = tuple(boundary_energies)
        for b in self.boundary_energies:
            if not isinstance(b, Expr):
                raise TypeError("boundary_energies must be symbolic Exprs")
        if kwargs.get("adaptive_loss") is not None:
            raise ValueError(
                "DeepRitz does not support adaptive_loss: the Ritz objective "
                "owns its weighting (the energy term is unweighted and every "
                "boundary loss gets the fixed bc_weight penalty)")
        self.chain = chain
        self.energy = energy
        self.strategy = strategy or StochasticTraining(4096)
        self.bc_weight = float(bc_weight)
        self.kwargs = kwargs


def discretize_ritz(pde_system: PDESystem, alg: DeepRitz) -> TrainingProblem:
    """PDESystem (its ``eqs`` are ignored — the energy replaces them) +
    DeepRitz -> TrainingProblem minimizing ``|Ω|·mean e + β·Σ mean r_bc²``."""
    if not isinstance(alg.strategy, (GridTraining, StochasticTraining)):
        raise TypeError("DeepRitz supports GridTraining or StochasticTraining "
                        f"energy collocation; got {type(alg.strategy).__name__}")

    bc_system = PDESystem([], pde_system.bcs, pde_system.domains,
                          pde_system.ivs, pde_system.dvs, ps=pde_system.ps,
                          defaults=pde_system.defaults)
    n_bc = len(pde_system.bcs)
    # unit adaptive weights: the Ritz loss owns the bc_weight scaling itself
    # (a weighted NonAdaptiveLoss here would double-count if ever composed)
    disc = PhysicsInformedNN(alg.chain, alg.strategy, **alg.kwargs)
    pinnrep = symbolic_discretize(bc_system, disc)
    bc_loss_fns = pinnrep.loss_functions.bc_loss_functions
    dtype, device = pinnrep.dtype, pinnrep.device

    # --- energy terms: lower with the same machinery as any residual ------
    ctx = LoweringContext.from_pinnrep(pinnrep)

    spans = {d.variables.name: (float(infimum(d.domain)),
                                float(supremum(d.domain)))
             for d in pde_system.domains}

    def make_energy_term(expr: Expr):
        """``|domain of free syms| · mean(e)``; boundary terms pin
        coordinates inside their depvar calls, so their free-sym measure is
        the FACE measure |Γ| (a fully pinned face is a point, measure 1).
        Nodes and sampling bounds are device tensors made here."""
        energy_eq = Eq(expr, 0.0)
        args = get_argument(energy_eq, pinnrep.depvars)
        syms = [a for a in args if isinstance(a, Sym)]
        layout = [a if isinstance(a, Sym) else None for a in args]
        e_fn = build_residual_function(energy_eq, layout, ctx,
                                       pinnrep.default_p)
        for s in syms:
            if s.name not in spans:
                raise ValueError(f"energy variable {s.name!r} has no domain")
        volume = float(np.prod([spans[s.name][1] - spans[s.name][0]
                                for s in syms])) if syms else 1.0

        if isinstance(alg.strategy, GridTraining):
            nodes = generate_training_sets(pde_system.domains,
                                           alg.strategy.dx, [args], dtype,
                                           device)[0]

            def term(theta, generator=None):
                del generator
                return volume * share(torch.mean(e_fn(shard_batch(nodes),
                                                      theta)))
        else:
            lo = [spans[a.name][0] if isinstance(a, Sym) else float(a)
                  for a in args]
            hi = [spans[a.name][1] if isinstance(a, Sym) else float(a)
                  for a in args]
            lb = torch.as_tensor(lo, dtype=dtype, device=device)
            ub = torch.as_tensor(hi, dtype=dtype, device=device)
            n_pts = alg.strategy.points

            def term(theta, generator):
                pts = alg.strategy.sampler(n_pts, lb, ub, generator)
                return volume * share(torch.mean(e_fn(shard_batch(pts),
                                                      theta)))

        return term, e_fn

    energy_loss, e_fn = make_energy_term(alg.energy)
    boundary_terms = [make_energy_term(b)[0] for b in alg.boundary_energies]

    bc_w = alg.bc_weight

    def full_loss(theta, lstate):
        generator = lstate["generator"]
        e_val = energy_loss(theta, generator)
        for term in boundary_terms:
            e_val = e_val + term(theta, generator)
        bc_losses = (torch.stack([f(theta, generator) for f in bc_loss_fns])
                     if n_bc else torch.zeros((0,), dtype=dtype,
                                              device=device))
        total = e_val + bc_w * torch.sum(bc_losses)
        aux = {"pde_losses": e_val[None], "bc_losses": bc_losses,
               "weighted_pde_losses": e_val[None],
               "weighted_bc_losses": bc_w * bc_losses,
               "energy": e_val, "full_weighted_loss": total}
        return total, aux

    pinnrep.loss_functions = PINNLossFunctions(
        bc_loss_functions=bc_loss_fns,
        pde_loss_functions=[energy_loss],
        full_loss_function=full_loss,
        additional_loss_function=None,
        datafree_pde_loss_functions=[e_fn],
        datafree_bc_loss_functions=(
            pinnrep.loss_functions.datafree_bc_loss_functions),
    )
    return TrainingProblem(loss=full_loss,
                           init_params=pinnrep.flat_init_params,
                           pinnrep=pinnrep)
