"""neural_adapter: transfer learning / domain decomposition
(`neuralpde_tpu.solvers.adapter`; reference: src/neural_adapter.jl).

Trains a new network to match an existing prediction.  ``loss(cord, theta)``
is user-provided, in residual form returning per-point values (e.g.
``functional_call(net2, theta, (cord,))[0] - target(cord)``); the strategy
supplies collocation points over the *full* domain product (no per-equation
argument analysis — the reference uses the raw domain spans,
src/neural_adapter.jl:1-23).  ``theta`` is the new network's parameter dict
as given in ``init_params``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import default_float
from ..ops.quadrature import tensor_rule_box
from ..strategies import (
    GridTraining, QuadratureTraining, QuasiRandomTraining, StochasticTraining,
    julia_range,
)
from ..symbolic.system import infimum, supremum
from .ode import _SimpleProblem as _AdapterProblem


def _full_grid(domains, dx, dtype, device):
    dxs = dx if isinstance(dx, (list, tuple)) else [dx] * len(domains)
    spans = [julia_range(infimum(d.domain), supremum(d.domain), h)
             for d, h in zip(domains, dxs)]
    grid = np.meshgrid(*spans, indexing="ij")
    return torch.as_tensor(np.stack([g.reshape(-1) for g in grid]),
                           dtype=dtype, device=device)


def _domain_bounds(domains, dtype, device):
    lb = torch.tensor([float(infimum(d.domain)) for d in domains],
                      dtype=dtype, device=device)
    ub = torch.tensor([float(supremum(d.domain)) for d in domains],
                      dtype=dtype, device=device)
    return lb, ub


def _loss_for_strategy(loss, pde_system, strategy, dtype, device, theta0=None):
    domains = pde_system.domains
    if isinstance(strategy, GridTraining):
        pts = _full_grid(domains, strategy.dx, dtype, device)
        return lambda theta, generator: torch.mean(loss(pts, theta) ** 2)
    if isinstance(strategy, (StochasticTraining, QuasiRandomTraining)):
        lb, ub = _domain_bounds(domains, dtype, device)
        n = strategy.points
        design = (strategy._design(n, lb, ub)
                  if isinstance(strategy, QuasiRandomTraining) else None)

        def sloss(theta, generator):
            pts = (strategy.sampler or design)(n, lb, ub, generator)
            return torch.mean(loss(pts, theta) ** 2)

        return sloss
    if isinstance(strategy, QuadratureTraining):
        lb = [infimum(d.domain) for d in domains]
        ub = [supremum(d.domain) for d in domains]
        area = float(np.prod(np.asarray(ub) - np.asarray(lb)))

        def rule(panels):
            nodes, weights = tensor_rule_box(lb, ub, strategy.order, panels)
            return (torch.as_tensor(nodes, dtype=dtype, device=device),
                    torch.as_tensor(weights / area, dtype=dtype,
                                    device=device))

        integral_at = None
        if theta0 is not None and strategy.panels is None:
            def integral_at(panels):
                n, w_ = rule(panels)
                with torch.no_grad():
                    return float(torch.sum(loss(n, theta0) ** 2 * w_))

        nodes, w = rule(strategy.resolve_panels(integral_at, len(domains)))
        return lambda theta, generator: torch.sum(loss(nodes, theta) ** 2 * w)
    raise TypeError(f"unsupported strategy {type(strategy).__name__}")


def neural_adapter(loss, init_params, pde_system, strategy, *, device=None):
    """A problem for `neuralpde_tpu_torch.solve` that trains ``init_params``
    against ``loss`` over ``pde_system``'s domains (reference:
    src/neural_adapter.jl:82-89), or against a list of losses, each over its
    own system, summed (src/neural_adapter.jl:91-99).  The parameters and
    the collocation points go to ``device`` (``"cuda"`` unless given)."""
    dtype = default_float()
    device = torch.device(device if device is not None else "cuda")
    init_params = {k: torch.as_tensor(v).detach().to(device)
                   for k, v in init_params.items()}
    if isinstance(loss, (list, tuple)):
        fns = [_loss_for_strategy(l, s, strategy, dtype, device,
                                  theta0=init_params)
               for l, s in zip(loss, pde_system)]

        def total(theta, generator):
            return sum(f(theta, generator) for f in fns)

        return _AdapterProblem(total, init_params)
    fn = _loss_for_strategy(loss, pde_system, strategy, dtype, device,
                            theta0=init_params)
    return _AdapterProblem(fn, init_params)
