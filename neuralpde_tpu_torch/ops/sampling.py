"""Collocation-point samplers (`neuralpde_tpu.ops.sampling`).

Only `uniform_random` (and `uniform_nodes`, the separable strategy's 1-D
axis draw) is ported so far; Sobol, Latin hypercube and lattice
designs wait for the strategies that use them.
"""

from __future__ import annotations

import torch


def uniform_random(points: int, lb, ub, generator: torch.Generator, *,
                   dtype=None, device=None) -> torch.Tensor:
    """Uniform random points in [lb, ub], shape (dim, points), drawn from
    ``generator`` on ``device`` (default: that of ``lb``).

    Mirrors ``generate_random_points`` (reference:
    src/training_strategies.jl:197-200).
    """
    lb = torch.as_tensor(lb, dtype=dtype, device=device)
    ub = torch.as_tensor(ub, dtype=lb.dtype, device=lb.device)
    u = torch.rand((lb.shape[0], points), generator=generator, dtype=lb.dtype,
                   device=lb.device)
    return u * (ub[:, None] - lb[:, None]) + lb[:, None]


def uniform_nodes(points: int, lb: torch.Tensor, ub: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """``points`` uniform nodes in [lb, ub] for one grid axis, shape
    (points,), on the device and in the dtype of the 0-d tensor ``lb``."""
    return lb + (ub - lb) * torch.rand((points,), generator=generator,
                                       dtype=lb.dtype, device=lb.device)
