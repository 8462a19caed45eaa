"""Training strategies (`neuralpde_tpu.strategies`; reference:
src/training_strategies.jl).

Each strategy pairs a collocation-point source with a loss reduction and
produces per-equation scalar objectives ``loss(theta, generator) -> scalar``.
Deterministic strategies ignore the generator; stochastic ones draw a fresh
sample from it on every call.  Only `GridTraining` and `StochasticTraining`
are ported so far.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .ops.sampling import uniform_random
from .symbolic.expr import Sym
from .symbolic.system import infimum, supremum


class TrainingStrategy:
    pass


def _msq(r, acc=None):
    """mean(r²), optionally accumulated in a wider dtype ``acc``."""
    sq = r * r
    if acc is not None:
        sq = sq.to(acc)
    return torch.mean(sq)


def julia_range(a: float, b: float, dx: float) -> np.ndarray:
    """Julia `a:dx:b` — inclusive of b when it lands on the grid."""
    n = int(np.floor((b - a) / dx + 1e-10)) + 1
    return a + dx * np.arange(n)


def generate_training_sets(domains, dx, eq_args_list, dtype, device=None):
    """Cartesian-product grids per equation (reference: src/discretize.jl:183-239).

    ``eq_args_list``: per equation, the get_argument layout (Syms and numbers).
    Returns a list of (rows, N) coordinate tensors on ``device``.
    """
    dxs = dx if isinstance(dx, (list, tuple)) else [dx] * len(domains)
    spans = {d.variables.name: julia_range(infimum(d.domain), supremum(d.domain), h)
             for d, h in zip(domains, dxs)}
    out = []
    for args in eq_args_list:
        axes = [spans[a.name] if isinstance(a, Sym) else np.array([float(a)])
                for a in args]
        grid = np.meshgrid(*axes, indexing="ij") if axes else [np.zeros((1,))]
        cord = np.stack([g.reshape(-1) for g in grid], axis=0)
        out.append(torch.as_tensor(cord, dtype=dtype, device=device))
    return out


def get_bounds(domains, eq_args_list, points: int, dtype, device=None):
    """Per-equation (lb, ub) tensors for sampling strategies, with the
    reference's 1/points inset (src/discretize.jl:297-322)."""
    dx = 1.0 / points
    lo = {d.variables.name: infimum(d.domain) + dx for d in domains}
    hi = {d.variables.name: supremum(d.domain) - dx for d in domains}
    bounds = []
    for args in eq_args_list:
        lb = np.array([lo[a.name] if isinstance(a, Sym) else float(a) for a in args])
        ub = np.array([hi[a.name] if isinstance(a, Sym) else float(a) for a in args])
        bounds.append((torch.as_tensor(lb, dtype=dtype, device=device),
                       torch.as_tensor(ub, dtype=dtype, device=device)))
    return bounds


class GridTraining(TrainingStrategy):
    """Cartesian grid with spacing `dx` (reference: src/training_strategies.jl:1-15)."""

    def __init__(self, dx):
        self.dx = dx

    def build(self, pinnrep, datafree_pde, datafree_bc):
        dtype, device = pinnrep.dtype, pinnrep.device
        pde_sets = generate_training_sets(
            pinnrep.domains, self.dx, pinnrep.pde_args, dtype, device)
        bc_sets = generate_training_sets(
            pinnrep.domains, self.dx, pinnrep.bc_args, dtype, device)
        acc = pinnrep.loss_accum_dtype
        pde = [_mean_sq_loss(f, s, acc) for f, s in zip(datafree_pde, pde_sets)]
        bc = [_mean_sq_loss(f, s, acc) for f, s in zip(datafree_bc, bc_sets)]
        return pde, bc


def _mean_sq_loss(residual, train_set, acc=None):
    def loss(theta, generator=None):
        del generator
        return _msq(residual(train_set, theta), acc)

    return loss


class StochasticTraining(TrainingStrategy):
    """Uniform resample each step (reference: src/training_strategies.jl:190-237).

    ``microbatch``: evaluate the residual in chunks of that many points, each
    under `torch.utils.checkpoint`, so only one chunk's activations are alive
    at a time and the backward pass recomputes them chunk by chunk.  Chunk
    ``c`` holds columns ``c*microbatch ... (c+1)*microbatch - 1`` of the
    sample, as in the JAX package.  ``points`` must be a multiple of
    ``microbatch``.

    ``sampler``: the point source, ``(n, lb, ub, generator) -> (dim, n)``;
    `uniform_random` unless replaced (tests replace it to feed both packages
    the same points).
    """

    def __init__(self, points: int, bcs_points: int | None = None,
                 microbatch: int | None = None):
        self.points = points
        self.bcs_points = bcs_points if bcs_points is not None else points
        self.microbatch = microbatch
        self.sampler = uniform_random
        if microbatch is not None and points % microbatch != 0:
            raise ValueError(
                f"points ({points}) must be a multiple of microbatch "
                f"({microbatch})")

    def build(self, pinnrep, datafree_pde, datafree_bc):
        dtype, device = pinnrep.dtype, pinnrep.device
        pde_bounds = get_bounds(pinnrep.domains, pinnrep.pde_args, self.points,
                                dtype, device)
        bc_bounds = get_bounds(pinnrep.domains, pinnrep.bc_args, self.points,
                               dtype, device)
        acc = pinnrep.loss_accum_dtype
        mb = self.microbatch

        def make(residual, bound, n):
            lb, ub = bound

            if mb is not None and n > mb:
                def chunk_sum(theta, pts):
                    sq = residual(pts, theta) ** 2
                    if acc is not None:
                        sq = sq.to(acc)
                    return torch.sum(sq)

                def loss(theta, generator):
                    pts = self.sampler(n, lb, ub, generator)
                    sums = [checkpoint(chunk_sum, theta, pts[:, c:c + mb],
                                       use_reentrant=False)
                            for c in range(0, n, mb)]
                    return torch.sum(torch.stack(sums)) / n

                return loss

            def loss(theta, generator):
                return _msq(residual(self.sampler(n, lb, ub, generator), theta),
                            acc)

            return loss

        pde = [make(f, b, self.points) for f, b in zip(datafree_pde, pde_bounds)]
        bc = [make(f, b, self.bcs_points) for f, b in zip(datafree_bc, bc_bounds)]
        return pde, bc
