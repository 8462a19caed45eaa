"""Derivative engines for trial functions (`neuralpde_tpu.ops.derivatives`).

* ``numeric_derivative`` — the reference's central finite-difference stencils
  with step ``eps(T)^(1/(2+order))`` per-axis masks.
* ``jvp_derivative`` — nested forward mode (`torch.func.jvp`) along unit
  coordinate directions.
* ``jet_derivative`` — Taylor mode: one pass of a truncated Taylor series
  through the module (`TrialFunction.taylor`), sharing the primal across
  orders.
* ``jet_directions`` — Taylor mode along several coordinates in one pass
  (`TrialFunction.taylor_directions`), sharing the primal across them too.
  `JetPasses` runs it for the pure partials of one residual evaluation.

`u` is a callable ``u(x) -> (out, N)`` over a coordinate matrix ``x`` of
shape ``(dim, N)``; for Taylor mode it is a `TrialFunction`, which carries
the module, since PyTorch has no `jax.experimental.jet` to trace a closure.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import jvp


def fd_step(dtype, order: int) -> float:
    """ε = eps(T)^(1/(2+order)) — reference: src/symbolic_utilities.jl:98-103."""
    eps = (torch.finfo(dtype).eps if isinstance(dtype, torch.dtype)
           else np.finfo(np.dtype(dtype)).eps)
    return float(eps ** (1.0 / (2.0 + order)))


def eps_masks(dim: int, var_indices: Sequence[int], dtype) -> np.ndarray:
    """Static per-order ε masks for a mixed partial; every mask uses the
    *total*-order step size (reference: src/symbolic_utilities.jl:161-201)."""
    order = len(var_indices)
    step = fd_step(dtype, order)
    masks = np.zeros((order, dim))
    for k, vi in enumerate(var_indices):
        masks[k, vi] = step
    return masks


def numeric_derivative(u: Callable, x: torch.Tensor, masks: np.ndarray,
                       order: int) -> torch.Tensor:
    """Reference-parity FD stencils (src/pinn_types.jl:421-458): the fused
    stencil when every mask is identical (pure partial), otherwise the
    outermost derivative is split off recursively."""
    eps_vec = masks[order - 1]
    inv_eps = 1.0 / eps_vec[eps_vec != 0.0][0]
    e = torch.as_tensor(eps_vec, dtype=x.dtype, device=x.device)[:, None]

    same = bool(np.all(masks == masks[0]))
    if order > 4 or not same:
        sub = masks[: order - 1]
        return (
            numeric_derivative(u, x + e, sub, order - 1)
            - numeric_derivative(u, x - e, sub, order - 1)
        ) * inv_eps / 2.0
    if order == 4:
        return (
            u(x + 2 * e) - 4 * u(x + e) + 6 * u(x) - 4 * u(x - e) + u(x - 2 * e)
        ) * inv_eps**4
    if order == 3:
        return (u(x + 2 * e) - 2 * u(x + e) + 2 * u(x - e) - u(x - 2 * e)) * inv_eps**3 / 2.0
    if order == 2:
        return (u(x + e) + u(x - e) - 2 * u(x)) * inv_eps**2
    if order == 1:
        return (u(x + e) - u(x - e)) * inv_eps / 2.0
    raise ValueError(f"invalid derivative order {order}")


def _unit(x: torch.Tensor, index: int) -> torch.Tensor:
    t = torch.zeros_like(x)
    t[index] = 1
    return t


def jet_series(u, x: torch.Tensor, var_index: int, order: int) -> list:
    """``[u(x), ∂u, ..., ∂^order u]`` along coordinate ``var_index`` by one
    Taylor pass: the series (e_var, 0, ..., 0) goes through ``u.taylor``
    and its k-th output coefficient is the k-th derivative."""
    series = [_unit(x, var_index)] + [torch.zeros_like(x)
                                      for _ in range(order - 1)]
    primal, coeffs = u.taylor(x, series)
    return [primal, *coeffs]


def jet_derivative(u, x: torch.Tensor, var_index: int,
                   order: int) -> torch.Tensor:
    """Pure k-th partial (k >= 1) by Taylor mode (`jet_series`)."""
    return jet_series(u, x, var_index, order)[order]


def jet_directions(u, x: torch.Tensor, var_indices: Sequence[int],
                   order: int) -> list:
    """The ``order``-th pure partials along each coordinate of
    ``var_indices`` by one Taylor pass: each coordinate's series (e_var, 0,
    ..., 0) of `jet_series` goes through ``u.taylor_directions`` over one
    primal, so the primal's work is done once for all of them."""
    zeros = [torch.zeros_like(x) for _ in range(order - 1)]
    _, out = u.taylor_directions(
        x, [[_unit(x, v)] + zeros for v in var_indices])
    return [series[order - 1] for series in out]


def jvp_derivative(u: Callable, x: torch.Tensor, var_indices: Sequence[int],
                   dim: int) -> torch.Tensor:
    """Exact mixed partial via nested forward-mode AD.

    ``var_indices`` lists the coordinate axis per derivative application,
    e.g. ``[0, 0]`` for ∂²/∂x², ``[0, 1]`` for ∂²/∂x∂y.
    """
    if len(var_indices) == 0:
        return u(x)
    vi = var_indices[-1]

    def inner(y):
        return jvp_derivative(u, y, var_indices[:-1], dim)

    return jvp(inner, (x,), (_unit(x, vi),))[1]


class DerivativeEngine:
    """Pluggable derivative backend shared by the lowering pipeline.

    ``mode`` ∈ {"jvp", "fd", "jet"}.  The lowering calls
    ``engine(u, x, var_indices, dim)``.  "jet" uses Taylor mode for pure
    partials of order ≥ 2 of a module with Taylor rules, and nested jvp for
    mixed partials and for modules without rules: a static choice by the
    partial and the module's type, which gives the same value either way.

    ``jet_passes`` counts the Taylor passes run and ``jet_terms`` the pure
    partials they served, on the host at each evaluation that runs Python
    (eager steps, captures, the CPU; not replays of a captured graph).  A
    residual evaluation serves all its pure partials of one order of one
    call from one pass (`JetPasses`): a Laplacian u_xx + u_yy reads one
    pass for two terms.
    """

    def __init__(self, mode: str = "jvp"):
        if mode not in ("jvp", "fd", "jet"):
            raise ValueError(f"unknown derivative mode {mode!r}")
        self.mode = mode
        self.jet_passes = 0
        self.jet_terms = 0

    def takes_jet(self, u, var_indices) -> bool:
        """Whether the partial ``var_indices`` of ``u`` is taken by Taylor
        mode: a pure partial of order >= 2 of a module with rules."""
        return (self.mode == "jet" and len(set(var_indices)) == 1
                and len(var_indices) >= 2
                and getattr(u, "has_taylor_rule", False))

    def jet_partials(self, u, x, var_indices: Sequence[int],
                     order: int) -> dict:
        """``{var: the order-th pure partial of u along var}`` for each
        coordinate of ``var_indices``: one pass (`jet_directions`) for
        several coordinates of a module with rules for several directions,
        else one `jet_derivative` pass each (a static choice by the number
        of coordinates and the module's type)."""
        if len(var_indices) > 1 and getattr(u, "has_directions_rule", False):
            self.jet_passes += 1
            return dict(zip(var_indices,
                            jet_directions(u, x, var_indices, order)))
        self.jet_passes += len(var_indices)
        return {v: jet_derivative(u, x, v, order) for v in var_indices}

    def __call__(self, u, x, var_indices, dim):
        var_indices = tuple(var_indices)
        if self.takes_jet(u, var_indices):
            self.jet_passes += 1
            self.jet_terms += 1
            return jet_derivative(u, x, var_indices[0], len(var_indices))
        if self.mode in ("jvp", "jet"):
            return jvp_derivative(u, x, var_indices, dim)
        masks = eps_masks(dim, var_indices, x.dtype)
        return numeric_derivative(u, x, masks, len(var_indices))


class JetPasses:
    """The Taylor passes of one residual evaluation.  ``groups`` maps
    (call, order) to the coordinates along which the evaluation takes pure
    partials of that order of that call (a call is a dependent variable at
    its arguments, so one network input); the first such term runs the
    group's pass (`DerivativeEngine.jet_partials`) and the others read it.
    Made anew for every evaluation, so no pass outlives it: under
    `torch.utils.checkpoint` the recompute is an evaluation of its own."""

    def __init__(self, engine: DerivativeEngine, groups: dict):
        self.engine = engine
        self.groups = groups
        self.passes: dict = {}

    def partial(self, call, u, make_x: Callable, var_indices):
        """The pure partial ``var_indices`` of ``u`` at the input
        ``make_x()`` (made only by a group's first term) of ``call``, or
        None when the engine does not take it by Taylor mode."""
        key = (call, len(var_indices))
        if key not in self.groups or not self.engine.takes_jet(u, var_indices):
            return None
        partials = self.passes.get(key)
        if partials is None:
            partials = self.passes[key] = self.engine.jet_partials(
                u, make_x(), self.groups[key], len(var_indices))
        self.engine.jet_terms += 1
        return partials[var_indices[0]]
