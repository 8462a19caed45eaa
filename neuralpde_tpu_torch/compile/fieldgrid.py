"""Field-grid lowering: symbolic equations -> residual fields on a uniform
tensor grid (`neuralpde_tpu.compile.fieldgrid`; the PINO-PDE backend).

`compile/lower.py` treats each dependent variable as a pointwise network
evaluated per collocation column.  Here each dependent variable is a field:
one tensor over the whole grid ``(N1, ..., Nd, P)`` from a single operator
evaluation.  So:

* derivatives are finite differences of the evaluated field along grid
  axes (second-order central interior, one-sided second-order ends), or
  on periodic axes named in ``spectral_axes`` exact FFT derivatives;
* boundary conditions lower to slices: a constant call argument on a grid
  node (``u(0, t)``) pins that axis to the node, giving a size-1 axis that
  broadcasts against the rest of the expression;
* a `Param` broadcasts its training column ``(P,)`` over the grid axes.

Everything the residuals read besides the fields (grid coordinates, the
spectral derivative factors) is a device tensor made when the context is
built, so a step that evaluates them copies nothing from the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..symbolic.expr import (
    PRIMITIVES, Call, DepVarCall, Deriv, Eq, Expr, IntegralExpr, Num, Param,
    Sym, expand_derivatives,
)


def grid_diff(u, h, axis: int, order: int):
    """Finite difference of a field along one grid axis: second-order
    central interior with one-sided second-order ends (the boundary rows
    stay usable for boundary-condition slices).  ``order`` 1 or 2 directly;
    higher orders compose (``order=3`` -> second then first, etc.)."""
    if order >= 3:
        return grid_diff(grid_diff(u, h, axis, 2), h, axis, order - 2)
    u = torch.movedim(u, axis, 0)
    n = u.shape[0]
    if order == 1:
        if n < 3:
            raise ValueError(f"first derivative needs >= 3 grid nodes, got {n}")
        interior = (u[2:] - u[:-2]) / (2 * h)
        first = (-3 * u[0:1] + 4 * u[1:2] - u[2:3]) / (2 * h)
        last = (3 * u[-1:] - 4 * u[-2:-1] + u[-3:-2]) / (2 * h)
    elif order == 2:
        if n < 4:
            raise ValueError(f"second derivative needs >= 4 grid nodes, got {n}")
        interior = (u[2:] - 2 * u[1:-1] + u[:-2]) / h**2
        first = (2 * u[0:1] - 5 * u[1:2] + 4 * u[2:3] - u[3:4]) / h**2
        last = (2 * u[-1:] - 5 * u[-2:-1] + 4 * u[-3:-2] - u[-4:-3]) / h**2
    else:
        raise ValueError(f"derivative order must be >= 1, got {order}")
    return torch.movedim(torch.cat([first, interior, last], dim=0), 0, axis)


def spectral_factor(n_nodes: int, span: float, order: int) -> np.ndarray:
    """``(ik)^order`` over the rFFT bins of a periodic axis of ``n_nodes``
    nodes (wrap node included): the odd-order Nyquist bin is zeroed (its
    derivative is not representable on the real grid), and an even order's
    factor is real."""
    m = n_nodes - 1
    if m < 2:
        raise ValueError(f"spectral derivative needs >= 3 grid nodes, got "
                         f"{n_nodes}")
    k = 2.0 * np.pi * np.fft.rfftfreq(m) * m / span  # angular wavenumbers
    factor = (1j * k) ** order
    if order % 2 == 1 and m % 2 == 0:
        factor[-1] = 0.0                             # odd-order Nyquist
    if order % 2 == 0:
        factor = factor.real                         # (ik)^even is real
    return factor


def grid_diff_spectral(u, span: float, axis: int, order: int, factor=None):
    """Spectral (FFT) derivative of a periodic field along one grid axis
    whose nodes include both endpoints: the wrap node is dropped for the
    FFT and appended again, so the output layout matches `grid_diff`.
    ``span`` is the period.  ``factor``: `spectral_factor` as a tensor on
    the field's device (made from numpy here when not given)."""
    u = torch.movedim(u, axis, 0)
    m = u.shape[0] - 1                               # wrap node dropped
    if factor is None:
        factor = torch.as_tensor(spectral_factor(u.shape[0], span, order),
                                 device=u.device)
        factor = factor.to(u.dtype if not factor.is_complex()
                           else u.dtype.to_complex())
    elif m < 2:
        raise ValueError(f"spectral derivative needs >= 3 grid nodes, got "
                         f"{u.shape[0]}")
    uh = torch.fft.rfft(u[:-1], dim=0)
    du = torch.fft.irfft(uh * factor.reshape((-1,) + (1,) * (u.ndim - 1)),
                         n=m, dim=0).to(u.dtype)
    du = torch.cat([du, du[0:1]], dim=0)             # re-append wrap node
    return torch.movedim(du, 0, axis)


@dataclass
class FieldGridContext:
    """Static lowering context: the grid layout shared by all equations.

    * iv_names: grid-axis variable names, axis order
    * grids: per-axis 1-D node tensors (uniform spacing), on the device
    * dict_depvar_input: depvar name -> canonical input names
    * eq_params: Param names in the order of the parameter-column rows
    * spectral_axes: names of periodic axes whose field derivatives use
      `grid_diff_spectral` instead of the FD stencils (the grid must span
      one full period, wrap node included)
    """

    iv_names: list
    grids: list
    dict_depvar_input: dict
    eq_params: list
    spectral_axes: frozenset = frozenset()

    def __post_init__(self):
        # spacings and spans in the grids' dtype, as the JAX package takes
        # them from its arrays
        nodes = [torch.as_tensor(g).detach().cpu() for g in self.grids]
        self.spacings = [float(g[1] - g[0]) if len(g) > 1 else 1.0
                         for g in nodes]
        self.spans = [float(g[-1] - g[0]) if len(g) > 1 else 1.0
                      for g in nodes]
        self._node_vals = [[float(v) for v in g] for g in nodes]
        unknown = set(self.spectral_axes) - set(self.iv_names)
        if unknown:
            raise ValueError(f"spectral_axes {sorted(unknown)} are not grid "
                             f"axes ({self.iv_names})")
        # grid coordinates shaped to broadcast, made once on the grids'
        # device; the spectral factors are made by `build_field_residual`
        self._coords = [torch.as_tensor(g).reshape(
            _axis_shape(self, a, len(nodes[a]))) for a, g in
            enumerate(self.grids)]
        self._factors = {}

    @property
    def ndim(self) -> int:
        return len(self.iv_names)

    def axis_of(self, name: str) -> int:
        return self.iv_names.index(name)

    def node_index(self, axis: int, value: float) -> int:
        """Nearest grid node of a constant call argument; raises if the
        constant is not (numerically) a node: boundary conditions must sit
        on the training grid."""
        nodes = self._node_vals[axis]
        idx = min(range(len(nodes)), key=lambda i: abs(nodes[i] - value))
        span = abs(nodes[-1] - nodes[0]) or 1.0
        if abs(nodes[idx] - value) > 1e-6 * span:
            raise ValueError(
                f"constant argument {value!r} of grid axis "
                f"{self.iv_names[axis]!r} is not a grid node (nearest: "
                f"{nodes[idx]!r}); field-grid lowering evaluates boundary "
                "conditions by slicing the training grid")
        return idx

    def spectral_factor(self, axis: int, order: int):
        """`spectral_factor` of a grid axis as a tensor of the grid's dtype
        (its complex twin for odd orders) on the grid's device, made at the
        first request: `build_field_residual` asks for every factor its
        equation needs, so no step makes one."""
        key = (axis, order)
        if key not in self._factors:
            g = torch.as_tensor(self.grids[axis])
            f = spectral_factor(len(self._node_vals[axis]), self.spans[axis],
                                order)
            dtype = g.dtype.to_complex() if np.iscomplexobj(f) else g.dtype
            self._factors[key] = torch.as_tensor(f, dtype=dtype,
                                                 device=g.device)
        return self._factors[key]


def _axis_shape(ctx: FieldGridContext, axis: int, n: int):
    """Broadcast shape placing `n` values on grid axis `axis`:
    (1, ..., n, ..., 1, 1) with the trailing 1 the parameter axis."""
    shape = [1] * (ctx.ndim + 1)
    shape[axis] = n
    return tuple(shape)


def _resolve_call(call: DepVarCall, ctx: FieldGridContext):
    """Full-rank slice index for one depvar call: per grid axis,
    `slice(None)` when the field's argument there is the canonical grid
    variable (or the field is not declared on that axis: its stored tensor
    has a size-1 axis there), or a pinned node index when the argument is a
    constant."""
    inputs = ctx.dict_depvar_input[call.name]
    if len(call.args) != len(inputs):
        raise ValueError(f"{call.name} called with {len(call.args)} args, "
                         f"declared with {len(inputs)}")
    idx = [slice(None)] * ctx.ndim
    for slot, (canon, a) in enumerate(zip(inputs, call.args)):
        axis = ctx.axis_of(canon)
        if isinstance(a, Sym):
            if a.name != canon:
                raise ValueError(
                    f"field-grid lowering requires canonical call arguments: "
                    f"{call.name} slot {slot} is declared {canon!r}, got "
                    f"{a.name!r}")
        elif isinstance(a, Num):
            i = ctx.node_index(axis, a.value)
            idx[axis] = slice(i, i + 1)       # keepdims: broadcastable
        else:
            raise ValueError(
                f"field-grid lowering supports grid variables and constants "
                f"as call arguments; {call.name} got {a!r}")
    return tuple(idx)


def _ev_field(expr: Expr, fields: dict, p_cols, ctx: FieldGridContext):
    """Recursive evaluator; every result broadcasts to (N1, ..., Nd, P)."""
    if isinstance(expr, Num):
        return expr.value
    if isinstance(expr, Sym):
        return ctx._coords[ctx.axis_of(expr.name)]
    if isinstance(expr, Param):
        row = ctx.eq_params.index(expr.name)
        return p_cols[row].reshape((1,) * ctx.ndim + (-1,))
    if isinstance(expr, Call):
        vals = [_ev_field(a, fields, p_cols, ctx) for a in expr.args]
        return PRIMITIVES[expr.op](*vals)
    if isinstance(expr, DepVarCall):
        return fields[expr.name][(*_resolve_call(expr, ctx), slice(None))]
    if isinstance(expr, Deriv):
        target = expr.target
        if not isinstance(target, DepVarCall):
            raise ValueError(
                f"derivative target {target!r} is not a dependent-variable "
                "call; run expand_derivatives first")
        inputs = ctx.dict_depvar_input[target.name]
        if any(w.name not in inputs for w in expr.wrt):
            return 0.0                        # ∂u/∂z with z not an input of u
        counts = {}
        for w in expr.wrt:
            counts[w.name] = counts.get(w.name, 0) + 1
        u = fields[target.name]
        for name, k in counts.items():
            axis = ctx.axis_of(name)
            if name in ctx.spectral_axes:
                u = grid_diff_spectral(u, ctx.spans[axis], axis, k,
                                       ctx.spectral_factor(axis, k))
            else:
                u = grid_diff(u, ctx.spacings[axis], axis, k)
        return u[(*_resolve_call(target, ctx), slice(None))]
    if isinstance(expr, IntegralExpr):
        raise NotImplementedError(
            "integral terms are not supported on the field-grid (PINO) path; "
            "use PhysicsInformedNN for integro-differential equations")
    raise TypeError(f"cannot lower {type(expr).__name__} on the field grid")


def _make_factors(expr: Expr, ctx: FieldGridContext) -> None:
    """Make the spectral factors of every derivative in ``expr`` now."""
    if isinstance(expr, Call):
        for a in expr.args:
            _make_factors(a, ctx)
    elif isinstance(expr, Deriv):
        counts = {}
        for w in expr.wrt:
            counts[w.name] = counts.get(w.name, 0) + 1
        for name, k in counts.items():
            if name in ctx.spectral_axes:
                ctx.spectral_factor(ctx.axis_of(name), k)


def build_field_residual(eq: Eq, ctx: FieldGridContext) -> Callable:
    """Lower one equation into ``residual(fields, p_cols) -> tensor`` whose
    shape is the broadcast of the equation's slices: the full grid
    ``(N1, ..., Nd, P)`` for interior equations, size-1 pinned axes for
    boundary conditions.  A residual that is a number (an equation with no
    field in it) comes back as a 0-d tensor of the fields' dtype."""
    expr = Call("-", (expand_derivatives(eq.lhs), expand_derivatives(eq.rhs)))
    _make_factors(expr, ctx)

    def residual(fields, p_cols):
        out = _ev_field(expr, fields, p_cols, ctx)
        if isinstance(out, torch.Tensor):
            return out
        like = next(iter(fields.values()))
        return torch.full((), out, dtype=like.dtype, device=like.device)

    return residual
