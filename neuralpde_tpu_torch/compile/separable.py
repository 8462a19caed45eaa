"""Factorized tensor-grid lowering for separable trial functions (SPINN)
(`neuralpde_tpu.compile.separable`).

Lowers the same symbolic equations as `compile.lower` but evaluates them on a
tensor-product grid: every dependent-variable call and derivative term becomes
an einsum contraction of per-axis feature matrices

    u-grid            = sum_r prod_a F_a[:, r]        F_a = f_a(nodes_a)
    d^k u/dx_a^k grid = sum_r F_a^(k) prod_{b!=a} F_b F^(k) = order-k features

so an ``N^d``-point residual costs ``N d`` axis-net evaluations; the only
``N^d``-sized tensors are the residual grids themselves.  A two-axis
residual that is a sum of such terms (and of products of an axis-0 and an
axis-1 value) is the low-rank matrix ``aᵀ b``: the factored route keeps it
as its two factor matrices (`build_factored_residual`) and writes the grid
once, inside `factored_msq`.

Selected by the `SeparableTraining` strategy; every chain must be a
`SeparableNet`.  Equations that cannot factorize (an argument coupling two
grid axes) are routed to a dense pointwise evaluation on the same grid.
Integral terms with constant bounds take temporary quadrature axes on the
grid (`_integral_grid`); with symbolic bounds they are routed like any
other equation that cannot factorize.
On one card the grid is not sharded (the JAX package's `shard_axis_nodes`
is the identity here).
"""

from __future__ import annotations

import string
import warnings
from dataclasses import dataclass

import torch
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from ..kernels.sq_sum import sq_sum
from ..nn.separable import SeparableNet
from ..ops.quadrature import rule_tensors
from ..ops.sampling import uniform_nodes
from ..parallel.mesh import (
    data_rank, data_size, gather_over_data, share, shard_axis_nodes,
    sum_over_data,
)
from ..strategies import (
    TrainingStrategy, _mean_sq_loss, _msq, _msq_at, generate_training_sets,
    julia_range,
)
from ..symbolic.expr import (
    PRIMITIVES, Call, DepVarCall, Deriv, Eq, Expr, IntegralExpr, Num, Param,
    Sym, _simplify, expand_derivatives, symbolic_diff,
)
from ..symbolic.system import infimum, supremum
from .lower import LoweringContext, _walk, get_argument
from .transform_inf import transform_inf_integral

_AXIS_LETTERS = string.ascii_lowercase[:10]

# error texts that mean "this equation cannot factorize" (vs a genuinely
# malformed problem): SeparableTraining.build routes these equations to a
# dense pointwise fallback instead of failing the whole problem
_FACTORIZATION_ERROR_MARKS = ("separable fast path",)

# dense-fallback tensor grids beyond this size would materialize the full
# N^d pointwise evaluation the factorized path exists to avoid
_DENSE_FALLBACK_MAX_POINTS = 1 << 22


def _shard_nodes(nodes: list):
    """``(nodes, split)``: under a mesh, axis 0's nodes cut to this rank's
    slice (`shard_axis_nodes`), so the rank contracts its rows of the grid;
    ``split`` is 0 when they were cut, else None."""
    if not nodes:
        return nodes, None
    first = shard_axis_nodes(nodes[0])
    if first is nodes[0]:
        return nodes, None
    return [first] + list(nodes[1:]), 0


def _is_factorization_error(e: BaseException) -> bool:
    return (isinstance(e, (ValueError, NotImplementedError))
            and any(m in str(e) for m in _FACTORIZATION_ERROR_MARKS))


@dataclass
class _GridContext:
    """Per-equation evaluation context on a tensor grid."""

    ctx: LoweringContext          # shared symbolic context (theta_for, params)
    nets: dict                    # depvar name -> SeparableNet
    nodes: list                   # per grid axis: (N_i,) 1-D node tensor
    k: int                        # number of grid axes
    dtype: torch.dtype
    device: torch.device
    top_orders: dict              # feature key -> highest order the expr uses
    features: dict                # feature key -> [F_0, ..., F_top], per call


def _feature_key(name: str, slot: int, arg) -> tuple:
    return name, slot, repr(arg)


def _top_orders(expr: Expr, ctx: LoweringContext) -> dict:
    """For each (depvar, input slot, argument) of the expression, the highest
    derivative order it takes, so that each axis net runs once per residual
    evaluation: one Taylor pass to that order also gives the lower ones."""
    top: dict = {}
    for node in _walk(expr):
        if isinstance(node, DepVarCall):
            for slot, arg in enumerate(node.args):
                key = _feature_key(node.name, slot, arg)
                top.setdefault(key, 0)
        elif isinstance(node, Deriv) and isinstance(node.target, DepVarCall):
            inputs = ctx.dict_depvar_input[node.target.name]
            for w in node.wrt:
                if w.name in inputs:
                    slot = inputs.index(w.name)
                    key = _feature_key(node.target.name, slot,
                                       node.target.args[slot])
                    top[key] = max(top.get(key, 0),
                                   sum(v.name == w.name for v in node.wrt))
    return top


def _grid_env(gctx: _GridContext, axes) -> dict:
    """Bind each grid-axis Sym to its nodes, broadcast-shaped (1,…,N_i,…,1)."""
    env = {}
    for i, s in enumerate(axes):
        shape = [1] * gctx.k
        shape[i] = gctx.nodes[i].shape[0]
        env[s.name] = gctx.nodes[i].reshape(shape)
    return env


def _slot_nodes(arg, env, theta, p, gctx: _GridContext):
    """Evaluate one depvar-call argument -> (grid axis or None, (N,) nodes).

    A `Num`/constant maps to a single-node axis (shape (1,)); a value varying
    along exactly one grid axis maps to that axis; anything coupling two axes
    cannot factorize and raises.
    """
    if isinstance(arg, Num):
        return None, torch.full((1,), float(arg.value), dtype=gctx.dtype,
                                device=gctx.device)
    val = torch.as_tensor(_gev(arg, env, theta, p, gctx))
    if val.ndim == 0:
        return None, val.reshape(1)
    if val.ndim != gctx.k:
        val = val.reshape((1,) * (gctx.k - val.ndim) + tuple(val.shape))
    nz = [d for d in range(gctx.k) if val.shape[d] != 1]
    if len(nz) == 0:
        return None, val.reshape(1)
    if len(nz) == 1:
        return nz[0], val.reshape(-1)
    raise ValueError(
        "separable fast path: a dependent-variable argument couples several "
        "grid axes and cannot factorize — under SeparableTraining this "
        "equation auto-routes to a dense pointwise evaluation; elsewhere "
        "use a dense training strategy")


def _call_features(call: DepVarCall, orders: dict, env, theta, p,
                   gctx: _GridContext):
    """The rank-r features of a (derivative of a) depvar call:
    ``(by_axis, const)``, ``by_axis`` mapping each grid axis the call varies
    along to its ``(rank, N_i)`` features, ``const`` the ``(rank,)`` product
    of the constant slots' features (None without one).

    ``orders[slot]`` is the per-input-slot derivative order (0 if absent).
    """
    net = gctx.nets[call.name]
    params = gctx.ctx.theta_for(call.name, theta)
    want = len(gctx.ctx.dict_depvar_input[call.name])
    if len(call.args) != want:
        raise ValueError(
            f"{call.name} called with {len(call.args)} args, declared with {want}")

    by_axis: dict = {}        # grid axis -> (rank, N_i) combined features
    const = None              # (rank,) product of constant-slot features
    for slot, arg in enumerate(call.args):
        axis, nodes = _slot_nodes(arg, env, theta, p, gctx)
        order = orders.get(slot, 0)
        key = _feature_key(call.name, slot, arg)
        series = gctx.features.get(key)
        if series is None or len(series) <= order:
            series = net.axis_series(params, slot, nodes,
                                     max(order, gctx.top_orders.get(key, 0)))
            gctx.features[key] = series
        F = series[order]
        if axis is None:
            vec = F[:, 0]
            const = vec if const is None else const * vec
        elif axis in by_axis:
            by_axis[axis] = by_axis[axis] * F   # two slots fed the same axis
        else:
            by_axis[axis] = F
    return by_axis, const


def _depvar_grid(call: DepVarCall, orders: dict, env, theta, p,
                 gctx: _GridContext):
    """Grid tensor of a (derivative of a) depvar call (`_call_features`)."""
    by_axis, const = _call_features(call, orders, env, theta, p, gctx)
    if not by_axis:                              # fully pinned call, e.g. u(0, 0)
        return torch.sum(const)
    terms, ops, out = [], [], ""
    if const is not None:
        terms.append("z")
        ops.append(const)
    for axis in sorted(by_axis):
        terms.append("z" + _AXIS_LETTERS[axis])
        ops.append(by_axis[axis])
        out += _AXIS_LETTERS[axis]
    val = torch.einsum(",".join(terms) + "->" + out, *ops)
    shape = [1] * gctx.k
    for j, axis in enumerate(sorted(by_axis)):
        shape[axis] = val.shape[j]
    return val.reshape(shape)


def _gev(expr: Expr, env: dict, theta, p, gctx: _GridContext):
    """Recursive grid evaluator (the tensor-grid analog of lower._ev)."""
    ctx = gctx.ctx
    if isinstance(expr, Num):
        return expr.value
    if isinstance(expr, Sym):
        try:
            return env[expr.name]
        except KeyError:
            raise KeyError(
                f"variable {expr.name!r} is unbound in this equation's "
                f"grid layout {sorted(env)}") from None
    if isinstance(expr, Param):
        idx = ctx.eq_params.index(expr.name)
        if ctx.param_estim:
            return theta["p"][idx]
        if p is None:
            raise ValueError(f"parameter {expr.name!r} has no default value")
        return p[idx]
    if isinstance(expr, Call):
        vals = [_gev(a, env, theta, p, gctx) for a in expr.args]
        return PRIMITIVES[expr.op](*vals)
    if isinstance(expr, DepVarCall):
        return _depvar_grid(expr, {}, env, theta, p, gctx)
    if isinstance(expr, Deriv):
        orders = _deriv_orders(expr, ctx)
        if orders is None:                  # ∂u/∂z, z not an input of u
            return torch.zeros((), dtype=gctx.dtype, device=gctx.device)
        return _depvar_grid(expr.target, orders, env, theta, p, gctx)
    if isinstance(expr, IntegralExpr):
        return _integral_grid(expr, env, theta, p, gctx)
    raise TypeError(f"cannot lower {type(expr).__name__}")


def _deriv_orders(expr: Deriv, ctx: LoweringContext):
    """Per-input-slot derivative orders of a derivative of a depvar call, or
    None where it differentiates by a variable that is no input of it."""
    target = expr.target
    if not isinstance(target, DepVarCall):
        raise ValueError(
            f"derivative target {target!r} is not a dependent-variable "
            "call; run expand_derivatives first")
    inputs = ctx.dict_depvar_input[target.name]
    orders: dict = {}
    for w in expr.wrt:
        if w.name not in inputs:
            return None
        slot = inputs.index(w.name)
        orders[slot] = orders.get(slot, 0) + 1
    return orders


def _integral_grid(expr: IntegralExpr, env, theta, p, gctx: _GridContext):
    """Integral terms on the factorized grid: each integration variable
    becomes a temporary extra grid axis of static Gauss-Legendre nodes, the
    integrand evaluates through the same factorized machinery on the
    extended tensor grid, and the quadrature contraction removes the extra
    axes again.  Constant (or infinite — transformed) bounds only; bounds
    referencing grid axes couple axes and need a dense strategy."""
    expr = transform_inf_integral(expr)
    if any(isinstance(b, Expr) and not isinstance(b, Num)
           for b in expr.lb + expr.ub):
        raise NotImplementedError(
            "integro-differential terms with symbolic/parametric bounds "
            "cannot factorize on the separable fast path (the bound couples "
            "grid axes); under SeparableTraining such equations auto-route "
            "to a dense pointwise evaluation (other equations stay "
            "factorized) — or use GridTraining/StochasticTraining/"
            "QuadratureTraining for the whole problem")
    lbs = [b.value if isinstance(b, Num) else float(b) for b in expr.lb]
    ubs = [b.value if isinstance(b, Num) else float(b) for b in expr.ub]
    nu, wu = rule_tensors(1, gctx.ctx.integral_order, gctx.ctx.integral_panels,
                          gctx.dtype, gctx.device)
    m = len(expr.ivars)
    k0 = gctx.k

    env2 = {name: (v.reshape(tuple(v.shape) + (1,) * m)
                   if isinstance(v, torch.Tensor) and v.ndim else v)
            for name, v in env.items()}
    nodes2 = list(gctx.nodes)
    for d, iv in enumerate(expr.ivars):
        qn = lbs[d] + (ubs[d] - lbs[d]) * nu[0]
        nodes2.append(qn)
        shape = [1] * (k0 + m)
        shape[k0 + d] = qn.shape[0]
        env2[iv.name] = qn.reshape(shape)

    top_orders = _top_orders(expr.integrand, gctx.ctx)
    gctx2 = _GridContext(ctx=gctx.ctx, nets=gctx.nets, nodes=nodes2,
                         k=k0 + m, dtype=gctx.dtype, device=gctx.device,
                         top_orders=top_orders, features={})
    val = torch.as_tensor(_gev(expr.integrand, env2, theta, p, gctx2),
                          dtype=gctx.dtype, device=gctx.device)
    if val.ndim == 0:
        val = val.reshape((1,) * (k0 + m))
    # no broadcast_to: a size-1 temp axis (ivar-independent integrand)
    # contracts against the weights (Σw = 1) without materializing the
    # full extended grid, and the caller broadcasts the outer axes
    for d in reversed(range(m)):
        val = torch.sum(val * wu, dim=-1) * (ubs[d] - lbs[d])
    return val


# ---------------------------------------------------------------------------
# The factored route: a two-axis residual as a sum of rank-factored terms
# ---------------------------------------------------------------------------

class _NotFactored(Exception):
    """The residual is no sum of rank-factored terms over two grid axes."""


@dataclass
class _Terms:
    """A two-axis grid kept factored, ``Σ_k a[k, i]·b[k, j]``: lists of
    blocks of rows of the two factor matrices, ``(K_m, N_0)`` and
    ``(K_m, N_1)``, concatenated once at the end."""

    a: list
    b: list

    def neg(self) -> "_Terms":
        return _Terms([-x for x in self.a], self.b)

    def scaled(self, axis, value, divide: bool = False) -> "_Terms":
        """Times (or over) a value along at most one grid axis: a scalar or
        an axis-0 value scales ``a``, an axis-1 value scales ``b``."""
        if axis is not None:
            value = value.reshape(1, -1)
        side = [x / value if divide else x * value
                for x in (self.b if axis == 1 else self.a)]
        return _Terms(self.a, side) if axis == 1 else _Terms(side, self.b)


def _rank_one(axis, value, gctx: _GridContext) -> _Terms:
    """A value along at most one grid axis (``axis`` None: a scalar) as a
    rank-1 term, with a ones vector on the other side."""
    ones = [torch.ones((1, n.shape[0]), dtype=gctx.dtype, device=gctx.device)
            for n in gctx.nodes]
    if axis is None:
        return _Terms([ones[0] * value], [ones[1]])
    ones[axis] = value.reshape(1, -1)
    return _Terms([ones[0]], [ones[1]])


def _call_terms(call: DepVarCall, orders: dict, grid_env, theta, p,
                gctx: _GridContext) -> _Terms:
    """A (derivative of a) depvar call as its rank-r features: a constant
    slot scales ``a``; a call along one grid axis, or none, is rank 1."""
    by_axis, const = _call_features(call, orders, grid_env, theta, p, gctx)
    if not by_axis:
        return _rank_one(None, torch.sum(const), gctx)
    if len(by_axis) == 1:
        (axis, F), = by_axis.items()
        return _rank_one(axis, F.sum(0) if const is None else const @ F,
                         gctx)
    a = by_axis[0] if const is None else by_axis[0] * const[:, None]
    return _Terms([a], [by_axis[1]])


def _fev(expr: Expr, env: dict, grid_env: dict, theta, p,
         gctx: _GridContext):
    """Factored evaluator over two grid axes: a `_Terms`, or a value along
    at most one axis as ``(axis, value)`` (axis None: a scalar, else a 1-D
    tensor over that axis's nodes).  Raises `_NotFactored` where the
    expression is no sum of rank-factored terms: a product of two depvar
    terms, a function of a depvar, an integral, an argument coupling the
    axes.  ``env`` maps each grid-axis name to ``(axis, nodes)``;
    ``grid_env`` is `_grid_env`'s, for the depvar calls' arguments."""
    ctx = gctx.ctx
    if isinstance(expr, Num):
        return None, expr.value
    if isinstance(expr, Sym):
        if expr.name not in env:
            raise _NotFactored(f"{expr.name!r} is no grid axis")
        return env[expr.name]
    if isinstance(expr, Param):
        return None, _gev(expr, grid_env, theta, p, gctx)
    if isinstance(expr, DepVarCall):
        return _call_terms(expr, {}, grid_env, theta, p, gctx)
    if isinstance(expr, Deriv):
        orders = _deriv_orders(expr, ctx)
        if orders is None:                  # ∂u/∂z, z not an input of u
            return None, 0.0
        return _call_terms(expr.target, orders, grid_env, theta, p, gctx)
    if not isinstance(expr, Call):
        raise _NotFactored(f"{type(expr).__name__} does not factor")
    vals = [_fev(a, env, grid_env, theta, p, gctx) for a in expr.args]
    op = expr.op
    if not any(isinstance(v, _Terms) for v in vals):
        axes = {axis for axis, _ in vals if axis is not None}
        if len(axes) <= 1:
            return (axes.pop() if axes else None,
                    PRIMITIVES[op](*(v for _, v in vals)))
        if op not in ("+", "-", "*", "/"):
            raise _NotFactored(f"{op!r} couples the grid axes")
        # a product of an axis-0 and an axis-1 value (or a sum) is rank 1
        vals = [_rank_one(*vals[0], gctx), vals[1]]
    if op == "neg":
        return vals[0].neg()
    if op in ("+", "-"):
        lhs, rhs = (v if isinstance(v, _Terms) else _rank_one(*v, gctx)
                    for v in vals)
        rhs = rhs.neg() if op == "-" else rhs
        return _Terms(lhs.a + rhs.a, lhs.b + rhs.b)
    if op == "*" and isinstance(vals[1], _Terms):
        vals = vals[::-1]
    if op in ("*", "/") and not isinstance(vals[1], _Terms):
        return vals[0].scaled(*vals[1], divide=op == "/")
    raise _NotFactored(f"{op!r} of a depvar term does not factor")


class _FactoredMsq(torch.autograd.Function):
    """``mean(r²)`` of ``r = aᵀ b``: one matrix product writes the grid,
    `sq_sum` reads it once; the backward is two products of the saved grid,
    ``da = s·b rᵀ`` and ``db = s·a r`` with ``s = 2ḡ/N``, scaled at their
    ``(rows, N)`` size, never at the grid's.  Only the leading ``rows``
    rows carry a gradient; the others' is 0."""

    @staticmethod
    def forward(ctx, a, b, acc, rows):
        r = torch.matmul(a.T, b)
        ctx.save_for_backward(a, b, r)
        ctx.rows = rows
        return (sq_sum(r) / r.numel()).to(r.dtype if acc is None else acc)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, b, r = ctx.saved_tensors
        s = (g.double() * (2.0 / r.numel())).to(r.dtype)
        rest = (0, 0, 0, a.shape[0] - ctx.rows)     # zero rows after them
        da = (torch.nn.functional.pad((b[:ctx.rows] @ r.T) * s, rest)
              if ctx.needs_input_grad[0] else None)
        db = (torch.nn.functional.pad((a[:ctx.rows] @ r) * s, rest)
              if ctx.needs_input_grad[1] else None)
        return da, db, None, None


def factored_msq(a, b, acc, rows):
    """``_msq(aᵀ b, acc)``, the mean square of a residual grid given as its
    factor matrices ``a`` ``(K, N_0)`` and ``b`` ``(K, N_1)``, with the sum
    of squares taken in float64 (`kernels.sq_sum`).  Only the leading
    ``rows`` rows get a gradient: the rest must be constants."""
    return _FactoredMsq.apply(a, b, acc, rows)


def _theta_device(theta: dict) -> torch.device:
    """The device of the parameters; with none, no device is chosen for the
    caller (in particular not the CPU), so an empty ``theta`` raises."""
    for v in theta.values():
        return v.device
    raise ValueError("a separable residual needs parameters to take its "
                     "device from; theta is empty")


def _expr_residual(expr: Expr, axes, ctx: LoweringContext, nets: dict, dtype,
                   default_p=None):
    """Lower one (already-expanded) Expr to ``fn(nodes_list, theta) -> grid``
    over the given ordered ``axes``."""
    p_vals = None if default_p is None else [float(v) for v in default_p]
    top_orders = _top_orders(expr, ctx)

    def residual(nodes_list, theta):
        device = _theta_device(theta)
        nodes = [torch.as_tensor(n, dtype=dtype, device=device)
                 for n in nodes_list]
        gctx = _GridContext(ctx=ctx, nets=nets, nodes=nodes, k=len(axes),
                            dtype=dtype, device=device, top_orders=top_orders,
                            features={})
        out = _gev(expr, _grid_env(gctx, axes), theta, p_vals, gctx)
        grid_shape = tuple(n.shape[0] for n in nodes)
        out = torch.as_tensor(out, dtype=dtype, device=device)
        return torch.broadcast_to(out, grid_shape)

    return residual


def build_separable_residual(eq: Eq, ctx: LoweringContext, nets: dict, dtype,
                             default_p=None):
    """Lower one equation to ``residual(nodes_list, theta) -> grid tensor``.

    Returns ``(residual, axes)`` where ``axes`` is the ordered list of grid
    Syms (get_argument order); ``nodes_list`` supplies the per-axis 1-D node
    arrays in that order and the result has shape ``(N_1, …, N_k)``.
    """
    expr = Call("-", (expand_derivatives(eq.lhs), expand_derivatives(eq.rhs)))
    axes = [a for a in get_argument(eq, ctx.depvars) if isinstance(a, Sym)]
    return _expr_residual(expr, axes, ctx, nets, dtype, default_p), axes


def build_factored_residual(eq: Eq, ctx: LoweringContext, nets: dict, dtype,
                            theta, default_p=None):
    """Lower a two-axis equation to ``factors(nodes_list, theta) -> (a, b,
    rows)``, its residual grid ``aᵀ b`` as factor matrices ``(K, N_0)`` and
    ``(K, N_1)``, the terms that carry a gradient in the leading ``rows``
    rows, K padded with zero rows to a multiple of 4 (aligned operands for
    the matrix product; a zero row adds exactly 0); or None where the
    residual does not factor (`_fev`), which a probe with ``theta`` decides
    here, once."""
    expr = Call("-", (expand_derivatives(eq.lhs), expand_derivatives(eq.rhs)))
    axes = [a for a in get_argument(eq, ctx.depvars) if isinstance(a, Sym)]
    if len(axes) != 2:
        raise ValueError(f"the factored route takes two grid axes, not "
                         f"{len(axes)}")
    p_vals = None if default_p is None else [float(v) for v in default_p]
    top_orders = _top_orders(expr, ctx)

    def factors(nodes_list, theta):
        device = _theta_device(theta)
        nodes = [torch.as_tensor(n, dtype=dtype, device=device)
                 for n in nodes_list]
        gctx = _GridContext(ctx=ctx, nets=nets, nodes=nodes, k=2,
                            dtype=dtype, device=device, top_orders=top_orders,
                            features={})
        env = {s.name: (i, n) for i, (s, n) in enumerate(zip(axes, nodes))}
        out = _fev(expr, env, _grid_env(gctx, axes), theta, p_vals, gctx)
        terms = out if isinstance(out, _Terms) else _rank_one(*out, gctx)
        # the terms that carry a gradient first: the backward's products
        # take only their rows (the source's rows are constants)
        pairs = sorted(zip(terms.a, terms.b), key=lambda ab: not (
            ab[0].requires_grad or ab[1].requires_grad))
        rows = sum(x.shape[0] for x, y in pairs
                   if x.requires_grad or y.requires_grad)
        pad = -sum(x.shape[0] for x, _ in pairs) % 4
        zeros = [torch.zeros((pad, n.shape[0]), dtype=dtype, device=device)
                 for n in nodes]
        return (torch.cat([x for x, _ in pairs] + zeros[:1]),
                torch.cat([y for _, y in pairs] + zeros[1:]), rows)

    try:
        probe_residual(factors, 2, theta, dtype)
    except _NotFactored:
        return None
    return factors


def probe_residual(residual, n_axes: int, theta, dtype) -> None:
    """Evaluate ``residual`` once, without gradients, on a 2-node-per-axis
    grid on the parameters' device, so that factorization errors surface
    when the loss is built rather than at the first step."""
    device = _theta_device(theta)
    with torch.no_grad():
        residual([torch.zeros((2,), dtype=dtype, device=device)
                  for _ in range(n_axes)], theta)


def _axis_spans(pinnrep) -> dict:
    return {d.variables.name: (float(infimum(d.domain)),
                               float(supremum(d.domain)))
            for d in pinnrep.domains}


def static_axis_nodes(pinnrep, dx) -> dict:
    """Julia-range nodes per domain variable for grid spacing ``dx``
    (scalar or per-domain list)."""
    dxs = list(dx) if isinstance(dx, (list, tuple)) else [dx] * len(
        pinnrep.domains)
    spans = _axis_spans(pinnrep)
    return {d.variables.name: julia_range(*spans[d.variables.name], h)
            for d, h in zip(pinnrep.domains, dxs)}


class SeparableTraining(TrainingStrategy):
    """Tensor-product-grid training for `SeparableNet` chains (SPINN).

    * ``dx``: grid spacing (scalar or per-domain list): static Julia-range
      nodes per axis, like GridTraining but factorized.
    * ``points``: per-axis node count with ``resample=True`` drawing fresh
      uniform axis nodes every step (the collocation grid is the product of
      the per-axis draws).
    * ``causal``: a time variable (Sym or name) switches equations whose
      grid contains that axis to causality-respecting weighting: every time
      node is a slab, its mean-square residual over the other axes L_i gets
      weight ``exp(-causal_eps·Δt·Σ_{j<i} L_j)`` (no gradient), so late
      times only count once early times are resolved.  ``causal_eps=0``
      reduces exactly to the unweighted loss.
    * ``rad_candidates`` (resampling mode only): residual-adaptive axis
      sampling: each step draws that many uniform candidates per axis,
      evaluates the residual (no gradient) on the candidate grid, and
      resamples the ``points`` axis nodes from the per-axis marginals
      ``mean_other|r|^rad_k + rad_c·mean``; BCs keep uniform resampling.

    ``sampler``: the axis-node source, ``(n, lb, ub, generator) -> (n,)``
    with 0-d tensor bounds; `uniform_nodes` unless replaced (tests replace
    it to feed both packages the same nodes).  Draws are made per loss
    call, in equation order, axis by axis.

    Builds its own factorized losses from the symbolic equations; the
    pointwise datafree closures back the dense fallback.
    `PhysicsInformedNN(gradient_enhanced=w)` lowers the gPINN rows
    symbolically onto the grid, and ``remat=True`` checkpoints each grid
    residual.

    The route of each loss is chosen once, at build, from its expression:
    ``"factored"`` where the residual has exactly two grid axes and is a sum
    of rank-factored terms (`build_factored_residual`), with no causal
    weighting, gPINN rows or remat: the grid is written once by one matrix
    product and its mean square taken by `factored_msq`; ``"grid"`` where it
    is evaluated as a grid (`build_separable_residual`); ``"dense"`` where
    it cannot factorize at all (the dense fallback).  ``routes`` lists them
    in equation order, the PDE losses first.
    """

    def __init__(self, dx=None, *, points=None, resample: bool = False,
                 causal=None, causal_eps: float = 1.0,
                 rad_candidates: int | None = None, rad_k: float = 1.0,
                 rad_c: float = 1.0):
        if (dx is None) == (points is None):
            raise ValueError("give exactly one of dx= or points=")
        if points is not None and not resample:
            raise ValueError("points= requires resample=True (use dx= for a "
                             "static grid)")
        if rad_candidates is not None and points is None:
            raise ValueError("rad_candidates= needs the resampling mode "
                             "(points=..., resample=True)")
        self.dx = dx
        self.points = points
        self.resample = resample
        self.causal = (causal.name if isinstance(causal, Sym) else causal)
        self.causal_eps = causal_eps
        self.rad_candidates = rad_candidates
        self.rad_k = rad_k
        self.rad_c = rad_c
        self.sampler = uniform_nodes
        self._weight_fns = []
        self.routes = []

    def build(self, pinnrep, datafree_pde, datafree_bc):
        dtype, device = pinnrep.dtype, pinnrep.device
        acc = pinnrep.loss_accum_dtype
        phis = pinnrep.phi if pinnrep.multioutput else [pinnrep.phi]
        nets = {}
        for name, phi in zip(pinnrep.depvars, phis):
            if not isinstance(phi.module, SeparableNet):
                raise TypeError(
                    f"SeparableTraining requires every chain to be a "
                    f"SeparableNet; chain for {name!r} is "
                    f"{type(phi.module).__name__}")
            nets[name] = phi.module

        ctx = LoweringContext.from_pinnrep(pinnrep)
        spans = _axis_spans(pinnrep)
        static_nodes = (static_axis_nodes(pinnrep, self.dx)
                        if self.dx is not None else None)

        def bound(name):
            lo, hi = spans[name]
            return (torch.tensor(lo, dtype=dtype, device=device),
                    torch.tensor(hi, dtype=dtype, device=device))

        eps = self.causal_eps

        def causal_reduce(r, t_pos, dt, split):
            """Per-t-node causal weighting of a grid residual: one slab per
            grid node, the exponent discretizing w(t) = exp(-eps ∫₀ᵗ L) as
            ``Σ_{j<i} L_j·Δt`` (``mean(w·L)`` == plain mean-square at
            eps == 0).  ``split``: the residual dimension whose nodes are
            this rank's slice under a mesh (None: whole); the weights come
            from the global L, and the loss is the rank's share."""
            sq = r * r
            if acc is not None:
                sq = sq.to(acc)
            other = tuple(d for d in range(sq.ndim) if d != t_pos)
            L = torch.mean(sq, dim=other) if other else sq
            if split is None:
                Lg = L
            elif split == t_pos:        # the rank holds its time nodes
                Lg = gather_over_data(L.detach())
            else:                       # the rank's part of every node's mean
                Lg = sum_over_data(L.detach()) / data_size()
            csum = (torch.cumsum(Lg, dim=0) - Lg) * dt
            w = torch.exp(-eps * csum).detach()
            wl = (w if split != t_pos
                  else w.narrow(0, data_rank() * L.shape[0], L.shape[0]))
            return share(torch.mean(wl * L)), w

        ge = pinnrep.gradient_enhanced
        remat = pinnrep.remat
        theta0 = pinnrep.flat_init_params

        def make_loss(eq, allow_causal):
            residual, axes = build_separable_residual(
                eq, ctx, nets, dtype, pinnrep.default_p)
            for a in axes:
                if a.name not in spans:
                    raise ValueError(
                        f"equation variable {a.name!r} has no domain")
            stacked = False
            if allow_causal and ge:
                # gPINN on the factorized path: the rows ∂f/∂x_a come from
                # symbolic differentiation of the expanded residual, stacked
                # as leading rows like the dense ge_wrap rows
                expr = Call("-", (expand_derivatives(eq.lhs),
                                  expand_derivatives(eq.rhs)))
                sqrt_w = float(ge) ** 0.5
                try:
                    grad_res = [
                        _expr_residual(_simplify(symbolic_diff(expr, a)),
                                       axes, ctx, nets, dtype,
                                       pinnrep.default_p)
                        for a in axes]
                except ValueError as e:
                    raise ValueError(
                        "gradient_enhanced with SeparableTraining needs a "
                        "symbolically differentiable residual; "
                        f"lowering d/dx of {eq!r} failed: {e}") from e
                base = residual

                def residual(nodes, theta, base=base, grad_res=grad_res,
                             sqrt_w=sqrt_w):
                    rows = [base(nodes, theta)] + [
                        sqrt_w * g(nodes, theta) for g in grad_res]
                    return torch.stack(rows)

                stacked = True
            probe_residual(residual, len(axes), theta0, dtype)
            if remat:
                plain = residual

                def residual(nodes, theta, plain=plain):
                    return checkpoint(plain, nodes, theta, use_reentrant=False,
                                      preserve_rng_state=False)

            t_axis = None   # index into the grid-axis list (node sorting)
            t_pos = None    # index into the residual array dims (reduction)
            if allow_causal and self.causal is not None:
                names = [a.name for a in axes]
                if self.causal in names:
                    t_axis = names.index(self.causal)
                    t_pos = t_axis + (1 if stacked else 0)

            if static_nodes is not None:
                fixed = [torch.as_tensor(static_nodes[a.name], dtype=dtype,
                                         device=device) for a in axes]

                def nodes_of(generator, theta, fixed=fixed):
                    del generator, theta
                    return fixed
            elif self.rad_candidates and allow_causal and axes:
                nodes_of = self._rad_nodes(
                    [bound(a.name) for a in axes], t_axis, residual,
                    1 if stacked else 0)
            else:
                bounds = [bound(a.name) for a in axes]

                def nodes_of(generator, theta, bounds=bounds, t_axis=t_axis):
                    del theta
                    ns = []
                    for i, (lb, ub) in enumerate(bounds):
                        draw = self.sampler(self.points, lb, ub, generator)
                        if i == t_axis:
                            draw = torch.sort(draw).values  # causal cumsum order
                        ns.append(draw)
                    return ns

            row = 1 if stacked else 0   # the residual dimension of axis 0

            factors = None
            if len(axes) == 2 and t_pos is None and not stacked and not remat:
                factors = build_factored_residual(eq, ctx, nets, dtype,
                                                  theta0, pinnrep.default_p)
            if factors is not None:
                def loss(theta, generator, factors=factors,
                         nodes_of=nodes_of):
                    nodes, _ = _shard_nodes(nodes_of(generator, theta))
                    a, b, rows = factors(nodes, theta)
                    return share(factored_msq(a, b, acc, rows))
                return loss, "factored"

            if t_pos is None:
                def loss(theta, generator, residual=residual,
                         nodes_of=nodes_of):
                    nodes, _ = _shard_nodes(nodes_of(generator, theta))
                    return share(_msq(residual(nodes, theta), acc))
                return loss, "grid"

            lo, hi = spans[self.causal]
            n_t = (len(static_nodes[self.causal])
                   if static_nodes is not None else self.points)
            dt = (hi - lo) / max(n_t - 1, 1)

            def weighted(theta, generator, residual=residual,
                         nodes_of=nodes_of, t_pos=t_pos, dt=dt, row=row):
                nodes, split = _shard_nodes(nodes_of(generator, theta))
                return causal_reduce(residual(nodes, theta), t_pos, dt,
                                     None if split is None else row)

            self._weight_fns.append(lambda theta, generator:
                                    weighted(theta, generator)[1])
            return lambda theta, generator: weighted(theta, generator)[0], "grid"

        def dense_fallback(df, args, eq, why):
            """Pointwise evaluation of one non-factorizable equation on the
            same tensor grid the factorized equations train on.
            Causal/RAD weighting does not apply to routed equations."""
            sym_args = [a for a in args if isinstance(a, Sym)]
            if static_nodes is not None:
                n_total = 1
                for a in sym_args:
                    n_total *= len(static_nodes[a.name])
            else:
                n_total = self.points ** len(sym_args) if sym_args else 1
            if n_total > _DENSE_FALLBACK_MAX_POINTS:
                raise ValueError(
                    f"equation {eq!r} cannot factorize ({why}) and its dense "
                    f"fallback tensor grid has {n_total} points (> "
                    f"{_DENSE_FALLBACK_MAX_POINTS}) — coarsen the grid for "
                    "this problem or use a dense training strategy") from None
            warnings.warn(
                f"SeparableTraining: equation {eq!r} cannot factorize "
                f"({why}); evaluating it densely on the {n_total}-point "
                "tensor grid (remaining equations stay on the factorized "
                "fast path; causal/RAD weighting does not apply to this "
                "equation)", stacklevel=3)
            if static_nodes is not None:
                train_set = generate_training_sets(
                    pinnrep.domains, self.dx, [args], dtype, device)[0]
                return _mean_sq_loss(df, train_set, acc)

            bounds = [bound(a.name) if isinstance(a, Sym) else None
                      for a in args]

            def loss(theta, generator, df=df, bounds=bounds, args=args):
                cols = [torch.full((1,), float(a), dtype=dtype, device=device)
                        if b is None
                        else self.sampler(self.points, b[0], b[1], generator)
                        for a, b in zip(args, bounds)]
                grids = torch.meshgrid(*cols, indexing="ij")
                cord = torch.stack([g.reshape(-1) for g in grids])
                return _msq_at(df, cord, theta, acc)

            return loss

        def route(eq, df, args, allow_causal):
            try:
                loss, how = make_loss(eq, allow_causal)
            except (ValueError, NotImplementedError) as e:
                if not _is_factorization_error(e):
                    raise
                loss, how = dense_fallback(df, args, eq, str(e)), "dense"
            self.routes.append(how)
            return loss

        self._weight_fns = []
        self.routes = []
        pde_losses = [route(eq, df, args, True)
                      for eq, df, args in zip(pinnrep.eqs, datafree_pde,
                                              pinnrep.pde_args)]
        bc_losses = [route(bc, df, args, False)
                     for bc, df, args in zip(pinnrep.bcs, datafree_bc,
                                             pinnrep.bc_args)]
        return pde_losses, bc_losses

    def _rad_nodes(self, bounds, t_axis, residual, offset):
        """Axis-factorized RAD node draw: candidate tensor grid -> |r|^k
        marginals per axis -> categorical per-axis resample, all without
        gradient."""
        n_cand = int(self.rad_candidates)
        rad_k, rad_c = float(self.rad_k), float(self.rad_c)

        def nodes_of(generator, theta):
            cand = [self.sampler(n_cand, lb, ub, generator)
                    for lb, ub in bounds]
            with torch.no_grad():
                w = torch.abs(residual(cand, theta)) ** rad_k
            ns = []
            for i in range(len(bounds)):
                other = tuple(d for d in range(w.ndim) if d != i + offset)
                marg = torch.mean(w, dim=other) if other else w
                marg = marg + rad_c * torch.mean(marg)
                idx = torch.multinomial(marg + 1e-30, self.points,
                                        replacement=True, generator=generator)
                draw = cand[i][idx]
                if i == t_axis:
                    draw = torch.sort(draw).values
                ns.append(draw)
            return ns

        return nodes_of

    def causal_weights(self, theta, generator=None):
        """Per-time-node causal weights of each time-dependent equation (the
        convergence monitor: done when the last weight ≈ 1)."""
        if not self._weight_fns:
            raise ValueError(
                "causal_weights requires a discretized problem built with "
                "causal=<time var> (and at least one time-dependent equation)")
        return [f(theta, generator) for f in self._weight_fns]
