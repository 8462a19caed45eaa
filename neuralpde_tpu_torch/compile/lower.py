"""Lowering: symbolic equations -> residual functions of tensors.

The counterpart of `neuralpde_tpu.compile.lower`: a recursive evaluator over
the expression IR produces

    residual(cord, theta) -> (N,) residual values

where ``cord`` is the `(rows, N)` collocation matrix whose row layout is the
equation's argument list (`get_argument`), and ``theta`` the flat parameter
dict (``"depvar.layer_0.weight"``, ..., and ``"p"`` for estimated PDE
parameters).

Every tensor the evaluator creates takes the device and dtype of the
parameters or collocation points it works on, so constants (``u(0.0, y)``,
a zero derivative, a literal residual) never bring a CPU or float64 tensor
into a computation on the card.  Integral terms become batched fixed-shape
Gauss-Legendre quadrature whose node and weight tensors are kept on the
device (`ops.quadrature.rule_tensors`), so a step that integrates can be
captured as a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..nn.core import TrialFunction
from ..ops.derivatives import DerivativeEngine, JetPasses
from ..ops.quadrature import adaptive_quad_1d, adaptive_quad_nd, rule_tensors
from ..symbolic.expr import (
    PRIMITIVES, Call, DepVarCall, Deriv, Eq, Expr, IntegralExpr, Num, Param,
    Sym, expand_derivatives,
)
from .transform_inf import transform_inf_integral


def depvar_params(theta: dict, name: str | None = None) -> dict:
    """The parameters of one dependent variable's module, under the module's
    own names: ``theta["depvar.layer_0.weight"]`` -> ``"layer_0.weight"``
    (with ``name``, ``"depvar.<name>.layer_0.weight"``)."""
    prefix = "depvar." if name is None else f"depvar.{name}."
    return {k[len(prefix):]: v for k, v in theta.items() if k.startswith(prefix)}


@dataclass
class LoweringContext:
    """Static compile context shared by all equations of a system."""

    depvars: list            # depvar names, declaration order
    indvars: list            # indvar names, declaration order
    dict_depvar_input: dict  # depvar name -> list of canonical input var names
    modules: list            # per-depvar nn.Module: (dim_u, N) -> (1, N)
    multioutput: bool
    derivative: DerivativeEngine
    eq_params: list = field(default_factory=list)  # Param names, order of ps
    param_estim: bool = False
    integral_order: int = 20
    integral_panels: int = 1

    def theta_for(self, name, theta):
        return depvar_params(theta, name if self.multioutput else None)

    def module_for(self, name):
        return self.modules[self.depvars.index(name)]

    @classmethod
    def from_pinnrep(cls, pinnrep) -> "LoweringContext":
        """Rebuild the compile context of an existing `PINNRepresentation`
        (the separable and Gauss-Newton re-lowering entry point)."""
        phis = pinnrep.phi if pinnrep.multioutput else [pinnrep.phi]
        return cls(
            depvars=pinnrep.depvars, indvars=pinnrep.indvars,
            dict_depvar_input=pinnrep.dict_depvar_input,
            modules=[p.module for p in phis], multioutput=pinnrep.multioutput,
            derivative=pinnrep.derivative, eq_params=pinnrep.eq_params,
            param_estim=pinnrep.param_estim,
            integral_order=pinnrep.integral_order,
            integral_panels=pinnrep.integral_panels)


# ---------------------------------------------------------------------------
# Equation analysis (get_argument / get_variables analogs)
# ---------------------------------------------------------------------------

def _walk(expr: Expr, integrands: bool = True):
    """Every node of ``expr``; with ``integrands=False``, only those that
    one evaluation environment evaluates (an integrand is evaluated at its
    own nodes, its bounds are not)."""
    yield expr
    if isinstance(expr, Call):
        for a in expr.args:
            yield from _walk(a, integrands)
    elif isinstance(expr, Deriv):
        yield from _walk(expr.target, integrands)
    elif isinstance(expr, DepVarCall):
        for a in expr.args:
            yield from _walk(a, integrands)
    elif isinstance(expr, IntegralExpr):
        if integrands:
            yield from _walk(expr.integrand)
        for b in expr.lb + expr.ub:
            if isinstance(b, Expr):
                yield from _walk(b, integrands)


def _eq_expr(eq: Eq) -> Expr:
    return Call("-", (eq.lhs, eq.rhs))


def first_depvar_calls(eq: Eq, depvars: Sequence[str]) -> list:
    """First call of each depvar appearing in the equation, depvar order
    (mirrors get_argument's find_thing_in_expr pass, reference:
    src/symbolic_utilities.jl:502-526)."""
    calls = {}
    for node in _walk(_eq_expr(eq)):
        if isinstance(node, DepVarCall) and node.name not in calls:
            calls[node.name] = node
    return [calls[d] for d in depvars if d in calls]


def get_argument(eq: Eq, depvars: Sequence[str]) -> list:
    """Training-set column layout: call args of each depvar, symbols deduped
    (first occurrence), numbers kept (reference: src/symbolic_utilities.jl:502-526)."""
    args = []
    seen = set()
    for call in first_depvar_calls(eq, depvars):
        for a in call.args:
            if isinstance(a, Sym):
                if a.name not in seen:
                    seen.add(a.name)
                    args.append(a)
            elif isinstance(a, Num):
                args.append(a.value)
            else:
                # computed argument: its free symbols are collected instead
                for sub in _walk(a):
                    if isinstance(sub, Sym) and sub.name not in seen:
                        seen.add(sub.name)
                        args.append(sub)
    return args


def get_variables(eq: Eq, depvars: Sequence[str]) -> list:
    """Symbols of get_argument (reference: src/symbolic_utilities.jl:465-468)."""
    return [a for a in get_argument(eq, depvars) if isinstance(a, Sym)]


def get_integration_variables(eq: Eq) -> list:
    out = []
    for node in _walk(_eq_expr(eq)):
        if isinstance(node, IntegralExpr):
            out.extend(v for v in node.ivars if v not in out)
    return out


def jet_groups(expr: Expr, ctx: LoweringContext) -> dict:
    """``{(call, order): input slots}``: for each dependent-variable call
    of ``expr`` (``repr`` of the call: the same name at the same
    arguments, so one network input) and each order >= 2, the slots of its
    pure partials of that order, in order of first appearance.  One Taylor
    pass takes each group (`JetPasses`).  Integrands are left out: they
    are evaluated at their own nodes, one partial a pass.  Empty unless
    the engine's mode is "jet", the only one that takes Taylor passes."""
    groups: dict = {}
    if ctx.derivative.mode != "jet":
        return groups
    for node in _walk(expr, integrands=False):
        if not (isinstance(node, Deriv) and isinstance(node.target,
                                                       DepVarCall)):
            continue
        inputs = ctx.dict_depvar_input[node.target.name]
        name = node.wrt[0].name
        if (node.order < 2 or name not in inputs
                or any(w.name != name for w in node.wrt)):
            continue
        slots = groups.setdefault((repr(node.target), node.order), [])
        if inputs.index(name) not in slots:
            slots.append(inputs.index(name))
    return {k: tuple(v) for k, v in groups.items()}


def free_symbols(eq: Eq) -> list:
    """The equation's Syms, in order of first appearance."""
    out = []
    for node in _walk(_eq_expr(eq)):
        if isinstance(node, Sym) and node not in out:
            out.append(node)
    return out


# ---------------------------------------------------------------------------
# Recursive evaluator
# ---------------------------------------------------------------------------

def _first_tensor(params: dict, env: dict) -> torch.Tensor:
    """A tensor whose device and dtype new tensors follow: the module's
    first parameter (EltypeAdaptor semantics), else a collocation row."""
    for v in params.values():
        return v
    for v in env.values():
        if isinstance(v, torch.Tensor):
            return v
    raise ValueError("no parameter or collocation row to take a device from")


def _ev(expr: Expr, env: dict, theta, p, ctx: LoweringContext, N: int,
        jets: JetPasses | None = None):
    """The value of ``expr`` at the collocation rows ``env``; ``jets``
    holds the evaluation's shared Taylor passes (None: one pass a
    partial)."""
    if isinstance(expr, Num):
        return expr.value
    if isinstance(expr, Sym):
        try:
            return env[expr.name]
        except KeyError:
            raise KeyError(
                f"variable {expr.name!r} is unbound in this equation's "
                f"collocation layout {sorted(env)}"
            ) from None
    if isinstance(expr, Param):
        idx = ctx.eq_params.index(expr.name)
        if ctx.param_estim:
            return theta["p"][idx]
        if p is None:
            raise ValueError(f"parameter {expr.name!r} has no default value")
        return p[idx]
    if isinstance(expr, Call):
        vals = [_ev(a, env, theta, p, ctx, N, jets) for a in expr.args]
        return PRIMITIVES[expr.op](*vals)
    if isinstance(expr, DepVarCall):
        theta_u = ctx.theta_for(expr.name, theta)
        cord_u = _depvar_cord(expr, env, theta, p, ctx, N, jets)
        return TrialFunction(ctx.module_for(expr.name), theta_u)(cord_u)[0]
    if isinstance(expr, Deriv):
        return _ev_deriv(expr, env, theta, p, ctx, N, jets)
    if isinstance(expr, IntegralExpr):
        return _ev_integral(expr, env, theta, p, ctx, N, jets)
    raise TypeError(f"cannot lower {type(expr).__name__}")


def _depvar_cord(call: DepVarCall, env, theta, p, ctx, N, jets=None):
    """Network-input matrix (dim_u, N) from call args in canonical order
    (the `cordᵢ = vcat(...)` header, reference: src/discretize.jl:111-115).
    Rows take the parameters' dtype and device (EltypeAdaptor semantics,
    reference: src/eltype_matching.jl)."""
    want = len(ctx.dict_depvar_input[call.name])
    if len(call.args) != want:
        raise ValueError(
            f"{call.name} called with {len(call.args)} args, declared with {want}"
        )
    like = _first_tensor(ctx.theta_for(call.name, theta), env)
    rows = []
    for a in call.args:
        v = _ev(a, env, theta, p, ctx, N, jets)
        if isinstance(v, torch.Tensor):
            v = torch.broadcast_to(v, (N,))
            if v.is_floating_point():
                v = v.to(like.dtype)
        else:
            v = torch.full((N,), float(v), dtype=like.dtype, device=like.device)
        rows.append(v)
    return torch.stack(rows, dim=0)


def _ev_deriv(expr: Deriv, env, theta, p, ctx, N, jets=None):
    target = expr.target
    if not isinstance(target, DepVarCall):
        raise ValueError(
            f"derivative target {target!r} is not a dependent-variable call; "
            "run expand_derivatives first"
        )
    inputs = ctx.dict_depvar_input[target.name]
    theta_u = ctx.theta_for(target.name, theta)
    var_indices = []
    for w in expr.wrt:
        if w.name not in inputs:
            # ∂u/∂z with z not an input of u
            like = _first_tensor(theta_u, env)
            return torch.zeros((N,), dtype=like.dtype, device=like.device)
        var_indices.append(inputs.index(w.name))
    # The derivative is wrt the network's input slot; the call argument at that
    # position may be a constant (Neumann BC `Dx(u(0, y))`) or any expression —
    # the stencil/jvp shifts the evaluated row (reference semantics: the FD
    # engine shifts the bound cord row, src/pinn_types.jl:421-458).
    u_fn = TrialFunction(ctx.module_for(target.name), theta_u)
    if jets is not None:
        shared = jets.partial(
            repr(target), u_fn,
            lambda: _depvar_cord(target, env, theta, p, ctx, N, jets),
            var_indices)
        if shared is not None:
            return shared[0]
    cord_u = _depvar_cord(target, env, theta, p, ctx, N, jets)
    return ctx.derivative(u_fn, cord_u, var_indices, len(inputs))[0]


def _like(env: dict, theta: dict) -> torch.Tensor:
    """The tensor whose device and dtype an integral's nodes follow: a
    collocation row (the problem's dtype), else a parameter."""
    for v in env.values():
        if isinstance(v, torch.Tensor):
            return v
    for k, v in theta.items():
        if k.startswith("depvar."):
            return v
    raise ValueError("no collocation row or parameter to take a device from")


def _row(v, n: int, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a number or a tensor) as an ``(n,)`` tensor of ``like``'s
    device, and of its dtype unless ``v`` is a tensor of another float
    dtype there (`jnp.broadcast_to`, without promoting a float32 problem:
    a Python number or a folded constant takes the dtype of ``like``)."""
    if isinstance(v, torch.Tensor) and v.ndim == 0 \
            and v.device != like.device:
        v = float(v)        # a constant folded on the host
    if isinstance(v, torch.Tensor):
        return torch.broadcast_to(v, (n,))
    return torch.full((n,), float(v), dtype=like.dtype, device=like.device)


def _spread(env: dict, n: int, q: int) -> dict:
    """Every row of ``env`` repeated for the ``q`` nodes of each of its
    ``n`` columns, flattened to ``(n*q,)`` (column-major in the nodes)."""
    return {k: (torch.broadcast_to(v[..., None], (n, q)).reshape(-1)
                if isinstance(v, torch.Tensor) else v)
            for k, v in env.items()}


def _ev_integral(expr: IntegralExpr, env, theta, p, ctx, N, jets=None):
    """Integral terms -> batched static-shape Gauss-Legendre quadrature.

    The reference solves one adaptive IntegralProblem per collocation column
    in a host loop (src/discretize.jl:387-394); here the integrand of every
    column is evaluated at all its nodes in one batch of ``N * Q`` columns.
    The bounds take the evaluation's shared passes ``jets``; the integrand,
    at its own nodes, takes one pass a partial.
    """
    expr = transform_inf_integral(expr)
    ndims = len(expr.ivars)
    like = _like(env, theta)

    def bound(b):
        return _row(_ev(b, env, theta, p, ctx, N, jets)
                    if isinstance(b, Expr) else b, N, like)

    if ndims == 1:
        nu, wu = rule_tensors(1, ctx.integral_order, ctx.integral_panels,
                              like.dtype, like.device)
        Q = wu.shape[0]
        lb, ub = bound(expr.lb[0]), bound(expr.ub[0])
        scale = ub - lb                                       # (N,)
        nodes = lb[:, None] + scale[:, None] * nu[0][None, :]   # (N, Q)
        env_flat = _spread(env, N, Q)
        env_flat[expr.ivars[0].name] = nodes.reshape(-1)
        vals = _ev(expr.integrand, env_flat, theta, p, ctx, N * Q)
        vals = _row(vals, N * Q, like).reshape(N, Q)
        return torch.sum(vals * wu[None, :], dim=-1) * scale

    # n-D with parametric bounds: rewrite as iterated 1-D integrals
    # (outermost = first ivar; inner bounds may reference outer ivars,
    # reference: ProductDomain(UnitInterval(), ClosedInterval(0, x)) in
    # ide__integrodiff_example_4)
    if any(isinstance(b, Expr) and not isinstance(b, Num)
           for b in expr.lb + expr.ub):
        inner = IntegralExpr(expr.integrand, expr.ivars[1:],
                             expr.lb[1:], expr.ub[1:])
        outer = IntegralExpr(inner, expr.ivars[:1], expr.lb[:1], expr.ub[:1])
        return _ev_integral(outer, env, theta, p, ctx, N, jets)

    # n-D, static numeric bounds: tensor rule on the unit cube
    lbs = [b.value if isinstance(b, Num) else float(b) for b in expr.lb]
    ubs = [b.value if isinstance(b, Num) else float(b) for b in expr.ub]
    nodes_u, weights_u = rule_tensors(ndims, ctx.integral_order,
                                      ctx.integral_panels, like.dtype,
                                      like.device)
    Q = weights_u.shape[0]
    vol = float(np.prod(np.subtract(ubs, lbs)))
    env_flat = _spread(env, N, Q)
    for d, iv in enumerate(expr.ivars):
        nd = lbs[d] + (ubs[d] - lbs[d]) * nodes_u[d]          # (Q,)
        env_flat[iv.name] = torch.broadcast_to(nd[None, :], (N, Q)).reshape(-1)
    vals = _ev(expr.integrand, env_flat, theta, p, ctx, N * Q)
    vals = _row(vals, N * Q, like).reshape(N, Q)
    return torch.sum(vals * weights_u[None, :], dim=-1) * vol


# ---------------------------------------------------------------------------
# Public entry: build the residual closure for one equation
# ---------------------------------------------------------------------------

def _p_values(default_p):
    return None if default_p is None else [float(v) for v in default_p]


def get_numeric_integral(ctx: LoweringContext, default_p=None, *,
                         adaptive: bool = False, reltol: float = 1e-6,
                         abstol: float = 1e-3, maxiters: int = 1000):
    """Debugging helper (reference export: src/discretize.jl:332-396): returns
    ``integral(expr, cord, theta, env_syms)`` evaluating an IntegralExpr at the
    columns of ``cord`` (rows bound to ``env_syms`` in order; ``cord`` takes
    the parameters' device and dtype).

    ``adaptive=True`` switches to the runtime h-adaptive host path honoring
    reltol/abstol/maxiters — per-column adaptive solves exactly as the
    reference's per-column IntegralProblem loop (src/discretize.jl:387-394):
    QuadGKJL-style interval bisection for 1-D integrals, CubatureJLh-style
    box bisection (`ops.quadrature.adaptive_quad_nd`) for n-D.  The integrand
    runs on the parameters' device, the bisection on the host, and no
    gradient flows: use it for evaluation parity, not inside a loss."""
    p_vals = _p_values(default_p)

    def integral(expr: IntegralExpr, cord, theta, env_syms: Sequence[Sym]):
        like = next(iter(theta.values()))
        cord = torch.atleast_2d(torch.as_tensor(cord)).to(
            device=like.device, dtype=like.dtype)
        N = cord.shape[1]
        if not adaptive:
            env = {s.name: cord[i] for i, s in enumerate(env_syms)}
            return _ev_integral(expr, env, theta, p_vals, ctx, N)

        expr_t = transform_inf_integral(expr)
        ivars = [v.name for v in expr_t.ivars]
        outs = []

        def bound(b, env_j):
            return (float(_ev(b, env_j, theta, p_vals, ctx, 1))
                    if isinstance(b, Expr) else float(b))

        def integrand(env_j, rows: dict, n: int):
            v = _ev(expr_t.integrand, {**env_j, **rows}, theta, p_vals, ctx, n)
            return _row(v, n, cord)

        with torch.no_grad():
            for j in range(N):
                env_j = {s.name: cord[i, j] for i, s in enumerate(env_syms)}
                lbs = [bound(b, env_j) for b in expr_t.lb]
                ubs = [bound(b, env_j) for b in expr_t.ub]

                def f(nodes, env_j=env_j):
                    nodes = torch.as_tensor(np.atleast_2d(nodes),
                                            dtype=cord.dtype,
                                            device=cord.device)
                    return integrand(env_j, dict(zip(ivars, nodes)),
                                     nodes.shape[1])

                if len(ivars) == 1:
                    val, _err = adaptive_quad_1d(f, lbs[0], ubs[0],
                                                 reltol=reltol, abstol=abstol,
                                                 maxiters=maxiters)
                else:
                    val, _err = adaptive_quad_nd(f, lbs, ubs, reltol=reltol,
                                                 abstol=abstol,
                                                 maxiters=maxiters)
                outs.append(val)
        return torch.as_tensor(np.stack(outs), dtype=cord.dtype,
                               device=cord.device)

    return integral


def build_residual_function(eq: Eq, row_layout: Sequence, ctx: LoweringContext,
                            default_p=None) -> Callable:
    """Lower one equation into ``residual(cord, theta) -> (N,)``.

    ``row_layout`` gives, per cord row, the Sym bound to that row (or None for
    constant rows kept only for train-set shape parity with the reference).
    ``default_p`` is closed over for non-estimated parameters
    (reference: src/discretize.jl:172 binds default_p the same way).
    Each evaluation takes the pure partials of one order of one call from
    one Taylor pass (`jet_groups`, collected here; `JetPasses`).
    """
    expr = Call("-", (expand_derivatives(eq.lhs), expand_derivatives(eq.rhs)))
    sym_rows = [(i, s) for i, s in enumerate(row_layout) if isinstance(s, Sym)]
    p_vals = _p_values(default_p)
    groups = jet_groups(expr, ctx)

    def residual(cord, theta):
        N = cord.shape[1]
        env = {s.name: cord[i] for i, s in sym_rows}
        out = _ev(expr, env, theta, p_vals, ctx, N,
                  JetPasses(ctx.derivative, groups) if groups else None)
        if not isinstance(out, torch.Tensor):
            return torch.full((N,), float(out), dtype=cord.dtype,
                              device=cord.device)
        return torch.broadcast_to(out, (N,))

    return residual


# reference export-name alias (src/NeuralPDE.jl:90-116 exports build_loss_function)
build_loss_function = build_residual_function
