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
into a computation on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch

from ..nn.core import TrialFunction
from ..ops.derivatives import DerivativeEngine
from ..symbolic.expr import (
    PRIMITIVES, Call, DepVarCall, Deriv, Eq, Expr, IntegralExpr, Num, Param,
    Sym, expand_derivatives,
)


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
            param_estim=pinnrep.param_estim)


# ---------------------------------------------------------------------------
# Equation analysis (get_argument / get_variables analogs)
# ---------------------------------------------------------------------------

def _walk(expr: Expr):
    yield expr
    if isinstance(expr, Call):
        for a in expr.args:
            yield from _walk(a)
    elif isinstance(expr, Deriv):
        yield from _walk(expr.target)
    elif isinstance(expr, DepVarCall):
        for a in expr.args:
            yield from _walk(a)
    elif isinstance(expr, IntegralExpr):
        yield from _walk(expr.integrand)
        for b in expr.lb + expr.ub:
            if isinstance(b, Expr):
                yield from _walk(b)


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


def _ev(expr: Expr, env: dict, theta, p, ctx: LoweringContext, N: int):
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
        vals = [_ev(a, env, theta, p, ctx, N) for a in expr.args]
        return PRIMITIVES[expr.op](*vals)
    if isinstance(expr, DepVarCall):
        theta_u = ctx.theta_for(expr.name, theta)
        cord_u = _depvar_cord(expr, env, theta, p, ctx, N)
        return TrialFunction(ctx.module_for(expr.name), theta_u)(cord_u)[0]
    if isinstance(expr, Deriv):
        return _ev_deriv(expr, env, theta, p, ctx, N)
    if isinstance(expr, IntegralExpr):
        raise NotImplementedError(
            "integral terms are not ported yet (the quadrature slice of the "
            "port)")
    raise TypeError(f"cannot lower {type(expr).__name__}")


def _depvar_cord(call: DepVarCall, env, theta, p, ctx, N):
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
        v = _ev(a, env, theta, p, ctx, N)
        if isinstance(v, torch.Tensor):
            v = torch.broadcast_to(v, (N,))
            if v.is_floating_point():
                v = v.to(like.dtype)
        else:
            v = torch.full((N,), float(v), dtype=like.dtype, device=like.device)
        rows.append(v)
    return torch.stack(rows, dim=0)


def _ev_deriv(expr: Deriv, env, theta, p, ctx, N):
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
    cord_u = _depvar_cord(target, env, theta, p, ctx, N)
    u_fn = TrialFunction(ctx.module_for(target.name), theta_u)
    return ctx.derivative(u_fn, cord_u, var_indices, len(inputs))[0]


# ---------------------------------------------------------------------------
# Public entry: build the residual closure for one equation
# ---------------------------------------------------------------------------

def build_residual_function(eq: Eq, row_layout: Sequence, ctx: LoweringContext,
                            default_p=None) -> Callable:
    """Lower one equation into ``residual(cord, theta) -> (N,)``.

    ``row_layout`` gives, per cord row, the Sym bound to that row (or None for
    constant rows kept only for train-set shape parity with the reference).
    ``default_p`` is closed over for non-estimated parameters
    (reference: src/discretize.jl:172 binds default_p the same way).
    """
    if any(isinstance(n, IntegralExpr) for side in (eq.lhs, eq.rhs)
           for n in _walk(side)):
        raise NotImplementedError(
            "integral terms are not ported yet (the quadrature slice of the "
            "port)")
    expr = Call("-", (expand_derivatives(eq.lhs), expand_derivatives(eq.rhs)))
    sym_rows = [(i, s) for i, s in enumerate(row_layout) if isinstance(s, Sym)]
    p_vals = None if default_p is None else [float(v) for v in default_p]

    def residual(cord, theta):
        N = cord.shape[1]
        env = {s.name: cord[i] for i, s in sym_rows}
        out = _ev(expr, env, theta, p_vals, ctx, N)
        if not isinstance(out, torch.Tensor):
            return torch.full((N,), float(out), dtype=cord.dtype,
                              device=cord.device)
        return torch.broadcast_to(out, (N,))

    return residual


# reference export-name alias (src/NeuralPDE.jl:90-116 exports build_loss_function)
build_loss_function = build_residual_function
