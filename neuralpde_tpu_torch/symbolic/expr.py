"""Lightweight symbolic expression IR (ModelingToolkit/Symbolics replacement).

The same sympy-free expression tree as `neuralpde_tpu.symbolic.expr`, with
its numeric op table (`PRIMITIVES`) in PyTorch.  It is lowered by
`neuralpde_tpu_torch.compile.lower` into residual functions of tensors.

Node types:
  Sym          — independent variable (x, t, ...)
  Param        — symbolic scalar parameter of the PDE (σ, ρ, ...; inverse problems)
  Num          — numeric literal
  Call         — elementwise primitive application ("+", "sin", ...)
  DepVarCall   — dependent-variable application u(x, y)
  Deriv        — (mixed) partial derivative of a DepVarCall
  IntegralExpr — definite integral over one/more independent variables
  Eq           — equation lhs ~ rhs
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


class Expr:
    """Base class; supports arithmetic operator overloading."""

    def __add__(self, o):
        return Call("+", (self, wrap(o)))

    def __radd__(self, o):
        return Call("+", (wrap(o), self))

    def __sub__(self, o):
        return Call("-", (self, wrap(o)))

    def __rsub__(self, o):
        return Call("-", (wrap(o), self))

    def __mul__(self, o):
        return Call("*", (self, wrap(o)))

    def __rmul__(self, o):
        return Call("*", (wrap(o), self))

    def __truediv__(self, o):
        return Call("/", (self, wrap(o)))

    def __rtruediv__(self, o):
        return Call("/", (wrap(o), self))

    def __pow__(self, o):
        return Call("^", (self, wrap(o)))

    def __rpow__(self, o):
        return Call("^", (wrap(o), self))

    def __neg__(self):
        return Call("neg", (self,))

    def __pos__(self):
        return self

    # a ~ b  (Julia's equation syntax) -> Eq
    def __invert__(self):
        raise TypeError("use Eq(lhs, rhs) or lhs.eq(rhs)")

    def eq(self, other) -> "Eq":
        return Eq(self, wrap(other))


class Sym(Expr):
    """Independent variable."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return self.name

    def __hash__(self):
        return hash(("Sym", self.name))

    def __eq__(self, o):
        return isinstance(o, Sym) and o.name == self.name


class Param(Expr):
    """Symbolic scalar PDE parameter (maps to `p[i]` / `θ.p[i]` at runtime;
    reference: src/discretize.jl:82-109)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return self.name

    def __hash__(self):
        return hash(("Param", self.name))

    def __eq__(self, o):
        return isinstance(o, Param) and o.name == self.name


class Num(Expr):
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = float(value)

    def __repr__(self):
        return repr(self.value)


def wrap(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, float)):
        return Num(x)
    # 0-d numpy/torch scalars, e.g. npde.exp(0.0) evaluated numerically
    # before entering a symbolic product (concrete values only)
    if getattr(x, "shape", None) == ():
        try:
            return Num(float(x))
        except TypeError:
            pass
    raise TypeError(f"cannot use {type(x).__name__} in a symbolic expression")


class Call(Expr):
    __slots__ = ("op", "args")

    def __init__(self, op: str, args: Sequence[Expr]):
        self.op = op
        self.args = tuple(wrap(a) for a in args)

    def __repr__(self):
        if self.op in _BINOPS:
            return f"({self.args[0]} {self.op} {self.args[1]})"
        return f"{self.op}({', '.join(map(repr, self.args))})"


class DepVar:
    """Dependent-variable *symbol*; calling it produces a DepVarCall.

    `u = DepVar("u")`; `u(x, y)` in an equation.  Declared canonical inputs
    come from the PDESystem's `dvs` list (e.g. `dvs=[u(x, y)]`), mirroring
    `dict_depvar_input` (reference: src/symbolic_utilities.jl:401-426).
    """

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, *args) -> "DepVarCall":
        return DepVarCall(self.name, tuple(wrap(a) for a in args))

    def __repr__(self):
        return self.name


class DepVarCall(Expr):
    __slots__ = ("name", "args")

    def __init__(self, name: str, args: Sequence[Expr]):
        self.name = name
        self.args = tuple(args)

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


class Deriv(Expr):
    """(∏_k ∂/∂ wrt[k]) target — target must be a DepVarCall after
    `expand_derivatives`."""

    __slots__ = ("target", "wrt")

    def __init__(self, target: Expr, wrt: Sequence[Sym]):
        self.target = target
        self.wrt = tuple(wrt)

    @property
    def order(self) -> int:
        return len(self.wrt)

    def __repr__(self):
        ws = "".join(f"∂{w.name}" for w in self.wrt)
        return f"{ws}({self.target})"


class Differential:
    """`Differential(x)` is an operator: `Differential(x)(u(x,y))`.

    Supports composition (`Dx(Dy(u(x,y)))`) and repeated application
    (`Differential(x, 2)`), mirroring ModelingToolkit's `Differential(x)^2`.
    """

    def __init__(self, var: Sym, order: int = 1):
        self.var = var
        self.order = order

    def __pow__(self, n: int):
        return Differential(self.var, self.order * n)

    def __call__(self, expr) -> Deriv:
        expr = wrap(expr)
        wrt = (self.var,) * self.order
        if isinstance(expr, Deriv):
            return Deriv(expr.target, wrt + expr.wrt)
        return Deriv(expr, wrt)


class IntegralExpr(Expr):
    """∫ integrand d(ivars) with bounds lb..ub (numbers, ±inf, or Exprs)."""

    __slots__ = ("integrand", "ivars", "lb", "ub")

    def __init__(self, integrand: Expr, ivars: Sequence[Sym], lb, ub):
        self.integrand = wrap(integrand)
        self.ivars = tuple(ivars)
        self.lb = tuple(lb if isinstance(lb, (tuple, list)) else [lb])
        self.ub = tuple(ub if isinstance(ub, (tuple, list)) else [ub])

    def __repr__(self):
        vs = ",".join(v.name for v in self.ivars)
        return f"Integral[{vs}:{self.lb}..{self.ub}]({self.integrand})"


class Integral:
    """`Integral(x, lb, ub)` or `Integral((x, y), (lx, ly), (ux, uy))` operator,
    mirroring `Symbolics.Integral(x in DomainSets.ClosedInterval(lb, ub))`."""

    def __init__(self, var, lb, ub):
        self.ivars = tuple(var) if isinstance(var, (tuple, list)) else (var,)
        self.lb = lb
        self.ub = ub

    def __call__(self, integrand) -> IntegralExpr:
        return IntegralExpr(wrap(integrand), self.ivars, self.lb, self.ub)


class Eq:
    """lhs ~ rhs."""

    __slots__ = ("lhs", "rhs")

    def __init__(self, lhs, rhs):
        self.lhs = wrap(lhs)
        self.rhs = wrap(rhs)

    def __repr__(self):
        return f"{self.lhs} ~ {self.rhs}"


# ---------------------------------------------------------------------------
# Primitive registry: numeric implementation + symbolic derivative rule
# ---------------------------------------------------------------------------

_BINOPS = {"+", "-", "*", "/", "^"}


def _on_tensors(fn):
    """Wrap a torch op that takes tensors only.  Python numbers become
    tensors on the device and dtype of the first tensor argument, so no CPU
    or float64 constant enters a graph on the card; with no tensor argument
    (constant folding) they become float64 scalars."""

    def op(*args):
        like = next((a for a in args if isinstance(a, torch.Tensor)), None)
        if like is None:
            args = [torch.tensor(float(a), dtype=torch.float64) for a in args]
        else:
            args = [a if isinstance(a, torch.Tensor)
                    else torch.full((), float(a), dtype=like.dtype,
                                    device=like.device)
                    for a in args]
        return fn(*args)

    op.__name__ = getattr(fn, "__name__", "op")
    return op


def _pow(a, b):
    """``a ** b``.  A Python-number exponent or base stays a number
    (``torch.pow(Tensor, float)``, ``torch.pow(float, Tensor)``): as a
    tensor it would carry a tangent of its own, and the backward pass through
    ``u**e · log(u) · ė`` (ė = 0) is NaN at a negative base, as in the
    gradient of a gPINN row.  With no tensor argument (constant folding) both
    become float64 scalars."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.pow(a, b)
    return torch.pow(torch.tensor(float(a), dtype=torch.float64), float(b))


PRIMITIVES = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "^": _pow,
    "neg": lambda a: -a,
    "sin": _on_tensors(torch.sin),
    "cos": _on_tensors(torch.cos),
    "tan": _on_tensors(torch.tan),
    "asin": _on_tensors(torch.asin),
    "acos": _on_tensors(torch.acos),
    "atan": _on_tensors(torch.atan),
    "sinh": _on_tensors(torch.sinh),
    "cosh": _on_tensors(torch.cosh),
    "tanh": _on_tensors(torch.tanh),
    "exp": _on_tensors(torch.exp),
    "log": _on_tensors(torch.log),
    "sqrt": _on_tensors(torch.sqrt),
    "abs": _on_tensors(torch.abs),
    "erf": _on_tensors(torch.special.erf),
    "sigmoid": _on_tensors(torch.sigmoid),
    "min": _on_tensors(torch.minimum),
    "max": _on_tensors(torch.maximum),
}


def _make_fn(opname):
    def f(x):
        if isinstance(x, Expr):
            return Call(opname, (x,))
        return PRIMITIVES[opname](x)

    f.__name__ = opname
    return f


_CUSTOM_DIFF: dict = {}


def register_primitive(name: str, fn, deriv=None):
    """Register a custom unary primitive for use in symbolic expressions
    (e.g. Bessel functions, as in the reference's nonlinear_hyperbolic
    example which uses SpecialFunctions.besselj0).

    * fn: elementwise numeric implementation on torch tensors.
    * deriv: optional symbolic derivative rule `a -> Expr` giving
      d fn(a)/d a (the chain-rule factor is applied automatically).
      Without it the primitive still lowers and evaluates, but
      `expand_derivatives` raises if a Differential crosses it.

    Returns a function usable like the built-ins: `j0 = register_primitive(
    "j0", my_j0); ... j0(x) ...`.
    """
    PRIMITIVES[name] = fn
    if deriv is not None:
        _CUSTOM_DIFF[name] = deriv
    return _make_fn(name)


sin = _make_fn("sin")
cos = _make_fn("cos")
tan = _make_fn("tan")
asin = _make_fn("asin")
acos = _make_fn("acos")
atan = _make_fn("atan")
sinh = _make_fn("sinh")
cosh = _make_fn("cosh")
tanh = _make_fn("tanh")
exp = _make_fn("exp")
log = _make_fn("log")
sqrt = _make_fn("sqrt")
abs_ = _make_fn("abs")
erf = _make_fn("erf")
sigmoid = _make_fn("sigmoid")

pi = math.pi


# ---------------------------------------------------------------------------
# Symbolic differentiation (`expand_derivatives` analog)
# ---------------------------------------------------------------------------

def _diff_primitive(op: str, args, dargs):
    """d op(args) given d(args); returns Expr (chain rule numerator parts)."""
    a = args
    da = dargs
    if op == "+":
        return da[0] + da[1]
    if op == "-":
        return da[0] - da[1]
    if op == "*":
        return da[0] * a[1] + a[0] * da[1]
    if op == "/":
        return (da[0] * a[1] - a[0] * da[1]) / (a[1] * a[1])
    if op == "^":
        if isinstance(a[1], Num):  # a^c: c*a^(c-1)*da
            c = a[1].value
            return Num(c) * (a[0] ** Num(c - 1.0)) * da[0]
        # general: a^b * (db*log(a) + b*da/a)
        return (a[0] ** a[1]) * (da[1] * log(a[0]) + a[1] * da[0] / a[0])
    if op == "neg":
        return -da[0]
    table = {
        "sin": lambda: cos(a[0]) * da[0],
        "cos": lambda: -sin(a[0]) * da[0],
        "tan": lambda: (1.0 + tan(a[0]) ** 2) * da[0],
        "exp": lambda: exp(a[0]) * da[0],
        "log": lambda: da[0] / a[0],
        "sqrt": lambda: da[0] / (2.0 * sqrt(a[0])),
        "tanh": lambda: (1.0 - tanh(a[0]) ** 2) * da[0],
        "sinh": lambda: cosh(a[0]) * da[0],
        "cosh": lambda: sinh(a[0]) * da[0],
        "sigmoid": lambda: sigmoid(a[0]) * (1.0 - sigmoid(a[0])) * da[0],
        "erf": lambda: Num(2.0 / math.sqrt(math.pi)) * exp(-(a[0] ** 2)) * da[0],
        "asin": lambda: da[0] / sqrt(1.0 - a[0] ** 2),
        "acos": lambda: -da[0] / sqrt(1.0 - a[0] ** 2),
        "atan": lambda: da[0] / (1.0 + a[0] ** 2),
    }
    if op in table:
        return table[op]()
    if op in _CUSTOM_DIFF and len(a) == 1:
        return _CUSTOM_DIFF[op](a[0]) * da[0]
    raise ValueError(f"no symbolic derivative rule for primitive {op!r}")


def symbolic_diff(expr: Expr, var: Sym) -> Expr:
    """d expr / d var with full product/quotient/chain rules.

    DepVarCall arguments must be raw Syms/Nums (as in the reference, where phi
    inputs are raw coordinates)."""
    if isinstance(expr, Num) or isinstance(expr, Param):
        return Num(0.0)
    if isinstance(expr, Sym):
        return Num(1.0) if expr == var else Num(0.0)
    if isinstance(expr, DepVarCall):
        for a in expr.args:
            if not isinstance(a, (Sym, Num)):
                raise ValueError(
                    f"cannot differentiate {expr!r}: dependent-variable arguments "
                    "must be plain variables for symbolic differentiation"
                )
        if any(isinstance(a, Sym) and a == var for a in expr.args):
            return Deriv(expr, (var,))
        return Num(0.0)
    if isinstance(expr, Deriv):
        if _depends_on(expr.target, var):
            return Deriv(expr.target, (var,) + expr.wrt)
        return Num(0.0)
    if isinstance(expr, Call):
        dargs = tuple(symbolic_diff(a, var) for a in expr.args)
        return _diff_primitive(expr.op, expr.args, dargs)
    if isinstance(expr, IntegralExpr):
        # Leibniz rule: d/dx ∫_{a(x)}^{b(x)} f(s, x) ds
        #   = f(b(x), x)·b'(x) − f(a(x), x)·a'(x) + ∫ ∂f/∂x ds
        # (the reference's Symbolics layer handles this in principle; no
        # reference test exercises it — expressivity-parity edge, VERDICT r2)
        if any(v == var for v in expr.ivars):
            return Num(0.0)            # bound (dummy) variable
        terms = []
        d_int = symbolic_diff(expr.integrand, var)
        if not _is_zero(_simplify(d_int)):
            terms.append(IntegralExpr(_simplify(d_int), expr.ivars,
                                      expr.lb, expr.ub))
        # boundary terms, one pair per integration dimension d:
        #   +[∫ over the other dims of f|_{s_d=ub_d}]·ub_d'(x)
        #   −[∫ over the other dims of f|_{s_d=lb_d}]·lb_d'(x)
        # valid for box-with-x-dependent-bounds regions: a bound may depend
        # on the differentiation variable but not on another integration
        # variable (a simplex-like region would change shape on
        # substitution)
        for b in expr.lb + expr.ub:
            if isinstance(b, Expr) and any(_depends_on(b, v)
                                           for v in expr.ivars):
                raise ValueError(
                    "derivative of an integral whose bound depends on "
                    "another integration variable is not supported "
                    "(non-box region)")
        for d, s in enumerate(expr.ivars):
            for sign, b in ((1.0, expr.ub[d]), (-1.0, expr.lb[d])):
                if isinstance(b, Num) or not isinstance(b, Expr):
                    continue   # constant bound (finite or ±inf): b' = 0,
                               # no boundary term
                db = _simplify(symbolic_diff(b, var))
                if _is_zero(db):
                    continue
                face = _simplify(substitute(expr.integrand, {s: b}))
                rest = tuple(v for j, v in enumerate(expr.ivars) if j != d)
                if rest:
                    face = IntegralExpr(
                        face,
                        rest,
                        tuple(bb for j, bb in enumerate(expr.lb) if j != d),
                        tuple(bb for j, bb in enumerate(expr.ub) if j != d))
                terms.append(Num(sign) * face * db)
        if not terms:
            return Num(0.0)
        out = terms[0]
        for t in terms[1:]:
            out = out + t
        return _simplify(out)
    raise TypeError(f"cannot differentiate {type(expr).__name__}")


def _depends_on(expr: Expr, var: Sym) -> bool:
    if isinstance(expr, Sym):
        return expr == var
    if isinstance(expr, DepVarCall):
        return any(isinstance(a, Sym) and a == var for a in expr.args)
    if isinstance(expr, Deriv):
        return _depends_on(expr.target, var)
    if isinstance(expr, Call):
        return any(_depends_on(a, var) for a in expr.args)
    if isinstance(expr, IntegralExpr):
        return _depends_on(expr.integrand, var) or any(
            isinstance(b, Expr) and _depends_on(b, var) for b in expr.lb + expr.ub
        )
    return False


def _is_zero(e: Expr) -> bool:
    return isinstance(e, Num) and e.value == 0.0


def _simplify(e: Expr) -> Expr:
    """Light constant folding to keep expanded trees small."""
    if isinstance(e, Call):
        args = tuple(_simplify(a) for a in e.args)
        op = e.op
        if op == "+":
            if _is_zero(args[0]):
                return args[1]
            if _is_zero(args[1]):
                return args[0]
        elif op == "-":
            if _is_zero(args[1]):
                return args[0]
            if _is_zero(args[0]):
                return _simplify(Call("neg", (args[1],)))
        elif op == "*":
            if _is_zero(args[0]) or _is_zero(args[1]):
                return Num(0.0)
            if isinstance(args[0], Num) and args[0].value == 1.0:
                return args[1]
            if isinstance(args[1], Num) and args[1].value == 1.0:
                return args[0]
        elif op == "/":
            if _is_zero(args[0]):
                return Num(0.0)
            if isinstance(args[1], Num) and args[1].value == 1.0:
                return args[0]
        elif op == "neg" and isinstance(args[0], Num):
            return Num(-args[0].value)
        if all(isinstance(a, Num) for a in args) and op in PRIMITIVES:
            try:
                return Num(float(PRIMITIVES[op](*[a.value for a in args])))
            except Exception:
                pass
        return Call(op, args)
    if isinstance(e, Deriv):
        return Deriv(_simplify(e.target) if not isinstance(e.target, DepVarCall)
                     else e.target, e.wrt)
    if isinstance(e, IntegralExpr):
        return IntegralExpr(_simplify(e.integrand), e.ivars, e.lb, e.ub)
    return e


def expand_derivatives(expr: Expr) -> Expr:
    """Push Deriv nodes down to DepVarCalls (product/chain rules applied),
    mirroring `Symbolics.expand_derivatives` use in `parse_equation`
    (reference: src/symbolic_utilities.jl:360-370)."""
    if isinstance(expr, Deriv):
        target = expand_derivatives(expr.target)
        if isinstance(target, DepVarCall):
            return expr if target is expr.target else Deriv(target, expr.wrt)
        # apply one derivative at a time, innermost last
        result = target
        for var in reversed(expr.wrt):
            result = _simplify(symbolic_diff(expand_derivatives(result), var))
        return result
    if isinstance(expr, Call):
        return _simplify(Call(expr.op, tuple(expand_derivatives(a) for a in expr.args)))
    if isinstance(expr, IntegralExpr):
        return IntegralExpr(expand_derivatives(expr.integrand), expr.ivars, expr.lb, expr.ub)
    return expr


def substitute(expr: Expr, mapping: dict) -> Expr:
    """One-pass substitution of Syms (keys) by expressions (values), including
    inside dependent-variable call arguments."""
    if isinstance(expr, Sym):
        return mapping.get(expr, expr)
    if isinstance(expr, Call):
        return Call(expr.op, tuple(substitute(a, mapping) for a in expr.args))
    if isinstance(expr, DepVarCall):
        return DepVarCall(expr.name, tuple(substitute(a, mapping) for a in expr.args))
    if isinstance(expr, Deriv):
        return Deriv(substitute(expr.target, mapping), expr.wrt)
    if isinstance(expr, IntegralExpr):
        inner = {k: v for k, v in mapping.items() if k not in expr.ivars}
        return IntegralExpr(
            substitute(expr.integrand, inner), expr.ivars,
            tuple(substitute(b, inner) if isinstance(b, Expr) else b for b in expr.lb),
            tuple(substitute(b, inner) if isinstance(b, Expr) else b for b in expr.ub),
        )
    return expr


def symbols(names: str):
    """`x, y = symbols("x y")`."""
    out = tuple(Sym(n) for n in names.replace(",", " ").split())
    return out[0] if len(out) == 1 else out


def depvars(names: str):
    out = tuple(DepVar(n) for n in names.replace(",", " ").split())
    return out[0] if len(out) == 1 else out


def parameters(names: str):
    out = tuple(Param(n) for n in names.replace(",", " ").split())
    return out[0] if len(out) == 1 else out
