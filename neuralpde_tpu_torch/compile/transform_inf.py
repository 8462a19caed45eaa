"""Infinite-domain integral transforms (`neuralpde_tpu.compile.transform_inf`;
reference: src/transform_inf_integral.jl).

Rewrites improper integrals to finite domain by the reference's three
change-of-variable maps, multiplying the integrand by the analytic Jacobian
and clipping the finite bounds with ε = 1/20
(reference: src/transform_inf_integral.jl:41-77,129-166):

  (-∞, ∞):  x = τ/(1-τ²),      τ ∈ [-1+ε, 1-ε],  J = (1+τ²)/(1-τ²)²
  (a,  ∞):  x = a + τ/(1-τ),   τ ∈ [0, 1-ε],     J = 1/(1-τ)²
  (-∞, b):  x = b + τ/(1+τ),   τ ∈ [-1+ε, 0],    J = 1/(1+τ)²
  (a(·),∞): x = τ/(1-τ),       τ ∈ [a/(1+a), 1-ε] (symbolic lower bound)
  (-∞,b(·)):x = τ/(1+τ),       τ ∈ [-1+ε, b/(1-b)] (symbolic upper bound)
"""

from __future__ import annotations

import math

from ..symbolic.expr import Expr, IntegralExpr, Num, substitute

# ε = 1/20 mirrors the reference (src/transform_inf_integral.jl:129).  The
# clipping bounds the effective domain (x ≲ 20 for semi-infinite) so the
# network's unconstrained far-field tail cannot dominate the integral; the
# cost is a small inconsistency in the truncated equation, which is why the
# reference tests fit these problems only moderately (BFGS, ~200 iters).
_EPS = 1.0 / 20.0


def _is_neg_inf(b) -> bool:
    return not isinstance(b, Expr) and math.isinf(float(b)) and float(b) < 0


def _is_pos_inf(b) -> bool:
    return not isinstance(b, Expr) and math.isinf(float(b)) and float(b) > 0


def transform_inf_integral(expr: IntegralExpr) -> IntegralExpr:
    """Return an equivalent IntegralExpr with finite bounds (identity if
    already finite)."""
    if not any(_is_neg_inf(b) for b in expr.lb) and not any(_is_pos_inf(b) for b in expr.ub):
        return expr

    integrand = expr.integrand
    new_lb, new_ub = [], []
    for iv, lb, ub in zip(expr.ivars, expr.lb, expr.ub):
        tau = iv  # the quadrature node variable keeps the integration symbol
        lb_inf, ub_inf = _is_neg_inf(lb), _is_pos_inf(ub)
        if lb_inf and ub_inf:
            sub = tau / (1.0 - tau**2)
            jac = (1.0 + tau**2) / (1.0 - tau**2) ** 2
            lo, hi = -1.0 + _EPS, 1.0 - _EPS
        elif ub_inf:
            jac = 1.0 / (1.0 - tau) ** 2
            hi = 1.0 - _EPS
            if isinstance(lb, Expr) and not isinstance(lb, Num):
                sub = tau / (1.0 - tau)
                lo = lb / (1.0 + lb)
            else:
                a = lb.value if isinstance(lb, Num) else float(lb)
                sub = a + tau / (1.0 - tau)
                lo = 0.0
        elif lb_inf:
            jac = 1.0 / (1.0 + tau) ** 2
            lo = -1.0 + _EPS
            if isinstance(ub, Expr) and not isinstance(ub, Num):
                sub = tau / (1.0 + tau)
                hi = ub / (1.0 - ub)
            else:
                b = ub.value if isinstance(ub, Num) else float(ub)
                sub = b + tau / (1.0 + tau)
                hi = 0.0
        else:
            new_lb.append(lb)
            new_ub.append(ub)
            continue
        integrand = substitute(integrand, {iv: sub}) * jac
        new_lb.append(lo)
        new_ub.append(hi)

    return IntegralExpr(integrand, expr.ivars, tuple(new_lb), tuple(new_ub))
