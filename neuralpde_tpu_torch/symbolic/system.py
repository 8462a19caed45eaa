"""Domains and PDESystem (DomainSets/ModelingToolkit PDESystem replacement)."""

from __future__ import annotations

import math
from typing import Sequence

from .expr import DepVarCall, Eq, Param, Sym


class Interval:
    """Closed interval [lo, hi]; ±inf allowed (infinite-domain integrals)."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: float, hi: float):
        self.lo = float(lo)
        self.hi = float(hi)
        if not self.lo < self.hi:
            raise ValueError(f"Interval requires lo < hi, got [{lo}, {hi}]")

    def __repr__(self):
        return f"Interval({self.lo}, {self.hi})"

    @property
    def is_finite(self) -> bool:
        return math.isfinite(self.lo) and math.isfinite(self.hi)


def infimum(d: Interval) -> float:
    return d.lo


def supremum(d: Interval) -> float:
    return d.hi


class Domain:
    """Pairing `var ∈ interval`, mirroring `x ∈ Interval(0, 1)` domain decls."""

    __slots__ = ("variables", "domain")

    def __init__(self, var: Sym, interval: Interval):
        self.variables = var
        self.domain = interval

    def __repr__(self):
        return f"{self.variables} ∈ {self.domain}"


def in_domain(var: Sym, interval: Interval) -> Domain:
    return Domain(var, interval)


class PDESystem:
    """Symbolic PDE problem description (ModelingToolkit.PDESystem analog).

    * eqs:  list of Eq (interior equations)
    * bcs:  list of Eq (boundary/initial conditions)
    * domains: list of Domain, one per independent variable
    * ivs:  independent variables (Sym), order defines coordinate indices
    * dvs:  dependent variables as *declared calls*, e.g. [u(x, y)] — the call
            arguments define each network's canonical inputs
            (`dict_depvar_input`, reference: src/symbolic_utilities.jl:401-426)
    * ps:   symbolic parameters (Param) for inverse problems
    * defaults: {Param: value} default parameter values
    """

    def __init__(self, eqs, bcs, domains: Sequence[Domain], ivs: Sequence[Sym],
                 dvs: Sequence[DepVarCall], ps: Sequence[Param] | None = None,
                 defaults: dict | None = None, name: str = "pde_system"):
        self.eqs = list(eqs) if isinstance(eqs, (list, tuple)) else [eqs]
        self.bcs = list(bcs) if isinstance(bcs, (list, tuple)) else [bcs]
        self.domains = list(domains)
        self.ivs = list(ivs)
        self.dvs = list(dvs)
        self.ps = list(ps) if ps else []
        self.defaults = dict(defaults) if defaults else {}
        self.name = name

        for e in self.eqs + self.bcs:
            if not isinstance(e, Eq):
                raise TypeError(f"equations must be Eq, got {type(e).__name__}")
        for d in self.dvs:
            if not isinstance(d, DepVarCall):
                raise TypeError(
                    "dvs must be declared dependent-variable calls, e.g. [u(x, y)]"
                )
        declared = {d.variables.name for d in self.domains}
        for v in self.ivs:
            if v.name not in declared:
                raise ValueError(f"independent variable {v} has no domain")

    def __repr__(self):
        return (f"PDESystem({self.name}: {len(self.eqs)} eqs, {len(self.bcs)} bcs, "
                f"ivs={[v.name for v in self.ivs]}, "
                f"dvs={[d.name for d in self.dvs]})")
