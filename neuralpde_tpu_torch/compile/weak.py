"""hp-VPINN weak-form training (`neuralpde_tpu.compile.weak`; beyond the
reference).

`WeakTraining` trains against *variational* residuals: each PDE residual
R(u) is projected onto tensor-product polynomial test functions localized
on a cartesian mesh of elements (hp-VPINN; Kharazmi, Zhang & Karniadakis
2021, CMAME 374:113547),

    F_{j,k} = (1/c_{j,k}) ∫_{E_j} R(u) · v_k dx ,   loss = mean F²,

with per-row normalization c_{j,k} = ‖v_k‖_{L2(E_j)}·√|E_j| so that (by
Cauchy-Schwarz) every row is bounded by the element RMS residual and the
loss lives on the same scale as the strong-form mean square regardless of
mesh/test-order choices.

The projection is one batched residual evaluation on a static
tensor-product Gauss-Legendre grid followed by one `torch.einsum` with
precomputed per-axis (quad × test) tensors: no extra network evaluations.
The grid, the contraction tensors and the row weights are computed on the
host in float64 and go to the problem's device and dtype once, when the
loss is built, so a weak step copies nothing from the host and `solve` can
capture it as a CUDA graph.  With `ibp ≥ 1`, derivatives are moved off the
network onto the (analytic, polynomial) test functions by integration by
parts, so e.g. a Poisson operator needs only FIRST network derivatives.

Integration by parts is applied per additive term of the residual, per
axis: a term  c·∂ⁿx(target)  (c constant over the domain: numbers, Params,
or expressions of them) becomes  (−1)^m·c·∂^{n−m}x(target)  contracted
against the m-th derivative of the test functions.  Terms that are not
pure derivatives with constant coefficients (e.g. the nonlinear u·u_x, or
a(x)·u_xx) are kept at m = 0 — partial integration by parts, the paper's
VPINN-2 regime.  The test basis matches the requested `ibp`:

  * ibp = 0 — Legendre P_0..P_{K−1} (includes constants: row (j, 0) is the
    element-mean residual, so ibp=0 is a moment-filtered strong form);
  * ibp = 1 — v_k = P_{k+1} − P_{k−1}, k = 1..K (vanish at element edges,
    killing every first boundary term — including internal element
    interfaces, so NO flux coupling between elements is needed);
  * ibp = 2 — v_k = (1−ξ²)²·P_{k−1}, k = 1..K (v and v' vanish, killing
    both boundary terms of a double integration by parts).

Equations the projection cannot represent (integro-differential terms,
equations with no free variables) fall back to a quadrature-weighted
pointwise loss on the same nodes — routing, not rejection, as on the
separable path.  Boundary conditions stay pointwise penalties on a static
grid (essential BCs; natural BCs can instead be imposed variationally via
`DeepRitz`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import data_rank, data_size, share, shard_batch
from ..strategies import (
    TrainingStrategy, _mean_sq_loss, generate_training_sets,
)
from ..symbolic.expr import (
    Call, DepVarCall, Deriv, Eq, Expr, IntegralExpr, Num, Param, Sym,
    expand_derivatives,
)
from ..symbolic.system import infimum, supremum
from .discretize import PhysicsInformedNN, _rematerialized, discretize
from .lower import LoweringContext, build_residual_function, depvar_params


# ---------------------------------------------------------------------------
# test bases (Legendre-coefficient representation, reference element [-1,1])
# ---------------------------------------------------------------------------

def _test_basis(n_test: int, vanish: int) -> list[np.ndarray]:
    """Legendre coefficient vectors of the K test functions; `vanish` is the
    number of derivatives (0, 1 or 2) required to vanish at ξ = ±1."""
    L = np.polynomial.legendre
    if vanish == 0:
        return [np.eye(n_test)[k] for k in range(n_test)]
    if vanish == 1:
        out = []
        for k in range(1, n_test + 1):
            c = np.zeros(k + 2)
            c[k + 1] = 1.0
            if k - 1 >= 0:
                c[k - 1] -= 1.0
            out.append(c)
        return out
    if vanish == 2:
        # (1-ξ²) = (2/3)·(P0 - P2)
        w = np.array([2.0 / 3.0, 0.0, -2.0 / 3.0])
        w2 = L.legmul(w, w)
        return [L.legmul(w2, np.eye(n_test)[k]) for k in range(n_test)]
    raise ValueError(f"vanish must be 0, 1 or 2; got {vanish}")


def _axis_matrices(n_test, vanish: int, quad: int, lo: float, hi: float,
                   elements, max_order: int):
    """Per-axis quadrature nodes and contraction matrices.

    ``elements`` is an element count (uniform mesh) or an array of E+1
    element edges spanning [lo, hi] (h-refined mesh).  ``n_test`` is the
    per-element test-function count: an int (uniform p) or an array of E
    ints (p-refined mesh; rows are padded to max K with ZEROED columns, so
    the tensor stays static-shape — the inactive rows carry no residual
    energy and zero loss weight).  Returns (nodes (E·q,), weights (E·q,),
    C, mask) where C[m] is the (E, q, Kmax) tensor contracting
    reference-element residual values with the m-th physical derivative of
    the normalized test functions times the physical quadrature weights —
    the per-axis, per-element factor of F_{j,k} — and mask is the (E, Kmax)
    0/1 activity of each (element, mode) row."""
    L = np.polynomial.legendre
    xi, w_ref = L.leggauss(quad)
    if np.ndim(elements) == 0:
        edges = np.linspace(lo, hi, int(elements) + 1)
    else:
        edges = np.asarray(elements, dtype=np.float64)
        # relative tolerance: accumulated edges (lo + cumsum of widths) on
        # large-magnitude domains can miss the endpoint by >1e-12 while
        # still being correct to float precision
        tol = 1e-9 * max(1.0, abs(hi - lo), abs(lo), abs(hi))
        if not (abs(edges[0] - lo) <= tol and abs(edges[-1] - hi) <= tol
                and np.all(np.diff(edges) > 0)):
            raise ValueError(
                f"edges must increase from {lo} to {hi}; got {edges}")
    n_el = len(edges) - 1
    if np.ndim(n_test) == 0:
        k_el = np.full(n_el, int(n_test))
    else:
        k_el = np.asarray(n_test, dtype=int)
        if k_el.shape != (n_el,):
            raise ValueError(
                f"per-element n_test must have one entry per element "
                f"({n_el}); got shape {k_el.shape}")
        if np.any(k_el < 1):
            raise ValueError(f"per-element n_test must be >= 1; got {k_el}")
    k_max = int(k_el.max())
    mask = (np.arange(k_max)[None, :] < k_el[:, None]).astype(np.float64)

    h = np.diff(edges)                                   # (E,)
    centers = (edges[:-1] + edges[1:]) / 2.0
    nodes = (centers[:, None] + (h[:, None] / 2.0) * xi[None, :]).reshape(-1)
    weights = ((h[:, None] / 2.0) * w_ref[None, :]).reshape(-1)

    basis = _test_basis(k_max, vanish)
    # ‖v_k‖²_{L2[-1,1]} = Σ c_i²·2/(2i+1);  physical norm = √(h/2)·ref norm;
    # divisor c_{j,k} = ‖v_k‖_{L2(E)}·√h = (h/√2)·‖v_k‖_ref
    norms = np.array([np.sqrt(np.sum(c * c * 2.0 / (2 * np.arange(len(c)) + 1)))
                      for c in basis])
    C = []
    for m in range(max_order + 1):
        V = np.stack([L.legval(xi, L.legder(c, m) if m else c)
                      for c in basis], axis=1)          # (q, Kmax)
        # per-element scale: (h/2)·(2/h)^m (quad weight × chain rule) over
        # the normalization (h/√2)
        scale = ((h / 2.0) * (2.0 / h) ** m
                 / (h / np.sqrt(2.0)))                   # (E,)
        C.append(mask[:, None, :]
                 * scale[:, None, None] * (w_ref[:, None] * V)[None, :, :]
                 / norms[None, None, :])
    return nodes, weights, C, mask


# ---------------------------------------------------------------------------
# term decomposition for integration by parts
# ---------------------------------------------------------------------------

def _is_const(e: Expr) -> bool:
    """Constant over the domain: no free variables, depvars, or integrals
    (Params are trainable scalars but spatially constant — legal factors)."""
    if isinstance(e, (Num, Param)):
        return True
    if isinstance(e, (Sym, DepVarCall, Deriv, IntegralExpr)):
        return False
    if isinstance(e, Call):
        return all(_is_const(a) for a in e.args)
    return False


def _signed_terms(e: Expr, sign: int = 1):
    """Flatten top-level +/−/neg into (sign, term) pairs."""
    if isinstance(e, Call):
        if e.op == "+":
            return _signed_terms(e.args[0], sign) + _signed_terms(e.args[1], sign)
        if e.op == "-" and len(e.args) == 2:
            return (_signed_terms(e.args[0], sign)
                    + _signed_terms(e.args[1], -sign))
        if e.op == "neg":
            return _signed_terms(e.args[0], -sign)
    return [(sign, e)]


def _peel_constants(e: Expr):
    """Split a term into (constant factors, core).  Only fully constant
    multipliers/divisors are peeled; anything else stays in the core."""
    if isinstance(e, Call) and e.op == "*":
        a, b = e.args
        if _is_const(a):
            fs, core = _peel_constants(b)
            return [a] + fs, core
        if _is_const(b):
            fs, core = _peel_constants(a)
            return [b] + fs, core
    if isinstance(e, Call) and e.op == "/" and _is_const(e.args[1]):
        fs, core = _peel_constants(e.args[0])
        return fs + [Call("/", (Num(1.0), e.args[1]))], core
    if isinstance(e, Call) and e.op == "neg":
        fs, core = _peel_constants(e.args[0])
        return fs + [Num(-1.0)], core
    return [], e


def _reassemble(factors, core: Expr) -> Expr:
    out = core
    for f in factors:
        out = Call("*", (f, out))
    return out


def _contains_integral(e) -> bool:
    if isinstance(e, IntegralExpr):
        return True
    if isinstance(e, Call):
        return any(_contains_integral(a) for a in e.args)
    if isinstance(e, Deriv):
        return _contains_integral(e.target)
    if isinstance(e, DepVarCall):
        return any(_contains_integral(a) for a in e.args)
    return False


def _ibp_groups(expr: Expr, axis_names: set, ibp: int):
    """Group the residual's additive terms by the per-axis test-derivative
    orders after integration by parts.

    Returns {orders: summed Expr} where `orders` maps axis name -> m (the
    number of derivatives moved onto the test functions in that axis; the
    (−1)^Σm sign is folded into the expression)."""
    groups: dict = {}
    for sign, term in _signed_terms(expr):
        factors, core = _peel_constants(term)
        orders = {}
        if ibp > 0 and isinstance(core, Deriv):
            counts: dict = {}
            for v in core.wrt:
                counts[v.name] = counts.get(v.name, 0) + 1
            kept = []
            for v in core.wrt:
                m_target = min(ibp, counts[v.name]) if v.name in axis_names \
                    else 0
                if orders.get(v.name, 0) < m_target:
                    orders[v.name] = orders.get(v.name, 0) + 1
                    sign = -sign
                else:
                    kept.append(v)
            core = Deriv(core.target, kept) if kept else core.target
        new_term = _reassemble(factors, core)
        if sign < 0:
            new_term = Call("neg", (new_term,))
        key = tuple(sorted(orders.items()))
        groups[key] = (Call("+", (groups[key], new_term))
                       if key in groups else new_term)
    return groups


# ---------------------------------------------------------------------------
# the strategy
# ---------------------------------------------------------------------------

class WeakTraining(TrainingStrategy):
    """hp-VPINN weak-form training strategy (see module docstring).

    * ``elements``: elements per axis — an int (uniform mesh), an array of
      E+1 element edges (h-refined mesh, e.g. from `refine_weak`), or a
      {var name: int | edges} dict
    * ``n_test``: test functions per axis per element — an int, an array of
      E per-element counts (p-refined mesh, e.g. from
      `refine_weak(mode="p"|"hp")`; rows pad to max K with zero weight), or
      a {var name: int | counts} dict
    * ``quad``: Gauss-Legendre points per element per axis
      (default ``max n_test + ibp + 3`` — exact for the polynomial factor,
      leaving the budget to resolve the network)
    * ``ibp``: integrations by parts per term per axis (0, 1 or 2); selects
      the matching vanishing test basis
    * ``bc_dx``: grid spacing for the pointwise boundary losses (scalar or
      per-domain list; default = element size / quad, matching the interior
      node density)

    Composes with adaptive losses, `additional_loss`, `param_estim`,
    checkpointing and `matmul_precision` unchanged (it is an ordinary
    strategy producing per-equation scalar losses).  `gradient_enhanced`
    is rejected: gPINN rows are strong-form by construction.
    """

    def __init__(self, elements=4, n_test: int | dict = 8, *, quad=None,
                 ibp: int = 1, bc_dx=None):
        if ibp not in (0, 1, 2):
            raise ValueError(f"ibp must be 0, 1 or 2; got {ibp}")
        self.elements = elements
        self.n_test = n_test
        self.quad = quad
        self.ibp = ibp
        self.bc_dx = bc_dx

    def _per_axis(self, value, name, default=None):
        if isinstance(value, dict):
            return value.get(name, default)
        return value

    @staticmethod
    def _spans(pinnrep):
        return {d.variables.name: (float(infimum(d.domain)),
                                   float(supremum(d.domain)))
                for d in pinnrep.domains}

    def build(self, pinnrep, datafree_pde, datafree_bc):
        if pinnrep.gradient_enhanced:
            raise ValueError(
                "gradient_enhanced (gPINN) is strong-form and cannot be "
                "projected by WeakTraining; use GridTraining/"
                "StochasticTraining for gPINN rows")
        acc = pinnrep.loss_accum_dtype
        ctx = LoweringContext.from_pinnrep(pinnrep)
        spans = self._spans(pinnrep)

        pde_losses = [
            self._equation_loss(eq, args, ctx, pinnrep, spans, f, acc)
            for eq, args, f in zip(pinnrep.eqs, pinnrep.pde_args,
                                   datafree_pde)]

        # essential BCs stay pointwise penalties on a static grid
        bc_sets = self._bc_training_sets(pinnrep, spans)
        bc = [_mean_sq_loss(f, s, acc) for f, s in zip(datafree_bc, bc_sets)]
        return pde_losses, bc

    def _bc_training_sets(self, pinnrep, spans):
        """Static boundary training sets at the interior node density
        (shared by `build` and the Gauss-Newton residual vector)."""
        if self.bc_dx is not None:
            bc_dx = self.bc_dx
        else:
            bc_dx = []
            for d in pinnrep.domains:
                nm = d.variables.name
                lo, hi = spans[nm]
                e = self._per_axis(self.elements, nm, 4)
                n_el = len(e) - 1 if np.ndim(e) else int(e)
                q = self._resolve_quad(nm)
                bc_dx.append((hi - lo) / max(n_el * q - 1, 1))
        return generate_training_sets(pinnrep.domains, bc_dx,
                                      pinnrep.bc_args, pinnrep.dtype,
                                      pinnrep.device)

    def _resolve_quad(self, name):
        if self.quad is not None:
            return self._per_axis(self.quad, name)
        nt = self.n_test
        vals = list(nt.values()) if isinstance(nt, dict) else [nt]
        nt_max = max(int(np.max(np.asarray(v))) for v in vals)
        return nt_max + self.ibp + 3

    def _equation_loss(self, eq, args, ctx, pinnrep, spans, datafree, acc):
        rows, wvec = self._equation_rows(eq, args, ctx, pinnrep, spans,
                                         datafree, pinnrep.remat)
        wj = torch.as_tensor(wvec, dtype=acc or pinnrep.dtype,
                             device=pinnrep.device)

        def loss(theta, generator=None):
            del generator
            # under a mesh, the rank's rows where they divide (its share of
            # the sum), else all of them at 1/W
            r = rows(theta, shard=True)
            w = wj if r.shape[0] == wj.shape[0] else shard_batch(wj[None])[0]
            sq = r * r
            if acc is not None:
                sq = sq.to(acc)
            total = torch.sum(sq * w)
            return share(total) if w is wj else total

        return loss

    def _equation_rows(self, eq, args, ctx, pinnrep, spans, datafree,
                       remat=False, with_meta=False):
        """Flat residual rows + static per-row quadrature weights (a
        float64 numpy vector) for one equation, with
        ``equation_loss(θ) == Σ_i w_i · rows(θ)_i²``.  Every tensor that
        ``rows`` closes over lies on the problem's device.

        Shared by the scalar training loss, by
        `gauss_newton.build_residual_vector` (WeakTraining is deterministic,
        so hp-VPINN objectives are valid Gauss-Newton least squares), and —
        with ``with_meta=True``, which appends a third element carrying the
        projection geometry (or None for quadrature-routed equations) — by
        `refine_weak`'s per-element scoring."""
        dtype, device = pinnrep.dtype, pinnrep.device
        syms = [a for a in args if isinstance(a, Sym)]
        layout = [a if isinstance(a, Sym) else None for a in args]
        expr = Call("-", (expand_derivatives(eq.lhs),
                          expand_derivatives(eq.rhs)))

        for s in syms:
            if s.name not in spans:
                raise ValueError(f"equation variable {s.name!r} has no domain")

        # per-axis quadrature geometry + contraction matrices
        axis_geo = {}
        edges_of = {}
        for s in syms:
            lo, hi = spans[s.name]
            e = self._per_axis(self.elements, s.name, 4)
            edges = (np.linspace(lo, hi, int(e) + 1) if np.ndim(e) == 0
                     else np.asarray(e, dtype=np.float64))
            edges_of[s.name] = edges
            nt = self._per_axis(self.n_test, s.name, 8)
            q = self._resolve_quad(s.name)
            axis_geo[s.name] = (_axis_matrices(nt, self.ibp, q, lo, hi, edges,
                                               max_order=self.ibp),
                                len(edges) - 1, q)

        # static tensor-product node grid in the equation's arg layout
        mesh_axes = [axis_geo[s.name][0][0] for s in syms]
        grids = (np.meshgrid(*mesh_axes, indexing="ij") if mesh_axes
                 else [np.zeros((1,))])
        n_total = grids[0].size
        rows, gi = [], 0
        for a in args:
            if isinstance(a, Sym):
                rows.append(grids[gi].reshape(-1))
                gi += 1
            else:
                rows.append(np.full(n_total, float(a)))
        cord = torch.as_tensor(np.stack(rows, axis=0), dtype=dtype,
                               device=device)

        if _contains_integral(expr) or not syms:
            # routing, not rejection: quadrature-weighted pointwise loss on
            # the same nodes (the separable auto-hybrid precedent)
            w_parts = [axis_geo[s.name][0][1] for s in syms]
            W = np.ones((1,))
            for w in w_parts:
                W = (W[:, None] * w[None, :]).reshape(-1)
            volume = float(np.prod([spans[s.name][1] - spans[s.name][0]
                                    for s in syms])) if syms else 1.0

            def quad_rows(theta, shard=False):
                return datafree(shard_batch(cord) if shard else cord,
                                theta).reshape(-1)

            if with_meta:
                return quad_rows, W / volume, None
            return quad_rows, W / volume

        groups = _ibp_groups(expr, {s.name for s in syms}, self.ibp)
        grid_shape = tuple(x for s in syms
                           for x in (axis_geo[s.name][1],
                                     axis_geo[s.name][2]))

        compiled = []
        for orders_key, gexpr in groups.items():
            orders = dict(orders_key)
            rfn = build_residual_function(Eq(gexpr, 0.0), layout, ctx,
                                          pinnrep.default_p)
            if remat:
                rfn = _rematerialized(rfn)
            mats = [torch.as_tensor(
                axis_geo[s.name][0][2][orders.get(s.name, 0)], dtype=dtype,
                device=device) for s in syms]
            compiled.append((rfn, mats))

        d = len(syms)
        # einsum per axis: (E1,q1,..,Ed,qd) × (E_a,q_a,K_a) -> (E1,K1,..)
        # (the contraction matrix carries the element dim: h-refined meshes
        # have per-element scales)
        letters = "abcdefgh"[:d]
        qs = "mnopqrst"[:d]
        ks = "uvwxyzAB"[:d]
        in_sub = "".join(letters[a] + qs[a] for a in range(d))
        out_sub = "".join(letters[a] + ks[a] for a in range(d))
        spec = (in_sub + ","
                + ",".join(letters[a] + qs[a] + ks[a] for a in range(d))
                + "->" + out_sub)

        # per-row loss weights: 1/n_active on active (element, mode) rows,
        # 0 on rows padded by per-element p-refinement (their F is already
        # zeroed through the masked contraction matrices)
        act = np.array(1.0)
        for s in syms:
            act = act[..., None, None] * axis_geo[s.name][0][3]
        act = act.reshape(-1)                    # (E1·K1·E2·K2·..,) layout
        wrow = act / act.sum()

        def weak_rows(theta, shard=False):
            """The weak residual rows; ``shard=True`` under a mesh whose
            data axis divides the elements of the first axis: this rank's
            elements only (their nodes are its contiguous slice of the
            points, and their rows a contiguous slice of the rows)."""
            n, e1 = data_size(), grid_shape[0]
            own = shard and n > 1 and e1 % n == 0
            c, shape = ((shard_batch(cord), (e1 // n,) + grid_shape[1:])
                        if own else (cord, grid_shape))
            F = None
            for rfn, mats in compiled:
                r = rfn(c, theta).reshape(shape)
                if own:
                    mats = [mats[0].narrow(0, data_rank() * (e1 // n),
                                           e1 // n)] + mats[1:]
                proj = torch.einsum(spec, r, *mats)
                F = proj if F is None else F + proj
            return F.reshape(-1)

        if with_meta:
            meta = {"syms": [s.name for s in syms],
                    "shape": tuple(x for s in syms
                                   for x in (axis_geo[s.name][1],
                                             axis_geo[s.name][0][2][0]
                                             .shape[2])),
                    "edges": edges_of,
                    "masks": {s.name: axis_geo[s.name][0][3] for s in syms}}
            return weak_rows, wrow, meta
        return weak_rows, wrow


def _hp_action(mode_energy, k_e: int, p_inc: int, p_max: int,
               smooth_tol: float) -> str:
    """The hp decision for one flagged element: "p" when the element's
    projected-residual spectrum decays (smooth solution, resolved-but-
    nonzero residual — raise the polynomial order), "h" when the tail
    carries energy (unresolved local structure — split the element).

    The indicator is the energy fraction in the top HALF of the active
    modes (a single tail mode is too noisy at small K: a point-like spike
    projects as ~v_k(ξ0), which can vanish at any one k by coincidence).
    Elements already at the p cap always h-split."""
    if k_e + p_inc > p_max:
        return "h"
    m_tail = max(1, k_e // 2)
    en = np.asarray(mode_energy)[:k_e]
    tail = en[k_e - m_tail:].sum() / (en.sum() + 1e-300)
    return "h" if tail > smooth_tol else "p"


def refine_weak(prob, theta, *, frac: float = 0.3, parts: int = 2,
                mode: str = "h", p_inc: int = 4, p_max: int = 24,
                smooth_tol: float = 0.1):
    """Residual-driven hp-refinement of a `WeakTraining` mesh (Kharazmi et
    al. 2021 §2.3 refine toward the residual).

    Scores each axis-element by the weighted energy Σ w·F² of the trained
    projection, reduced over every tensor dimension except that axis's
    element/mode dimensions (summed over all weak PDE equations;
    quadrature-routed equations don't contribute).  The rows are evaluated
    once, without gradient, on the problem's device; the scores are float64
    on the host.  The top ``frac`` fraction of elements per axis are
    refined; ``mode`` picks how:

    * ``"h"`` — split each flagged element into ``parts`` equal children
      (children inherit the parent's test-function count);
    * ``"p"`` — raise the flagged element's test-function count by
      ``p_inc`` (up to ``p_max``; elements already at the cap h-split);
    * ``"hp"`` — decide per element from the projection's spectral decay:
      the residual energy fraction in the top HALF of the element's
      active modes above ``smooth_tol`` marks a non-smooth element
      (slowly decaying projection tail) → h-split; a small tail means the
      residual is resolved-but-nonzero on a smooth solution → p-refine
      (see `_hp_action` for why the half, not a thinner tail).

    Returns a NEW `WeakTraining` with per-axis refined edges / per-element
    test counts and every other setting inherited — re-discretize and
    warm-start to continue training (or call `solve_weak_adaptive`, which
    runs this loop for you)::

        res = solve(prob, opt, maxiters=...)
        strat2 = refine_weak(prob, res.u, mode="hp")
        disc2 = PhysicsInformedNN(chain, strat2, ...)
        prob2 = discretize(system, disc2).with_params(res.u)
    """
    pinnrep = getattr(prob, "pinnrep", prob)
    strategy = pinnrep.strategy
    if not isinstance(strategy, WeakTraining):
        raise TypeError("refine_weak needs a WeakTraining problem; got "
                        f"{type(strategy).__name__}")
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"frac must be in (0, 1]; got {frac}")
    if parts < 2:
        raise ValueError(f"parts must be >= 2; got {parts}")
    if mode not in ("h", "p", "hp"):
        raise ValueError(f"mode must be 'h', 'p' or 'hp'; got {mode!r}")
    if p_inc < 1:
        raise ValueError(f"p_inc must be >= 1; got {p_inc}")
    ctx = LoweringContext.from_pinnrep(pinnrep)
    spans = WeakTraining._spans(pinnrep)
    lf = pinnrep.loss_functions

    scores: dict = {}          # axis -> (E, Kmax) per-(element, mode) energy
    edges_of: dict = {}
    masks_of: dict = {}
    for eq, args, f in zip(pinnrep.eqs, pinnrep.pde_args,
                           lf.datafree_pde_loss_functions):
        rows, wvec, meta = strategy._equation_rows(
            eq, args, ctx, pinnrep, spans, f, with_meta=True)
        if meta is None:
            continue
        with torch.no_grad():
            F = rows(theta).detach().cpu().to(torch.float64).numpy()
        F2 = (F ** 2 * wvec).reshape(meta["shape"])  # (E1, K1, E2, K2, ...)
        for i, name in enumerate(meta["syms"]):
            keep = (2 * i, 2 * i + 1)
            sc = F2.sum(axis=tuple(j for j in range(F2.ndim)
                                   if j not in keep))
            prev = scores.get(name)
            scores[name] = sc if prev is None else prev + sc
            edges_of[name] = meta["edges"][name]
            masks_of[name] = meta["masks"][name]
    if not scores:
        raise ValueError("no weak-projected equations to score (all "
                         "equations quadrature-routed) — nothing to refine")

    # seed every domain axis with its ORIGINAL settings (count/edges and
    # test counts) so axes that only appear in quadrature-routed equations /
    # BC domains keep their configuration instead of falling back to the
    # defaults
    new_elements: dict = {
        d.variables.name: strategy._per_axis(strategy.elements,
                                             d.variables.name, 4)
        for d in pinnrep.domains}
    new_ntest: dict = {
        d.variables.name: strategy._per_axis(strategy.n_test,
                                             d.variables.name, 8)
        for d in pinnrep.domains}
    orig_ntest = dict(new_ntest)
    for name, sc in scores.items():
        edges = edges_of[name]
        n_el = sc.shape[0]
        k_act = masks_of[name].sum(axis=1).astype(int)       # (E,)
        totals = sc.sum(axis=1)                              # (E,)
        k = max(1, int(np.ceil(frac * n_el)))
        top = set(np.argsort(totals)[-k:].tolist())
        out_edges = [edges[0]]
        out_k = []
        for e_i in range(n_el):
            k_e = int(k_act[e_i])
            action = None
            if e_i in top:
                if mode == "h":
                    action = "h"
                elif mode == "p":
                    action = "p" if k_e + p_inc <= p_max else "h"
                else:                                        # "hp"
                    action = _hp_action(sc[e_i], k_e, p_inc, p_max,
                                        smooth_tol)
            if action == "h":
                out_edges.extend(np.linspace(edges[e_i], edges[e_i + 1],
                                             parts + 1)[1:])
                out_k.extend([k_e] * parts)
            elif action == "p":
                out_edges.append(edges[e_i + 1])
                out_k.append(k_e + p_inc)
            else:
                out_edges.append(edges[e_i + 1])
                out_k.append(k_e)
        new_elements[name] = np.asarray(out_edges)
        out_k = np.asarray(out_k)
        # collapse to a scalar when uniform (keeps repr/bc defaults tidy)
        new_ntest[name] = (int(out_k[0]) if np.all(out_k == out_k[0])
                           else out_k)

    # p-refinement can raise an axis's max test count past an EXPLICIT quad
    # setting; under-integrated top modes are projection noise that training
    # then chases.  Raise quad to the auto-resolve floor
    # ONLY for axes whose max test count actually grew — pure h-refinement
    # must preserve a deliberate explicit (even under-integrating) quad
    # setting.  quad=None keeps auto-resolving on its own.
    new_quad = strategy.quad
    if new_quad is not None:
        def _max_k(tree, name):
            return int(np.max(np.asarray(tree.get(name, 8))))

        def floor_of(name):
            return _max_k(new_ntest, name) + strategy.ibp + 3

        def grew(name):
            return _max_k(new_ntest, name) > _max_k(orig_ntest, name)

        if isinstance(new_quad, dict):
            new_quad = {n: (max(int(q), floor_of(n)) if grew(n) else int(q))
                        for n, q in new_quad.items()}
        elif any(grew(n) for n in new_ntest):
            new_quad = max(int(new_quad),
                           max(floor_of(n) for n in new_ntest if grew(n)))

    return WeakTraining(elements=new_elements, n_test=new_ntest,
                        quad=new_quad, ibp=strategy.ibp,
                        bc_dx=strategy.bc_dx)


class WeakAdaptiveResult:
    """`solve_weak_adaptive` output: the final trained state plus the
    per-round refinement trail.  Quacks like a `SolveResult` (u, objective,
    iterations, history) and carries the FINAL TrainingProblem (`prob`) so
    the trained network can be evaluated (`prob.pinnrep.phi`).  ``results``
    holds every round's `SolveResult` (on the card, each with its own
    ``aux["cuda_graph"]`` counts)."""

    def __init__(self, result, prob, strategies, round_objectives, history,
                 iterations, results=()):
        self.result = result
        self.prob = prob
        self.strategies = strategies          # one WeakTraining per round
        self.round_objectives = round_objectives
        self.history = history
        self.iterations = iterations          # total across rounds
        self.results = list(results)

    @property
    def u(self):
        return self.result.u

    @property
    def params(self):
        return self.result.u

    @property
    def objective(self):
        return self.result.objective

    @property
    def strategy(self):
        return self.strategies[-1]


def solve_weak_adaptive(pde_system, discretization, optimizer=None, *,
                        rounds: int = 3, maxiters=2000, frac: float = 0.3,
                        parts: int = 2, mode: str = "hp", p_inc: int = 4,
                        p_max: int = 24, smooth_tol: float = 0.1,
                        abstol: float | None = None, generator=None,
                        seed: int = 0, verbose: bool = False, **solve_kw):
    """One-call adaptive hp-VPINN solve: train → `refine_weak` →
    warm-start, for up to ``rounds`` training rounds (so ``rounds - 1``
    refinements).  This automates the manual loop in the `refine_weak`
    docstring; the network parameters carry over between rounds (only the
    projection mesh changes), so later rounds polish rather than restart.

    * ``discretization``: a `PhysicsInformedNN` whose strategy is the
      INITIAL `WeakTraining` (coarse mesh); each round re-discretizes with
      the refined strategy and every other setting inherited.  The
      optimizer and the adaptive-loss state (if any) restart each round,
      and on the card each round's `solve` captures its own CUDA graphs
      (the mesh, and so every shape in the step, changes between rounds).
    * ``maxiters``: per-round iteration budget — an int (same every round)
      or a list of per-round budgets (len == rounds).
    * ``frac``/``parts``/``mode``/``p_inc``/``p_max``/``smooth_tol``:
      forwarded to `refine_weak`.
    * ``abstol``: stop (inside a round AND across rounds) once the
      objective crosses it.
    * ``generator``/``seed`` and extra kwargs forward to `train.solve`
      (inner_steps, callback, checkpoint_dir, ...).

    Returns a `WeakAdaptiveResult`.
    """
    from ..train import solve as train_solve

    if not isinstance(discretization.strategy, WeakTraining):
        raise TypeError("solve_weak_adaptive needs a WeakTraining "
                        "discretization; got "
                        f"{type(discretization.strategy).__name__}")
    if rounds < 1:
        raise ValueError(f"rounds must be >= 1; got {rounds}")
    budgets = (list(maxiters) if isinstance(maxiters, (list, tuple))
               else [maxiters] * rounds)
    if len(budgets) != rounds:
        raise ValueError(f"maxiters list has {len(budgets)} entries for "
                         f"{rounds} rounds")

    def clone(disc, strategy, init_params):
        return PhysicsInformedNN(
            disc.chain, strategy, init_params=init_params,
            derivative=disc.derivative, param_estim=disc.param_estim,
            additional_loss=disc.additional_loss,
            adaptive_loss=disc.adaptive_loss, logger=disc.logger,
            log_options=disc.log_options, seed=disc.seed,
            integral_order=disc.integral_order,
            integral_panels=disc.integral_panels, dtype=disc.dtype,
            device=disc.device, remat=disc.remat,
            loss_accum_dtype=disc.loss_accum_dtype,
            gradient_enhanced=disc.gradient_enhanced,
            matmul_precision=disc.matmul_precision)

    disc = discretization
    prob = discretize(pde_system, disc)
    strategies = [disc.strategy]
    round_objectives = []
    history = []
    results = []
    total_iters = 0
    res = None
    for r in range(rounds):
        res = train_solve(prob, optimizer, maxiters=budgets[r],
                          abstol=abstol, generator=generator, seed=seed,
                          verbose=verbose, **solve_kw)
        results.append(res)
        round_objectives.append(res.objective)
        history.extend(res.history)
        total_iters += res.iterations
        if verbose:
            print(f"[weak-adaptive] round {r + 1}/{rounds}  objective "
                  f"{res.objective:.6g}")
        if r == rounds - 1 or (abstol is not None
                               and res.objective < abstol):
            break
        strat2 = refine_weak(prob, res.u, frac=frac, parts=parts, mode=mode,
                             p_inc=p_inc, p_max=p_max,
                             smooth_tol=smooth_tol)
        disc = clone(disc, strat2, depvar_params(res.u))
        prob = discretize(pde_system, disc).with_params(res.u)
        strategies.append(strat2)

    return WeakAdaptiveResult(res, prob, strategies, round_objectives,
                              history, total_iters, results)
