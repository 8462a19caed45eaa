"""Matrix-free damped Gauss-Newton for PINN losses (`neuralpde_tpu.gauss_newton`).

PINN objectives are nonlinear least squares, ``loss(θ) = Σ_i w_i·mean r_i²``
over residual blocks; Gauss-Newton curvature reaches floors that Adam does
not.  No Jacobian is ever formed: each inner iteration is one
`torch.func.jvp` (J·v) and one application of a `torch.func.vjp` closure
(Jᵀu) through the flat residual vector, the closure built once per outer
step.  The inner solves (CG, LSQR) keep their scalars as 0-d device tensors,
so they run without a host sync; the outer damping (LM) or radius (trust
region) adapts on the host, one sync per outer step.

Deterministic training sets are required (the objective must be fixed
across inner iterations): `GridTraining`, static-grid `SeparableTraining`,
`QuadratureTraining` (its fixed rule) or `WeakTraining` (the hp-VPINN
projection rows); `solve_ode_gauss_newton` drives an `ODEProblem` + `NNODE`
the same way, and `solve_pino_gauss_newton`/`solve_pino_pde_gauss_newton`
the operator objectives (PINOODE, PINOPDE) on their fixed train sets.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import Callable

import numpy as np
import torch
from torch.func import jvp, vjp, vmap

from .config import matmul_precision as _matmul_precision
from .strategies import (
    GridTraining, QuadratureTraining, WeightedIntervalTraining,
    generate_training_sets, julia_range,
)
from .train import SolveResult, _side_stream
from .utils.pytree import parameters_to_vector


def _prec_ctx(matmul_precision):
    """Matmul-precision context for a GN computation (None inherits the
    ambient setting)."""
    return (_matmul_precision(matmul_precision)
            if matmul_precision is not None else contextlib.nullcontext())


def _ls_driver(method: str):
    """Least-squares outer driver for ``method`` ("lm" | "tr")."""
    if method == "lm":
        return lm_least_squares
    if method == "tr":
        return trust_region_least_squares
    raise ValueError(f"method must be 'lm' or 'tr', got {method!r}")


def _weighted_block(fn, w: float):
    """``theta -> ravel(fn(theta)) * sqrt(w / size)``: one block of the
    residual vector, so that its squared norm is ``w · mean r²``.  The
    scale is made on the device at the first call, so that later calls
    copy nothing from the host (a captured CUDA graph may not)."""
    scale = {}

    def r(theta):
        out = fn(theta).reshape(-1)
        key = (out.dtype, out.device)
        if key not in scale:
            scale[key] = torch.sqrt(torch.tensor(w / out.numel(),
                                                 dtype=out.dtype,
                                                 device=out.device))
        return out * scale[key]

    return r


def build_residual_vector(pinnrep, adaptive_state=None) -> Callable:
    """One flat residual function ``r(theta) -> (M,)`` with
    ``||r(θ)||² == full_loss(θ)`` at the given adaptive state's weights:
    each equation/BC residual block is scaled by ``sqrt(w_i / N_i)``.

    ``adaptive_state``: the weight state whose loss GN should optimize (a
    `solve` result's ``res.aux["adaptive_state"]``).  With the default
    `NonAdaptiveLoss` the initial state is used; an adaptive scheme without
    an explicit state is rejected (GN would silently optimize a different
    weighting than training did)."""
    from .adaptive import NonAdaptiveLoss
    from .compile.lower import LoweringContext
    from .compile.weak import WeakTraining
    from .compile.separable import (
        SeparableTraining, _is_factorization_error, build_separable_residual,
        probe_residual, static_axis_nodes,
    )
    from .nn.separable import SeparableNet

    strategy = pinnrep.strategy
    lf = pinnrep.loss_functions
    dtype, device = pinnrep.dtype, pinnrep.device
    n_pde = len(lf.datafree_pde_loss_functions)
    n_bc = len(lf.datafree_bc_loss_functions)
    if adaptive_state is None:
        if not isinstance(pinnrep.adaloss, NonAdaptiveLoss):
            raise ValueError(
                f"the problem was built with {type(pinnrep.adaloss).__name__} "
                "— Gauss-Newton at the INITIAL weights would optimize a "
                "different objective than training did; pass the trained "
                "state: solve_gauss_newton(prob, adaptive_state="
                "res.aux['adaptive_state'])")
        adaptive_state = pinnrep.adaloss.init_state(n_pde, n_bc, dtype, device)
    w_pde, w_bc = (torch.as_tensor(adaptive_state[k]).detach().cpu().to(
        torch.float64).numpy() for k in ("pde_weights", "bc_weights"))

    def dense_block(f, train_set, w):
        return _weighted_block(lambda theta: f(train_set, theta), w)

    if isinstance(strategy, GridTraining):
        pde_sets = generate_training_sets(
            pinnrep.domains, strategy.dx, pinnrep.pde_args, dtype, device)
        bc_sets = generate_training_sets(
            pinnrep.domains, strategy.dx, pinnrep.bc_args, dtype, device)
        blocks = (
            [dense_block(f, s, w) for f, s, w in
             zip(lf.datafree_pde_loss_functions, pde_sets, w_pde)]
            + [dense_block(f, s, w) for f, s, w in
               zip(lf.datafree_bc_loss_functions, bc_sets, w_bc)])

    elif isinstance(strategy, SeparableTraining):
        if strategy.dx is None:
            raise ValueError("Gauss-Newton needs a deterministic objective: "
                             "use SeparableTraining(dx=...), not resample=True")
        if strategy.causal is not None:
            raise ValueError(
                "Gauss-Newton on SeparableTraining(causal=...) would optimize "
                "the UNWEIGHTED least-squares objective, not the causally "
                "weighted one that training uses — build the problem with "
                "causal=None for GN")
        if pinnrep.gradient_enhanced:
            raise ValueError(
                "Gauss-Newton with SeparableTraining does not lower the gPINN "
                "residual-gradient rows; build with gradient_enhanced=None "
                "(GridTraining supports gPINN rows in GN)")
        phis = pinnrep.phi if pinnrep.multioutput else [pinnrep.phi]
        nets = {name: phi.module
                for name, phi in zip(pinnrep.depvars, phis)}
        for name, net in nets.items():
            if not isinstance(net, SeparableNet):
                raise TypeError(f"chain for {name!r} is not a SeparableNet")
        ctx = LoweringContext.from_pinnrep(pinnrep)
        nodes_of = static_axis_nodes(pinnrep, strategy.dx)

        def sep_block(eq, w):
            residual, axes = build_separable_residual(
                eq, ctx, nets, dtype, pinnrep.default_p)
            nodes = [torch.as_tensor(nodes_of[a.name], dtype=dtype,
                                     device=device) for a in axes]
            # surface factorization failures now, so the routing below can
            # catch them
            probe_residual(residual, len(axes), pinnrep.flat_init_params,
                           dtype)
            return _weighted_block(lambda theta: residual(nodes, theta), w)

        def sep_or_dense(eq, f, args, w):
            # auto-hybrid routing (as SeparableTraining.build's dense
            # fallback): non-factorizable equations contribute dense
            # pointwise rows on the same tensor grid
            try:
                return sep_block(eq, w)
            except (ValueError, NotImplementedError) as e:
                if not _is_factorization_error(e):
                    raise
                return dense_block(f, generate_training_sets(
                    pinnrep.domains, strategy.dx, [args], dtype, device)[0], w)

        blocks = (
            [sep_or_dense(eq, f, a, w) for eq, f, a, w in
             zip(pinnrep.eqs, lf.datafree_pde_loss_functions,
                 pinnrep.pde_args, w_pde)]
            + [sep_or_dense(bc, f, a, w) for bc, f, a, w in
               zip(pinnrep.bcs, lf.datafree_bc_loss_functions,
                   pinnrep.bc_args, w_bc)])

    elif isinstance(strategy, QuadratureTraining):
        # fixed composite rule (deterministic): fold the per-point quadrature
        # weights into the residual scaling so ||r||² == Σ w_i·Σ_j q_j·r_j²
        from .ops.quadrature import tensor_rule_box
        from .symbolic.expr import Sym
        from .symbolic.system import infimum, supremum

        lo = {d.variables.name: infimum(d.domain) for d in pinnrep.domains}
        hi = {d.variables.name: supremum(d.domain) for d in pinnrep.domains}
        theta0 = pinnrep.flat_init_params

        def quad_block(f, args, w):
            syms = [a for a in args if isinstance(a, Sym)]
            if not syms:
                return dense_block(f, torch.zeros((len(args), 10), dtype=dtype,
                                                  device=device), w)
            lb = [lo[s.name] for s in syms]
            ub = [hi[s.name] for s in syms]
            area = float(np.prod(np.asarray(ub, dtype=np.float64)
                                 - np.asarray(lb, dtype=np.float64)))

            def rule(p):
                nodes, weights = tensor_rule_box(lb, ub, strategy.order, p)
                return (torch.as_tensor(nodes, dtype=dtype, device=device),
                        torch.as_tensor(weights / area, dtype=dtype,
                                        device=device))

            # replay the strategy's build-time auto-refinement so the panel
            # count (and hence ||r||²) matches the trained objective exactly
            integral_at = None
            if theta0 is not None and strategy.panels is None:
                def integral_at(p):
                    n, wq = rule(p)
                    with torch.no_grad():
                        return float(torch.sum(f(n, theta0) ** 2 * wq))

            nodes, q = rule(strategy.resolve_panels(integral_at, len(syms)))
            # matches the strategy's sum(r²·q) reduction (no /rows)
            scale = torch.sqrt(q * float(w))[None, :]

            def r(theta):
                out = torch.atleast_2d(f(nodes, theta))   # (rows, Q)
                return (out * scale).reshape(-1)

            return r

        blocks = (
            [quad_block(f, a, w) for f, a, w in
             zip(lf.datafree_pde_loss_functions, pinnrep.pde_args, w_pde)]
            + [quad_block(f, a, w) for f, a, w in
               zip(lf.datafree_bc_loss_functions, pinnrep.bc_args, w_bc)])

    elif isinstance(strategy, WeakTraining):
        # hp-VPINN: the weak projection F_{j,k}(θ) is itself a deterministic
        # residual vector (loss == Σ w_row·F²), so GN optimizes the exact
        # weak objective; essential BCs contribute their pointwise rows.
        ctx = LoweringContext.from_pinnrep(pinnrep)
        spans = WeakTraining._spans(pinnrep)

        def weak_block(eq, args, f, w):
            rows, wvec = strategy._equation_rows(eq, args, ctx, pinnrep,
                                                 spans, f)
            scale = torch.as_tensor(
                np.sqrt(np.asarray(wvec, np.float64) * w), dtype=dtype,
                device=device)
            return lambda theta: rows(theta) * scale

        bc_sets = strategy._bc_training_sets(pinnrep, spans)
        blocks = (
            [weak_block(eq, a, f, w) for eq, a, f, w in
             zip(pinnrep.eqs, pinnrep.pde_args,
                 lf.datafree_pde_loss_functions, w_pde)]
            + [dense_block(f, s, w) for f, s, w in
               zip(lf.datafree_bc_loss_functions, bc_sets, w_bc)])

    else:
        raise TypeError(
            f"Gauss-Newton needs a deterministic strategy (GridTraining, "
            f"SeparableTraining(dx=...), QuadratureTraining or WeakTraining); "
            f"got {type(strategy).__name__}")

    def residuals(theta):
        return torch.cat([b(theta) for b in blocks])

    return residuals


def _damped_lsqr(matvec, rmatvec, b, damp, iters: int, hi=None, graph=None):
    """LSQR (Paige & Saunders 1982, Golub-Kahan bidiagonalization) for
    ``min ||J x - b||² + damp²·||x||²``: the LM normal equations
    ``(JᵀJ + damp² I) x = Jᵀ b`` without forming JᵀJ products in the
    recurrence, so the conditioning is κ(J) instead of κ(J)².

    ``matvec``/``rmatvec`` evaluate J·v / Jᵀ·u in the residual dtype; with
    ``hi`` (e.g. torch.float64) the bidiagonalization vectors, rotations and
    solution accumulate in the wider dtype.  The ``iters`` steps are a
    Python loop whose scalars (α, β, ρ̄, φ̄) stay 0-d device tensors: no
    host sync."""
    lo_dtype = b.dtype
    cast = (lambda z: z.to(hi)) if hi is not None else (lambda z: z)
    lo = (lambda z: z.to(lo_dtype)) if hi is not None else (lambda z: z)

    def _normalize(z):
        nrm = torch.linalg.vector_norm(z)
        return z / torch.where(nrm > 0, nrm, torch.ones_like(nrm)), nrm

    u, beta = _normalize(cast(b))
    v, alpha = _normalize(cast(rmatvec(lo(u))))
    damp = torch.as_tensor(damp, device=u.device).to(u.dtype)

    def step(state):
        x, w, u, v, alpha, phibar, rhobar = state
        u, beta = _normalize(cast(matvec(lo(v))) - alpha * u)
        v, alpha = _normalize(cast(rmatvec(lo(u))) - beta * v)
        # rotation eliminating the damping row
        rhobar1 = torch.sqrt(rhobar * rhobar + damp * damp)
        phibar = (rhobar / rhobar1) * phibar
        # Givens rotation eliminating the subdiagonal β
        rho = torch.sqrt(rhobar1 * rhobar1 + beta * beta)
        cs, sn = rhobar1 / rho, beta / rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        return (x + (phi / rho) * w, v - (theta / rho) * w, u, v, alpha,
                phibar, rhobar)

    x = _iterate(step, (torch.zeros_like(v), v, u, v, alpha, beta, alpha),
                 iters, graph)[0]
    return lo(x)


def _cg(matvec, b, maxiter: int, M=None, tol: float = 1e-5, graph=None):
    """Conjugate gradients from x = 0, the iterates of
    `jax.scipy.sparse.linalg.cg`: it stops once ``||r||² ≤ tol²·||b||²``
    (``r·M r`` in place of ``||r||²`` without a preconditioner).  Here a
    device-side flag freezes the iterate instead, so the ``maxiter`` steps
    run with no host sync and return the same point."""
    precond = M if M is not None else (lambda r: r)
    p = precond(b)
    atol2 = tol * tol * torch.dot(b, b)

    def step(state):
        x, r, gamma, p = state
        active = (gamma if M is None else torch.dot(r, r)) > atol2
        Ap = matvec(p)
        alpha = gamma / torch.dot(p, Ap)
        r_new = r - alpha * Ap
        z = precond(r_new)
        gamma_new = torch.dot(r_new, z)
        new = (x + alpha * p, r_new, gamma_new, z + (gamma_new / gamma) * p)
        return tuple(torch.where(active, n, o) for n, o in zip(new, state))

    return _iterate(step, (torch.zeros_like(b), b, torch.dot(b, p), p),
                    maxiter, graph)[0]


_EAGER_STEPS = 2


def _iterate(step, state: tuple, iters: int,
             graph: dict | None = None) -> tuple:
    """``state = step(state)``, ``iters`` times, with no host sync.

    On CPU tensors a plain loop.  On CUDA tensors the first `_EAGER_STEPS`
    iterations run as they are (they warm up what the step allocates and
    initializes), then one iteration is captured as a CUDA graph on the
    current stream, which must be a side stream that also ran the forward
    passes the step differentiates (`_side_stream`), and replayed for the
    rest: Gauss-Newton's inner iterations are launch-bound, a few hundred
    small kernels behind `torch.func` dispatch on the host.  ``graph``, a
    dict with "captures" and "replays", is added to when that happens."""
    state = tuple(state)
    warm = iters if not state[0].is_cuda else min(_EAGER_STEPS, iters)
    for _ in range(warm):
        state = step(state)
    if warm == iters:
        return state
    static = tuple(t.clone() for t in state)
    captured = torch.cuda.CUDAGraph()
    with torch.cuda.graph(captured, stream=torch.cuda.current_stream()):
        for buf, new in zip(static, step(static)):
            buf.copy_(new)
    for _ in range(iters - warm):
        captured.replay()
    if graph is not None:
        graph["captures"] += 1
        graph["replays"] += iters - warm
    return static


def rademacher_probes(n: int, dtype, device, count: int = 8) -> torch.Tensor:
    """``count`` Rademacher vectors of length ``n`` from a fixed generator
    (seed 0): the Hutchinson probes of the Jacobi preconditioner."""
    g = torch.Generator(device=device).manual_seed(0)
    bits = torch.randint(0, 2, (count, n), generator=g, device=device)
    return (2 * bits - 1).to(dtype)


def lm_least_squares(r_fn: Callable, init_params, *, maxiters: int = 50,
                     damping: float = 1e-3, cg_iters: int = 100,
                     damping_factor: float = 3.0, min_damping: float = 1e-12,
                     max_damping: float = 1e8, abstol: float = 0.0,
                     precondition: bool = False, solver: str = "cg",
                     scalar_dtype=None,
                     matmul_precision: str | None = "highest",
                     verbose: bool = False, callback=None,
                     probes: Callable = rademacher_probes) -> SolveResult:
    """Levenberg-Marquardt on ``loss(θ) = ||r_fn(θ)||²`` for any residual
    function of a parameter dict.

    Each outer iteration: residual and gradient, a ``cg_iters``-step
    matrix-free inner solve of ``(JᵀJ + λI)δ = Jᵀr``, and the trial
    objective at ``θ - δ``.  λ adapts on the host: accepted steps divide it
    by ``damping_factor``, rejected steps multiply (θ unchanged).  Stops at
    ``maxiters`` outer iterations or ``loss < abstol``.

    * ``solver``: "cg" (CG on the normal equations; each iteration one jvp +
      one vjp) or "lsqr" (damped LSQR on J itself — same cost per
      iteration, conditioning κ(J) instead of κ(J)²).
    * ``scalar_dtype``: with solver="lsqr", run the recurrence/rotations in
      this wider dtype (e.g. ``torch.float64``) while the J products stay in
      the residual dtype (mixed-precision GN).
    * ``precondition``: Jacobi preconditioner for CG from a Hutchinson
      estimate of diag(JᵀJ) over ``probes(n, dtype, device)`` (8 Rademacher
      vectors from a fixed generator by default).
    * ``matmul_precision``: the matmul-precision context of every GN
      computation (default "highest": true float32 matmuls, TF32 off);
      None inherits the ambient setting.

    ``result.aux["cuda_graph"]`` counts the inner steps' graph captures and
    replays on the card (both 0 on the CPU), as `solve`'s does.
    """
    v0, unravel = parameters_to_vector(init_params)
    v0 = v0.detach()
    if v0.dtype == torch.float32 and matmul_precision != "highest":
        warnings.warn(
            "float32 Gauss-Newton without matmul_precision='highest' may run "
            "its matmuls in TF32, which stalls the solve far above the "
            "float32 floor — leave matmul_precision='highest' or use a "
            "float64 problem", stacklevel=2)
    if solver not in ("cg", "lsqr"):
        raise ValueError(f"solver must be 'cg' or 'lsqr', got {solver!r}")
    if scalar_dtype is not None and solver != "lsqr":
        raise ValueError("scalar_dtype (mixed-precision recurrence) requires "
                         "solver='lsqr'")
    if precondition and solver == "lsqr":
        raise ValueError("precondition=True is a CG-only option (LSQR is "
                         "already better conditioned; use solver='cg' with "
                         "precondition, or drop one of them)")

    def r_flat(v):
        return r_fn(unravel(v))

    def loss_of(v):
        r = r_flat(v)
        return torch.sum(r * r)

    def trial(v, lam):
        r, vjp_fn = vjp(r_flat, v)

        def J(p):
            return jvp(r_flat, (v,), (p,))[1]

        if solver == "lsqr":
            delta = _damped_lsqr(J, lambda y: vjp_fn(y)[0], r,
                                 torch.sqrt(lam), cg_iters, hi=scalar_dtype,
                                 graph=graph)
        else:
            M = None
            if precondition:
                # Jacobi preconditioner from a Hutchinson estimate of
                # diag(JᵀJ): E[(JᵀJ z) ⊙ z] over Rademacher z (fixed probes
                # — determinism keeps the LM accept/reject stable)
                zs = probes(v.shape[0], v.dtype, v.device)
                diag = torch.mean(vmap(lambda z: vjp_fn(J(z))[0] * z)(zs),
                                  dim=0)
                inv = 1.0 / (torch.abs(diag) + lam)
                M = lambda p: inv * p      # noqa: E731
            delta = _cg(lambda p: vjp_fn(J(p))[0] + lam * p, vjp_fn(r)[0],
                        cg_iters, M, graph=graph)
        v_new = v - delta
        return v_new, loss_of(v_new)

    lam = float(damping)
    v = v0
    graph = {"captures": 0, "replays": 0}
    with _side_stream(v0), _prec_ctx(matmul_precision):
        loss = float(loss_of(v))
        history = [loss]
        it = 0
        while it < maxiters:
            v_new, loss_new = trial(v, torch.tensor(lam, dtype=v.dtype,
                                                    device=v.device))
            loss_new = float(loss_new)
            if np.isfinite(loss_new) and loss_new < loss:
                v, loss = v_new, loss_new
                lam = max(lam / damping_factor, min_damping)
                accepted = True
            else:
                lam = min(lam * damping_factor, max_damping)
                accepted = False
            it += 1
            history.append(loss)
            if verbose:
                print(f"[gn] iter={it} loss={loss:.3e} lam={lam:.1e} "
                      f"{'acc' if accepted else 'rej'}")
            if callback is not None:
                callback(it, loss, lam, accepted)
            if loss < abstol:
                break
            if lam >= max_damping:
                break   # stalled: no descent direction at any damping

    return SolveResult(u=unravel(v), objective=loss, iterations=it,
                       aux={"damping": lam, "cuda_graph": graph},
                       history=history)


def trust_region_least_squares(r_fn: Callable, init_params, *,
                               maxiters: int = 50, cg_iters: int = 100,
                               delta0: float = 1.0, max_delta: float = 1e4,
                               eta: float = 0.125, abstol: float = 0.0,
                               matmul_precision: str | None = "highest",
                               verbose: bool = False,
                               callback=None) -> SolveResult:
    """Steihaug-Toint trust-region Gauss-Newton on ``loss = ||r_fn(θ)||²``
    (Conn, Gould & Toint 2000, Alg. 7.5.1): the model
    ``m(p) = gᵀp + ½pᵀJᵀJp`` is minimized over ``||p|| <= Δ`` by truncated
    CG that stops at the boundary, on negative curvature or at a small
    model gradient; the radius Δ adapts on the host from the
    actual/predicted reduction ratio.

    The truncated CG is a host loop that reads its two stop flags once per
    inner iteration (one sync each), so it stops as early as the JAX
    package's `while_loop` and runs no product past the stop.
    ``matmul_precision``: see `lm_least_squares`."""
    if not eta < 0.25:
        # the radius only shrinks when rho < 0.25; with eta >= 0.25 a
        # rejected step with rho in [0.25, eta] would leave delta unchanged
        # and the deterministic trial would repeat identically forever
        raise ValueError(f"eta must be < 0.25 (got {eta}): the trust-region "
                         "radius shrinks only when rho < 0.25")
    v0, unravel = parameters_to_vector(init_params)
    v0 = v0.detach()

    def r_flat(v):
        return r_fn(unravel(v))

    def loss_of(v):
        r = r_flat(v)
        return torch.sum(r * r)

    def tr_step(v, delta):
        r, vjp_fn = vjp(r_flat, v)
        g = vjp_fn(r)[0]                 # ∇(½||r||²) = Jᵀr

        def B(p):
            return vjp_fn(jvp(r_flat, (v,), (p,))[1])[0]

        info = torch.finfo(v.dtype)
        g2 = torch.dot(g, g)
        small_tol = max((50.0 * info.eps) ** 2, 1e-14)

        def boundary(p, d):
            # τ >= 0 with ||p + τ d|| = Δ
            pd, dd, pp = torch.dot(p, d), torch.dot(d, d), torch.dot(p, p)
            disc = torch.sqrt(torch.clamp_min(pd * pd - dd * (pp - delta * delta),
                                              0.0))
            return (-pd + disc) / torch.clamp_min(dd, info.tiny)

        p = torch.zeros_like(g)
        rr, d = g, -g
        m = torch.zeros((), dtype=v.dtype, device=v.device)
        hit, n_inner = False, 0
        while n_inner < cg_iters:
            Bd = B(d)
            dBd = torch.dot(d, Bd)
            rr2 = torch.dot(rr, rr)
            rd = torch.dot(rr, d)
            alpha = rr2 / torch.where(dBd > 0, dBd, torch.ones_like(dBd))
            p_try = p + alpha * d
            to_boundary = (dBd <= 0) | (torch.dot(p_try, p_try)
                                        >= delta * delta)
            step = torch.where(to_boundary, boundary(p, d), alpha)
            p = p + step * d
            # model value m(p) = gᵀp + ½pᵀBp accumulated along the CG path
            m = m + step * rd + 0.5 * step * step * dBd
            n_inner += 1
            if bool(to_boundary):
                hit = True
                break
            rr_new = rr + alpha * Bd
            rr2_new = torch.dot(rr_new, rr_new)
            d = -rr_new + (rr2_new / torch.clamp_min(rr2, info.tiny)) * d
            rr = rr_new
            if bool(rr2_new < small_tol * g2):
                break
        # predicted reduction of the ½||r||² model (positive for descent)
        v_new = v + p
        return (v_new, loss_of(v_new), -m, torch.linalg.vector_norm(p), hit,
                n_inner)

    v = v0
    with _prec_ctx(matmul_precision):
        loss = float(loss_of(v))
    delta = float(delta0)
    history = [loss]
    it = 0
    inner_total = 0
    while it < maxiters:
        with _prec_ctx(matmul_precision):
            v_new, loss_new, pred, pnorm, hit, n_inner = tr_step(
                v, torch.as_tensor(delta, dtype=v.dtype, device=v.device))
        inner_total += n_inner
        loss_new, pred, pnorm = float(loss_new), float(pred), float(pnorm)
        if not (np.isfinite(loss_new) and np.isfinite(pred)
                and np.isfinite(pnorm)):
            # NaN/Inf trial (radius overshot into a non-finite region):
            # reject AND shrink, or the deterministic step would repeat
            # identically for every remaining iteration
            rho, accepted = -1.0, False
            delta = max(0.25 * delta, 1e-12)
        else:
            ared = 0.5 * (loss - loss_new)  # actual reduction in ½ metric
            rho = ared / max(pred, 1e-300)
            accepted = rho > eta and loss_new < loss
            if accepted:
                v, loss = v_new, loss_new
            if rho < 0.25:
                delta = max(0.25 * pnorm, 1e-12)
            elif rho > 0.75 and hit:
                delta = min(2.0 * delta, max_delta)
        it += 1
        history.append(loss)
        if verbose:
            print(f"[gn-tr] iter={it} loss={loss:.3e} delta={delta:.1e} "
                  f"rho={rho:.2f} {'acc' if accepted else 'rej'}")
        if callback is not None:
            callback(it, loss, delta, accepted)
        if loss < abstol:
            break
        if delta <= 1e-12:
            break   # radius collapsed: no trustable descent direction

    return SolveResult(u=unravel(v), objective=loss, iterations=it,
                       aux={"delta": delta, "inner_iterations": inner_total},
                       history=history)


def solve_gauss_newton(prob, *, method: str = "lm", adaptive_state=None,
                       **kwargs) -> SolveResult:
    """Gauss-Newton on a discretized `TrainingProblem`'s least-squares
    objective (deterministic strategies only: GridTraining, static-grid
    SeparableTraining or QuadratureTraining).

    ``method``: "lm" (Levenberg-Marquardt damping, `lm_least_squares`) or
    "tr" (Steihaug trust region, `trust_region_least_squares`).
    ``adaptive_state``: required when the problem uses an adaptive loss —
    pass ``res.aux["adaptive_state"]`` from the training `solve` so GN
    polishes the same weighted objective (see `build_residual_vector`)."""
    return _ls_driver(method)(
        build_residual_vector(prob.pinnrep, adaptive_state),
        prob.init_params, **kwargs)


# ---------------------------------------------------------------------------
# Gauss-Newton for the ODE solver surface (NNODE)
# ---------------------------------------------------------------------------

def build_ode_residual_vector(prob, alg, *, dt=None, device=None):
    """Flat residual ``r(theta) -> (M,)`` for an `ODEProblem` + `NNODE`
    config with ``||r(θ)||² == total NNODE loss``: physics rows at the
    strategy's deterministic time points scaled 1/√N (matching
    `inner_loss`'s sum/N reduction, solvers/ode.py), plus data-L2 rows
    (scale 1) and Data-Quadrature rows (scale √w) for inverse problems
    (reference losses: src/ode_solve.jl:184-342).

    Deterministic strategies only: GridTraining or
    WeightedIntervalTraining (its one-shot sample is drawn at build time,
    like the reference's per-solve draw).  ``device`` defaults to
    ``"cuda"``.  Returns ``(r_fn, theta0, phi)``.
    """
    from .config import default_float
    from .solvers.ode import (
        _batched_f, _problem_p, initial_theta, make_phi, ode_dfdx,
    )

    dtype = default_float()
    device = torch.device(device if device is not None else "cuda")
    t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
    if np.iscomplexobj(np.asarray(prob.u0)):
        raise ValueError("Gauss-Newton residual vectors require real u "
                         "(complex ODEs: use solve_ode with Adam/L-BFGS)")
    if alg.additional_loss is not None:
        raise ValueError(
            "Gauss-Newton cannot fold NNODE(additional_loss=...) into the "
            "least-squares residual vector (||r||^2 would silently differ "
            "from the trained objective) — stack your extra terms as "
            "residual rows via lm_least_squares instead")
    scalar_u0 = np.ndim(prob.u0) == 0
    n_output = 1 if scalar_u0 else int(np.prod(np.shape(prob.u0)))
    dataset = alg.dataset or []

    theta0 = initial_theta(prob, alg, dtype, device)
    phi = make_phi(prob, alg, theta0)
    p_fixed = _problem_p(prob.p, dtype, device)

    def tensor(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    strategy = alg.strategy
    if strategy is None and dt is not None:
        strategy = GridTraining(dt)
    if isinstance(strategy, GridTraining):
        ts = tensor(julia_range(t0, t1, strategy.dx))
    elif isinstance(strategy, WeightedIntervalTraining):
        ts = tensor(strategy.sample_times(t0, t1))
    else:
        raise TypeError(
            "Gauss-Newton needs a deterministic NNODE objective: use "
            "GridTraining(dx)/dt= or WeightedIntervalTraining; got "
            f"{type(strategy).__name__}")
    f_b = _batched_f(prob.f)
    inv_sqrt_n = float(ts.shape[0]) ** -0.5

    def physics_rows(theta):
        p_ = theta["p"] if alg.param_estim else p_fixed
        out = phi(ts, theta)
        fs = f_b(out[0] if scalar_u0 else out, p_, ts)
        dxdt = ode_dfdx(phi, ts, theta, alg.autodiff)
        return (fs - dxdt).reshape(-1) * inv_sqrt_n

    blocks = [physics_rows]
    if alg.param_estim and dataset:
        t_d = tensor(dataset[-2])
        us = torch.stack([tensor(dataset[i]) for i in range(n_output)])

        def data_rows(theta):
            return (phi(t_d, theta) - us).reshape(-1)  # sum-of-squares: scale 1

        blocks.append(data_rows)
        if alg.estim_collocate:
            w = torch.sqrt(tensor(dataset[-1]))

            def collocate_rows(theta):
                dxdt = ode_dfdx(phi, t_d, theta, alg.autodiff)
                fs = f_b(us[0] if scalar_u0 else us, theta["p"], t_d)
                return ((dxdt - fs) * w[None, :]).reshape(-1)

            blocks.append(collocate_rows)

    def r_fn(theta):
        return torch.cat([b(theta) for b in blocks])

    return r_fn, theta0, phi


def solve_ode_gauss_newton(prob, alg, *, dt=None, saveat=None,
                           save_everystep: bool = True, method: str = "lm",
                           device=None, **kwargs):
    """`solve_ode` with Gauss-Newton instead of a first-order optimizer:
    the NNODE objective (physics + inverse-problem losses) is minimized as
    the nonlinear least-squares problem it is.  ``method``: "lm" or "tr";
    ``device`` defaults to ``"cuda"``; remaining kwargs go to
    `lm_least_squares` or `trust_region_least_squares`.  Returns the same dense
    `ODESolution` as `solve_ode`."""
    from .solvers.ode import build_ode_solution

    r_fn, theta0, phi = build_ode_residual_vector(prob, alg, dt=dt,
                                                  device=device)
    res = _ls_driver(method)(r_fn, theta0, **kwargs)
    return build_ode_solution(prob, phi, res, dt=dt, saveat=saveat,
                              save_everystep=save_everystep)


# ---------------------------------------------------------------------------
# Gauss-Newton for the operator solvers (PINOODE, PINOPDE)
# ---------------------------------------------------------------------------

def build_pino_residual_vector(prob, alg, *, dt=None, device=None):
    """Flat residual for an `ODEProblem` + `PINOODE` config with
    ``||r(θ)||² == PINO loss`` (physics mean + IC mean, `solvers/pino.py`
    `_losses`) on the deterministic GridTraining (p, t) product train set,
    on ``device`` (``"cuda"`` unless given).  Returns ``(r_fn, theta0,
    phi)``."""
    from .config import default_float
    from .solvers.ode import initial_theta
    from .solvers.pino import PINOPhi, _grid_trainset, _residuals

    dtype = default_float()
    device = torch.device(device if device is not None else "cuda")
    if alg.bounds is None:
        raise ValueError("PINOODE requires parameter bounds")
    if alg.additional_loss is not None:
        raise ValueError(
            "Gauss-Newton cannot fold PINOODE(additional_loss=...) into the "
            "least-squares residual vector — stack your extra terms as "
            "residual rows via lm_least_squares instead")
    strategy = alg.strategy
    if strategy is None and dt is not None:
        strategy = GridTraining(dt)
    if not isinstance(strategy, GridTraining):
        raise TypeError(
            "Gauss-Newton needs a deterministic PINO train set: use "
            "PINOODE(strategy=GridTraining(dx)) or pass dt=")
    bounds = [tuple(map(float, b)) for b in alg.bounds]
    tspan = (float(prob.tspan[0]), float(prob.tspan[1]))
    phi = PINOPhi(alg.chain)
    theta0 = initial_theta(prob, alg, dtype, device)
    p_tr, t_tr = _grid_trainset(bounds, alg.number_of_parameters, tspan,
                                strategy.dx or dt, dtype, device)

    def r_fn(theta):
        r_phys, r_ic = _residuals(phi, prob, p_tr, t_tr, theta)
        return torch.cat([r_phys.reshape(-1) / math.sqrt(r_phys.numel()),
                          r_ic.reshape(-1) / math.sqrt(r_ic.numel())])

    return r_fn, theta0, phi


def solve_pino_gauss_newton(prob, alg, *, dt=None, method: str = "lm",
                            device=None, **kwargs):
    """`solve_pino_ode` with Gauss-Newton: minimizes the operator-learning
    least squares (physics + IC over the (p, t) grid) on ``device``
    (``"cuda"`` unless given).  Returns the same `PINOODESolution`."""
    from .config import default_float
    from .solvers.pino import (
        PINOODESolution, _grid_trainset, _n_out, make_pino_interp,
    )

    r_fn, theta0, phi = build_pino_residual_vector(prob, alg, dt=dt,
                                                   device=device)
    res = _ls_driver(method)(r_fn, theta0, **kwargs)

    like = next(iter(theta0.values()))
    bounds = [tuple(map(float, b)) for b in alg.bounds]
    tspan = (float(prob.tspan[0]), float(prob.tspan[1]))
    strategy = (alg.strategy if isinstance(alg.strategy, GridTraining)
                else GridTraining(dt))
    p_fin, t_fin = _grid_trainset(bounds, alg.number_of_parameters, tspan,
                                  strategy.dx or dt, default_float(),
                                  like.device)
    interp = make_pino_interp(phi, res.u, _n_out(prob))
    return PINOODESolution(u=interp(p_fin, t_fin), t=t_fin, p=p_fin,
                           interp=interp, original=res)


def build_pino_pde_residual_vector(pde_system, alg, *, device=None):
    """Flat residual for a `PDESystem` + `PINOPDE` config with
    ``||r(θ)||² == PINOPDE loss`` (per-equation mean-square residual
    fields, `solvers/pino_pde.py`) on the family fixed at build, on
    ``device`` (``"cuda"`` unless given).  Returns ``(r_fn, theta0,
    built)`` with ``built`` the shared lowering (`solvers/pino_pde._build`)."""
    from .compile.lower import depvar_params
    from .solvers.pino_pde import _build

    if alg.additional_loss is not None:
        raise ValueError(
            "Gauss-Newton cannot fold PINOPDE(additional_loss=...) into the "
            "least-squares residual vector — stack your extra terms as "
            "residual rows via lm_least_squares instead")
    if alg.resample:
        raise ValueError(
            "Gauss-Newton needs a deterministic objective: use "
            "PINOPDE(resample=False) (polish the fixed build-time family)")
    if alg.causal_eps is not None:
        raise ValueError(
            "Gauss-Newton cannot express causal weighting as a fixed "
            "least-squares residual (weights depend on the residuals); "
            "polish with PINOPDE(causal_eps=None)")
    b = _build(pde_system, alg, device)

    def r_fn(theta):
        with b.prec():
            fields = b.eval_fields(depvar_params(theta), b.p_tr, b.grids,
                                   b.input_samples)
            rows = [r(fields, b.p_tr) for r in b.residuals]
        return torch.cat([r.reshape(-1) / math.sqrt(r.numel())
                          for r in rows])

    return r_fn, b.theta0, b


def solve_pino_pde_gauss_newton(pde_system, alg, *, method: str = "lm",
                                device=None, **kwargs):
    """`solve_pino_pde` with Gauss-Newton: minimizes the operator-learning
    least squares over the field-grid residuals on ``device`` (``"cuda"``
    unless given).  Returns the same `PINOPDESolution`.  Typical use: Adam
    pre-training by `solve_pino_pde`, then a polish with
    ``alg.init_params = depvar_params(sol.original.u)``."""
    from .solvers.pino_pde import _make_solution

    r_fn, theta0, b = build_pino_pde_residual_vector(pde_system, alg,
                                                     device=device)
    res = _ls_driver(method)(r_fn, theta0, **kwargs)
    return _make_solution(b, res.u, res)
