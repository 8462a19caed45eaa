"""Training strategies (`neuralpde_tpu.strategies`; reference:
src/training_strategies.jl).

Each strategy pairs a collocation-point source with a loss reduction and
produces per-equation scalar objectives ``loss(theta, generator) -> scalar``.
Deterministic strategies ignore the generator; stochastic ones draw a fresh
sample from it on every call, on the problem's device, so a step that
samples can be captured as a CUDA graph and replayed with fresh draws.
`QuadratureTraining` refines its rule when the loss is built, reading
values on the host there and never inside a step.

The random strategies draw their points through a ``sampler`` attribute,
``(n, lb, ub, generator) -> (dim, n)``, which tests replace to feed the
JAX package and the port the same points.

Under an active mesh (`parallel.mesh`) every loss draws the global batch
and returns this rank's share of its value: `shard_batch` keeps the rank's
slice of the points, and a term whose points do not divide over the data
axis is computed whole and counted at 1/W.  The training step sums the
shares.  Without a mesh the losses are computed as they were.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .ops import sampling
from .ops.quadrature import tensor_rule_box
from .ops.sampling import uniform_random
from .parallel.mesh import (
    data_rank, data_size, share, shard_batch, sum_over_data,
)
from .symbolic.expr import Sym
from .symbolic.system import infimum, supremum


class TrainingStrategy:
    pass


def _msq(r, acc=None):
    """mean(r²), optionally accumulated in a wider dtype ``acc``."""
    sq = r * r
    if acc is not None:
        sq = sq.to(acc)
    return torch.mean(sq)


def _wsum_sq(r, w, acc=None):
    """sum(r²·w) with optional wide-dtype accumulation (quadrature loss)."""
    sq = r * r
    if acc is not None:
        sq = sq.to(acc)
        w = w.to(acc)
    return torch.sum(sq * w)


def _msq_at(residual, pts, theta, acc=None):
    """mean(r²) of ``residual`` at the points ``pts`` (dim, N); under a mesh
    the rank's share of it: the mean over the rank's slice over W, which is
    also the share of a term computed whole (module note)."""
    return share(_msq(residual(shard_batch(pts), theta), acc))


def julia_range(a: float, b: float, dx: float) -> np.ndarray:
    """Julia `a:dx:b` — inclusive of b when it lands on the grid."""
    n = int(np.floor((b - a) / dx + 1e-10)) + 1
    return a + dx * np.arange(n)


def generate_training_sets(domains, dx, eq_args_list, dtype, device=None):
    """Cartesian-product grids per equation (reference: src/discretize.jl:183-239).

    ``eq_args_list``: per equation, the get_argument layout (Syms and numbers).
    Returns a list of (rows, N) coordinate tensors on ``device``.
    """
    dxs = dx if isinstance(dx, (list, tuple)) else [dx] * len(domains)
    spans = {d.variables.name: julia_range(infimum(d.domain), supremum(d.domain), h)
             for d, h in zip(domains, dxs)}
    out = []
    for args in eq_args_list:
        axes = [spans[a.name] if isinstance(a, Sym) else np.array([float(a)])
                for a in args]
        grid = np.meshgrid(*axes, indexing="ij") if axes else [np.zeros((1,))]
        cord = np.stack([g.reshape(-1) for g in grid], axis=0)
        out.append(torch.as_tensor(cord, dtype=dtype, device=device))
    return out


def get_bounds(domains, eq_args_list, points: int, dtype, device=None):
    """Per-equation (lb, ub) tensors for sampling strategies, with the
    reference's 1/points inset (src/discretize.jl:297-322)."""
    dx = 1.0 / points
    lo = {d.variables.name: infimum(d.domain) + dx for d in domains}
    hi = {d.variables.name: supremum(d.domain) - dx for d in domains}
    bounds = []
    for args in eq_args_list:
        lb = np.array([lo[a.name] if isinstance(a, Sym) else float(a) for a in args])
        ub = np.array([hi[a.name] if isinstance(a, Sym) else float(a) for a in args])
        bounds.append((torch.as_tensor(lb, dtype=dtype, device=device),
                       torch.as_tensor(ub, dtype=dtype, device=device)))
    return bounds


def get_loss_function(pinnrep, residual, args=None, strategy=None):
    """Per-strategy scalar loss for ONE datafree residual — the reference's
    exported debugging entry (reference: src/NeuralPDE.jl:101-105,
    src/training_strategies.jl:163-176): given a residual closure
    ``residual(cord, theta)``, returns ``loss(theta, generator) -> scalar``
    built by the strategy's point source + reduction, on ``pinnrep``'s
    device.

    ``args`` is the equation's argument layout (defaults to the first PDE's);
    ``strategy`` defaults to ``pinnrep.strategy``.
    """
    from types import SimpleNamespace

    strategy = strategy if strategy is not None else pinnrep.strategy
    if args is None:
        args = pinnrep.pde_args[0]
    shim = SimpleNamespace(dtype=pinnrep.dtype, device=pinnrep.device,
                           domains=pinnrep.domains, pde_args=[list(args)],
                           bc_args=[],
                           loss_accum_dtype=pinnrep.loss_accum_dtype,
                           flat_init_params=pinnrep.flat_init_params)
    pde, _ = strategy.build(shim, [residual], [])
    return pde[0]


class GridTraining(TrainingStrategy):
    """Cartesian grid with spacing `dx` (reference: src/training_strategies.jl:1-15)."""

    def __init__(self, dx):
        self.dx = dx

    def build(self, pinnrep, datafree_pde, datafree_bc):
        dtype, device = pinnrep.dtype, pinnrep.device
        pde_sets = generate_training_sets(
            pinnrep.domains, self.dx, pinnrep.pde_args, dtype, device)
        bc_sets = generate_training_sets(
            pinnrep.domains, self.dx, pinnrep.bc_args, dtype, device)
        acc = pinnrep.loss_accum_dtype
        pde = [_mean_sq_loss(f, s, acc) for f, s in zip(datafree_pde, pde_sets)]
        bc = [_mean_sq_loss(f, s, acc) for f, s in zip(datafree_bc, bc_sets)]
        return pde, bc


def _mean_sq_loss(residual, train_set, acc=None):
    def loss(theta, generator=None):
        del generator
        return _msq_at(residual, train_set, theta, acc)

    return loss


class StochasticTraining(TrainingStrategy):
    """Uniform resample each step (reference: src/training_strategies.jl:190-237).

    ``microbatch``: evaluate the residual in chunks of that many points, each
    under `torch.utils.checkpoint`, so only one chunk's activations are alive
    at a time and the backward pass recomputes them chunk by chunk.  Chunk
    ``c`` holds columns ``c*microbatch ... (c+1)*microbatch - 1`` of the
    sample, as in the JAX package (under a mesh, of the rank's slice of
    it; the JAX package splits every chunk over the devices instead, and
    the sums agree up to their order).  ``points`` must be a multiple of
    ``microbatch``.

    ``sampler``: the point source, ``(n, lb, ub, generator) -> (dim, n)``;
    `uniform_random` unless replaced (tests replace it to feed both packages
    the same points).
    """

    def __init__(self, points: int, bcs_points: int | None = None,
                 microbatch: int | None = None):
        self.points = points
        self.bcs_points = bcs_points if bcs_points is not None else points
        self.microbatch = microbatch
        self.sampler = uniform_random
        if microbatch is not None and points % microbatch != 0:
            raise ValueError(
                f"points ({points}) must be a multiple of microbatch "
                f"({microbatch})")

    def build(self, pinnrep, datafree_pde, datafree_bc):
        dtype, device = pinnrep.dtype, pinnrep.device
        pde_bounds = get_bounds(pinnrep.domains, pinnrep.pde_args, self.points,
                                dtype, device)
        bc_bounds = get_bounds(pinnrep.domains, pinnrep.bc_args, self.points,
                               dtype, device)
        acc = pinnrep.loss_accum_dtype
        mb = self.microbatch

        def make(residual, bound, n):
            lb, ub = bound

            if mb is not None and n > mb:
                def chunk_sum(theta, pts):
                    sq = residual(pts, theta) ** 2
                    if acc is not None:
                        sq = sq.to(acc)
                    return torch.sum(sq)

                def loss(theta, generator):
                    pts = self.sampler(n, lb, ub, generator)
                    # under a mesh each rank evaluates its slice of the
                    # sample in chunks of ``microbatch`` points, so a rank
                    # launches 1/W of the chunks, each at the full chunk
                    # width; a chunk draws no random numbers, so its CUDA
                    # RNG state is not saved (as jax.checkpoint; saving it
                    # is not allowed while a CUDA graph captures the step)
                    local = shard_batch(pts)
                    sums = [checkpoint(chunk_sum, theta, local[:, c:c + mb],
                                       use_reentrant=False,
                                       preserve_rng_state=False)
                            for c in range(0, local.shape[-1], mb)]
                    total = torch.sum(torch.stack(sums)) / n
                    return total if local is not pts else share(total)

                return loss

            def loss(theta, generator):
                return _msq_at(residual, self.sampler(n, lb, ub, generator),
                               theta, acc)

            return loss

        pde = [make(f, b, self.points) for f, b in zip(datafree_pde, pde_bounds)]
        bc = [make(f, b, self.bcs_points) for f, b in zip(datafree_bc, bc_bounds)]
        return pde, bc


def _sampled_loss(residual, strategy, bound, n, acc):
    """mean-square residual at ``n`` points in ``bound`` from the strategy's
    ``sampler`` (looked up at each call, so a replaced sampler takes
    effect in a built problem)."""
    lb, ub = bound

    def loss(theta, generator):
        return _msq_at(residual, strategy.sampler(n, lb, ub, generator),
                       theta, acc)

    return loss


class QuasiRandomTraining(TrainingStrategy):
    """Low-discrepancy sampling (reference: src/training_strategies.jl:266-344).

    ``sampling_alg`` is "lhs" (Latin hypercube, the reference default),
    "sobol" or "lattice" (a randomly shifted Sobol or rank-1 lattice design,
    its bits precomputed on the host once and kept on the device).  With
    ``resampling=True`` every step draws a fresh randomized sample; otherwise
    ``minibatch`` designs are drawn once (from a generator seeded 0 on the
    problem's device) and each step picks one at random.
    """

    def __init__(self, points: int, bcs_points: int | None = None,
                 sampling_alg: str = "lhs", resampling: bool = True,
                 minibatch: int = 0):
        if sampling_alg not in ("lhs", "sobol", "lattice"):
            raise ValueError("sampling_alg must be 'lhs', 'sobol' or 'lattice'")
        self.points = points
        self.bcs_points = bcs_points if bcs_points is not None else points
        self.sampling_alg = sampling_alg
        self.resampling = resampling
        self.minibatch = minibatch
        self.sampler = None

    def _design(self, n, lb, ub):
        """The sampler of the chosen design: ``(n, lb, ub, generator)``."""
        if self.sampling_alg == "lhs":
            return sampling.latin_hypercube
        base = (sampling.sobol_bits if self.sampling_alg == "sobol"
                else sampling.lattice_rule_bits)(n, lb.shape[0])
        bits = sampling.bits_tensor(base, lb.device)
        return lambda n, lb, ub, generator: sampling.sobol_sample(
            bits, lb, ub, generator)

    def build(self, pinnrep, datafree_pde, datafree_bc):
        dtype, device = pinnrep.dtype, pinnrep.device
        acc = pinnrep.loss_accum_dtype
        pde_bounds = get_bounds(pinnrep.domains, pinnrep.pde_args, self.points,
                                dtype, device)
        bc_bounds = get_bounds(pinnrep.domains, pinnrep.bc_args, self.points,
                               dtype, device)
        if not self.resampling and self.minibatch <= 0:
            raise ValueError("minibatch must be > 0 when resampling=False")

        def make(residual, bound, n):
            lb, ub = bound
            design = self._design(n, lb, ub)

            def sampler(n, lb, ub, generator):
                return (self.sampler or design)(n, lb, ub, generator)

            if self.resampling:
                def loss(theta, generator):
                    return _msq_at(residual, sampler(n, lb, ub, generator),
                                   theta, acc)

                return loss
            seeded = torch.Generator(device=device).manual_seed(0)
            batch = torch.stack([sampler(n, lb, ub, seeded)
                                 for _ in range(self.minibatch)])

            def loss(theta, generator):
                idx = torch.randint(0, self.minibatch, (1,),
                                    generator=generator, device=device)
                return _msq_at(residual, torch.index_select(batch, 0, idx)[0],
                               theta, acc)

            return loss

        pde = [make(f, b, self.points) for f, b in zip(datafree_pde, pde_bounds)]
        bc = [make(f, b, self.bcs_points) for f, b in zip(datafree_bc, bc_bounds)]
        return pde, bc


class QuadratureTraining(TrainingStrategy):
    """Loss = (1/|Ω|)·∫_Ω ‖residual‖² via a composite Gauss-Legendre tensor
    rule (reference: src/training_strategies.jl:367-436 uses h-adaptive
    CubatureJLh).  A training step keeps fixed shapes, so adaptivity runs
    when the loss is built: with ``panels=None`` (the default) the panel
    count doubles until two successive composite rules agree on the
    initial-parameter loss integral to ``reltol``/``abstol``, subject to
    ``(order·panels)^dim <= maxiters`` integrand evaluations (the
    reference's maxiters semantics).  An explicit ``panels`` pins the rule
    and skips refinement.  The rule's nodes and weights lie on the problem's
    device from then on.

    For runtime h-adaptive *evaluation* parity (the reference's per-point
    adaptive integrals) see `ops.quadrature.adaptive_quad_1d` and
    `compile.lower.get_numeric_integral(..., adaptive=True)`.
    """

    DEFAULT_PANELS = 4  # used when no integrand is available for refinement

    def __init__(self, order: int = 8, panels: int | None = None,
                 reltol=1e-6, abstol=1e-3, maxiters=1000, batch=0):
        self.order = order
        self.panels = panels
        self.reltol = float(reltol)
        self.abstol = float(abstol)
        self.maxiters = int(maxiters)
        self.batch = batch  # API parity; every node is evaluated in one batch
        # per-equation trained-rule checks registered by build() when the
        # rule was auto-refined (see validate_trained)
        self._trained_checks = []

    @property
    def static_panels(self) -> int:
        """Pinned panel count for call sites without a refinement integrand."""
        return self.panels if self.panels is not None else self.DEFAULT_PANELS

    def resolve_panels(self, integral_at=None, dim: int = 1) -> int:
        """Static auto-refinement honoring reltol/abstol/maxiters.

        ``integral_at(panels) -> float`` evaluates the loss integral with the
        given composite-rule panel count (at the initial parameters).  Panels
        double until two successive rules agree to the tolerances; the node
        budget ``(order·panels)^dim <= maxiters`` mirrors the reference's
        max integrand evaluations (src/training_strategies.jl:406-436).
        Each evaluation is read on the host.
        """
        if self.panels is not None:
            return self.panels
        if integral_at is None:
            return self.DEFAULT_PANELS
        panels = 1
        prev = float(integral_at(panels))
        while (self.order * 2 * panels) ** dim <= self.maxiters:
            cur = float(integral_at(2 * panels))
            if abs(cur - prev) <= max(self.abstol, self.reltol * abs(cur)):
                return 2 * panels  # converged; keep the finer rule
            prev = cur
            panels *= 2
        return panels

    def build(self, pinnrep, datafree_pde, datafree_bc):
        dtype, device = pinnrep.dtype, pinnrep.device
        lo = {d.variables.name: infimum(d.domain) for d in pinnrep.domains}
        hi = {d.variables.name: supremum(d.domain) for d in pinnrep.domains}
        theta0 = pinnrep.flat_init_params
        acc = pinnrep.loss_accum_dtype

        def make(residual, args):
            syms = [a for a in args if isinstance(a, Sym)]
            if not syms:
                dummy = torch.zeros((len(args), 10), dtype=dtype,
                                    device=device)
                return _mean_sq_loss(residual, dummy, acc)
            lb = [lo[s.name] for s in syms]
            ub = [hi[s.name] for s in syms]
            area = float(np.prod(np.asarray(ub) - np.asarray(lb)))

            def rule(p):
                # quadrature cord rows = symbol args only; constant args are
                # folded into the residual at lowering time (row layout)
                nodes, weights = tensor_rule_box(lb, ub, self.order, p)
                return (torch.as_tensor(nodes, dtype=dtype, device=device),
                        torch.as_tensor(weights / area, dtype=dtype,
                                        device=device))

            def integral_of(theta):
                def at(p):
                    n, w = rule(p)
                    with torch.no_grad():
                        return float(torch.sum(residual(n, theta) ** 2 * w))

                return at

            refine = theta0 is not None and self.panels is None
            panels = self.resolve_panels(
                integral_of(theta0) if refine else None, len(syms))
            nodes, weights = rule(panels)

            if refine:
                # refinement matched the tolerances only on the
                # initial-params integrand; register a post-solve check of
                # the same rule against the trained solution (the reference's
                # h-adaptive cubature tracks the solution at every step,
                # src/training_strategies.jl:406-436; this rule is frozen
                # when the loss is built)
                def check(theta):
                    at = integral_of(theta)
                    v1, v2 = at(panels), at(2 * panels)
                    ok = abs(v2 - v1) <= max(self.abstol,
                                             self.reltol * abs(v2))
                    return {"panels": panels, "loss_at_panels": v1,
                            "loss_at_2x_panels": v2, "ok": ok}

                self._trained_checks.append(check)

            def loss(theta, generator=None):
                del generator
                # under a mesh, the rank's nodes and weights: its share of
                # the sum (a rule that does not divide counts at 1/W)
                local = shard_batch(nodes)
                if local is nodes:
                    return share(_wsum_sq(residual(nodes, theta), weights,
                                          acc))
                return _wsum_sq(residual(local, theta),
                                shard_batch(weights[None])[0], acc)

            return loss

        self._trained_checks = []
        pde = [make(f, a) for f, a in zip(datafree_pde, pinnrep.pde_args)]
        bc = [make(f, a) for f, a in zip(datafree_bc, pinnrep.bc_args)]
        return pde, bc

    def validate_trained(self, theta, warn: bool = True) -> list:
        """Re-run the build-time refinement check at the trained params: for
        each auto-refined equation, compare the loss integral at the frozen
        panel count against a doubled rule and flag disagreement beyond
        reltol/abstol.  Called at the end of `solve`, outside any step;
        returns the per-equation reports (``ok`` False = the trained
        solution has sharper structure than the frozen rule resolves —
        rebuild with more ``panels`` or tighter tolerances and retrain, or
        pass ``quad_adapt=True`` to `solve`)."""
        import warnings

        reports = [check(theta) for check in self._trained_checks]
        bad = [r for r in reports if not r["ok"]]
        if bad and warn:
            worst = max(bad, key=lambda r: abs(r["loss_at_2x_panels"]
                                               - r["loss_at_panels"]))
            warnings.warn(
                f"QuadratureTraining: the auto-refined rule no longer meets "
                f"reltol={self.reltol}/abstol={self.abstol} on the TRAINED "
                f"solution for {len(bad)} equation(s) (worst: loss "
                f"{worst['loss_at_panels']:.3e} at {worst['panels']} panels "
                f"vs {worst['loss_at_2x_panels']:.3e} at double) — the "
                "trained residual has structure the frozen rule misses; "
                "rebuild with explicit panels= (or tighter reltol/abstol) "
                "and retrain")
        return reports


class WeightedIntervalTraining(TrainingStrategy):
    """ODE-only weighted time-segment sampling
    (reference: src/training_strategies.jl:438-468)."""

    def __init__(self, weights, points: int, seed: int | None = None):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.points = points
        self.seed = seed

    def segment_counts(self) -> np.ndarray:
        """Per-segment sample counts summing to exactly ``points``
        (largest-remainder apportionment)."""
        w = self.weights / self.weights.sum()
        exact = self.points * w
        counts = np.floor(exact).astype(np.int64)
        rem = self.points - int(counts.sum())
        if rem > 0:
            order = np.argsort(-(exact - counts))
            counts[order[:rem]] += 1
        return counts

    def sample_times(self, t0: float, t1: float, rng=None) -> np.ndarray:
        """One-shot weighted segment sample (drawn once per solve; pass
        ``seed`` to the constructor for reproducibility)."""
        rng = rng if rng is not None else np.random.default_rng(self.seed)
        counts = self.segment_counts()
        diff = (t1 - t0) / len(counts)
        ts = [rng.random(int(n)) * diff + t0 + i * diff
              for i, n in enumerate(counts)]
        return np.concatenate(ts)

    def build(self, pinnrep, datafree_pde, datafree_bc):
        raise ValueError(
            "WeightedIntervalTraining can only be used with ODEs (NNODE)")


class ResidualAdaptiveTraining(TrainingStrategy):
    """Residual-based adaptive collocation sampling (RAD; beyond the
    reference): each step draws ``candidates`` uniform points, evaluates the
    residual on them without gradient, and resamples ``points`` of them
    with probability ∝ |r|^k + c·mean(|r|^k).  BCs take plain uniform
    sampling (``bcs_points``).

    The JAX package draws the indices by `jax.random.categorical` (the
    Gumbel-max trick, points × candidates draws); the port draws the same
    law by inverse CDF (`ops.sampling.categorical`: a cumulative sum and a
    search of ``points`` uniforms).  ``categorical`` is that draw,
    ``(weights, n, generator) -> indices``; tests replace it, and
    ``sampler`` (the candidates), to inject the JAX package's draws.
    """

    def __init__(self, points: int, candidates: int | None = None,
                 bcs_points: int | None = None, k: float = 1.0, c: float = 1.0):
        self.points = points
        self.candidates = candidates if candidates is not None else 4 * points
        self.bcs_points = bcs_points if bcs_points is not None else points
        self.k = k
        self.c = c
        self.sampler = uniform_random
        self.categorical = sampling.categorical

    def build(self, pinnrep, datafree_pde, datafree_bc):
        dtype, device = pinnrep.dtype, pinnrep.device
        acc = pinnrep.loss_accum_dtype
        pde_bounds = get_bounds(pinnrep.domains, pinnrep.pde_args, self.points,
                                dtype, device)
        bc_bounds = get_bounds(pinnrep.domains, pinnrep.bc_args, self.points,
                               dtype, device)

        def make_pde(residual, bound):
            lb, ub = bound

            def loss(theta, generator):
                cand = self.sampler(self.candidates, lb, ub, generator)
                with torch.no_grad():
                    w = torch.abs(residual(cand, theta)) ** self.k
                    w = w + self.c * torch.mean(w)
                    idx = self.categorical(w, self.points, generator)
                return _msq_at(residual, cand[:, idx], theta, acc)

            return loss

        pde = [make_pde(f, b) for f, b in zip(datafree_pde, pde_bounds)]
        bc = [_sampled_loss(f, self, b, self.bcs_points, acc)
              for f, b in zip(datafree_bc, bc_bounds)]
        return pde, bc


class CausalTraining(TrainingStrategy):
    """Causality-respecting training for time-dependent PDEs (beyond the
    reference; Wang, Sankaran & Perdikaris 2022).

    The interior loss is split into ``n_slabs`` consecutive time slabs with
    mean residuals L_1..L_M, and slab i is weighted

        w_i = exp(-causal_eps * Σ_{j<i} L_j)        (no gradient)

    so later slabs count only once earlier times are resolved.  Sampling is
    slab-stratified uniform: ``points`` divides into ``n_slabs`` equal
    slabs, each with ``points/n_slabs`` fresh points a step, the other
    coordinates uniform.  Equations whose arguments lack ``time_var`` (and
    all BCs/ICs) take plain stochastic sampling.  ``causal_weights(theta,
    generator)`` gives the weights (the paper's monitor: done when the last
    is ≈ 1).

    ``causal_eps`` is the raw form ``exp(-eps·Σ_{j<i} L_j)``, whose scale
    depends on ``n_slabs``; `SeparableTraining(causal=...)` scales the sum
    by the node spacing instead.
    """

    def __init__(self, points: int, time_var, bcs_points: int | None = None,
                 n_slabs: int = 32, causal_eps: float = 1.0):
        self.points = points
        self.time_var = time_var.name if isinstance(time_var, Sym) else str(time_var)
        self.bcs_points = bcs_points if bcs_points is not None else points
        self.n_slabs = n_slabs
        self.causal_eps = causal_eps
        if points % n_slabs != 0:
            raise ValueError(
                f"points ({points}) must be a multiple of n_slabs ({n_slabs})")
        self.sampler = uniform_random
        self._weight_fns = []

    def _slab_losses(self, residual, lb, ub, t_idx, acc):
        """Per-slab mean-square residuals L, shape (n_slabs,), from
        slab-major stratified sampling.  Under a mesh whose data axis
        divides the slabs, each rank evaluates its slabs and returns its
        share of L (its slabs' means, zeros elsewhere); otherwise every
        rank evaluates all, at 1/W."""
        M, per = self.n_slabs, self.points // self.n_slabs

        def slabs(theta, generator):
            pts = self.sampler(self.points, lb, ub, generator)
            # restratify the time row slab-major: slab s spans
            # [lb_t + s·Δ, lb_t + (s+1)·Δ], Δ = (ub_t − lb_t)/M
            span = ub[t_idx] - lb[t_idx]
            u = (pts[t_idx] - lb[t_idx]) / torch.clamp(span, min=1e-30)
            slab = torch.arange(M, dtype=pts.dtype,
                                device=pts.device).repeat_interleave(per)
            t = lb[t_idx] + (slab + u) * span / M
            pts = torch.cat([pts[:t_idx], t[None], pts[t_idx + 1:]])
            n = data_size()
            if n == 1 or M % n != 0:
                return share(self._slab_means(residual(pts, theta), M, per,
                                              acc))
            # the rank's columns are whole slabs: their means are exact, and
            # no other rank holds them
            m, r = M // n, data_rank()
            own = self._slab_means(residual(shard_batch(pts), theta), m, per,
                                   acc)
            return torch.nn.functional.pad(own, (r * m, M - (r + 1) * m))

        return slabs

    @staticmethod
    def _slab_means(r, m, per, acc):
        sq = r ** 2
        if acc is not None:
            sq = sq.to(acc)
        return torch.mean(sq.reshape(-1, m, per), dim=(0, 2))

    @staticmethod
    def _weights(L, eps):
        """The slab weights of the global slab losses (the shares summed
        over the data axis under a mesh)."""
        L = sum_over_data(L.detach())
        csum = torch.cumsum(L, dim=0) - L          # Σ_{j<i} L_j
        return torch.exp(-eps * csum).detach()

    def build(self, pinnrep, datafree_pde, datafree_bc):
        dtype, device = pinnrep.dtype, pinnrep.device
        acc = pinnrep.loss_accum_dtype
        pde_bounds = get_bounds(pinnrep.domains, pinnrep.pde_args, self.points,
                                dtype, device)
        bc_bounds = get_bounds(pinnrep.domains, pinnrep.bc_args,
                               self.bcs_points, dtype, device)
        self._weight_fns = []

        def t_index(args):
            for i, a in enumerate(args):
                if isinstance(a, Sym) and a.name == self.time_var:
                    return i
            return None

        def make_pde(residual, bound, args):
            t_idx = t_index(args)
            if t_idx is None:
                return _sampled_loss(residual, self, bound,
                                     self.points, acc)
            slabs = self._slab_losses(residual, *bound, t_idx, acc)

            def loss(theta, generator):
                L = slabs(theta, generator)
                return torch.mean(self._weights(L, self.causal_eps) * L)

            self._weight_fns.append(
                lambda theta, generator: self._weights(
                    slabs(theta, generator), self.causal_eps))
            return loss

        pde = [make_pde(f, b, a) for f, b, a in
               zip(datafree_pde, pde_bounds, pinnrep.pde_args)]
        bc = [_sampled_loss(f, self, b, self.bcs_points, acc)
              for f, b in zip(datafree_bc, bc_bounds)]
        return pde, bc

    def causal_weights(self, theta, generator=None):
        """Current slab weights per time-dependent equation, from a fresh
        sample drawn with ``generator`` (torch's default generator if None).
        Available after the strategy has been built by `discretize`."""
        if not self._weight_fns:
            raise ValueError("causal_weights requires a discretized problem "
                             "(call discretize(system, disc) first)")
        return [fn(theta, generator) for fn in self._weight_fns]
