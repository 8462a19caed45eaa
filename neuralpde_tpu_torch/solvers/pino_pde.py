"""PINOPDE: physics-informed neural operator for parametric PDE families
(`neuralpde_tpu.solvers.pino_pde`; beyond the reference, whose PINO
surface is ODE-only, src/pino_ode_solve.jl).

Learns the solution operator of a symbolic `PDESystem` over a family of
problem instances, parametrized by scalar parameters (`PDESystem.ps` over
``bounds``, each an operator input channel) and/or input functions (fields
that are given, not solved for, e.g. the initial condition, drawn from a
sampler such as `GaussianRandomField` and fed as function-valued channels).

One operator evaluation gives the whole solution field on the training
grid for every family member; the equations and boundary conditions lower
onto it through `compile/fieldgrid.py`.  The loss is the mean square of
every equation's residual field.  `solve_pino_pde` trains through
`train.solve`, so on the card each step replays a captured CUDA graph (the
cuFFT plans are made by the eager first step); with ``resample=True`` a
new family is drawn inside every step from the solve's generator, which
the graph registers, so each replay draws another family.

A sampler is called as ``sampler(generator, axis_grids, n)`` with
``axis_grids`` numpy arrays and returns ``(*axis_sizes, n)`` values (a
tensor on the generator's device, or an array).  The family fixed at build
is drawn on the CPU from a generator seeded with ``seed ^ 0x5EED``, so the
same configuration trains on the same family on every device.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call

from ..compile.fieldgrid import FieldGridContext, build_field_residual
from ..compile.lower import depvar_params
from ..config import default_float, matmul_precision
from ..nn.deeponet import DeepONetPDE
from ..nn.fno import FNO1D, FNO2D, FNO3D
from ..parallel.mesh import (
    check_mesh, data_size, no_mesh, share, shard_batch, sum_over_data,
)
from ..strategies import GridTraining, TrainingStrategy, julia_range
from ..symbolic.system import PDESystem, infimum, supremum
from ..train import SolveResult, adam, solve as train_solve
from .ode import _SimpleProblem, initial_theta


class GaussianRandomField:
    """Sampler of smooth random fields for input-function families:
    squared-exponential-filtered white noise on the periodized grid,
    normalized to standard deviation ``variance**0.5`` (the population
    std over every value drawn) and shifted by ``mean``.

    ``sampler(generator, axis_grids, n)`` returns ``(*axis_sizes, n)``
    values on the given uniform grids (any dimension), on the generator's
    device.  Periodic by construction: the first and last node of every
    axis carry the same value (grids include both endpoints).  The filter
    is made on the first call for a grid layout and kept, so later calls
    (inside a captured step) copy nothing from the host.
    """

    def __init__(self, length_scale: float = 0.1, variance: float = 1.0,
                 mean: float = 0.0):
        self.length_scale = float(length_scale)
        self.variance = float(variance)
        self.mean = float(mean)
        self._filters: dict = {}

    @staticmethod
    def _geometry(axis_grids):
        grids = [np.ravel(np.asarray(g)) for g in axis_grids]
        sizes = [g.shape[0] - 1 for g in grids]          # periodic reduced
        if any(s < 2 for s in sizes):
            raise ValueError("GaussianRandomField needs >= 3 nodes per axis")
        spans = [float(g[-1] - g[0]) for g in grids]
        return sizes, spans

    def _filter(self, sizes, spans, dtype, device):
        key = (tuple(sizes), tuple(spans), dtype, str(device))
        if key not in self._filters:
            k2 = 0.0
            for ax, (m, span) in enumerate(zip(sizes, spans)):
                freq = (np.fft.rfftfreq(m) if ax == len(sizes) - 1
                        else np.fft.fftfreq(m))
                k = 2 * np.pi * freq * m / span
                shape = [1] * (len(sizes) + 1)
                shape[ax] = k.shape[0]
                k2 = k2 + torch.as_tensor(k.reshape(shape) ** 2, dtype=dtype)
            self._filters[key] = torch.exp(
                -k2 * self.length_scale**2 / 4.0).to(device)
        return self._filters[key]

    def transform(self, white, axis_grids):
        """The field of white noise ``white`` ``(*sizes, n)`` (sizes = nodes
        - 1 an axis): the filter, the normalization and the wrap nodes."""
        sizes, spans = self._geometry(axis_grids)
        axes = tuple(range(len(sizes)))
        wh = torch.fft.rfftn(white, dim=axes)
        wh = wh * self._filter(sizes, spans, white.dtype, white.device)
        f = torch.fft.irfftn(wh, s=sizes, dim=axes)
        f = f / (torch.std(f, correction=0) + 1e-12) * self.variance**0.5 \
            + self.mean
        # append the periodic wrap node on every axis (grids have endpoints)
        for ax in axes:
            f = torch.cat([f, f.narrow(ax, 0, 1)], dim=ax)
        return f

    def __call__(self, generator, axis_grids, n: int):
        sizes, _ = self._geometry(axis_grids)
        white = torch.randn((*sizes, n), generator=generator,
                            dtype=default_float(), device=generator.device)
        return self.transform(white, axis_grids)


@dataclass
class PINOPDE:
    """chain: `FNO3D`/`FNO2D`/`FNO1D` matching the system's
    independent-variable count, or a `DeepONetPDE` (scalar-parameter
    families only);
    opt: optimizer factory (default ``adam(1e-3)``);
    bounds: (lb, ub) per `PDESystem.ps` parameter, declaration order;
    number_of_parameters: train-set size along the family axis;
    init_params: the chain's parameters under its own names (else drawn
    from a CPU generator seeded with ``seed``);
    input_functions: ``{declared_call: sampler}`` for function-valued
    family inputs, e.g. ``{f0(x): GaussianRandomField(0.1)}`` with ``f0`` a
    `DepVar` not among `PDESystem.dvs`;
    resample: draw a new family every training step (scalar parameters
    uniform over ``bounds``, input functions from their samplers) instead
    of training on the family fixed at build;
    causal_eps: causal weighting of the interior residual fields (Wang et
    al. 2022): per time node k on ``causal_time_var`` (default: the last
    independent variable) the slice loss L_k is weighted
    exp(-eps * Δt * Σ_{j<k} L_j), the weights carrying no gradient;
    boundary conditions stay unweighted;
    matmul_precision: the matmul-precision switch of the loss ("highest",
    "high", "default"; None inherits, and `solve` runs with TF32 off);
    spectral_axes: independent variables (Syms or names) along which field
    derivatives are exact FFT derivatives instead of the FD stencils
    (periodic axes only; the grid spans one period, wrap node included)."""

    chain: Any
    opt: Any = None
    bounds: Any = None
    number_of_parameters: int = 50
    init_params: Any = None
    strategy: TrainingStrategy | None = None
    additional_loss: Callable | None = None
    input_functions: Any = None
    resample: bool = False
    causal_eps: float | None = None
    causal_time_var: Any = None
    matmul_precision: str | None = None
    spectral_axes: Any = None
    seed: int = 0


@dataclass
class PINOPDESolution:
    """``sol(p, grids, input_values)`` evaluates the trained operator at
    parameter columns ``(n_ps, P)`` and/or input-function values on the
    training grid, or on any uniform grids over the same domains (FNO
    discretization transfer).  Fields are tensors on the solve's device."""

    u: Any                     # field(s) on the training grid
    grids: Any                 # training grid node tensors, ivs order
    p: Any                     # training parameter columns (n_ps, P)
    input_samples: Any         # {name: (*axis_sizes, P)} training samples
    depvars: Any
    interp: Any
    original: Any
    input_axes: Any = None     # {name: [grid-axis indices]}
    loss_fn: Any = None        # the trained objective (theta, generator)
    retcode: str = "Success"
    matmul_precision: str | None = None   # the solve's (PINOPDE's)

    def __call__(self, p=None, grids=None, input_values=None):
        return self.interp(*_eval_inputs(p, grids, input_values, self.p,
                                         self.grids, self.input_samples))


def _eval_inputs(p, grids, input_values, p_tr, grids_tr, samples):
    """The evaluation inputs of a trained operator: the training family and
    grids where not given (new grids need new input-function values)."""
    like = grids_tr[0]
    p = p_tr if p is None else torch.atleast_2d(
        torch.as_tensor(p, dtype=like.dtype, device=like.device))
    gs = (grids_tr if grids is None else
          [torch.as_tensor(g, dtype=like.dtype, device=like.device)
           .reshape(-1) for g in grids])
    if input_values is None:
        if grids is not None and samples:
            raise ValueError(
                "evaluating on new grids requires input_values for the "
                f"input functions {sorted(samples)} (sampled values live on "
                "the training grid)")
        input_values = samples
    return p, gs, input_values


def _validate(pde_system: PDESystem, alg: PINOPDE, input_fns: dict):
    ivs = [v.name for v in pde_system.ivs]
    if isinstance(alg.chain, DeepONetPDE):
        if alg.chain.grid_ndim != len(ivs):
            raise ValueError(f"DeepONetPDE(grid_ndim={alg.chain.grid_ndim}) "
                             f"but the system has {len(ivs)} independent "
                             f"variables ({ivs})")
        if input_fns:
            raise ValueError(
                "DeepONetPDE takes scalar parameter families only — "
                "function-valued operator inputs (input_functions=) need an "
                "FNO backbone (FNO1D/2D/3D)")
    elif isinstance(alg.chain, FNO3D):
        if len(ivs) != 3:
            raise ValueError(f"FNO3D expects 3 independent variables, the "
                             f"system has {len(ivs)} ({ivs})")
    elif isinstance(alg.chain, FNO2D):
        if len(ivs) != 2:
            raise ValueError(f"FNO2D expects 2 independent variables, the "
                             f"system has {len(ivs)} ({ivs})")
    elif isinstance(alg.chain, FNO1D):
        if len(ivs) != 1:
            raise ValueError(f"FNO1D expects 1 independent variable, the "
                             f"system has {len(ivs)} ({ivs})")
    else:
        raise ValueError("PINOPDE requires an FNO chain (FNO3D/FNO2D/FNO1D "
                         "matching the independent-variable count) or a "
                         "DeepONetPDE; for pointwise networks use "
                         "PhysicsInformedNN")
    for d in pde_system.dvs:
        args = [a.name for a in d.args]
        if args != ivs:
            raise ValueError(
                f"field depvar {d.name} must be declared on all independent "
                f"variables in order ({ivs}); got {args}")
    for call in input_fns:
        names = [a.name for a in call.args]
        if any(n not in ivs for n in names) or \
                names != [n for n in ivs if n in names]:
            raise ValueError(
                f"input function {call.name} must be declared on a subset "
                f"of the independent variables in grid order ({ivs}); got "
                f"{names}")
        if call.name in {d.name for d in pde_system.dvs}:
            raise ValueError(
                f"input function {call.name} is also a solved depvar; "
                "input functions are given, not solved for")
    if not pde_system.ps and not input_fns:
        raise ValueError("PINOPDE learns a parametric family: the PDESystem "
                         "needs `ps` parameters (with PINOPDE bounds) "
                         "and/or PINOPDE input_functions")
    if pde_system.ps and (alg.bounds is None
                          or len(alg.bounds) != len(pde_system.ps)):
        raise ValueError(f"PINOPDE requires one (lb, ub) bound per system "
                         f"parameter ({len(pde_system.ps)})")
    n_in = len(pde_system.ps) + len(input_fns)
    if alg.chain.in_dim != n_in:
        raise ValueError(f"chain in_channels ({alg.chain.in_dim}) must equal "
                         f"n_parameters + n_input_functions ({n_in})")
    if alg.chain.out_dim != len(pde_system.dvs):
        raise ValueError(f"chain out_channels ({alg.chain.out_dim}) must "
                         f"equal the number of depvars ({len(pde_system.dvs)})")


class _Built:
    """What `_build` makes: the lowering shared by `solve_pino_pde`, the
    ensemble and the Gauss-Newton driver."""


def _as_field(vals, dtype, device):
    return torch.as_tensor(vals).to(dtype=dtype, device=device)


def _build(pde_system: PDESystem, alg: PINOPDE, device=None) -> _Built:
    """Validate, then build the training grids and family (on ``device``,
    ``"cuda"`` unless given), the field evaluator, the per-equation
    residual closures and the total loss."""
    dtype = default_float()
    device = torch.device(device if device is not None else "cuda")
    input_fns = dict(alg.input_functions or {})
    _validate(pde_system, alg, input_fns)
    ivs = [v.name for v in pde_system.ivs]
    depvars = [d.name for d in pde_system.dvs]
    ndim = len(ivs)

    strategy = alg.strategy
    if not isinstance(strategy, GridTraining) or strategy.dx is None:
        raise ValueError("PINOPDE requires GridTraining(dx): the field-grid "
                         "residual FD stencils (and the FNO FFT axes) need "
                         "a uniform tensor grid")
    dxs = (list(strategy.dx) if isinstance(strategy.dx, (list, tuple))
           else [strategy.dx] * len(ivs))
    dom = {d.variables.name: d.domain for d in pde_system.domains}
    grids_cpu = [torch.as_tensor(julia_range(infimum(dom[n]),
                                             supremum(dom[n]), h),
                                 dtype=dtype) for n, h in zip(ivs, dxs)]
    # the samplers read the grids as numpy, in the training dtype
    grids_np = [g.numpy() for g in grids_cpu]
    grids = [g.to(device) for g in grids_cpu]

    n_fam = alg.number_of_parameters
    bounds = [tuple(map(float, b)) for b in (alg.bounds or ())]
    if pde_system.ps:
        p_tr = torch.as_tensor(np.stack([np.linspace(b[0], b[1], n_fam)
                                         for b in bounds]),
                               dtype=dtype, device=device)
    else:
        p_tr = torch.zeros((0, n_fam), dtype=dtype, device=device)

    # the input-function family on the training grid, drawn on the CPU
    fn_names = [call.name for call in input_fns]
    fn_axes = {call.name: [ivs.index(a.name) for a in call.args]
               for call in input_fns}
    cpu_gen = torch.Generator().manual_seed(alg.seed ^ 0x5EED)
    input_samples = {}
    for call, sampler in input_fns.items():
        axes = fn_axes[call.name]
        vals = sampler(cpu_gen, [grids_np[a] for a in axes], n_fam)
        vals = _as_field(vals, dtype, device)
        want = tuple(grids[a].shape[0] for a in axes) + (n_fam,)
        if tuple(vals.shape) != want:
            raise ValueError(f"sampler for {call.name} returned shape "
                             f"{tuple(vals.shape)}, expected {want}")
        input_samples[call.name] = vals

    def _full_rank(name, vals):
        """(*axis_sizes, P) -> (N1(or 1), ..., Nd(or 1), P)."""
        shape = [1] * ndim + [vals.shape[-1]]
        for i, a in enumerate(fn_axes[name]):
            shape[a] = vals.shape[i]
        return vals.reshape(shape)

    spectral = frozenset(getattr(v, "name", str(v))
                         for v in (alg.spectral_axes or ()))
    ctx = FieldGridContext(
        iv_names=ivs, grids=grids,
        dict_depvar_input={**{d.name: [a.name for a in d.args]
                              for d in pde_system.dvs},
                           **{call.name: [a.name for a in call.args]
                              for call in input_fns}},
        eq_params=[p.name for p in pde_system.ps],
        spectral_axes=spectral)
    residuals = [build_field_residual(eq, ctx)
                 for eq in pde_system.eqs + pde_system.bcs]

    chain = alg.chain
    n_dv = len(depvars)

    def operator_input(p_cols, gs, input_values):
        """Stack scalar-parameter and input-function channels into the
        operator input: (C, N1, ..., Nd, P) when function channels are
        present, plain parameter columns (C, P) otherwise."""
        if not fn_names:
            return p_cols
        ns = tuple(g.shape[0] for g in gs)
        n_p = next(iter(input_values.values())).shape[-1]
        chans = [p_cols.reshape((p_cols.shape[0],) + (1,) * ndim + (-1,))
                 .expand((p_cols.shape[0], *ns, n_p))] \
            if p_cols.shape[0] else []
        for name in fn_names:
            chans.append(_full_rank(name, input_values[name])[None]
                         .expand((1, *ns, n_p)))
        return torch.cat(chans, dim=0)

    def eval_fields(params, p_cols, gs, input_values):
        """Fields of the chain's parameters ``params`` (its own names)."""
        op_in = operator_input(p_cols, gs, input_values)
        x_in = ((op_in, gs[0][None, :]) if isinstance(chain, FNO1D)
                else (op_in, tuple(gs)))
        out = functional_call(chain, params, (x_in,), strict=True)
        fields = ({depvars[0]: out} if n_dv == 1
                  else {name: out[i] for i, name in enumerate(depvars)})
        for name in fn_names:
            fields[name] = _full_rank(name, input_values[name])
        return fields

    def prec():
        return (matmul_precision(alg.matmul_precision)
                if alg.matmul_precision is not None
                else contextlib.nullcontext())

    if pde_system.ps:
        lo = torch.tensor([[b[0]] for b in bounds], dtype=dtype,
                          device=device)
        hi = torch.tensor([[b[1]] for b in bounds], dtype=dtype,
                          device=device)

    def _draw_family(generator):
        """A new family from ``generator`` (resample=True)."""
        if pde_system.ps:
            p_cols = lo + (hi - lo) * torch.rand(
                (len(bounds), n_fam), generator=generator, dtype=dtype,
                device=device)
        else:
            p_cols = p_tr
        samples = {}
        for call, sampler in input_fns.items():
            axes = fn_axes[call.name]
            samples[call.name] = _as_field(
                sampler(generator, [grids_np[a] for a in axes], n_fam),
                dtype, device)
        return p_cols, samples

    n_eq = len(pde_system.eqs)
    if alg.causal_eps is not None:
        causal_name = (ivs[-1] if alg.causal_time_var is None
                       else getattr(alg.causal_time_var, "name",
                                    str(alg.causal_time_var)))
        if causal_name not in ivs:
            raise ValueError(f"causal_time_var {causal_name!r} is not an "
                             f"independent variable ({ivs})")
        t_ax = ivs.index(causal_name)
        if grids[t_ax].shape[0] < 2:
            raise ValueError("causal weighting needs >= 2 time nodes")
        dt_node = float(grids_cpu[t_ax][1] - grids_cpu[t_ax][0])

    def _family_loss(params, p_cols, samples, shards: int = 1):
        """The loss of a family; ``shards`` > 1: the family is this rank's
        1/shards of the global one under a mesh, and the result its share
        (the causal weights from the slice means of the global family)."""
        fields = eval_fields(params, p_cols, grids, samples)
        rows = [r(fields, p_cols) for r in residuals]
        if alg.causal_eps is None:
            loss = sum(torch.mean(r ** 2) for r in rows)
            return fields, loss if shards == 1 else loss / shards
        loss = 0.0
        for i, r in enumerate(rows):
            if i < n_eq and r.ndim == ndim + 1 and r.shape[t_ax] > 1:
                other = tuple(a for a in range(r.ndim) if a != t_ax)
                L = torch.mean(r ** 2, dim=other)            # (T,)
                Lg = (L if shards == 1
                      else sum_over_data(L.detach()) / shards)
                csum = torch.cumsum(Lg, dim=0) - Lg          # exclusive
                w = torch.exp(-alg.causal_eps * dt_node * csum).detach()
                loss = loss + torch.mean(w * L)
            else:
                loss = loss + torch.mean(r ** 2)
        return fields, loss if shards == 1 else loss / shards

    def total_loss(theta, generator):
        with prec():
            if alg.resample:
                p_cols, samples = _draw_family(generator)
            else:
                p_cols, samples = p_tr, input_samples
            n = data_size()
            if n > 1 and n_fam % n == 0 and alg.additional_loss is None:
                # family-axis data parallelism: each rank evaluates its
                # members (FFTs included) and returns its share
                return _family_loss(
                    depvar_params(theta), shard_batch(p_cols),
                    {k: shard_batch(v) for k, v in samples.items()}, n)[1]
            fields, loss = _family_loss(depvar_params(theta), p_cols,
                                        samples)
            if alg.additional_loss is not None:
                loss = loss + alg.additional_loss(fields, theta)
        return share(loss)

    b = _Built()
    b.total_loss = total_loss
    b.family_loss = _family_loss
    b.theta0 = initial_theta(None, alg, dtype, device)
    b.grids = grids
    b.p_tr = p_tr
    b.input_samples = input_samples
    b.fn_axes = fn_axes
    b.fn_names = fn_names
    b.depvars = depvars
    b.n_dv = n_dv
    b.eval_fields = eval_fields
    b.residuals = residuals
    b.prec = prec
    b.matmul_precision = alg.matmul_precision
    b.dtype = dtype
    b.device = device
    return b


def _stack_depvars(b, fields, dim=0):
    if b.n_dv == 1:
        return fields[b.depvars[0]]
    return torch.stack([fields[n] for n in b.depvars], dim=dim)


def _input_values(b, input_values):
    vals = {n: _as_field(v, b.dtype, b.device)
            for n, v in (input_values or {}).items()}
    missing = set(b.fn_names) - set(vals)
    if missing:
        raise ValueError(f"missing input_values for {sorted(missing)}")
    return vals


def _make_solution(b, theta_trained, res) -> PINOPDESolution:
    """``theta_trained``: the flat trained parameters (``"depvar."``)."""
    params = depvar_params(theta_trained)

    @torch.no_grad()
    def interp(p_cols, gs, input_values):
        vals = _input_values(b, input_values)
        with b.prec():
            fields = b.eval_fields(params, p_cols, gs, vals)
        return _stack_depvars(b, fields)

    u = interp(b.p_tr, b.grids, b.input_samples)
    return PINOPDESolution(u=u, grids=b.grids, p=b.p_tr,
                           input_samples=b.input_samples,
                           input_axes=dict(b.fn_axes), depvars=b.depvars,
                           interp=interp, original=res,
                           loss_fn=b.total_loss,
                           matmul_precision=b.matmul_precision)


@dataclass
class PINOEnsembleResult:
    """Deep ensemble over a PINOPDE operator family: N independent FNO (or
    DeepONetPDE) initializations trained together (`solve_ensemble`).

    `best` is a full `PINOPDESolution` for the lowest-loss member;
    `mean_and_std` gives the deep-ensemble epistemic spread over family
    predictions (Lakshminarayanan et al. 2017), with the population std."""

    members: Any               # flat dict, "depvar." leaves (n_ensemble, ...)
    losses: Any                # (n_ensemble,) final per-member objectives
    iterations: int
    history: list
    _b: Any = None             # the shared _build namespace
    aux: dict | None = None    # "cuda_graph" counts on the card

    @property
    def n_ensemble(self) -> int:
        return int(next(iter(self.members.values())).shape[0])

    @property
    def best_index(self) -> int:
        losses = np.asarray(torch.as_tensor(self.losses).cpu(),
                            dtype=np.float64)
        return int(np.nanargmin(np.where(np.isfinite(losses), losses,
                                          np.nan)))

    @property
    def best(self) -> PINOPDESolution:
        return self.member_solution(self.best_index)

    def member_solution(self, i: int) -> PINOPDESolution:
        """Full `PINOPDESolution` for member i (the surface of a solo
        `solve_pino_pde`, discretization transfer included)."""
        theta_i = {k: v[i] for k, v in self.members.items()}
        res = SolveResult(u=theta_i, objective=float(self.losses[i]),
                          iterations=self.iterations, aux={}, history=[])
        return _make_solution(self._b, theta_i, res)

    @torch.no_grad()
    def predict(self, p=None, grids=None, input_values=None):
        """Every member's family prediction: (n_ensemble, [n_dv,] N1..Nd, P).
        Defaults evaluate on the training family and grids; new grids and
        values follow the `PINOPDESolution.__call__` contract."""
        b = self._b
        p, gs, vals = _eval_inputs(p, grids, input_values, b.p_tr, b.grids,
                                   b.input_samples)
        vals = _input_values(b, vals)
        out = []
        with b.prec():
            for i in range(self.n_ensemble):
                params = depvar_params({k: v[i]
                                        for k, v in self.members.items()})
                out.append(_stack_depvars(
                    b, b.eval_fields(params, p, gs, vals)))
        return torch.stack(out)

    def mean_and_std(self, p=None, grids=None, input_values=None):
        """Deep-ensemble predictive mean and epistemic std over members."""
        preds = self.predict(p, grids, input_values)
        return torch.mean(preds, dim=0), torch.std(preds, dim=0, correction=0)


def solve_pino_pde_ensemble(pde_system: PDESystem, alg: PINOPDE, *,
                            n_ensemble: int = 8, maxiters: int = 1000,
                            generator=None, seed: int = 0,
                            inner_steps: int = 1, mesh=None,
                            abstol: float | None = None,
                            verbose: bool = False, callback=None,
                            checkpoint_path: str | None = None,
                            checkpoint_every: int | None = None,
                            device=None) -> PINOEnsembleResult:
    """Train ``n_ensemble`` independent operator initializations together
    (`solve_ensemble`), on ``device`` (``"cuda"`` unless given).  Member
    m's parameters are the chain's reset from the CPU generator seeded with
    ``seed`` (members drawn in order), so member m with a deterministic
    family follows a solo ``solve_pino_pde`` from the same parameters.
    ``mesh`` shards the member axis (`solve_ensemble`); the loss is built
    and run without the family-axis sharding, which would use the same
    ranks."""
    from ..parallel.ensemble import solve_ensemble

    check_mesh(mesh)
    if alg.init_params is not None:
        raise ValueError("solve_pino_pde_ensemble draws per-member inits; "
                         "init_params= would make the members identical")
    with no_mesh():
        b = _build(pde_system, alg, device)
    chain = alg.chain

    def member_init(gen):
        chain.reset_parameters(gen)
        return {f"depvar.{k}": v.detach().to(device=b.device, dtype=b.dtype,
                                              copy=True)
                for k, v in chain.named_parameters()}

    prob = _SimpleProblem(b.total_loss, b.theta0, alg.matmul_precision)
    res = solve_ensemble(prob, alg.opt or adam(1e-3), maxiters=maxiters,
                         n_ensemble=n_ensemble, generator=generator,
                         seed=seed, inner_steps=inner_steps, mesh=mesh,
                         abstol=abstol,
                         verbose=verbose, callback=callback,
                         checkpoint_path=checkpoint_path,
                         checkpoint_every=checkpoint_every,
                         member_init=member_init)
    return PINOEnsembleResult(members=res.members, losses=res.losses,
                              iterations=res.iterations, history=res.history,
                              _b=b, aux=res.aux)


def solve_pino_pde(pde_system: PDESystem, alg: PINOPDE, *,
                   abstol: float = 1e-8, verbose: bool = False,
                   maxiters: int = 1000, generator=None, seed: int = 0,
                   inner_steps: int = 1, callback=None,
                   checkpoint_dir: str | None = None,
                   checkpoint_every: int = 1000,
                   profile_dir: str | None = None,
                   device=None) -> PINOPDESolution:
    """Train the operator on ``device`` (``"cuda"`` unless given);
    ``generator``/``seed`` feed ``resample=True``'s draws.  Under an active
    mesh the family axis is sharded over the data axis when it divides and
    no ``additional_loss`` is set (`parallel.mesh`)."""
    b = _build(pde_system, alg, device)
    res = train_solve(_SimpleProblem(b.total_loss, b.theta0,
                                     alg.matmul_precision, mesh_shares=True),
                      alg.opt or adam(1e-3), maxiters=maxiters,
                      abstol=abstol, verbose=verbose, generator=generator,
                      seed=seed, inner_steps=inner_steps, callback=callback,
                      checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every,
                      profile_dir=profile_dir)
    return _make_solution(b, res.u, res)
