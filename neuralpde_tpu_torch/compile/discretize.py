"""`symbolic_discretize` / `discretize` pipeline (`neuralpde_tpu.compile.
discretize`; reference: src/discretize.jl).

Transforms a symbolic `PDESystem` + `PhysicsInformedNN` into an inspectable
`PINNRepresentation` whose `loss_functions` are PyTorch objectives over a
flat parameter dict, and wraps them into a `TrainingProblem` for
`neuralpde_tpu_torch.train`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, ClassVar

import numpy as np
import torch
from torch.func import functional_call, jvp
from torch.utils.checkpoint import checkpoint

from ..adaptive import AbstractAdaptiveLoss, NonAdaptiveLoss
from ..config import default_float, matmul_precision
from ..logging_utils import LogOptions
from ..ops.derivatives import DerivativeEngine
from ..parallel.mesh import share
from ..strategies import QuadratureTraining, TrainingStrategy
from ..symbolic.expr import Call, Sym, expand_derivatives
from ..symbolic.system import PDESystem
from .lower import (
    LoweringContext, build_residual_function, depvar_params, get_argument,
    get_integration_variables, get_variables,
)


class Phi:
    """Trial-function wrapper over a network (reference: src/pinn_types.jl:57-68).

    Call as ``phi(cord, params)`` with cord shaped (in_dim, N) and ``params``
    the module's own parameter dict (`depvar_params` of a trained theta);
    returns (out_dim, N).  ``apply(params, cord)`` is the flipped-arg form.
    Evaluation runs under the discretization's ``matmul_precision``.
    """

    def __init__(self, module, matmul_precision: str | None = None):
        self.module = module
        self.matmul_precision = matmul_precision

    def apply(self, params, cord):
        # inputs follow the parameters' dtype and device (EltypeAdaptor
        # semantics), so a numpy or float64 cord evaluates a float32 net
        like = next(iter(params.values()))
        cord = torch.as_tensor(cord).to(device=like.device, dtype=like.dtype)
        with matmul_precision(self.matmul_precision):
            return functional_call(self.module, params, (cord,), strict=True)

    def __call__(self, cord, params):
        cord = torch.as_tensor(cord)
        if cord.ndim == 1:
            # single point given as a flat vector (the reference's
            # `phi([x, y], θ)` idiom) -> one column
            cord = cord[:, None]
        return self.apply(params, cord)


class PhysicsInformedNN:
    """Discretizer config (reference: src/pinn_types.jl:123-187).

    * chain: an `nn.Module` (single output) or a list of them (one per depvar)
    * strategy: a TrainingStrategy
    * init_params: optional dict of the networks' parameters under the
      modules' own names (``"layer_0.weight"``; ``"u.layer_0.weight"`` with
      one chain per depvar), as `params_from_jax` gives them from the JAX
      package's ``init_params``; otherwise drawn from a `torch.Generator`
      seeded with ``seed``.  `TrainingProblem.init_params` holds them under
      ``"depvar."`` (the JAX package's ``{"depvar": ...}``)
    * derivative: "jvp" (default, exact nested forward mode) | "fd"
      (reference-parity finite differences) | "jet" (Taylor mode) | a
      DerivativeEngine
    * param_estim: append PDE parameters to θ as θ["p"] for inverse problems
    * additional_loss: fn(phi, theta, p) added to the total loss
    * adaptive_loss: an AbstractAdaptiveLoss (default NonAdaptiveLoss)
    * logger / log_options: logging hook protocol
    * integral_order, integral_panels: the composite Gauss-Legendre rule of
      every integral term (nodes per panel, panels per integration axis)
    * dtype, device: of parameters, collocation points and losses; the
      device defaults to ``"cuda"`` (without a card, building the problem
      fails with torch's own error); pass ``device="cpu"`` for the CPU
    * loss_accum_dtype: a wider dtype for the mean-square reductions
    * matmul_precision: "highest"/None (true float32 matmuls) or
      "high"/"default" (TF32 tensor cores on the card)
    * remat: recompute each residual in the backward pass
      (`torch.utils.checkpoint`) instead of keeping its activations
    * gradient_enhanced: gPINN weight w; each PDE residual gains the rows
      √w·∂f/∂x_i, one per coordinate of the equation
    """

    def __init__(self, chain, strategy: TrainingStrategy | None, *,
                 init_params=None, derivative="jvp", param_estim: bool = False,
                 additional_loss: Callable | None = None,
                 adaptive_loss: AbstractAdaptiveLoss | None = None,
                 logger=None, log_options: LogOptions | None = None,
                 seed: int = 0, integral_order: int = 20,
                 integral_panels: int = 1, dtype=None, device=None,
                 remat: bool = False,
                 loss_accum_dtype=None, gradient_enhanced: float | None = None,
                 matmul_precision: str | None = None):
        self.multioutput = isinstance(chain, (list, tuple))
        self.chain = list(chain) if self.multioutput else chain
        self.strategy = strategy
        self.init_params = init_params
        if isinstance(derivative, DerivativeEngine):
            self.derivative = derivative
        else:
            self.derivative = DerivativeEngine(derivative)
        self.param_estim = param_estim
        self.additional_loss = additional_loss
        self.adaptive_loss = adaptive_loss or NonAdaptiveLoss()
        self.logger = logger
        self.log_options = log_options or LogOptions()
        self.seed = seed
        self.integral_order = integral_order
        self.integral_panels = integral_panels
        self.dtype = dtype
        self.device = torch.device(device if device is not None else "cuda")
        self.loss_accum_dtype = loss_accum_dtype
        self.remat = remat
        self.gradient_enhanced = gradient_enhanced
        self.matmul_precision = matmul_precision
        chains = self.chain if self.multioutput else [self.chain]
        self.phi = ([Phi(c, matmul_precision) for c in chains]
                    if self.multioutput else Phi(self.chain, matmul_precision))


class BayesianPINN(PhysicsInformedNN):
    """PhysicsInformedNN + dataset for HMC posterior sampling
    (reference: src/pinn_types.jl:207-221).  ``dataset`` is
    ``(dataset_pde, dataset_bc)``, each None or a list of per-depvar
    arrays whose rows are (value, coordinates...)."""

    def __init__(self, chain, strategy=None, *, dataset=None, **kwargs):
        super().__init__(chain, strategy, **kwargs)
        self.dataset = dataset if dataset is not None else (None, None)


@dataclass
class PINNLossFunctions:
    """Generated loss functions (reference: src/pinn_types.jl:390-416)."""

    bc_loss_functions: list
    pde_loss_functions: list
    full_loss_function: Callable
    additional_loss_function: Callable | None
    datafree_pde_loss_functions: list
    datafree_bc_loss_functions: list


@dataclass
class PINNRepresentation:
    """Internal representation returned by symbolic_discretize
    (reference: src/pinn_types.jl:233-379)."""

    eqs: list
    bcs: list
    domains: list
    eq_params: list
    defaults: dict
    default_p: Any
    param_estim: bool
    additional_loss: Callable | None
    adaloss: AbstractAdaptiveLoss
    depvars: list
    indvars: list
    dict_indvars: dict
    dict_depvars: dict
    dict_depvar_input: dict
    logger: Any
    multioutput: bool
    init_params: Any
    flat_init_params: Any
    phi: Any
    derivative: DerivativeEngine
    strategy: TrainingStrategy
    pde_indvars: list
    bc_indvars: list
    pde_integration_vars: list = field(default_factory=list)
    bc_integration_vars: list = field(default_factory=list)
    pde_args: list = field(default_factory=list)
    bc_args: list = field(default_factory=list)
    dtype: Any = None
    device: Any = None
    loss_accum_dtype: Any = None
    remat: bool = False
    gradient_enhanced: float | None = None
    integral_order: int = 20
    integral_panels: int = 1
    log_options: LogOptions = field(default_factory=LogOptions)
    symbolic_pde_loss_functions: list = field(default_factory=list)
    symbolic_bc_loss_functions: list = field(default_factory=list)
    loss_functions: PINNLossFunctions | None = None
    matmul_precision: str | None = None


@dataclass
class TrainingProblem:
    """OptimizationProblem analog returned by `discretize`
    (reference: src/discretize.jl:774-778).  Under a mesh its losses return
    rank shares (`parallel.mesh`), which `solve` sums."""

    mesh_shares: ClassVar[bool] = True

    loss: Callable            # (theta, lstate) -> (total, aux-dict)
    init_params: Any
    pinnrep: PINNRepresentation

    def with_params(self, params):  # `remake(prob, u0=...)` analog
        return TrainingProblem(self.loss, params, self.pinnrep)


def _get_vars(pde_system: PDESystem):
    depvars = [d.name for d in pde_system.dvs]
    indvars = [v.name for v in pde_system.ivs]
    dict_depvar_input = {}
    for d in pde_system.dvs:
        names = []
        for a in d.args:
            if not isinstance(a, Sym):
                raise TypeError(f"declared depvar {d!r} must have Sym arguments")
            names.append(a.name)
        dict_depvar_input[d.name] = names
    dict_indvars = {n: i for i, n in enumerate(indvars)}
    dict_depvars = {n: i for i, n in enumerate(depvars)}
    return depvars, indvars, dict_indvars, dict_depvars, dict_depvar_input


def _initial_params(chains, depvars, multioutput, seed):
    """Draw every module's parameters from one seeded CPU generator, so a
    seed gives the same initial values on every device."""
    generator = torch.Generator().manual_seed(seed)
    params = {}
    for name, chain in zip(depvars, chains):
        chain.reset_parameters(generator)
        prefix = f"{name}." if multioutput else ""
        params.update({prefix + k: v.detach().clone()
                       for k, v in chain.named_parameters()})
    return params


def symbolic_discretize(pde_system: PDESystem,
                        discretization: PhysicsInformedNN) -> PINNRepresentation:
    depvars, indvars, dict_indvars, dict_depvars, dict_depvar_input = \
        _get_vars(pde_system)
    dtype = discretization.dtype or default_float()
    device = discretization.device
    multioutput = discretization.multioutput
    chains = discretization.chain if multioutput else [discretization.chain]
    if multioutput and len(chains) != len(depvars):
        raise ValueError(f"{len(depvars)} dependent variables but {len(chains)} chains")

    # --- initial parameters (reference: src/discretize.jl:430-470) ---------
    if discretization.init_params is None:
        init_params = _initial_params(chains, depvars, multioutput,
                                      discretization.seed)
    else:
        init_params = discretization.init_params
    # the discretization dtype holds for every float parameter (the
    # reference's EltypeAdaptor semantics, src/eltype_matching.jl:1-18)
    init_params = {k: (torch.as_tensor(v).detach().to(device=device, dtype=dtype)
                       if torch.as_tensor(v).is_floating_point()
                       else torch.as_tensor(v).to(device))
                   for k, v in init_params.items()}

    for chain in chains:
        chain.prepare(dtype, device)

    eq_params = [p.name for p in pde_system.ps]
    default_p = None
    if pde_system.ps:
        missing = [p.name for p in pde_system.ps if p not in pde_system.defaults]
        if missing and not discretization.param_estim:
            raise ValueError(f"parameters {missing} need defaults (or param_estim=True)")
        default_p = np.array([float(pde_system.defaults.get(p, 0.0))
                              for p in pde_system.ps])

    flat_init_params = {f"depvar.{k}": v for k, v in init_params.items()}
    if discretization.param_estim:
        flat_init_params["p"] = torch.as_tensor(default_p, dtype=dtype,
                                                device=device)

    # --- per-equation layouts ---------------------------------------------
    eqs, bcs = pde_system.eqs, pde_system.bcs
    pde_args = [get_argument(eq, depvars) for eq in eqs]
    bc_args = [get_argument(bc, depvars) for bc in bcs]
    if isinstance(discretization.strategy, QuadratureTraining):
        # quadrature cord rows = symbol args only (reference: src/discretize.jl:118-124)
        pde_layouts = [[a for a in args if isinstance(a, Sym)] for args in pde_args]
        bc_layouts = [[a for a in args if isinstance(a, Sym)] for args in bc_args]
        pde_indvars, bc_indvars = pde_args, bc_args
    else:
        pde_layouts = [[a if isinstance(a, Sym) else None for a in args]
                       for args in pde_args]
        bc_layouts = [[a if isinstance(a, Sym) else None for a in args]
                      for args in bc_args]
        pde_indvars = [get_variables(eq, depvars) for eq in eqs]
        bc_indvars = [get_variables(bc, depvars) for bc in bcs]

    ctx = LoweringContext(
        depvars=depvars, indvars=indvars, dict_depvar_input=dict_depvar_input,
        modules=chains, multioutput=multioutput,
        derivative=discretization.derivative, eq_params=eq_params,
        param_estim=discretization.param_estim,
        integral_order=discretization.integral_order,
        integral_panels=discretization.integral_panels,
    )

    pinnrep = PINNRepresentation(
        eqs=eqs, bcs=bcs, domains=pde_system.domains, eq_params=eq_params,
        defaults=pde_system.defaults, default_p=default_p,
        param_estim=discretization.param_estim,
        additional_loss=discretization.additional_loss,
        adaloss=discretization.adaptive_loss, depvars=depvars, indvars=indvars,
        dict_indvars=dict_indvars, dict_depvars=dict_depvars,
        dict_depvar_input=dict_depvar_input, logger=discretization.logger,
        multioutput=multioutput, init_params=init_params,
        flat_init_params=flat_init_params, phi=discretization.phi,
        derivative=discretization.derivative, strategy=discretization.strategy,
        pde_indvars=pde_indvars, bc_indvars=bc_indvars,
        pde_integration_vars=[get_integration_variables(eq) for eq in eqs],
        bc_integration_vars=[get_integration_variables(bc) for bc in bcs],
        pde_args=pde_args, bc_args=bc_args, dtype=dtype, device=device,
        loss_accum_dtype=discretization.loss_accum_dtype,
        remat=discretization.remat,
        gradient_enhanced=discretization.gradient_enhanced,
        integral_order=discretization.integral_order,
        integral_panels=discretization.integral_panels,
        log_options=discretization.log_options,
        matmul_precision=discretization.matmul_precision,
    )

    # inspectable expanded residual expressions (symbolic AST parity)
    pinnrep.symbolic_pde_loss_functions = [
        Call("-", (expand_derivatives(eq.lhs), expand_derivatives(eq.rhs)))
        for eq in eqs]
    pinnrep.symbolic_bc_loss_functions = [
        Call("-", (expand_derivatives(bc.lhs), expand_derivatives(bc.rhs)))
        for bc in bcs]

    datafree_pde = [build_residual_function(eq, lay, ctx, default_p)
                    for eq, lay in zip(eqs, pde_layouts)]
    datafree_bc = [build_residual_function(bc, lay, ctx, default_p)
                   for bc, lay in zip(bcs, bc_layouts)]
    if discretization.gradient_enhanced:
        datafree_pde = [_gradient_enhanced(f, args,
                                           discretization.gradient_enhanced)
                        for f, args in zip(datafree_pde, pde_args)]
    if discretization.remat:
        datafree_pde = [_rematerialized(f) for f in datafree_pde]
        datafree_bc = [_rematerialized(f) for f in datafree_bc]
    pinnrep.loss_functions = _assemble_loss_functions(pinnrep, datafree_pde,
                                                      datafree_bc)
    return pinnrep


def _gradient_enhanced(f, args, weight):
    """gPINN (Yu, Lu, Meng & Karniadakis 2022): the residual grows the rows
    √w·∂f/∂x_i, one exact `torch.func.jvp` in the coordinates per Sym
    argument, so a mean-square reduction sees (L_res + w·ΣL_grad)/(1+n_axes).
    BCs are left untouched."""
    sqrt_w = float(np.sqrt(weight))
    axes = [i for i, a in enumerate(args) if isinstance(a, Sym)]

    def g(cord, theta):
        rows = [torch.atleast_2d(f(cord, theta))]
        for i in axes:
            tangent = torch.zeros_like(cord)
            tangent[i] = 1
            rows.append(sqrt_w * torch.atleast_2d(
                jvp(lambda c: f(c, theta), (cord,), (tangent,))[1]))
        return torch.cat(rows, dim=0)

    return g


def _rematerialized(f):
    def g(cord, theta):
        # no random draws inside: nothing to save (and saving the CUDA RNG
        # state is not allowed while a CUDA graph captures the step)
        return checkpoint(f, cord, theta, use_reentrant=False,
                          preserve_rng_state=False)

    return g


def _wrap_precision(fn, mp):
    def wrapped(*a, **k):
        with matmul_precision(mp):
            return fn(*a, **k)

    return wrapped


def _assemble_loss_functions(pinnrep, datafree_pde,
                             datafree_bc) -> PINNLossFunctions:
    """Strategy build + weighted-sum total loss, from datafree residual
    functions.  Each loss's forward pass runs under the discretization's
    matmul precision; `train.make_step` runs the backward pass under it too.
    Apart from `symbolic_discretize` so that `rebuild_strategy_losses` can
    build the strategy's rules again, against trained parameters."""
    mp = pinnrep.matmul_precision
    dtype, device = pinnrep.dtype, pinnrep.device

    pde_loss_functions, bc_loss_functions = pinnrep.strategy.build(
        pinnrep, datafree_pde, datafree_bc)
    pde_loss_functions = [_wrap_precision(f, mp) for f in pde_loss_functions]
    bc_loss_functions = [_wrap_precision(f, mp) for f in bc_loss_functions]

    additional_loss = pinnrep.additional_loss
    phi_for_user = pinnrep.phi
    param_estim = pinnrep.param_estim
    multioutput = pinnrep.multioutput
    depvars = pinnrep.depvars

    def stacked(fns, theta, generator):
        if not fns:
            return torch.zeros((0,), dtype=dtype, device=device)
        return torch.stack([f(theta, generator) for f in fns])

    def full_loss_function(theta, lstate):
        """(theta, {"generator", "adaptive"}) -> (total, aux).

        Mirrors the deterministic weighted-sum loss
        (reference: src/discretize.jl:564-649); weights come from the adaptive
        state and carry no gradient.  The PDE losses draw their points from
        the generator first, then the BC losses, in equation order.
        """
        generator = lstate["generator"]
        pde_losses = stacked(pde_loss_functions, theta, generator)
        bc_losses = stacked(bc_loss_functions, theta, generator)
        ada = lstate["adaptive"]
        weighted_pde = ada["pde_weights"].detach() * pde_losses
        weighted_bc = ada["bc_weights"].detach() * bc_losses
        total = torch.sum(weighted_pde) + torch.sum(weighted_bc)
        aux = {"pde_losses": pde_losses, "bc_losses": bc_losses,
               "weighted_pde_losses": weighted_pde,
               "weighted_bc_losses": weighted_bc}
        if additional_loss is not None:
            theta_ = ({d: depvar_params(theta, d) for d in depvars}
                      if multioutput else depvar_params(theta))
            p_ = theta.get("p") if param_estim else None
            # computed whole on every rank: its share under a mesh
            add = share(additional_loss(phi_for_user, theta_, p_))
            total = total + ada["additional_weights"].detach()[0] * add
            aux["additional_loss"] = add
        aux["full_weighted_loss"] = total
        return total, aux

    return PINNLossFunctions(
        bc_loss_functions=bc_loss_functions,
        pde_loss_functions=pde_loss_functions,
        full_loss_function=_wrap_precision(full_loss_function, mp),
        additional_loss_function=additional_loss,
        datafree_pde_loss_functions=datafree_pde,
        datafree_bc_loss_functions=datafree_bc,
    )


def rebuild_strategy_losses(pinnrep, at_params=None) -> Callable:
    """Re-run the training strategy's `build` — rule auto-refinement
    included — with `pinnrep.flat_init_params` set to ``at_params`` (e.g.
    trained parameters), and reassemble the total loss.

    The rebuild step of `solve(quad_adapt=True)`: an auto-refined
    `QuadratureTraining` rule was tuned on the initial-params integrand;
    when `validate_trained` finds that the trained residual outruns it, this
    refines every equation's rule again, against the trained solution (the
    reference's always-adaptive semantics, src/training_strategies.jl:406-436,
    delivered between solves: shapes inside a step are fixed).  Mutates
    ``pinnrep.loss_functions`` (and ``flat_init_params``); returns the new
    full loss for a warm-started `TrainingProblem`."""
    if at_params is not None:
        pinnrep.flat_init_params = at_params
    lf = pinnrep.loss_functions
    pinnrep.loss_functions = _assemble_loss_functions(
        pinnrep, lf.datafree_pde_loss_functions,
        lf.datafree_bc_loss_functions)
    return pinnrep.loss_functions.full_loss_function


def discretize(pde_system: PDESystem,
               discretization: PhysicsInformedNN) -> TrainingProblem:
    """PDESystem -> TrainingProblem (reference: src/discretize.jl:774-778)."""
    pinnrep = symbolic_discretize(pde_system, discretization)
    return TrainingProblem(
        loss=pinnrep.loss_functions.full_loss_function,
        init_params=pinnrep.flat_init_params,
        pinnrep=pinnrep,
    )
