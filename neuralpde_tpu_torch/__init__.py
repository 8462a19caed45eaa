"""neuralpde_tpu_torch — the PyTorch/CUDA port of `neuralpde_tpu`.

The dense PINN trainer (symbolic front end, lowering, Grid, Stochastic,
QuasiRandom, ResidualAdaptive and Causal training, Taylor-mode
derivatives, the adaptive loss weights, `solve` replaying a CUDA graph of
its step on the card, checkpoint/resume, Adam then L-BFGS), separable
(SPINN) training, matrix-free Gauss-Newton, quadrature (integral terms,
`QuadratureTraining`), the ODE/DAE solver surface (`solve_ode`,
`solve_dae`, `neural_adapter`), the trial-function zoo (`FBPINN`, `kan`,
`DGM`, `TorchModuleAdapter`), the variational formulations (hp-VPINN
`WeakTraining` with `refine_weak`, `DeepRitz`), the stochastic layer
(distributions, `solve_sde`, the Fokker-Planck `SDEPINN`, HMC/NUTS and the
Bayesian PINNs `BNNODE` and `BayesianPINN`) and the operator layer
(`DeepONet`, the FNOs, `solve_pino_ode`, `solve_pino_pde` on the
field-grid lowering, deep ensembles) on NVIDIA H100s, with
hand-written Hopper kernels under `kernels/` and `csrc/`; scale-out is one
process a card (`parallel.mesh`, `parallel.distributed`: data parallelism
over collocation batches, separable axes, operator families, ensemble
members and MCMC chains, and tensor parallelism of dense layers), and a
trained solution or operator exports to a `torch.export` artifact
(`utils.export`).  Public names are
those of `neuralpde_tpu`.  This package imports no JAX.
"""

from .config import default_float, enable_x64, finfo_eps, matmul_precision
from .logging_utils import (
    LogOptions, TensorBoardLogger, logscalar, logvector,
)
from .symbolic.expr import (
    DepVar, Deriv, Differential, Eq, Expr, Integral, IntegralExpr, Num, Param,
    Sym, abs_, acos, asin, atan, cos, cosh, depvars, erf, exp, expand_derivatives,
    log, parameters, pi, register_primitive, sigmoid, sin, sinh, sqrt,
    substitute, symbols, symbolic_diff, tan, tanh,
)
from .symbolic.system import Domain, Interval, PDESystem, in_domain, infimum, supremum
from .nn.core import (
    Chain, Dense, FourierFeatures, Module, PeriodicEmbedding, SkipConnection,
    Transformed, glorot_normal, glorot_uniform, mlp,
)
from .nn.separable import SeparableNet, separable_mlp
from .nn.adapters import TorchModuleAdapter
from .nn.dgm import DGM, DGMLSTMLayer
from .nn.fbpinn import FBPINN
from .nn.kan import KANLayer, kan
from .nn.deeponet import DeepONet, DeepONetPDE
from .nn.fno import (
    FNO1D, FNO2D, FNO3D, SpectralConv1D, SpectralConv2D, SpectralConv3D,
)
from .ops.derivatives import (
    DerivativeEngine, jet_derivative, jvp_derivative, numeric_derivative,
)
from .strategies import (
    CausalTraining, GridTraining, QuadratureTraining, QuasiRandomTraining,
    ResidualAdaptiveTraining, StochasticTraining, TrainingStrategy,
    WeightedIntervalTraining, generate_training_sets, get_bounds,
    get_loss_function,
)
from .adaptive import (
    AbstractAdaptiveLoss, GradientScaleAdaptiveLoss,
    InverseDirichletAdaptiveLoss, MiniMaxAdaptiveLoss, NonAdaptiveLoss,
    ReLoBRaLoAdaptiveLoss, SoftAdaptAdaptiveLoss,
)
from .compile.discretize import (
    BayesianPINN, PhysicsInformedNN, Phi, PINNLossFunctions, PINNRepresentation,
    TrainingProblem, discretize, symbolic_discretize,
)
from .compile.lower import (
    build_loss_function, build_residual_function, depvar_params, free_symbols,
    get_argument, get_integration_variables, get_numeric_integral,
    get_variables,
)
from .compile.separable import SeparableTraining, build_separable_residual
from .compile.weak import WeakTraining, refine_weak, solve_weak_adaptive
from .train import SolveResult, adam, lbfgs, make_step, solve, solve_hybrid
from .gauss_newton import (
    build_ode_residual_vector, build_pino_pde_residual_vector,
    build_pino_residual_vector, build_residual_vector, lm_least_squares,
    solve_gauss_newton, solve_ode_gauss_newton, solve_pino_gauss_newton,
    solve_pino_pde_gauss_newton, trust_region_least_squares,
)
from .solvers import (
    DAEProblem, DeepGalerkin, DeepRitz, GaussianRandomField, NNDAE, NNODE,
    NNSDE, ODEPhi, ODEProblem, ODESolution, PINOEnsembleResult, PINOODE,
    PINOODESolution, PINOPDE, PINOPDESolution, SDEPINN, SDEProblem, SDEsol,
    discretize_ritz, neural_adapter, solve_dae, solve_ode, solve_pino_ode,
    solve_pino_pde, solve_pino_pde_ensemble, solve_sde, solve_sde_weak,
)
from .parallel.mesh import (
    make_mesh, make_mesh_2d, replicate_params, shard_batch, shard_params_tp,
    use_mesh,
)
from .parallel.ensemble import EnsembleResult, solve_ensemble
from .bayesian import (
    BNNODE, BPINNsolution, BPINNstats, ahmc_bayesian_pinn_ode,
    ahmc_bayesian_pinn_pde, ess, mcmc_summarize, solve_bnnode, split_rhat,
)
from .ops.distributions import LogNormal, Normal, Particles, Uniform
from .utils.eltype import EltypeAdaptor, recursive_eltype
from .utils.pytree import parameters_to_vector, tree_size, vector_to_parameters
from .utils.convert import params_from_jax, params_to_numpy

__version__ = "0.1.0"
