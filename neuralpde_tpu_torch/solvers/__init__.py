from .problems import ODEProblem, ODESolution, SDEProblem, compute_ode_errors
from .ode import NNODE, ODEPhi, solve_ode
from .dae import DAEProblem, NNDAE, solve_dae
from .adapter import neural_adapter
from .dgm import DeepGalerkin  # noqa: F401
from .ritz import DeepRitz, discretize_ritz  # noqa: F401
from .sde import NNSDE, SDEPhi, SDEsol, solve_sde  # noqa: F401
from .sde_weak import SDEPINN, solve_sde_weak  # noqa: F401
from .pino import PINOODE, PINOODESolution, PINOPhi, solve_pino_ode  # noqa: F401
from .pino_pde import (  # noqa: F401
    GaussianRandomField, PINOEnsembleResult, PINOPDE, PINOPDESolution,
    solve_pino_pde, solve_pino_pde_ensemble,
)
