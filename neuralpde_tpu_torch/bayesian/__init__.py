from .diagnostics import ess, split_rhat, summarize as mcmc_summarize  # noqa: F401
from .hmc import SampleResult, find_good_stepsize, sample, sample_chains  # noqa: F401
from .ode import (  # noqa: F401
    BNNODE, BPINNsolution, BPINNstats, LogTargetDensity,
    ahmc_bayesian_pinn_ode, solve_bnnode,
)
from .pde import PDELogTargetDensity, ahmc_bayesian_pinn_pde, inference  # noqa: F401
