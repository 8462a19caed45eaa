"""Bayesian ODE PINN: `ahmc_bayesian_pinn_ode` and `BNNODE`
(`neuralpde_tpu.bayesian.ode`; reference: ext/bpinn/advancedHMC_MCMC.jl,
ext/bpinn/BPINN_ode.jl).

logdensity(θ) = physics log-likelihood + priors + data L2 log-likelihood
(+ the Data Quadrature log-likelihood with ``estim_collocate``)
(reference: ext/bpinn/advancedHMC_MCMC.jl:43-47) of a flat parameter vector
θ = (network parameters in `parameters_to_vector`'s order, which is
`ravel_pytree`'s, then the ODE parameters), sampled by `bayesian.hmc`.
Every tensor the density reads is on the device at build, and its standard
deviations are Python numbers, so a draw can be captured as a CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call, jvp, vmap

from ..config import default_float
from ..ops.distributions import Normal, Particles, mvnormal_diag_logpdf
from ..parallel.mesh import check_mesh
from ..solvers.ode import _batched_f
from ..solvers.problems import ODEProblem
from ..strategies import (
    GridTraining, QuadratureTraining, StochasticTraining,
    WeightedIntervalTraining, julia_range,
)
from ..utils.pytree import parameters_to_vector
from . import hmc


class LogTargetDensity:
    """Flat-vector log-density (LogDensityProblems analog, reference:
    ext/bpinn/advancedHMC_MCMC.jl:1-52).  ``init_nn_params`` is the chain's
    parameter dict (its own names) on the device the density runs on."""

    def __init__(self, prob: ODEProblem, chain, init_nn_params, strategy,
                 dataset, priors_nn: Normal, param_priors, phystd, phynewstd,
                 l2std, autodiff: bool, physdt: float, estim_collocate: bool):
        self.prob = prob
        self.chain = chain
        self.strategy = strategy
        self.dataset = dataset or []
        self.priors_nn = priors_nn
        self.param_priors = list(param_priors)
        self.extraparams = len(self.param_priors)
        self.phystd = [float(s) for s in phystd]
        self.phynewstd = phynewstd
        self.l2std = [float(s) for s in l2std]
        self.autodiff = autodiff
        self.physdt = physdt
        self.estim_collocate = estim_collocate

        flat, unravel = parameters_to_vector(init_nn_params)
        self.n_nn = flat.shape[0]
        self.unravel = unravel
        self.init_flat_nn = flat
        self.dim = self.n_nn + self.extraparams
        dtype, device = flat.dtype, flat.device

        def tensor(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64),
                                   dtype=dtype, device=device)

        self.u0 = tensor(np.atleast_1d(np.asarray(prob.u0, dtype=np.float64)))
        self.n_out = self.u0.shape[0]
        self.scalar_u0 = self.n_out == 1 and np.ndim(prob.u0) == 0
        t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
        self.t0 = t0

        ts = julia_range(t0, t1, strategy.dx if isinstance(strategy, GridTraining)
                         else physdt)
        if isinstance(strategy, GridTraining):
            phys_t = ts
        elif isinstance(strategy, WeightedIntervalTraining):
            phys_t = strategy.sample_times(t0, t1)
        elif isinstance(strategy, (StochasticTraining, QuadratureTraining)):
            # a static grid: resampling inside HMC would make the density
            # random (the JAX package's documented deviation)
            phys_t = np.linspace(t0, t1, getattr(strategy, "points", len(ts)))
        else:
            raise TypeError(f"unsupported strategy {type(strategy).__name__}")
        if self.dataset:
            phys_t = np.concatenate([phys_t, np.asarray(self.dataset[-2])])
        self.phys_t = tensor(phys_t)
        self.p_fixed = None if prob.p is None else tensor(prob.p)
        if self.dataset:
            self.data_t = tensor(self.dataset[-2])
            self.data_u = torch.stack([tensor(self.dataset[i])
                                       for i in range(self.n_out)])
            self.data_w = tensor(self.dataset[-1])

    # --- NN trial function ------------------------------------------------
    def phi(self, t, theta_nn_vec):
        out = functional_call(self.chain, self.unravel(theta_nn_vec),
                              (t[None, :],), strict=True)
        return self.u0[:, None] + (t[None, :] - self.t0) * out

    def _dfdx(self, t, theta_nn_vec):
        if self.autodiff:
            return jvp(lambda tt: self.phi(tt, theta_nn_vec), (t,),
                       (torch.ones_like(t),))[1]
        eps = float(torch.finfo(t.dtype).eps) ** 0.5
        return (self.phi(t + eps, theta_nn_vec)
                - self.phi(t, theta_nn_vec)) / eps

    def _split(self, theta):
        return theta[:self.n_nn], theta[self.n_nn:]

    def _ode_params(self, extra):
        return self.p_fixed if self.extraparams == 0 else extra

    def _f_batched(self, u, p, t):
        return _batched_f(self.prob.f)(
            torch.atleast_2d(u[0] if self.scalar_u0 else u), p, t)

    # --- log-likelihood terms (reference names) ---------------------------
    def physloglikelihood(self, theta):
        nn, extra = self._split(theta)
        p = self._ode_params(extra)
        t = self.phys_t
        physsol = self._f_batched(self.phi(t, nn), p, t)
        nnsol = self._dfdx(t, nn)
        return sum(mvnormal_diag_logpdf(nnsol[i] - physsol[i], 0.0,
                                        self.phystd[i])
                   for i in range(self.n_out))

    def priorweights(self, theta):
        nn, extra = self._split(theta)
        lp = torch.sum(self.priors_nn.logpdf(nn))
        for i, pr in enumerate(self.param_priors):
            lp = lp + pr.logpdf(extra[i])
        return lp

    def L2LossData(self, theta):
        if not self.dataset:
            return 0.0
        nn, _ = self._split(theta)
        pred = self.phi(self.data_t, nn)
        return sum(mvnormal_diag_logpdf(pred[i], self.data_u[i],
                                        self.l2std[i])
                   for i in range(self.n_out))

    def L2loss2(self, theta):
        if not (self.estim_collocate and self.dataset):
            return 0.0
        nn, extra = self._split(theta)
        p = self._ode_params(extra)
        nnsol = self._dfdx(self.data_t, nn)
        physsol = self._f_batched(self.data_u, p, self.data_t)
        std = self.phynewstd(p)
        return sum(mvnormal_diag_logpdf((nnsol[i] - physsol[i]) * self.data_w,
                                        0.0, std[i])
                   for i in range(self.n_out))

    def __call__(self, theta):
        return (self.physloglikelihood(theta) + self.priorweights(theta)
                + self.L2LossData(theta) + self.L2loss2(theta))


def _init_nn_params(chain, init_params, seed, dtype, device) -> dict:
    """The chain's parameters on ``device``: given, or drawn on the CPU
    from a generator seeded with ``seed`` (`reset_parameters`, in place of
    ``chain.init(key)``); constant tensors made there (`Module.prepare`)."""
    chain.prepare(dtype, device)
    if init_params is None:
        chain.reset_parameters(torch.Generator().manual_seed(seed))
        init_params = {k: v.detach().clone()
                       for k, v in chain.named_parameters()}
    return {k: torch.as_tensor(v).detach().to(device=device, dtype=dtype)
            for k, v in init_params.items()}


def _chain_starts(n_nn: int, theta0, nchains: int, seed: int):
    """Multichain starting points: network entries from a CPU generator
    seeded with ``seed + 100 + i`` (the JAX package's keys), the ODE
    parameters at their priors' means."""
    return torch.stack([
        torch.cat([torch.randn(
            (n_nn,), generator=torch.Generator().manual_seed(seed + 100 + i),
            dtype=theta0.dtype).to(theta0.device), theta0[n_nn:]])
        for i in range(nchains)])


def ahmc_bayesian_pinn_ode(
        prob: ODEProblem, chain, *, strategy=None, dataset=None,
        init_params=None, draw_samples: int = 1000, physdt: float = 1 / 20.0,
        l2std=(0.05,), phystd=(0.05,), phynewstd=None, priorsNNw=(0.0, 2.0),
        param=(), nchains: int = 1, autodiff: bool = False, Kernel: str = "hmc",
        n_leapfrog: int = 30, target_accept: float = 0.8, max_depth: int = 10,
        lam: float = 1.0, estim_collocate: bool = False, seed: int = 0,
        mesh=None, progress: bool = False, verbose: bool = False,
        device=None):
    """Reference: ext/bpinn/advancedHMC_MCMC.jl:390-581.  Returns
    ``(samples, sampler_stats, ltd)``: samples (draws, dim), or (chains,
    draws, dim) with ``nchains > 1``.  Runs on ``device``, ``"cuda"``
    unless given; ``mesh`` shards the chains (`hmc.sample_chains`)."""
    del progress
    check_mesh(mesh)
    device = torch.device(device if device is not None else "cuda")
    dtype = default_float()
    dataset = dataset or []
    if not dataset and len(param) > 0:
        raise ValueError(
            "Dataset is Required for Inverse problems performing Parameter "
            "Estimation.")
    if not dataset and estim_collocate:
        raise ValueError(
            "Dataset is Required for using the Data Quadrature loglikelihood "
            "term.")
    if dataset:
        if estim_collocate and len(dataset) < 3:
            raise ValueError(
                "Invalid dataset for Inverse solve with Data Quadrature loss; "
                "expected (x̂, t, W)")
        if len(dataset) < 2:
            raise ValueError("Invalid dataset; expected (x̂, t)")
        if len(dataset) < 3:
            dataset = list(dataset) + [np.ones(len(dataset[-1]))]

    strategy = strategy if strategy is not None else GridTraining(physdt)
    phynewstd = phynewstd or (lambda p: list(phystd))
    init_nn = _init_nn_params(chain, init_params, seed, dtype, device)
    priors_nn = Normal(float(priorsNNw[0]), float(priorsNNw[1]))
    ltd = LogTargetDensity(
        prob, chain, init_nn, strategy, dataset, priors_nn, param,
        list(phystd), phynewstd, list(l2std), autodiff, physdt,
        estim_collocate)

    theta0 = ltd.init_flat_nn
    if param:
        theta0 = torch.cat([theta0, torch.tensor(
            [pr.mean for pr in param], dtype=dtype, device=device)])
    if verbose:
        with torch.no_grad():
            print(f"Current Physics Log-likelihood: "
                  f"{float(ltd.physloglikelihood(theta0)):g}")
            print(f"Current Prior Log-likelihood: "
                  f"{float(ltd.priorweights(theta0)):g}")
            print(f"Current SSE against dataset Log-likelihood: "
                  f"{float(ltd.L2LossData(theta0)):g}")

    generator = torch.Generator(device=device).manual_seed(seed + 1)
    if nchains > 1:
        samples = hmc.sample_chains(
            ltd, _chain_starts(ltd.n_nn, theta0, nchains, seed), generator,
            draw_samples, kernel=Kernel, n_leapfrog=n_leapfrog,
            target_accept=target_accept, lam=lam, max_depth=max_depth,
            mesh=mesh)
        return samples, None, ltd
    res = hmc.sample(ltd, theta0, generator, draw_samples, kernel=Kernel,
                     n_leapfrog=n_leapfrog, target_accept=target_accept,
                     lam=lam, max_depth=max_depth)
    if verbose:
        print("Sampling Complete.")
        with torch.no_grad():
            print(f"Final Physics Log-likelihood: "
                  f"{float(ltd.physloglikelihood(res.samples[-1])):g}")
    stats = {**res.stats, "inv_mass": res.inv_mass, **res.aux}
    return res.samples, stats, ltd


@dataclass
class BPINNstats:
    mcmc_chain: Any
    samples: Any
    statistics: Any


@dataclass
class BPINNsolution:
    """Ensemble solution (reference: src/bpinn_types.jl:141-163)."""

    original: BPINNstats
    ensemblesol: list          # list of Particles over timeseries per output
    estimated_nn_params: Any
    estimated_de_params: list
    timepoints: Any

    def diagnostics(self, discard: int | None = None) -> dict:
        """ESS / split-R̂ / mean / std per flat parameter from this
        solution's chain (the reference's MCMCChains summary analog;
        `bayesian.diagnostics`).  ``discard`` drops warm-up draws (default
        2/3).  For multi-chain R̂, stack the chains yourself:
        ``split_rhat(np.stack([s.original.samples for s in sols]))``."""
        from .diagnostics import summarize

        draws = self.original.samples
        n = draws.shape[0]
        discard = (2 * n) // 3 if discard is None else discard
        return summarize(draws[discard:])


@dataclass
class BNNODE:
    """High-level Bayesian NNODE algorithm (reference: ext/bpinn/BPINN_ode.jl)."""

    chain: Any
    Kernel: str = "hmc"
    strategy: Any = None
    draw_samples: int = 1000
    priorsNNw: tuple = (0.0, 2.0)
    param: tuple = ()
    l2std: tuple = (0.05,)
    phystd: tuple = (0.05,)
    phynewstd: Callable | None = None
    dataset: Any = None
    physdt: float = 1 / 20.0
    nchains: int = 1
    autodiff: bool = False
    init_params: Any = None
    numensemble: int = 500
    estim_collocate: bool = False
    n_leapfrog: int = 30
    max_depth: int = 10
    seed: int = 0
    verbose: bool = False


def solve_bnnode(prob: ODEProblem, alg: BNNODE, *, saveat=None,
                 maxiters=None, device=None) -> BPINNsolution:
    """`solve(ODEProblem, BNNODE)` (reference: ext/bpinn/BPINN_ode.jl:26-109).
    Runs on ``device``, ``"cuda"`` unless given; the ensemble's curves come
    from one batched evaluation of the tail's draws."""
    del maxiters
    samples, stats, ltd = ahmc_bayesian_pinn_ode(
        prob, alg.chain, strategy=alg.strategy, dataset=alg.dataset,
        init_params=alg.init_params, draw_samples=alg.draw_samples,
        physdt=alg.physdt, l2std=alg.l2std, phystd=alg.phystd,
        phynewstd=alg.phynewstd, priorsNNw=alg.priorsNNw, param=alg.param,
        nchains=alg.nchains, autodiff=alg.autodiff, Kernel=alg.Kernel,
        n_leapfrog=alg.n_leapfrog, max_depth=alg.max_depth,
        estim_collocate=alg.estim_collocate, seed=alg.seed,
        verbose=alg.verbose, device=device)
    if alg.nchains > 1:
        samples = samples[0]  # first chain for the ensemble (reference behavior)

    numensemble = min(alg.numensemble, alg.draw_samples)
    tail = samples[-numensemble:]
    t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
    if saveat is None:
        saveat = 1.0 / 50.0
    ts = np.arange(t0, t1 + saveat / 2, saveat)
    ts_t = torch.as_tensor(ts, dtype=tail.dtype, device=tail.device)
    with torch.no_grad():
        curves = vmap(lambda th: ltd.phi(ts_t, th[:ltd.n_nn]))(tail)
        ensemble = [Particles(curves[:, i, :]) for i in range(ltd.n_out)]
        est_nn = ltd.unravel(torch.mean(tail[:, :ltd.n_nn], dim=0))
        est_de = [Particles(tail[:, ltd.n_nn + i])
                  for i in range(ltd.extraparams)]
    return BPINNsolution(
        original=BPINNstats(None, samples, stats),
        ensemblesol=ensemble, estimated_nn_params=est_nn,
        estimated_de_params=est_de, timepoints=ts)
