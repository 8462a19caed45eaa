"""Bayesian PDE PINN: `ahmc_bayesian_pinn_pde` (`neuralpde_tpu.bayesian.pde`;
reference: ext/bpinn/PDE_BPINN.jl).

The physics log-likelihood reuses the PDE pipeline's datafree residuals as
Gaussian (SSE) log-likelihoods over grid and data points (reference:
src/training_strategies.jl:50-128, src/discretize.jl:651-755); the flat HMC
vector maps onto the per-depvar parameters (`setparameters`, reference:
ext/bpinn/PDE_BPINN.jl:117-139).  With ``derivative="jet"`` and tanh
networks every gradient of the log-density runs the `tanh_jet2` kernels.

The reference's ``Dict_differentials`` symbolic-collocation likelihood is
``estim_collocate=True``: the IR tells Deriv nodes apart structurally, so no
user-supplied mask is needed, and the reference's per-row code becomes one
batched residual evaluation.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from ..compile.discretize import BayesianPINN, symbolic_discretize
from ..compile.lower import LoweringContext, build_residual_function
from ..ops.distributions import Normal, Particles, mvnormal_diag_logpdf
from ..parallel.mesh import check_mesh
from ..strategies import GridTraining, generate_training_sets, julia_range
from ..symbolic.expr import Call, DepVarCall, Deriv, Eq, IntegralExpr, Sym
from ..symbolic.system import infimum, supremum
from ..utils.pytree import parameters_to_vector
from . import hmc
from .ode import BPINNsolution, BPINNstats, _chain_starts


def _subst_plain_depvars(expr, mapping):
    """Replace *plain* dependent-variable calls by placeholder Syms, leaving
    Deriv subtrees intact — the masking step of the reference's `get_lossy`
    (ext/bpinn/PDE_BPINN.jl:29-80), done structurally on the IR."""
    if isinstance(expr, DepVarCall) and expr.name in mapping:
        return mapping[expr.name]
    if isinstance(expr, Deriv):
        return expr
    if isinstance(expr, Call):
        return Call(expr.op, tuple(_subst_plain_depvars(a, mapping)
                                   for a in expr.args))
    if isinstance(expr, IntegralExpr):
        return IntegralExpr(_subst_plain_depvars(expr.integrand, mapping),
                            expr.ivars, expr.lb, expr.ub)
    return expr


def _depvar_set(pinnrep, dataset, args):
    """Coordinates (rows, N) of the dataset of the depvar whose inputs are
    the equation's ``args``, or None."""
    names = [a.name for a in args if isinstance(a, Sym)]
    for i, name in enumerate(pinnrep.depvars):
        if pinnrep.dict_depvar_input[name] == names:
            return np.asarray(dataset[i])[:, 1:].T
    return None


def build_data_collocation_logliks(pinnrep, dataset):
    """Per-equation dataset-collocation log-likelihoods: each equation with
    its plain depvar calls replaced by the observed values, evaluated at the
    dataset's coordinates.

    The reference compiles one function per dataset row per equation
    (ext/bpinn/PDE_BPINN.jl:385-441); here each equation lowers once with
    placeholder symbols bound to extra cord rows holding the data values,
    and all rows evaluate in one batched call.
    """
    dtype, device = pinnrep.dtype, pinnrep.device
    depvars = pinnrep.depvars
    placeholders = {name: Sym(f"_data_{name}") for name in depvars}
    # data values per depvar (column 0); the depvars share the rows of the
    # dataset whose coordinates match, as in the reference
    values = {name: np.asarray(dataset[i])[:, 0]
              for i, name in enumerate(depvars)}
    ctx = LoweringContext.from_pinnrep(pinnrep)

    logliks = []
    for eq, args in zip(pinnrep.eqs, pinnrep.pde_args):
        masked = Eq(_subst_plain_depvars(eq.lhs, placeholders),
                    _subst_plain_depvars(eq.rhs, placeholders))
        arg_syms = [a for a in args if isinstance(a, Sym)]
        layout = arg_syms + [placeholders[n] for n in depvars]
        residual = build_residual_function(masked, layout, ctx,
                                           pinnrep.default_p)
        coord_rows = _depvar_set(pinnrep, dataset, args)
        if coord_rows is None:
            logliks.append(None)
            continue
        data_rows = np.stack([values[n] for n in depvars])
        cord = torch.as_tensor(np.vstack([coord_rows, data_rows]),
                               dtype=dtype, device=device)

        def loglik(theta, std, residual=residual, cord=cord):
            return mvnormal_diag_logpdf(residual(cord, theta), 0.0, std)

        logliks.append(loglik)
    return logliks


class PDELogTargetDensity:
    """(reference: ext/bpinn/PDE_BPINN.jl:1-26)"""

    def __init__(self, pinnrep, dataset, priors_nn: Normal, param_priors,
                 allstd, phynewstd, estim_collocate: bool = False):
        self.pinnrep = pinnrep
        self.dataset = dataset
        self.priors_nn = priors_nn
        self.param_priors = list(param_priors)
        self.extraparams = len(self.param_priors)
        self.phystd, self.bcstd, self.l2std = (
            [float(s) for s in std] for std in allstd)
        self.phynewstd = [float(s) for s in phynewstd]
        self.names = pinnrep.depvars
        self.multioutput = pinnrep.multioutput
        dtype, device = pinnrep.dtype, pinnrep.device

        # flat layout: per-depvar network parameters (declaration order),
        # then the PDE parameters
        init = pinnrep.init_params
        if self.multioutput:
            self.prefixes = [f"depvar.{n}." for n in self.names]
            parts = [parameters_to_vector(
                {k[len(n) + 1:]: v for k, v in init.items()
                 if k.startswith(f"{n}.")}) for n in self.names]
        else:
            self.prefixes = ["depvar."]
            parts = [parameters_to_vector(init)]
        self.unravels = [unr for _, unr in parts]
        self.sizes = [flat.shape[0] for flat, _ in parts]
        self.init_flat_nn = torch.cat([flat for flat, _ in parts])
        self.n_nn = int(sum(self.sizes))
        self.dim = self.n_nn + self.extraparams

        strategy = pinnrep.strategy
        lf = pinnrep.loss_functions
        # dataset points are arbitrary coordinates: always pointwise
        self.data_residuals = lf.datafree_pde_loss_functions
        if isinstance(strategy, GridTraining):
            self.pde_residuals = lf.datafree_pde_loss_functions
            self.bc_residuals = lf.datafree_bc_loss_functions
            self.pde_sets = generate_training_sets(
                pinnrep.domains, strategy.dx, pinnrep.pde_args, dtype, device)
            self.bc_sets = generate_training_sets(
                pinnrep.domains, strategy.dx, pinnrep.bc_args, dtype, device)
        else:
            self._separable(pinnrep, strategy)

        self.data_pde_sets = None
        if dataset is not None:
            self.data_pde_sets = [
                None if s is None else torch.as_tensor(s, dtype=dtype,
                                                       device=device)
                for s in (_depvar_set(pinnrep, dataset, args)
                          for args in pinnrep.pde_args)]
            self.data_mats = [torch.as_tensor(np.asarray(m), dtype=dtype,
                                              device=device)
                              for m in dataset]
        self.colloc_logliks = None
        if estim_collocate and dataset is not None:
            self.colloc_logliks = build_data_collocation_logliks(
                pinnrep, dataset)

    def _separable(self, pinnrep, strategy) -> None:
        """The factorized physics log-likelihood of a static-grid
        `SeparableTraining(dx=...)`: grid residuals flattened, equal to the
        pointwise evaluation on the same tensor grid."""
        from ..compile.separable import (
            SeparableTraining, build_separable_residual)

        if not (isinstance(strategy, SeparableTraining)
                and strategy.dx is not None):
            raise ValueError(
                "BayesianPINN supports GridTraining or static-grid "
                "SeparableTraining(dx=...) (the Bayesian loglikelihood "
                "needs a deterministic point set)")
        dtype, device = pinnrep.dtype, pinnrep.device
        phis = pinnrep.phi if self.multioutput else [pinnrep.phi]
        nets = {n: ph.module for n, ph in zip(pinnrep.depvars, phis)}
        ctx = LoweringContext.from_pinnrep(pinnrep)
        dxs = (list(strategy.dx) if isinstance(strategy.dx, (list, tuple))
               else [strategy.dx] * len(pinnrep.domains))
        nodes_of = {d.variables.name: julia_range(
            float(infimum(d.domain)), float(supremum(d.domain)), h)
            for d, h in zip(pinnrep.domains, dxs)}

        def adapter(eq):
            residual, axes = build_separable_residual(
                eq, ctx, nets, dtype, pinnrep.default_p)
            nodes = [torch.as_tensor(nodes_of[a.name], dtype=dtype,
                                     device=device) for a in axes]

            def res(_set, theta):
                return torch.ravel(residual(nodes, theta))

            return res, nodes

        pde = [adapter(eq) for eq in pinnrep.eqs]
        bc = [adapter(bc) for bc in pinnrep.bcs]
        self.pde_residuals = [r for r, _ in pde]
        self.bc_residuals = [r for r, _ in bc]
        self.pde_sets = [s for _, s in pde]
        self.bc_sets = [s for _, s in bc]

    def setparameters(self, theta) -> dict:
        """Flat vector -> the port's flat parameter dict
        (``"depvar.layer_0.weight"``, ``"depvar.<name>.…"`` with one chain
        per depvar, ``"p"``)."""
        out, i = {}, 0
        for prefix, unr, s in zip(self.prefixes, self.unravels, self.sizes):
            out.update({prefix + k: v for k, v in unr(theta[i:i + s]).items()})
            i += s
        if self.extraparams > 0:
            out["p"] = theta[self.n_nn:]
        return out

    # --- likelihood terms -------------------------------------------------
    def full_loglikelihood(self, theta_struct):
        total = 0.0
        for res, s, std in zip(self.pde_residuals, self.pde_sets,
                               self.phystd):
            total = total + mvnormal_diag_logpdf(res(s, theta_struct), 0.0,
                                                 std)
        for res, s, std in zip(self.bc_residuals, self.bc_sets, self.bcstd):
            total = total + mvnormal_diag_logpdf(res(s, theta_struct), 0.0,
                                                 std)
        if self.data_pde_sets is not None:
            for res, s, std in zip(self.data_residuals, self.data_pde_sets,
                                   self.phystd):
                if s is not None:
                    total = total + mvnormal_diag_logpdf(
                        res(s, theta_struct), 0.0, std)
        return total

    def _params_of(self, theta_struct, i):
        prefix = self.prefixes[i if self.multioutput else 0]
        return {k[len(prefix):]: v for k, v in theta_struct.items()
                if k.startswith(prefix)}

    def L2LossData(self, theta_struct):
        if self.dataset is None or self.extraparams <= 0:
            return 0.0
        phis = self.pinnrep.phi if self.multioutput else [self.pinnrep.phi]
        total = 0.0
        for i in range(len(self.names)):
            mat = self.data_mats[i]
            pred = phis[i](mat[:, 1:].T, self._params_of(theta_struct, i))[0]
            total = total + mvnormal_diag_logpdf(pred, mat[:, 0],
                                                 self.l2std[i])
        return total

    def priorlogpdf(self, theta):
        lp = torch.sum(self.priors_nn.logpdf(theta[:self.n_nn]))
        for i, pr in enumerate(self.param_priors):
            lp = lp + pr.logpdf(theta[self.n_nn + i])
        return lp

    def L2_loss2(self, theta_struct):
        """Dataset-collocation log-likelihood (reference: ext/bpinn/
        PDE_BPINN.jl:422-440 `L2_loss2`)."""
        if not self.colloc_logliks:
            return 0.0
        total = 0.0
        for ll, std in zip(self.colloc_logliks, self.phynewstd):
            if ll is not None:
                total = total + ll(theta_struct, std)
        return total

    def __call__(self, theta):
        ts = self.setparameters(theta)
        out = (self.full_loglikelihood(ts) + self.priorlogpdf(theta)
               + self.L2LossData(ts))
        if self.colloc_logliks:
            out = out + self.L2_loss2(ts)
        return out


def inference(samples, pinnrep, saveats, numensemble, ltd):
    """Ensemble predictions on the saveats grid (reference:
    ext/bpinn/PDE_BPINN.jl:222-312): one batched evaluation of the tail's
    draws per depvar."""
    dtype, device = pinnrep.dtype, samples.device
    ranges = {d.variables.name: julia_range(float(infimum(d.domain)),
                                            float(supremum(d.domain)), dx)
              for d, dx in zip(pinnrep.domains, saveats)}
    phis = pinnrep.phi if pinnrep.multioutput else [pinnrep.phi]
    tail = samples[-numensemble:]
    ensemblecurves, timepoints = [], []
    with torch.no_grad():
        for j, name in enumerate(pinnrep.depvars):
            axes = [ranges[v] for v in pinnrep.dict_depvar_input[name]]
            grid = np.meshgrid(*axes, indexing="ij")
            cord = torch.as_tensor(np.stack([g.reshape(-1) for g in grid]),
                                   dtype=dtype, device=device)

            def predict(th, j=j, cord=cord):
                return phis[j](cord, ltd._params_of(ltd.setparameters(th),
                                                    j))[0]

            ensemblecurves.append(Particles(vmap(predict)(tail)))
            timepoints.append(cord)
        mean = ltd.setparameters(torch.mean(tail, dim=0))
        est_nn = {k[len("depvar."):]: v for k, v in mean.items()
                  if k.startswith("depvar.")}
        est_params = [Particles(tail[:, ltd.n_nn + i])
                      for i in range(ltd.extraparams)]
    return ensemblecurves, est_nn, est_params, timepoints


def ahmc_bayesian_pinn_pde(
        pde_system, discretization: BayesianPINN, *, draw_samples: int = 1000,
        bcstd=(0.01,), l2std=(0.05,), phystd=(0.05,), phynewstd=(0.05,),
        priorsNNw=(0.0, 2.0), param=(), nchains: int = 1, Kernel: str = "hmc",
        n_leapfrog: int = 30, target_accept: float = 0.8, max_depth: int = 10,
        saveats=(1 / 10.0,), numensemble: int | None = None, seed: int = 0,
        estim_collocate: bool = False, mesh=None,
        progress: bool = False, verbose: bool = False) -> BPINNsolution:
    """(reference: ext/bpinn/PDE_BPINN.jl:371-635).  Runs on the
    discretization's device (``"cuda"`` unless it was given another);
    ``mesh`` shards the chains (`hmc.sample_chains`).

    ``estim_collocate=True`` enables the dataset-collocation
    log-likelihood — the reference's Dict_differentials path, which here
    needs no user-supplied differential mask."""
    del progress
    check_mesh(mesh)
    pinnrep = symbolic_discretize(pde_system, discretization)
    dataset_pde, dataset_bc = discretization.dataset

    if dataset_pde is None and dataset_bc is None:
        dataset = None
    elif dataset_bc is None:
        dataset = dataset_pde
    elif dataset_pde is None:
        dataset = dataset_bc
    else:
        dataset = [np.vstack([np.asarray(dataset_pde[i]),
                              np.asarray(dataset_bc[i])])
                   for i in range(len(dataset_pde))]

    if discretization.param_estim and not param:
        raise ValueError("param priors required when param_estim=True")
    if discretization.param_estim and dataset is None:
        raise ValueError("dataset required when param_estim=True")
    if discretization.param_estim and len(l2std) != len(pinnrep.depvars):
        raise ValueError("L2 stds length must match number of dependant "
                         "variables")
    if len(pinnrep.domains) != len(saveats):
        raise ValueError("Number of independent variables must match saveat "
                         "inference discretization steps")

    numensemble = numensemble or draw_samples // 3
    priors_nn = Normal(float(priorsNNw[0]), float(priorsNNw[1]))
    ltd = PDELogTargetDensity(pinnrep, dataset, priors_nn, param,
                              [list(phystd), list(bcstd), list(l2std)],
                              list(phynewstd), estim_collocate=estim_collocate)

    theta0 = ltd.init_flat_nn
    if param:
        theta0 = torch.cat([theta0, torch.tensor(
            [pr.mean for pr in param], dtype=theta0.dtype,
            device=theta0.device)])
    if verbose:
        with torch.no_grad():
            ts0 = ltd.setparameters(theta0)
            print(f"Current Physics Log-likelihood : "
                  f"{float(ltd.full_loglikelihood(ts0)):g}")
            print(f"Current Prior Log-likelihood : "
                  f"{float(ltd.priorlogpdf(theta0)):g}")
            print(f"Current SSE against dataset Log-likelihood : "
                  f"{float(ltd.L2LossData(ts0)):g}")

    generator = torch.Generator(device=theta0.device).manual_seed(seed + 1)
    if nchains > 1:
        chains = hmc.sample_chains(
            ltd, _chain_starts(ltd.n_nn, theta0, nchains, seed), generator,
            draw_samples, kernel=Kernel, n_leapfrog=n_leapfrog,
            target_accept=target_accept, max_depth=max_depth, mesh=mesh)
        sols = []
        for i in range(nchains):
            curves, est_nn, est_p, tp = inference(chains[i], pinnrep,
                                                  saveats, numensemble, ltd)
            sols.append(BPINNsolution(BPINNstats(None, chains[i], None),
                                      curves, est_nn, est_p, tp))
        return sols

    res = hmc.sample(ltd, theta0, generator, draw_samples, kernel=Kernel,
                     n_leapfrog=n_leapfrog, target_accept=target_accept,
                     max_depth=max_depth)
    if verbose:
        print("Sampling Complete.")
        with torch.no_grad():
            tsf = ltd.setparameters(res.samples[-1])
            print(f"Final Physics Log-likelihood : "
                  f"{float(ltd.full_loglikelihood(tsf)):g}")
    curves, est_nn, est_p, tp = inference(res.samples, pinnrep, saveats,
                                          numensemble, ltd)
    stats = {**res.stats, "inv_mass": res.inv_mass, **res.aux}
    return BPINNsolution(BPINNstats(None, res.samples, stats),
                         curves, est_nn, est_p, tp)
