#!/usr/bin/env python3
"""The effective sample size of the Lotka-Volterra BNNODE recipe in both
packages, on the CPU, from the same start and the same noise.

A comparison tool in the manner of `tests/test_torch_*.py` (it imports the
JAX package and the PyTorch port).  The recipe is `tests/test_bayesian.py`'s
`test_bnnode_lotka_volterra_inverse` (`examples/lotka_volterra_bpinn.py`
with a sigmoid ``mlp([1, 16, 16, 2])``, 1200 HMC draws of 25 leapfrog
steps, `estim_collocate`, float64), which `chip_smoke.py` phase 26 runs on
the card:

1. the JAX package's chain: `ahmc_bayesian_pinn_ode` as `solve_bnnode`
   calls it (seed 0);
2. the port's chain: its `LogTargetDensity` from the JAX chain's initial
   network parameters, then `hmc._sample_arrays` from the same start with
   the JAX chain's initial step size and its momentum normals and accept
   uniforms (`hmc.NoiseTable`, one row a draw).

Printed, as one JSON line: the ESS and split-R-hat of the four ODE
parameters over the last third of each chain (the post-warm-up draws, the
window of phase 26), each from its own package's `ess` and from the other
package's; the draws each package took a second; the largest relative
difference of the two chains at a few draws.

    python scripts/compare_bnnode_ess.py [--draws 1200]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--draws", type=int, default=1200)
    args = parser.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    import neuralpde_tpu as jpkg
    import neuralpde_tpu_torch as tpkg
    from neuralpde_tpu.bayesian import diagnostics as jdiag
    from neuralpde_tpu.bayesian import hmc as jhmc
    from neuralpde_tpu.bayesian.ode import ahmc_bayesian_pinn_ode as jahmc
    from neuralpde_tpu.nn.core import sigmoid as jsigmoid
    from neuralpde_tpu_torch.bayesian import hmc as thmc
    from neuralpde_tpu_torch.examples import lotka_volterra_bpinn as lv
    from neuralpde_tpu_torch.nn.core import sigmoid as tsigmoid

    torch.set_default_dtype(torch.float64)
    draws, n_leapfrog = args.draws, 25
    ts, dataset = lv.lotka_volterra_data(80)
    priors = [(2.0, 1.0), (1.5, 1.0), (2.5, 1.0), (1.5, 1.0)]
    common = dict(dataset=dataset, l2std=(0.02, 0.02), phystd=(0.05, 0.05),
                  priorsNNw=(0.0, 3.0), estim_collocate=True)

    def f(u, p, t):
        return jnp.array([p[0] * u[0] - p[1] * u[0] * u[1],
                          -p[2] * u[1] + p[3] * u[0] * u[1]])

    jprob = jpkg.ODEProblem(f=f, u0=np.array([1.0, 1.0]), tspan=(0.0, 2.0),
                            p=np.array([1.0, 1.0, 2.0, 1.0]))
    jchain = jpkg.mlp([1, 16, 16, 2], activation=jsigmoid)
    t0 = time.perf_counter()
    jsamples, _, jl = jahmc(jprob, jchain, draw_samples=draws,
                            param=[jpkg.Normal(*p) for p in priors],
                            n_leapfrog=n_leapfrog, **common)
    jsamples = np.asarray(jax.block_until_ready(jsamples))
    jax_s = time.perf_counter() - t0

    # the start, the initial step size and the noise of that chain
    # (`hmc.sample`: the key of seed + 1, split once for the step size)
    init_tree = jchain.init(jax.random.key(0))
    theta0 = np.concatenate([np.asarray(jl.init_flat_nn),
                             [p[0] for p in priors]])
    key, sub = jax.random.split(jax.random.key(1))
    eps0 = float(jhmc.find_good_stepsize(jl, jnp.asarray(theta0), sub))

    def one(k):
        kp, ka, _ = jax.random.split(k, 3)
        return (jax.random.normal(kp, (theta0.shape[0],)),
                jax.random.uniform(ka, ()))

    z, u = jax.vmap(one)(jax.random.split(key, draws))

    tl = tpkg.ahmc_bayesian_pinn_ode(
        lv.lotka_volterra_problem(),
        tpkg.mlp([1, 16, 16, 2], activation=tsigmoid), draw_samples=0,
        param=[tpkg.Normal(*p) for p in priors],
        init_params=tpkg.params_from_jax(init_tree), device="cpu",
        **common)[2]
    start = np.concatenate([tl.init_flat_nn.numpy(), [p[0] for p in priors]])
    t0 = time.perf_counter()
    tsamples = thmc._sample_arrays(
        tl, torch.tensor(start), None, draws, kernel="hmc",
        n_leapfrog=n_leapfrog, init_step_size=eps0,
        noise=thmc.NoiseTable(np.asarray(z), np.asarray(u)))[0].numpy()
    port_s = time.perf_counter() - t0

    tail = slice((2 * draws) // 3, None)
    jtail, ttail = jsamples[tail, -4:], tsamples[tail, -4:]

    def parted(i):
        return float(np.max(np.abs(tsamples[i] - jsamples[i]))
                     / np.max(np.abs(jsamples[i])))

    print(json.dumps({
        "draws": draws, "window": f"draws {(2 * draws) // 3}..{draws - 1}",
        "same_start": float(np.max(np.abs(start - theta0))),
        "initial_step_size": eps0,
        "ess_jax": jdiag.ess(jtail).tolist(),
        "ess_port": tpkg.ess(ttail).tolist(),
        "ess_jax_chain_by_port_ess": tpkg.ess(jtail).tolist(),
        "ess_port_chain_by_jax_ess": jdiag.ess(ttail).tolist(),
        "split_rhat_jax": jdiag.split_rhat(jtail).tolist(),
        "split_rhat_port": tpkg.split_rhat(ttail).tolist(),
        "estimates_jax": jtail.mean(0).tolist(),
        "estimates_port": ttail.mean(0).tolist(),
        "chains_rel_diff": {i: parted(i) for i in (1, 10, 60, 200, 400, 800,
                                                   draws - 1)
                            if i < draws},
        "draws_per_s": {"jax": draws / jax_s, "port": draws / port_s}}))


if __name__ == "__main__":
    main()
