"""Bayesian parameter estimation for Lotka-Volterra from noisy data, the
reference's Lotka_Volterra_BPINNs tutorial (`examples/lotka_volterra_bpinn.py`
in the port).

x' = a x - b x y, y' = -c y + d x y with (a, b, c, d) = (1.5, 1, 3, 1), 80
RK4 samples on [0, 2] with 1% noise; `BNNODE` with ``mlp([1, 16, 16, 2])``,
1,200 HMC draws of 25 leapfrog steps, priors on the four parameters,
``estim_collocate``.  Runs in float64: in float32 the density's spacing
(~-1.5e6 at the start) quantizes the Metropolis test's energy differences
and dual averaging shrinks the step size until the chain freezes.
Error: rel L2 of the estimated parameters against the true ones.

Run:

    python -m neuralpde_tpu_torch.examples.lotka_volterra_bpinn
        [--draws 1200] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import contextlib
import time

import numpy as np
import torch

from neuralpde_tpu_torch import BNNODE, Normal, ODEProblem, mlp, solve_bnnode

P_TRUE = np.array([1.5, 1.0, 3.0, 1.0])       # alpha, beta, gamma, delta


def _fnp(u, p):
    return np.array([p[0] * u[0] - p[1] * u[0] * u[1],
                     -p[2] * u[1] + p[3] * u[0] * u[1]])


def lotka_volterra_data(n: int = 80, seed: int = 0):
    """``(ts, dataset)``: RK4 samples of the true system at ``n`` times on
    [0, 2] with 1% noise (numpy ``default_rng(seed)``), as the dataset
    ``[x, y, t, dt]``."""
    ts = np.linspace(0, 2, n)
    us = [np.array([1.0, 1.0])]
    for i in range(n - 1):
        h, u = ts[i + 1] - ts[i], us[-1]
        k1 = _fnp(u, P_TRUE)
        k2 = _fnp(u + h / 2 * k1, P_TRUE)
        k3 = _fnp(u + h / 2 * k2, P_TRUE)
        k4 = _fnp(u + h * k3, P_TRUE)
        us.append(u + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4))
    traj = np.stack(us)
    noisy = traj + 0.01 * traj.std(0) * np.random.default_rng(
        seed).standard_normal(traj.shape)
    return ts, [noisy[:, 0], noisy[:, 1], ts, np.full_like(ts, ts[1] - ts[0])]


def lotka_volterra_problem() -> ODEProblem:
    def f(u, p, t):
        return torch.stack([p[0] * u[0] - p[1] * u[0] * u[1],
                            -p[2] * u[1] + p[3] * u[0] * u[1]])

    return ODEProblem(f=f, u0=np.array([1.0, 1.0]), tspan=(0.0, 2.0),
                      p=np.array([1.0, 1.0, 2.0, 1.0]))


def make_alg(draws: int = 1200, n_leapfrog: int = 25, *, chain=None,
             n_data: int = 80, **kw) -> BNNODE:
    """The example's `BNNODE` (``kw`` adds fields, e.g. ``numensemble``)."""
    _, dataset = lotka_volterra_data(n_data)
    return BNNODE(chain if chain is not None else mlp([1, 16, 16, 2]),
                  dataset=dataset, draw_samples=draws, l2std=(0.02, 0.02),
                  phystd=(0.05, 0.05), priorsNNw=(0.0, 3.0),
                  param=(Normal(2.0, 1.0), Normal(1.5, 1.0),
                         Normal(2.5, 1.0), Normal(1.5, 1.0)),
                  estim_collocate=True, n_leapfrog=n_leapfrog, **kw)


@contextlib.contextmanager
def _default_dtype(dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def run(draws: int = 1200, n_leapfrog: int = 25, *, n_data: int = 80,
        verbose: bool = True, device="cuda", **kw) -> dict:
    """Returns ``{"rel_l2", "wall_s", "estimates", "split_rhat", "ess"}``
    (the last two for the four parameters)."""
    with _default_dtype(torch.float64):
        alg = make_alg(draws, n_leapfrog, n_data=n_data, **kw)
        t0 = time.perf_counter()
        sol = solve_bnnode(lotka_volterra_problem(), alg, device=device)
        wall = time.perf_counter() - t0
    est = np.array([float(p.mean) for p in sol.estimated_de_params])
    d = sol.diagnostics()
    rel = float(np.linalg.norm(est - P_TRUE) / np.linalg.norm(P_TRUE))
    if verbose:
        print(f"true params: {P_TRUE.tolist()}\nestimated:   "
              f"{np.round(est, 3).tolist()}\nparam split-Rhat: "
              f"{np.round(d['split_rhat'][-4:], 3)}  ESS: "
              f"{np.round(d['ess'][-4:], 0)}", flush=True)
    return {"rel_l2": rel, "wall_s": round(wall, 2),
            "estimates": est.tolist(),
            "split_rhat": np.asarray(d["split_rhat"][-4:]).tolist(),
            "ess": np.asarray(d["ess"][-4:]).tolist()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=1200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.draws, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
