"""Weak SDE solution of geometric Brownian motion with `NNSDE`
(`examples/gbm_sde.py` in the port).

du = 1.2 u dt + 0.2 u dW, u(0) = 1 on [0, 1]; ``mlp([4, 16, 16, 1])`` with
sigmoid activations (three KL modes of the noise as extra inputs),
sub-batches of 8, an ensemble of 50 paths, dt = 1/50, 2,000 Adam(2e-2)
steps.  Error: rel L2 of the predicted mean E[u(t)] against exp(1.2 t).

Run:

    python -m neuralpde_tpu_torch.examples.gbm_sde [--iters 2000]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from neuralpde_tpu_torch import NNSDE, SDEProblem, adam, mlp, solve_sde

MU, SIGMA = 1.2, 0.2


def gbm_problem() -> SDEProblem:
    """du = mu u dt + sigma u dW, u(0) = 1, E[u(t)] = exp(mu t)."""
    return SDEProblem(f=lambda u, p, t: MU * u, g=lambda u, p, t: SIGMA * u,
                      u0=1.0, tspan=(0.0, 1.0))


def run(iters: int = 2000, *, hidden: int = 16, numensemble: int = 50,
        dt: float = 1 / 50, verbose: bool = True, device="cuda") -> dict:
    """Returns ``{"rel_l2", "wall_s", "mean_u1"}``."""
    alg = NNSDE(mlp([1 + 3, hidden, hidden, 1], activation=torch.sigmoid),
                adam(2e-2), sub_batch=8, numensemble=numensemble)
    t0 = time.perf_counter()
    sol = solve_sde(gbm_problem(), alg, dt=dt, maxiters=iters,
                    inner_steps=min(25, iters), device=device)
    wall = time.perf_counter() - t0
    ts = np.asarray(sol.timepoints)
    mean = np.asarray([float(p.mean) for p in sol.estimated_sol[0]])
    want = np.exp(MU * ts)
    rel = float(np.linalg.norm(mean - want) / np.linalg.norm(want))
    if verbose:
        print(f"E[u(1)] predicted: {mean[-1]:.5f}  analytic: "
              f"{np.exp(MU):.5f}; rel L2 of the mean {rel:.4e}", flush=True)
    return {"rel_l2": rel, "wall_s": round(wall, 2),
            "mean_u1": float(mean[-1])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.iters, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
