"""Allen-Cahn via causal training, the classic stiff-PDE PINN failure case
(`examples/allen_cahn_causal.py` in the port).

    u_t = 1e-4 u_xx + 5(u - u^3),  x in [-1,1] periodic,  t in [0,1]
    u(x,0) = x^2 cos(pi x)

`CausalTraining(8192, t, bcs_points=1024, n_slabs=32)` with eps annealed
1 -> 10 -> 100 (30,000, 30,000 and 40,000 Adam steps), an exactly periodic
trial function (a `PeriodicEmbedding` of x in front of ``mlp([21, 128,
128, 128, 128, 1])``), IC weight 100, Taylor-mode derivatives
(`accuracy.dense_allen_cahn_problem` at width 128); rel L2 against the
spectral reference on its 512 x 101 points.

Run:

    python -m neuralpde_tpu_torch.examples.allen_cahn_causal [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

from neuralpde_tpu_torch import adam, solve
from neuralpde_tpu_torch.accuracy import (
    dense_allen_cahn_problem, dense_allen_cahn_rel_l2,
)

STAGES = ((1.0, 30000, 1e-3), (10.0, 30000, 5e-4), (100.0, 40000, 2e-4))


def run(stages=STAGES, *, points: int = 8192, bcs_points: int = 1024,
        n_slabs: int = 32, hidden: int = 128, depth: int = 4,
        verbose: bool = True,
        device="cuda") -> dict:
    """The three stages of ``(eps, iters, lr)``, each from the last one's
    parameters.  Returns ``{"rel_l2", "wall_s", "per_stage": [(eps,
    rel_l2), ...]}``."""
    theta, per_stage = None, []
    t0 = time.perf_counter()
    for eps, iters, lr in stages:
        prob, _ = dense_allen_cahn_problem(
            eps, points=points, bcs_points=bcs_points, n_slabs=n_slabs,
            hidden=hidden, depth=depth, device=device)
        if theta is not None:
            prob = prob.with_params(theta)
        theta = solve(prob, adam(lr), maxiters=iters,
                      inner_steps=min(1000, iters)).u
        rel = dense_allen_cahn_rel_l2(prob, theta)
        per_stage.append((eps, rel))
        if verbose:
            print(f"eps={eps:>5}: rel L2 = {rel:.4f}  "
                  f"(t = {time.perf_counter() - t0:.1f}s)", flush=True)
    return {"rel_l2": per_stage[-1][1],
            "wall_s": round(time.perf_counter() - t0, 1),
            "per_stage": per_stage}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
