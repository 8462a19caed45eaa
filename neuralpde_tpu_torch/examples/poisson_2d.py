"""2-D Poisson with `PhysicsInformedNN`, the reference's flagship tutorial
(`examples/poisson_2d.py` in the port).

u_xx + u_yy = -sin(pi x) sin(pi y) on the unit square, u = 0 on its sides
(`accuracy.poisson_2d_system`); ``mlp([2, 16, 16, 1])`` on
`GridTraining(0.05)`, 3,000 Adam(2e-2) steps; max abs error and rel L2 on
a 21^2 grid against sin(pi x) sin(pi y) / (2 pi^2).

Run:

    python -m neuralpde_tpu_torch.examples.poisson_2d [--iters 3000]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from neuralpde_tpu_torch import (
    GridTraining, PhysicsInformedNN, adam, depvar_params, discretize,
    matmul_precision, mlp, solve,
)
from neuralpde_tpu_torch.accuracy import poisson_2d_rel_l2, poisson_2d_system


def run(iters: int = 3000, *, dx: float = 0.05, sizes=(2, 16, 16, 1),
        verbose: bool = True, device="cuda") -> dict:
    """Returns ``{"rel_l2", "max_abs_error", "wall_s", "loss"}``."""
    disc = PhysicsInformedNN(mlp(list(sizes)), GridTraining(dx),
                             device=device)
    prob = discretize(poisson_2d_system(), disc)
    t0 = time.perf_counter()
    res = solve(prob, adam(2e-2), maxiters=iters, inner_steps=25)
    wall = time.perf_counter() - t0
    xs = np.linspace(0, 1, 21)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    with torch.no_grad(), matmul_precision("highest"):
        pred = disc.phi(np.stack([X.ravel(), Y.ravel()]),
                        depvar_params(res.u))[0]
    pred = pred.double().cpu().numpy().reshape(21, 21)
    want = np.sin(np.pi * X) * np.sin(np.pi * Y) / (2 * np.pi ** 2)
    err = float(np.abs(pred - want).max())
    if verbose:
        print(f"final loss {res.objective:.3e}   max abs error {err:.4f}",
              flush=True)
    return {"rel_l2": poisson_2d_rel_l2(disc.phi, res.u), "max_abs_error": err,
            "wall_s": round(wall, 2), "loss": res.objective}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.iters, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
