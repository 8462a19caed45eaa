"""Kuramoto-Sivashinsky (a 4th-order PDE) against its solitary-wave
solution (`examples/kuramoto_sivashinsky.py` in the port).

u_t + u u_x + u_xx + 4 u_xxx + u_xxxx = 0 on [-10, 10] x [0, 1] with the
exact solution's initial value, end values and end slopes;
``mlp([2, 32, 32, 1])`` on `GridTraining([0.4, 0.1])` (51 x 11 nodes),
Taylor-mode derivatives (the order-2 term through ``tanh_jet2`` on the
card, orders 1, 3 and 4 through tanh's plain Taylor series), 3,000 Adam
steps, then 600 L-BFGS steps (captured on the card, in blocks of 10, as
the JAX example's).  rel L2 (RMS ratio) on a 41 x 5 grid.

The script trains only under `main` (or `run`).

Run:

    python -m neuralpde_tpu_torch.examples.kuramoto_sivashinsky
        [--adam-iters 3000] [--lbfgs-iters 600] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import neuralpde_tpu_torch as npde
from neuralpde_tpu_torch import (
    DepVar, Differential, Domain, Eq, GridTraining, Interval, PDESystem,
    PhysicsInformedNN, adam, depvar_params, discretize, lbfgs,
    matmul_precision, mlp, solve, symbols,
)

A, B, G = 1.0, 4.0, 1.0


def u_exact(xe, te, lib=np):
    th = lib.tanh(-xe / 2.0 + te)
    return 11 + 15 * th - 15 * th ** 2 - 15 * th ** 3


def du_exact(xe, te, lib=np):
    th = lib.tanh(-xe / 2.0 + te)
    return 15 / 2 * (th + 1) * (3 * th - 1) * (1 - th ** 2)


def build_system() -> PDESystem:
    x, t = symbols("x t")
    u = DepVar("u")
    Dt, Dx = Differential(t), Differential(x)
    U = u(x, t)
    eq = Eq(Dt(U) + U * Dx(U) + A * (Dx ** 2)(U) + B * (Dx ** 3)(U)
            + G * (Dx ** 4)(U), 0.0)
    bcs = [Eq(u(x, 0.0), u_exact(x, 0.0, npde)),
           Eq(u(-10.0, t), u_exact(-10.0, t, npde)),
           Eq(u(10.0, t), u_exact(10.0, t, npde)),
           Eq(Dx(u(-10.0, t)), du_exact(-10.0, t, npde)),
           Eq(Dx(u(10.0, t)), du_exact(10.0, t, npde))]
    return PDESystem(eq, bcs, [Domain(x, Interval(-10, 10)),
                               Domain(t, Interval(0, 1))], [x, t], [U])


def make_problem(dx=(0.4, 0.1), sizes=(2, 32, 32, 1), *,
                 dtype=torch.float32, device="cuda", init_params=None):
    return discretize(build_system(), PhysicsInformedNN(
        mlp(list(sizes), dtype=dtype), GridTraining(list(dx)),
        derivative="jet", dtype=dtype, device=device,
        init_params=init_params))


def rel_l2(prob, theta: dict) -> float:
    """RMS error over RMS of the exact solution on a 41 x 5 grid."""
    X, T = np.meshgrid(np.linspace(-10, 10, 41), np.linspace(0, 1, 5),
                       indexing="ij")
    with torch.no_grad(), matmul_precision("highest"):
        pred = prob.pinnrep.phi(np.stack([X.ravel(), T.ravel()]),
                                depvar_params(theta))[0]
    pred = pred.double().cpu().numpy().reshape(X.shape)
    want = u_exact(X, T)
    return float(np.sqrt(np.mean((pred - want) ** 2))
                 / np.sqrt(np.mean(want ** 2)))


def run(adam_iters: int = 3000, lbfgs_iters: int = 600, *, dx=(0.4, 0.1),
        sizes=(2, 32, 32, 1), verbose: bool = True, device="cuda") -> dict:
    """Adam(1e-2) in blocks of 25, then L-BFGS in blocks of 10.  Returns
    ``{"rel_l2", "wall_s", "per_stage": [("adam", rel_l2), ("lbfgs",
    rel_l2)], "loss", "stage_s"}``."""
    prob = make_problem(dx, sizes, device=device)
    t0 = time.perf_counter()
    res = solve(prob, adam(1e-2), maxiters=adam_iters, inner_steps=25)
    per_stage = [("adam", rel_l2(prob, res.u))]
    stage_s = [round(time.perf_counter() - t0, 2)]
    ts = time.perf_counter()
    res = solve(prob.with_params(res.u), lbfgs(), maxiters=lbfgs_iters,
                inner_steps=10)
    rel = rel_l2(prob, res.u)
    per_stage.append(("lbfgs", rel))
    stage_s.append(round(time.perf_counter() - ts, 2))
    if verbose:
        print(f"final loss {res.objective:.3e}   relative L2 {rel:.3e}",
              flush=True)
    return {"rel_l2": rel, "wall_s": round(time.perf_counter() - t0, 2),
            "per_stage": per_stage, "loss": res.objective,
            "stage_s": stage_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--adam-iters", type=int, default=3000)
    ap.add_argument("--lbfgs-iters", type=int, default=600)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.adam_iters, args.lbfgs_iters,
              device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
