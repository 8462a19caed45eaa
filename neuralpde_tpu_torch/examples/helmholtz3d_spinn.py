"""3-D Helmholtz with a separable PINN (`examples/helmholtz3d_spinn.py` in
the port).

    Δu + k²u = q(x, y, z)   on [0,1]³,   u = 0 on the boundary,
    q = (k² - 3 a²π²) sin(aπx) sin(aπy) sin(aπz)
    analytic solution u* = sin(aπx) sin(aπy) sin(aπz)

The separable trial function assembles the 128³ = 2.1M-point residual grid
from 3 x 128 axis-net evaluations and rank contractions; the Dirichlet
condition holds exactly through a per-axis `Transformed` boundary factor
x(1-x), so there are no boundary losses.  2,000 Adam steps (a timed solve
after a 10-step warm-up); rel L2 on a 64³ grid.

Run:

    python -m neuralpde_tpu_torch.examples.helmholtz3d_spinn [--iters 2000]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from neuralpde_tpu_torch import (
    DepVar, Differential, Domain, Eq, Interval, PDESystem, PhysicsInformedNN,
    SeparableNet, SeparableTraining, Transformed, adam, depvar_params,
    discretize, matmul_precision, mlp, sin, solve, symbols,
)

A = 2           # solution wavenumber (a·π per axis)
K = 1.0         # Helmholtz k
N_GRID = 128    # collocation nodes per axis -> 128^3 ≈ 2.1M points a step
RANK = 64
ITERS = 2000
LR = 2e-3


def _hard(c, out):
    return c * (1 - c) * out


def build_system() -> PDESystem:
    x, y, z = symbols("x y z")
    u = DepVar("u")
    U = u(x, y, z)
    api = A * np.pi
    q = (K ** 2 - 3 * api ** 2) * sin(api * x) * sin(api * y) * sin(api * z)
    eq = Eq((Differential(x) ** 2)(U) + (Differential(y) ** 2)(U)
            + (Differential(z) ** 2)(U) + K ** 2 * U, q)
    # hard-constrained: boundary factor on every axis net, no BC equations
    return PDESystem(eq, [], [Domain(v, Interval(0, 1)) for v in (x, y, z)],
                     [x, y, z], [U])


def make_net(rank: int = RANK, hidden: int = 64, dtype=torch.float32):
    return SeparableNet([Transformed(mlp([1, hidden, hidden, rank],
                                         dtype=dtype), _hard)
                         for _ in range(3)])


def build_problem(n_grid=N_GRID, rank: int = RANK, hidden: int = 64, *,
                  dtype=torch.float32, device="cuda", init_params=None):
    """The problem on ``n_grid`` nodes per axis (an int, or three counts)
    and its `SeparableNet`."""
    counts = [n_grid] * 3 if isinstance(n_grid, int) else list(n_grid)
    net = make_net(rank, hidden, dtype)
    disc = PhysicsInformedNN(
        net, SeparableTraining(dx=[1.0 / (n - 1) for n in counts]),
        dtype=dtype, device=device, init_params=init_params)
    return discretize(build_system(), disc), net


def rel_l2(net, theta: dict, n_eval: int = 64) -> float:
    """rel L2 against the analytic solution on an n_eval³ grid, through
    the factorized form."""
    like = next(iter(theta.values()))
    nodes = torch.linspace(0.0, 1.0, n_eval, dtype=like.dtype,
                           device=like.device)
    with torch.no_grad(), matmul_precision("highest"):
        u_pred = net.grid(depvar_params(theta), [nodes] * 3)
    u_pred = u_pred.double().cpu().numpy()
    g = np.sin(A * np.pi * np.linspace(0.0, 1.0, n_eval))
    u_true = np.einsum("a,b,c->abc", g, g, g)
    return float(np.linalg.norm(u_pred - u_true) / np.linalg.norm(u_true))


def run(iters: int = ITERS, n_grid=N_GRID, rank: int = RANK, *,
        hidden: int = 64, n_eval: int = 64,
        verbose: bool = True, device="cuda") -> dict:
    """A 10-step warm-up solve, then ``iters`` timed Adam steps in blocks
    of 100.  Returns ``{"rel_l2", "wall_s", "loss", "points_per_s"}``;
    ``wall_s`` is the timed solve's (ends in a synchronize on the card)."""
    prob, net = build_problem(n_grid, rank, hidden, device=device)
    if verbose:
        print(f"3-D Helmholtz, {n_grid}^3 collocation points per step, "
              f"rank {rank}", flush=True)
    solve(prob, adam(LR), maxiters=10, inner_steps=10)
    t0 = time.perf_counter()
    res = solve(prob, adam(LR), maxiters=iters, inner_steps=min(100, iters))
    if prob.pinnrep.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    err = rel_l2(net, res.u, n_eval)
    points = np.prod([n_grid] * 3 if isinstance(n_grid, int) else n_grid)
    out = {"rel_l2": err, "wall_s": round(dt, 3), "loss": res.objective,
           "points_per_s": float(points * iters / dt)}
    if verbose:
        print(f"{iters} Adam iters in {dt:.2f} s "
              f"({out['points_per_s'] / 1e9:.2f}B collocation points/sec); "
              f"final loss {res.objective:.3e}, "
              f"relative L2 {err:.2e}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(iters=args.iters, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
