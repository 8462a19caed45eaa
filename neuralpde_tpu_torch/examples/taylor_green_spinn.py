"""Taylor-Green vortex with a separable PINN (`examples/taylor_green_spinn.py`
in the port).

Unsteady incompressible Navier-Stokes on [0, 2 pi]^2 x [0, 1] (nu = 0.1,
three coupled equations, double spatial periodicity, a pressure gauge
pin): three separable fields u(x,y,t) = sum_r f_r(x) g_r(y) h_r(t) whose x
and y axis nets start with a `PeriodicEmbedding`, so every step evaluates
the residual on the full 128^3 = 2.1M-point tensor grid.  Two causal
stages (eps 3 then 30, 20,000 Adam steps each); rel L2 of (u, v) at t in
0.25, 0.5, 1.0 on a 64^2 grid against the analytic field.

Run:

    python -m neuralpde_tpu_torch.examples.taylor_green_spinn [--nodes 128]
        [--rank 64] [--iters 20000] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import neuralpde_tpu_torch as npde
from neuralpde_tpu_torch import (
    Chain, Dense, DepVar, Differential, Domain, Eq, Interval,
    NonAdaptiveLoss, PDESystem, PeriodicEmbedding, PhysicsInformedNN,
    SeparableNet, SeparableTraining, adam, depvar_params, discretize,
    matmul_precision, mlp, solve, symbols,
)
from neuralpde_tpu_torch.nn import tanh

NU = 0.1
PI2 = 2 * np.pi
RANK = 64
STAGES = ((3.0, 1e-3), (30.0, 5e-4))          # (causal eps, lr)
BC_WEIGHTS = [100.0, 100.0, 100.0, 10.0]
EVAL_TIMES = (0.25, 0.5, 1.0)


def build_system() -> PDESystem:
    x, y, t = symbols("x y t")
    u, v, p = DepVar("u"), DepVar("v"), DepVar("p")
    Dt, Dx, Dy = Differential(t), Differential(x), Differential(y)
    Dxx, Dyy = Dx ** 2, Dy ** 2
    U, V, P = u(x, y, t), v(x, y, t), p(x, y, t)
    eqs = [
        Eq(Dt(U) + U * Dx(U) + V * Dy(U) + Dx(P), NU * (Dxx(U) + Dyy(U))),
        Eq(Dt(V) + U * Dx(V) + V * Dy(V) + Dy(P), NU * (Dxx(V) + Dyy(V))),
        Eq(Dx(U) + Dy(V), 0.0),
    ]
    bcs = [
        Eq(u(x, y, 0.0), -npde.cos(x) * npde.sin(y)),
        Eq(v(x, y, 0.0), npde.sin(x) * npde.cos(y)),
        Eq(p(x, y, 0.0), -0.25 * (npde.cos(2.0 * x) + npde.cos(2.0 * y))),
        Eq(p(0.0, 0.0, t), -0.5 * npde.exp(-4.0 * NU * t)),   # gauge pin
    ]
    domains = [Domain(x, Interval(0, PI2)), Domain(y, Interval(0, PI2)),
               Domain(t, Interval(0, 1))]
    return PDESystem(eqs, bcs, domains, [x, y, t], [U, V, P])


def axis_net(periodic: bool, rank: int = RANK, hidden: int = 64,
             dtype=torch.float32):
    if periodic:
        return Chain(PeriodicEmbedding(1, axis=0, period=PI2, n_modes=6),
                     Dense(12, hidden, tanh, dtype=dtype),
                     Dense(hidden, hidden, tanh, dtype=dtype),
                     Dense(hidden, rank, dtype=dtype))
    return mlp([1, hidden, hidden, rank], dtype=dtype)


def make_net(rank: int = RANK, hidden: int = 64, dtype=torch.float32):
    return SeparableNet([axis_net(True, rank, hidden, dtype),
                         axis_net(True, rank, hidden, dtype),
                         axis_net(False, rank, hidden, dtype)])


def make_nets(rank: int = RANK, hidden: int = 64, dtype=torch.float32):
    """One separable net per field (u, v, p)."""
    return [make_net(rank, hidden, dtype) for _ in range(3)]


def make_problem(nets, causal_eps: float, *, nodes=128, dtype=torch.float32,
                 device="cuda", init_params=None):
    """One causal stage on the static grid of ``nodes`` per axis (an int,
    or counts for x, y, t)."""
    counts = [nodes] * 3 if isinstance(nodes, int) else list(nodes)
    system = build_system()
    strategy = SeparableTraining(
        dx=[PI2 / (counts[0] - 1), PI2 / (counts[1] - 1),
            1.0 / (counts[2] - 1)],
        causal=system.ivs[2], causal_eps=causal_eps)
    return discretize(system, PhysicsInformedNN(
        nets, strategy, dtype=dtype, device=device, init_params=init_params,
        adaptive_loss=NonAdaptiveLoss(bc_loss_weights=BC_WEIGHTS)))


def rel_l2_uv(nets, theta: dict, n_eval: int = 64) -> float:
    """Mean over t in 0.25, 0.5, 1.0 of the rel L2 of (u, v) on an
    n_eval^2 grid of [0, 2 pi]^2 against the analytic field."""
    xs = np.linspace(0, PI2, n_eval)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    like = next(iter(theta.values()))
    nx = torch.tensor(xs, dtype=like.dtype, device=like.device)
    rels = []
    for tv in EVAL_TIMES:
        dec = np.exp(-2 * NU * tv)
        ua = -np.cos(X) * np.sin(Y) * dec
        va = np.sin(X) * np.cos(Y) * dec
        nt = torch.tensor([tv], dtype=like.dtype, device=like.device)
        with torch.no_grad(), matmul_precision("highest"):
            up, vp = (nets[i].grid(depvar_params(theta, name), [nx, nx, nt])
                      [:, :, 0].double().cpu().numpy()
                      for i, name in enumerate("uv"))
        rels.append(np.sqrt(
            (np.linalg.norm(up - ua) ** 2 + np.linalg.norm(vp - va) ** 2)
            / (np.linalg.norm(ua) ** 2 + np.linalg.norm(va) ** 2)))
    return float(np.mean(rels))


def run(nodes=128, rank: int = RANK, iters: int = 20000, stages=STAGES, *,
        hidden: int = 64, n_eval: int = 64,
        verbose: bool = True, device="cuda") -> dict:
    """Both causal stages, each from the last one's parameters.  Returns
    ``{"rel_l2", "wall_s", "per_stage": [(eps, rel_l2), ...], "losses"}``."""
    nets = make_nets(rank, hidden)
    theta, per_stage, losses = None, [], []
    t0 = time.perf_counter()
    for eps, lr in stages:
        prob = make_problem(nets, eps, nodes=nodes, device=device)
        if theta is not None:
            prob = prob.with_params(theta)
        res = solve(prob, adam(lr), maxiters=iters,
                    inner_steps=min(1000, iters))
        theta = res.u
        rel = rel_l2_uv(nets, theta, n_eval)
        per_stage.append((eps, rel))
        losses.append(res.objective)
        if verbose:
            print(f"eps={eps}: mean rel L2(u,v) = {rel:.4f} (loss "
                  f"{res.objective:.3e}, "
                  f"t = {time.perf_counter() - t0:.1f} s)", flush=True)
    return {"rel_l2": per_stage[-1][1],
            "wall_s": round(time.perf_counter() - t0, 1),
            "per_stage": per_stage, "losses": losses}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=128)
    ap.add_argument("--rank", type=int, default=RANK)
    ap.add_argument("--iters", type=int, default=20000,
                    help="iters per causal stage")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(nodes=args.nodes, rank=args.rank, iters=args.iters,
              device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
