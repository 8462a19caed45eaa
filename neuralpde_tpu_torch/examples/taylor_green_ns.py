"""Taylor-Green vortex, unsteady incompressible Navier-Stokes with a dense
PINN (`examples/taylor_green_ns.py` in the port).

    u_t + u u_x + v u_y + p_x = nu (u_xx + u_yy)
    v_t + u v_x + v v_y + p_y = nu (v_xx + v_yy)
    u_x + v_y = 0                       on [0,2pi]^2 x [0,1], periodic

Three networks (u, v, p), each exactly periodic in x and y through two
chained `PeriodicEmbedding`s (the second on the 14-wide output of the
first) in front of ``mlp([25, 128, 128, 128, 1])``; `CausalTraining(8192,
t, bcs_points=1024, n_slabs=16)` with eps 1 then 10 (20,000 Adam steps
each), Taylor-mode derivatives (``tanh_jet2`` at width 128 on the card)
and a pressure gauge pin.  rel L2 of (u, v) at t in 0.25, 0.5, 1.0 on a
32^2 grid against the analytic field.

Run:

    python -m neuralpde_tpu_torch.examples.taylor_green_ns [--iters 20000]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from neuralpde_tpu_torch import (
    CausalTraining, Chain, NonAdaptiveLoss, PeriodicEmbedding,
    PhysicsInformedNN, adam, depvar_params, discretize, matmul_precision,
    mlp, solve,
)
from neuralpde_tpu_torch.examples.taylor_green_spinn import (
    NU, PI2, build_system,
)

STAGES = ((1.0, 1e-3), (10.0, 5e-4))           # (causal eps, lr)
BC_WEIGHTS = [100.0, 100.0, 100.0, 1.0]


def make_net(hidden: int = 128, depth: int = 3, dtype=torch.float32):
    pe_x = PeriodicEmbedding(3, axis=0, period=PI2, n_modes=6)   # [y,t,12]
    pe_y = PeriodicEmbedding(14, axis=0, period=PI2, n_modes=6)  # [t,12,12]
    return Chain(pe_x, pe_y,
                 *mlp([25, *([hidden] * depth), 1], dtype=dtype).layers)


def make_problem(causal_eps: float, *, points: int = 8192,
                 bcs_points: int = 1024, n_slabs: int = 16,
                 hidden: int = 128, dtype=torch.float32, device="cuda",
                 init_params=None):
    """One causal stage; returns the problem and its strategy."""
    system = build_system()
    strategy = CausalTraining(points, system.ivs[2], bcs_points=bcs_points,
                              n_slabs=n_slabs, causal_eps=causal_eps)
    prob = discretize(system, PhysicsInformedNN(
        [make_net(hidden, dtype=dtype) for _ in range(3)], strategy,
        derivative="jet", dtype=dtype, device=device,
        init_params=init_params,
        adaptive_loss=NonAdaptiveLoss(bc_loss_weights=BC_WEIGHTS)))
    return prob, strategy


def eval_points():
    """The 32^2 x 3 evaluation points (periodic grid without its wrap
    node, t in 0.25, 0.5, 1.0) and the analytic (u, v) there."""
    gs = np.linspace(0, PI2, 33)[:-1]
    X, Y, T = np.meshgrid(gs, gs, np.array([0.25, 0.5, 1.0]), indexing="ij")
    cord = np.stack([X.ravel(), Y.ravel(), T.ravel()])
    decay = np.exp(-2 * NU * cord[2])
    return cord, (-np.cos(cord[0]) * np.sin(cord[1]) * decay,
                  np.sin(cord[0]) * np.cos(cord[1]) * decay)


def rel_l2_uv(prob, theta: dict) -> float:
    cord, (u_true, v_true) = eval_points()
    phi = prob.pinnrep.phi
    with torch.no_grad(), matmul_precision("highest"):
        pu, pv = (phi[i](cord, depvar_params(theta, name))[0]
                  .double().cpu().numpy() for i, name in enumerate("uv"))
    return float(np.linalg.norm(np.concatenate([pu - u_true, pv - v_true]))
                 / np.linalg.norm(np.concatenate([u_true, v_true])))


def run(iters: int = 20000, stages=STAGES, *, points: int = 8192,
        bcs_points: int = 1024, n_slabs: int = 16, hidden: int = 128,
        verbose: bool = True,
        device="cuda") -> dict:
    """Both causal stages, each from the last one's parameters.  Returns
    ``{"rel_l2", "wall_s", "per_stage": [(eps, rel_l2), ...], "losses"}``."""
    theta, per_stage, losses = None, [], []
    t0 = time.perf_counter()
    for eps, lr in stages:
        prob, _ = make_problem(eps, points=points, bcs_points=bcs_points,
                               n_slabs=n_slabs, hidden=hidden, device=device)
        if theta is not None:
            prob = prob.with_params(theta)
        res = solve(prob, adam(lr), maxiters=iters,
                    inner_steps=min(1000, iters))
        theta = res.u
        rel = rel_l2_uv(prob, theta)
        per_stage.append((eps, rel))
        losses.append(res.objective)
        if verbose:
            print(json.dumps({"eps": eps, "rel_l2_uv": round(rel, 5),
                              "loss": res.objective,
                              "t": round(time.perf_counter() - t0, 1)}),
                  flush=True)
    return {"rel_l2": per_stage[-1][1],
            "wall_s": round(time.perf_counter() - t0, 1),
            "per_stage": per_stage, "losses": losses}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20000,
                    help="iters per causal stage")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(iters=args.iters, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
