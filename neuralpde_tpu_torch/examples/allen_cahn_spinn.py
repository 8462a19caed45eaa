"""Allen-Cahn with a separable (SPINN) trial function and causal training
(`examples/allen_cahn_spinn.py` in the port).

u_t = 1e-4 u_xx + 5(u - u^3), x in [-1,1] periodic, t in [0,1],
u(x,0) = x^2 cos(pi x).  Per-axis nets with an exactly periodic x-axis
embedding (`accuracy.allen_cahn_net`), a static 256^2 tensor grid, causal
weighting in t with eps continuation 1e2, 1e3, 1e4, 1e5 (75,000 Adam steps
each), IC weight 100 and true float32 matmuls (TF32 off) for training and
evaluation, against the spectral reference
(`accuracy.allen_cahn_ground_truth`).  `neuralpde_tpu_torch.accuracy`
runs bench's reduced three-stage version of this recipe.

Run:

    python -m neuralpde_tpu_torch.examples.allen_cahn_spinn
        [--precision default|highest] [--rank R] [--nodes N] [--iters N]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from neuralpde_tpu_torch import (
    NonAdaptiveLoss, PhysicsInformedNN, SeparableTraining, adam,
    depvar_params, discretize, matmul_precision, solve,
)
from neuralpde_tpu_torch.accuracy import (
    allen_cahn_ground_truth, allen_cahn_net, allen_cahn_system,
)

DEFAULT_STAGES = ((100.0, 1e-3), (1e3, 5e-4), (1e4, 2e-4), (1e5, 1e-4))


def make_problem(net, causal_eps: float, *, nodes: int = 256,
                 precision: str = "highest", device="cuda"):
    """One causal stage on ``nodes`` x ``nodes``, IC weight 100."""
    system = allen_cahn_system()
    strategy = SeparableTraining(dx=[2.0 / (nodes - 1), 1.0 / (nodes - 1)],
                                 causal=system.ivs[1], causal_eps=causal_eps)
    return discretize(system, PhysicsInformedNN(
        net, strategy, dtype=torch.float32, device=device,
        matmul_precision=precision,
        adaptive_loss=NonAdaptiveLoss(bc_loss_weights=[100.0])))


def rel_l2_measure(device="cuda"):
    """``rel_l2(net, theta)`` against the spectral reference on its
    512 x 101 points, evaluated under true float32 matmuls."""
    xg, ts, U = allen_cahn_ground_truth()
    X, T = np.meshgrid(xg, ts, indexing="ij")
    cord = torch.tensor(np.stack([X.ravel(), T.ravel()]),
                        dtype=torch.float32, device=device)
    want = U.T.reshape(-1)

    def rel_l2(net, theta):
        with torch.no_grad(), matmul_precision("highest"):
            got = net.apply(depvar_params(theta), cord)[0]
        got = got.double().cpu().numpy()
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    return rel_l2


def run(rank: int = 256, nodes: int = 256, iters: int = 75000,
        precision: str = "highest", stages=DEFAULT_STAGES,
        verbose: bool = True, *, hidden=(64, 64, 64),
        device="cuda") -> dict:
    """The full eps-continuation recipe.  Returns ``{"rel_l2", "wall_s",
    "per_stage": [(eps, rel_l2), ...], "losses", "stage_s"}``."""
    rel_l2 = rel_l2_measure(device)
    net = allen_cahn_net(rank, hidden)
    theta, per_stage, losses, stage_s = None, [], [], []
    rel = float("nan")
    t0 = time.perf_counter()
    for eps, lr in stages:
        ts = time.perf_counter()
        prob = make_problem(net, eps, nodes=nodes, precision=precision,
                            device=device)
        if theta is not None:
            prob = prob.with_params(theta)
        res = solve(prob, adam(lr), maxiters=iters,
                    inner_steps=min(1000, iters))
        theta = res.u
        rel = rel_l2(net, theta)
        per_stage.append((eps, rel))
        losses.append(res.objective)
        stage_s.append(round(time.perf_counter() - ts, 1))
        if verbose:
            print(f"eps={eps:>7} rank={rank} nodes={nodes} "
                  f"prec={precision}: rel L2 = {rel:.4f}  (loss "
                  f"{res.objective:.3e}, t = {time.perf_counter() - t0:.1f}s)",
                  flush=True)
    return {"rel_l2": rel, "wall_s": round(time.perf_counter() - t0, 1),
            "per_stage": per_stage, "losses": losses, "stage_s": stage_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--precision", default="highest",
                    choices=["default", "highest"])
    ap.add_argument("--rank", type=int, default=256)
    ap.add_argument("--nodes", type=int, default=256)
    ap.add_argument("--iters", type=int, default=75000,
                    help="iters per continuation stage")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(rank=args.rank, nodes=args.nodes, iters=args.iters,
              precision=args.precision, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
