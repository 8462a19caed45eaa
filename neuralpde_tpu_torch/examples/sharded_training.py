"""Data-parallel sharded PINN training over every rank of a process group
(`examples/sharded_training.py` in the port).

One process drives one card.  Under ``torchrun`` each process joins the
NCCL group from torchrun's environment; run alone, it makes a group of one
(a file store in a temporary directory).  2-D Poisson
(`accuracy.poisson_2d_system`) with ``mlp([2, 32, 32, 1])`` on
`StochasticTraining(1024 n, bcs_points=128 n)` over the n ranks of
``make_mesh()``: every rank draws the global batch, keeps its slice, and
the step sums the gradients (one all-reduce, captured in the step's CUDA
graph).  With 4 ranks or more (an even count), the same problem at width
64 on a (data, model) mesh whose layers are tensor-parallel over 2 ranks.
Error: rel L2 on a 21^2 grid against the exact solution.

Run:

    torchrun --nproc-per-node=4 -m \
        neuralpde_tpu_torch.examples.sharded_training
    python -m neuralpde_tpu_torch.examples.sharded_training [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch.distributed as dist

from neuralpde_tpu_torch import (
    PhysicsInformedNN, StochasticTraining, adam, discretize, make_mesh,
    make_mesh_2d, mlp, replicate_params, shard_params_tp, solve, use_mesh,
)
from neuralpde_tpu_torch.accuracy import poisson_2d_rel_l2, poisson_2d_system
from neuralpde_tpu_torch.parallel.distributed import initialize_distributed


def run(iters: int = 2000, tp_iters: int = 500, *, points: int = 1024,
        verbose: bool = True, device=None) -> dict:
    """Train under the mesh of the initialized process group.  Returns
    ``{"rel_l2", "wall_s", "loss", "ranks"}`` and, with a (data, model)
    mesh, ``"tp_loss"``."""
    mesh = make_mesh(device=device)
    n = mesh.shape["data"]
    say = verbose and dist.get_rank() == 0
    if say:
        print(f"training over {n} device(s)", flush=True)
    system = poisson_2d_system()
    t0 = time.perf_counter()
    with use_mesh(mesh):
        disc = PhysicsInformedNN(
            mlp([2, 32, 32, 1]),
            StochasticTraining(points * n, bcs_points=points // 8 * n),
            device=mesh.device)
        prob = discretize(system, disc)
        theta = replicate_params(prob.init_params, mesh)
        res = solve(prob.with_params(theta), adam(2e-2), maxiters=iters,
                    inner_steps=min(50, iters))
    wall = time.perf_counter() - t0
    out = {"rel_l2": poisson_2d_rel_l2(disc.phi, res.u),
           "wall_s": round(wall, 2), "loss": res.objective, "ranks": n}
    if say:
        print(f"final loss {res.objective:.3e}; rel L2 {out['rel_l2']:.4e}",
              flush=True)
    if n >= 4 and n % 2 == 0:
        mesh2 = make_mesh_2d(n // 2, 2, device=device)
        with use_mesh(mesh2):
            prob2 = discretize(system, PhysicsInformedNN(
                mlp([2, 64, 64, 1]),
                StochasticTraining(points // 2 * n,
                                   bcs_points=points // 16 * n),
                device=mesh2.device))
            local, _ = shard_params_tp(prob2.init_params, mesh2)
            res2 = solve(prob2.with_params(local), adam(2e-2),
                         maxiters=tp_iters, inner_steps=min(50, tp_iters))
        out["tp_loss"] = res2.objective
        if say:
            print(f"dp+tp final loss {res2.objective:.3e}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--device", default=None,
                    help="this rank's device (default cuda:LOCAL_RANK)")
    args = ap.parse_args(argv)
    own = not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        if own and "WORLD_SIZE" in os.environ:
            initialize_distributed(device=args.device)
        elif own:
            initialize_distributed(f"file://{tmp}/store", 1, 0,
                                   device=args.device)
        try:
            out = run(args.iters, device=args.device)
            print(json.dumps(out))
            return out
        finally:
            if own:
                dist.destroy_process_group()


if __name__ == "__main__":
    main()
