"""Probe of the captured `npde.lbfgs()` step on one CUDA card.

Run from the root of a checkout:

    python3 scripts/probe_lbfgs_capture.py

Three parts, each printing one line (or its traceback):

* timing: the hybrid recipe's L-BFGS stage (w64 `GridTraining(1/127)`, jet,
  float32, TF32 off, from 1,000 Adam steps), 100 steps through `solve` in
  blocks of 50, capture and first step included, with `npde.lbfgs()` and
  with `torch.optim.LBFGS`, twice each, in turns;
* ensemble: `solve_ensemble(n_ensemble=2)` with `npde.lbfgs()` on
  `StochasticTraining(128)`, float64: its graph counts and losses;
* mesh: the float64 grid problem under a one-rank NCCL mesh (a `file://`
  store under `build/`): its graph counts and losses.
"""

import os
import sys
import time
import traceback

import torch

sys.path.insert(0, os.getcwd())

import neuralpde_tpu_torch as npde  # noqa: E402
from neuralpde_tpu_torch.accuracy import poisson_2d_system  # noqa: E402


def problem(dtype, strategy=None):
    torch.manual_seed(0)
    return npde.discretize(poisson_2d_system(), npde.PhysicsInformedNN(
        npde.mlp([2, 64, 64, 1], dtype=dtype),
        strategy or npde.GridTraining(1 / 127), derivative="jet", dtype=dtype,
        device="cuda"))


def timing():
    torch.backends.cuda.matmul.allow_tf32 = False
    prob = problem(torch.float32)
    theta = npde.solve(prob, npde.adam(2e-3), maxiters=1000,
                       inner_steps=100).u
    rules = {"npde.lbfgs()": npde.lbfgs(),
             "torch.optim.LBFGS": lambda ps: torch.optim.LBFGS(
                 list(ps), lr=1.0, max_iter=1, max_eval=16, history_size=10,
                 line_search_fn="strong_wolfe")}
    for name, rule in list(rules.items()) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = npde.solve(prob.with_params(theta), rule, maxiters=100,
                         inner_steps=50)
        torch.cuda.synchronize()
        print(f"[timing] {name}: {10 * (time.perf_counter() - t0):.3f} ms a "
              f"step over 100 steps, capture included; loss "
              f"{res.objective:.4e}; {res.aux.get('cuda_graph')}")


def ensemble():
    res = npde.solve_ensemble(problem(torch.float64,
                                      npde.StochasticTraining(128)),
                              npde.lbfgs(), maxiters=6, inner_steps=3,
                              n_ensemble=2)
    print(f"[ensemble] {res.aux['cuda_graph']}; losses {res.losses.tolist()}")


def mesh():
    from neuralpde_tpu_torch.parallel import distributed, mesh as pm

    store = os.path.abspath(os.path.join("build", "probe_lbfgs_store"))
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    distributed.initialize_distributed("file://" + store, 1, 0)
    try:
        with npde.use_mesh(pm.make_mesh()):
            res = npde.solve(problem(torch.float64), npde.lbfgs(),
                             maxiters=6, inner_steps=3)
        print(f"[mesh] one NCCL rank: {res.aux['cuda_graph']}; losses "
              f"{res.history}")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("probe_lbfgs_capture: needs a CUDA card")
    failed = False
    for part in (timing, ensemble, mesh):
        try:
            part()
        except Exception:
            traceback.print_exc()
            failed = True
    sys.exit(1 if failed else 0)
