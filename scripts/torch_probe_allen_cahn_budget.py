"""The separable Allen-Cahn recipe at reduced iteration budgets, and the
per-iteration cost of its two matmul precisions, on one NVIDIA H100: the
twin of `scripts/probe_allen_cahn_budget.py`.

The recipe is `examples/allen_cahn_spinn.py`'s, built from
`accuracy.allen_cahn_net` (rank 256) and `accuracy.allen_cahn_stage` (a
256^2 static grid, causal in t, IC weight 100, float32): causal eps 1e2,
1e3, 1e4, 1e5 with Adam 1e-3, 5e-4, 2e-4, 1e-4, each stage from the last
one's parameters, ``iters`` steps in blocks of 1000 (half of ``iters`` if
that is less).  The JAX script's "highest" against "default" precisions
are true float32 against TF32 on the card.  One short solve first takes
the process's one-time costs (the kernels' build, the library set-up).
Each stage's first block (the eager step and the capture) trains but is
not timed: ``t`` sums the replayed blocks of the stages so far and
``ms_per_step`` is the stage's replayed step.

One JSON line a (precision, stage): ``{"precision", "tf32",
"iters_per_stage", "eps", "rel_l2", "t", "ms_per_step", "device",
"power_limit"}`` (``power_limit`` in watts; rel L2 against the spectral
reference, `accuracy.allen_cahn_ground_truth`, under true float32).
Needs a CUDA card; without one it raises.

    python3 scripts/torch_probe_allen_cahn_budget.py [ITERS_PER_STAGE]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:    # the port, when this file runs as a script
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
import neuralpde_tpu_torch as npde  # noqa: E402
from neuralpde_tpu_torch import accuracy  # noqa: E402

ITERS = 15_000
STAGES = ((100.0, 1e-3), (1e3, 5e-4), (1e4, 2e-4), (1e5, 1e-4))
PRECISIONS = ("highest", "default")     # float32, TF32
KEYS = ("precision", "tf32", "iters_per_stage", "eps", "rel_l2", "t",
        "ms_per_step", "device", "power_limit")


def make_problem(net, eps: float, precision: str = "highest", *,
                 nodes: int = 256, dtype=torch.float32, device="cuda"):
    """The JAX script's stage: its `discretize` of one causal stage."""
    bench_torch.require_card(device)
    prob, _ = accuracy.allen_cahn_stage(net, eps, nodes=nodes, dtype=dtype,
                                        device=device,
                                        matmul_precision=precision)
    return prob


def rel_l2_measure(device="cuda"):
    """``rel_l2(net, theta)`` against the spectral reference on its 512 x
    101 points, under true float32 matmuls."""
    bench_torch.require_card(device)
    xg, ts, U = accuracy.allen_cahn_ground_truth()
    X, T = np.meshgrid(xg, ts, indexing="ij")
    cord = torch.tensor(np.stack([X.ravel(), T.ravel()]),
                        dtype=torch.float32, device=device)
    want = U.T.reshape(-1)

    def rel_l2(net, theta):
        with torch.no_grad(), npde.matmul_precision("highest"):
            got = net.apply(npde.depvar_params(theta), cord)[0]
        got = got.double().cpu().numpy()
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    return rel_l2


def run_precision(precision: str, iters: int, stages=STAGES,
                  device="cuda") -> list[dict]:
    """The stages at ``precision``: one row a stage."""
    bench_torch.require_card(device)
    card = bench_torch.card_fields(device)
    rel_l2 = rel_l2_measure(device)
    net = accuracy.allen_cahn_net()
    block = min(1000, max(1, iters // 2))
    theta, t, rows = None, 0.0, []
    for eps, lr in stages:
        prob = make_problem(net, eps, precision, device=device)
        if theta is not None:
            prob = prob.with_params(theta)
        stamps = []
        res = npde.solve(prob, npde.adam(lr), maxiters=iters,
                         inner_steps=block,
                         callback=lambda it, loss, aux: stamps.append(
                             (it, time.perf_counter())))
        theta = res.u
        seconds = stamps[-1][1] - stamps[0][1]
        t += seconds
        rows.append({"precision": precision,
                     "tf32": precision == "default", "iters_per_stage": iters,
                     "eps": eps, "rel_l2": rel_l2(net, theta), "t": t,
                     "ms_per_step": 1e3 * seconds / (stamps[-1][0]
                                                     - stamps[0][0]),
                     "device": card["device"],
                     "power_limit": card["power_limit_w"]})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def run(iters: int = ITERS, precisions=PRECISIONS, stages=STAGES,
        device="cuda") -> list[dict]:
    """A short warm-up solve, then every precision in turn."""
    bench_torch.require_card(device)
    prob = make_problem(accuracy.allen_cahn_net(), stages[0][0],
                        device=device)
    npde.solve(prob, npde.adam(1e-3), maxiters=20, inner_steps=10)
    return [row for precision in precisions
            for row in run_precision(precision, iters, stages, device=device)]


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else ITERS)
