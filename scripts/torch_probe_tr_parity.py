"""Trust-region against LSQR Gauss-Newton wall time on the Poisson
Gauss-Newton frontier, on one NVIDIA H100: the twin of
`scripts/probe_tr_parity.py`.

The problem is bench's Gauss-Newton configuration: the hard-constrained
separable net (two ``mlp([1, 24, 24, 24])``, rank 24) on a static 33^2
grid, float32 with true float32 matmuls (``matmul_precision="highest"``,
TF32 off; `accuracy.poisson_spinn(33, 24, 24)`).  Each method first runs a
warm pass of 2 outer iterations (the kernels' build, the library set-up,
the captured inner steps' first capture), then ``maxiters`` outer
iterations of `CG_ITERS` inner ones are timed: Levenberg-Marquardt with
LSQR and float64 scalars, and the Steihaug trust region.

One JSON line a method: ``{"method", "options", "rel_l2", "loss",
"iters", "wall_s", "inner_iterations" (the trust region's total, else
null), "device", "power_limit"}`` (``power_limit`` in watts).  Needs a
CUDA card; without one it raises.

    python3 scripts/torch_probe_tr_parity.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:    # the port, when this file runs as a script
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
import neuralpde_tpu_torch as npde  # noqa: E402
from neuralpde_tpu_torch import accuracy  # noqa: E402

MAXITERS = 200
CG_ITERS = 200
WARM_ITERS = 2
KEYS = ("method", "options", "rel_l2", "loss", "iters", "wall_s",
        "inner_iterations", "device", "power_limit")


def build(*, dtype=torch.float32, device="cuda", init_params=None):
    """The JAX script's ``build``: ``(problem, net)``."""
    bench_torch.require_card(device)
    return accuracy.poisson_spinn(33, 24, 24, dtype=dtype, device=device,
                                  init_params=init_params,
                                  matmul_precision="highest")


def methods() -> list[tuple[str, dict]]:
    """(method, options) in the JAX script's order."""
    return [("lm", {"solver": "lsqr", "scalar_dtype": torch.float64}),
            ("tr", {})]


def run(maxiters: int = MAXITERS, device="cuda") -> list[dict]:
    """Both methods, warm; print and return one line each."""
    bench_torch.require_card(device)
    card = bench_torch.card_fields(device)
    rows = []
    for method, kw in methods():
        prob, net = build(device=device)
        npde.solve_gauss_newton(prob, method=method, maxiters=WARM_ITERS,
                                cg_iters=CG_ITERS, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = npde.solve_gauss_newton(prob, method=method, maxiters=maxiters,
                                      cg_iters=CG_ITERS, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows.append({"method": method,
                     "options": {k: str(v) for k, v in kw.items()},
                     "rel_l2": accuracy.poisson_rel_l2(net, res.u),
                     "loss": res.objective, "iters": res.iterations,
                     "wall_s": wall,
                     "inner_iterations": res.aux.get("inner_iterations"),
                     "device": card["device"],
                     "power_limit": card["power_limit_w"]})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    run()
