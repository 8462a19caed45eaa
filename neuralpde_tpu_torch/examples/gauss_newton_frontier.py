"""The accuracy frontier: Gauss-Newton on a hard-constrained separable grid
(`examples/gauss_newton_frontier.py` in the port).

2-D Poisson (Δu = -sin(pi x) sin(pi y)) from scratch with exact Dirichlet
conditions (a `Transformed` boundary factor per axis, no penalty terms), a
separable trial function on a static 33^2 grid (`accuracy.poisson_spinn(33,
24, 24)`) and `solve_gauss_newton` (matrix-free Levenberg-Marquardt, each
CG or LSQR iteration one jvp and one vjp).  Float64 by default; ``--f32``
trains in float32 with LSQR and float64 scalars.  rel L2 on a 101^2 grid.

Run:

    python -m neuralpde_tpu_torch.examples.gauss_newton_frontier [--f32]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from neuralpde_tpu_torch import solve_gauss_newton
from neuralpde_tpu_torch.accuracy import poisson_rel_l2, poisson_spinn


def run(f32: bool = False, *, n: int = 33, width: int = 24,
        maxiters: int = 200, cg_iters: int = 200, verbose: bool = True,
        device="cuda") -> dict:
    """Returns ``{"rel_l2", "wall_s", "loss", "iterations"}``."""
    dtype = torch.float32 if f32 else torch.float64
    prob, net = poisson_spinn(n, width, width, dtype=dtype, device=device)
    kw = dict(solver="lsqr", scalar_dtype=torch.float64) if f32 else {}
    t0 = time.perf_counter()
    res = solve_gauss_newton(prob, maxiters=maxiters, cg_iters=cg_iters,
                             **kw)
    if prob.pinnrep.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rel = poisson_rel_l2(net, res.u)
    if verbose:
        print(f"GN: loss {res.objective:.3e} after {res.iterations} steps "
              f"in {dt:.1f} s\nrelative L2 vs analytic: {rel:.2e}",
              flush=True)
    return {"rel_l2": rel, "wall_s": round(dt, 2), "loss": res.objective,
            "iterations": res.iterations}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.f32, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
