"""FBPINN at its paper's scale (`examples/fbpinn_multiscale.py` in the
port): the 50-period 1-D multi-scale ODE and the 2-D multi-scale Laplace
benchmark, each beside an equal-budget single MLP.

1. ``du/dx = cos(x) + 25 cos(25 x)``, ``u(0) = 0`` on [-2 pi, 2 pi]
   through the hard-constraint ansatz ``u = tanh(25 x) * NN``
   (`accuracy.two_scale_ode`): an FBPINN of 50 subdomains, an MLP [1, 64,
   64, 64, 1] at the same step budget and at the FBPINN's wall time, and a
   random-Fourier-feature MLP.
2. ``-Lap u = f`` on the unit square with ``u = (1/L) sum_l sin(2^l pi x)
   sin(2^l pi y)`` under ``u = 16 x(1-x) y(1-y) * NN``
   (`accuracy.multiscale_laplace`): a multilevel FBPINN of levels 1, 2,
   ..., 2^L, a flat one of 2^L x 2^L subdomains, and an MLP [2, 128, 128,
   128, 1] at the same step budget and at the multilevel net's wall time.

Run:

    python -m neuralpde_tpu_torch.examples.fbpinn_multiscale
        [--part ode|laplace|laplace5|all] [--iters N] [--quick]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from neuralpde_tpu_torch import (
    FBPINN, StochasticTraining, adam, mlp, solve,
)
from neuralpde_tpu_torch.accuracy import (
    multiscale_laplace, multiscale_laplace_rel_l2, two_scale_ode,
    two_scale_rel_l2,
)


def n_params(theta: dict) -> int:
    return sum(v.numel() for v in theta.values())


def run_row(name, prob, rel_l2, *, iters: int, lr: float = 1e-3,
            inner: int = 500, verbose: bool = True) -> dict:
    t0 = time.perf_counter()
    res = solve(prob, adam(lr), maxiters=iters, inner_steps=min(inner, iters))
    if prob.pinnrep.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rel = rel_l2(prob, res.u)
    row = dict(name=name, params=n_params(res.u), iters=iters, wall=wall,
               rel_l2=rel)
    if verbose:
        print(f"  {name:34s}  params={row['params']:7d}  iters={iters:6d}  "
              f"wall={wall:8.1f} s  rel L2={rel:.4f}", flush=True)
    return row


def equal_wall_iters(row_ref, row_cheap, inner: int = 500,
                     cap: int = 20) -> int:
    """Iteration count giving the cheap model about the reference row's
    wall time (rounded to ``inner``, capped at ``cap`` x its budget)."""
    rate = row_cheap["iters"] / max(row_cheap["wall"], 1e-9)
    its = int(rate * row_ref["wall"] / inner) * inner
    return max(inner, min(its, cap * row_cheap["iters"]))


def part_ode(iters: int, *, subdivisions: int = 50, width: int = 64,
             inner: int = 500, verbose: bool = True, device="cuda") -> list:
    """The 50-period two-scale ODE: FBPINN, MLP, MLP at equal wall, RFF
    MLP."""
    def row(name, net, its):
        return run_row(name, two_scale_ode(net, device=device),
                       two_scale_rel_l2, iters=its, inner=inner,
                       verbose=verbose)

    fb = row(f"FBPINN {subdivisions} subdomains",
             FBPINN([(-2 * torch.pi, 2 * torch.pi)],
                    subdivisions=subdivisions, hidden=(16,)), iters)
    sizes = [1, width, width, width, 1]
    plain = row(f"single MLP {sizes}", mlp(sizes), iters)
    return [fb, plain,
            row("single MLP, equal WALL", mlp(sizes),
                equal_wall_iters(fb, plain, inner)),
            row("RFF MLP m=64 sigma=10",
                mlp([1, width, width, 1], fourier_features=64,
                    fourier_sigma=10.0), iters)]


def part_laplace(iters: int, L: int = 4, *, dx: float = 1 / 128,
                 width: int = 128, inner: int = 500, verbose: bool = True,
                 device="cuda") -> list:
    """The multi-scale Laplace problem: multilevel and flat FBPINNs, MLP,
    MLP at equal wall, on the grid of spacing ``dx``; L = 5 trains on
    stochastic batches of 16,384 instead."""
    strategy = None if L <= 4 else StochasticTraining(16384, bcs_points=64)

    def row(name, net, its):
        return run_row(
            name, multiscale_laplace(L, dx=dx, device=device, net=net,
                                     strategy=strategy),
            lambda prob, th: multiscale_laplace_rel_l2(prob, th, L),
            iters=its, inner=inner, verbose=verbose)

    finest = 2 ** L
    levels = [2 ** l for l in range(L + 1)]
    box = [(0, 1), (0, 1)]
    ml = row(f"multilevel FBPINN {levels}",
             FBPINN(box, levels=levels, hidden=(16,)), iters)
    flat = row(f"flat FBPINN {finest}x{finest}",
               FBPINN(box, subdivisions=finest, hidden=(16,)), iters)
    sizes = [2, width, width, width, 1]
    plain = row(f"single MLP {sizes}", mlp(sizes), iters)
    return [ml, flat, plain,
            row("single MLP, equal WALL", mlp(sizes),
                equal_wall_iters(ml, plain, inner))]


def run(part: str = "all", iters: int = 30000, *, verbose: bool = True,
        device="cuda", **kw) -> dict:
    """``{"rel_l2" (the first FBPINN row's), "wall_s", "rows": {part:
    [row, ...]}}``; ``kw`` goes to the parts (sizes for a short run)."""
    t0 = time.perf_counter()
    rows = {}
    if part in ("ode", "all"):
        rows["ode"] = part_ode(iters, verbose=verbose, device=device,
                               **kw.get("ode", {}))
    if part in ("laplace", "all"):
        rows["laplace"] = part_laplace(iters, verbose=verbose, device=device,
                                       **kw.get("laplace", {}))
    if part == "laplace5":
        rows["laplace5"] = part_laplace(iters, 5, verbose=verbose,
                                        device=device,
                                        **kw.get("laplace", {}))
    first = next(iter(rows.values()))[0]
    return {"rel_l2": first["rel_l2"],
            "wall_s": round(time.perf_counter() - t0, 1), "rows": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", default="all",
                    choices=["ode", "laplace", "laplace5", "all"])
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--quick", action="store_true",
                    help="reduced budget smoke run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.part, 600 if args.quick else args.iters,
              device=args.device)
    print(json.dumps(out["rows"]))
    return out


if __name__ == "__main__":
    main()
