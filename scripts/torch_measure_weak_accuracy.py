"""rel L2 at equal wall time of hp-VPINN weak training against strong-form
collocation on one NVIDIA H100: the twin of
`scripts/measure_weak_accuracy_tpu.py`.

Two problems on the same network (``mlp([2, 64, 64, 1])``, jet, float32
with TF32 off), at matched residual nodes:

* smooth 2-D Poisson, u* = sin(pi x) sin(pi y): 16 elements x 12
  quadrature nodes = 192 an axis, ``n_test=8``;
* front 2-D Poisson, u* = tanh(60 (x - 0.7)) sin(pi y): 8 x 12 = 96 an
  axis (`accuracy.front_system`).

Configurations: strong `GridTraining` on the weak node grid, `WeakTraining`
at ibp 0, 1 and 2, and on the front problem ibp 1 with three rounds of
`refine_weak` (hp) under the same total budget.

Accounting: training runs in blocks of 100 Adam steps through `solve`'s
captured graph.  The first block of each `solve` (the eager step and the
capture) is not timed, for every configuration alike, where the JAX
script excluded compilation; its steps count.  The budget clock covers
every later block, the host's reads between blocks and, for the adaptive
row, the `refine_weak` scoring and the re-lowering (`discretize`) between
rounds.  A `solve` stops at the first block that ends past its budget.

One JSON line a (problem, configuration, seed): ``{"rel_l2", "steps",
"wall_s", "final_loss", "problem", "config", "seed", "device",
"power_limit"}`` (``power_limit`` in watts), then a line with the median
rel L2 of each configuration.  Needs a CUDA card; without one it raises.

    python3 scripts/torch_measure_weak_accuracy.py [--budget 20] [--seeds 3]
"""

from __future__ import annotations

import argparse
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

# matched residual nodes a problem: weak E * q an axis == the grid's
GEOM = {"smooth": dict(E=16, K=8, q=12), "front": dict(E=8, K=8, q=12)}
CHUNK = 100
ROUNDS = 3
KEYS = ("rel_l2", "steps", "wall_s", "final_loss", "problem", "config",
        "seed", "device", "power_limit")


def smooth_system():
    """``Lap u = -2 pi^2 sin(pi x) sin(pi y)``, ``u = 0`` on the sides."""
    x, y = npde.symbols("x y")
    u = npde.DepVar("u")
    eq = npde.Eq((npde.Differential(x) ** 2)(u(x, y))
                 + (npde.Differential(y) ** 2)(u(x, y)),
                 -2 * np.pi ** 2 * npde.sin(np.pi * x) * npde.sin(np.pi * y))
    bcs = [npde.Eq(u(0.0, y), 0.0), npde.Eq(u(1.0, y), 0.0),
           npde.Eq(u(x, 0.0), 0.0), npde.Eq(u(x, 1.0), 0.0)]
    return npde.PDESystem(eq, bcs, [npde.Domain(x, npde.Interval(0, 1)),
                                    npde.Domain(y, npde.Interval(0, 1))],
                          [x, y], [u(x, y)])


def exact(kind: str, X, Y):
    if kind == "smooth":
        return np.sin(np.pi * X) * np.sin(np.pi * Y)
    S, X0 = accuracy.FRONT
    return np.tanh(S * (X - X0)) * np.sin(np.pi * Y)


def build_problem(kind: str, strategy, seed: int, *, dtype=torch.float32,
                  device="cuda", init_params=None):
    """The JAX script's ``build_problem``: ``(system, discretization,
    problem)`` of ``kind`` ("smooth" or "front") on ``strategy``."""
    bench_torch.require_card(device)
    system = smooth_system() if kind == "smooth" else accuracy.front_system()
    disc = npde.PhysicsInformedNN(npde.mlp([2, 64, 64, 1], dtype=dtype),
                                  strategy, derivative="jet", seed=seed,
                                  dtype=dtype, device=device,
                                  init_params=init_params)
    return system, disc, npde.discretize(system, disc)


def rel_l2(kind: str, prob, theta) -> float:
    """rel L2 on a 201^2 grid of the unit square."""
    xs = np.linspace(0, 1, 201)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    with torch.no_grad(), npde.matmul_precision("highest"):
        got = prob.pinnrep.phi(np.stack([X.ravel(), Y.ravel()]),
                               npde.depvar_params(theta))[0]
    got = got.double().cpu().numpy()
    want = exact(kind, X, Y).ravel()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def timed_train(prob, budget: float, lr: float, seed: int):
    """Adam(lr) in blocks of `CHUNK` until the blocks after the first
    have taken ``budget`` seconds: ``(theta, steps, wall, final loss)``."""
    stamps = []

    def callback(it, loss, aux):
        stamps.append(time.perf_counter())
        return stamps[-1] - stamps[0] >= budget

    res = npde.solve(prob, npde.adam(lr), maxiters=10 ** 9,
                     inner_steps=CHUNK, seed=seed, callback=callback)
    return res.u, res.iterations, stamps[-1] - stamps[0], res.objective


def run_fixed(kind, factory, budget, lr, seed, device="cuda") -> dict:
    _, _, prob = build_problem(kind, factory(), seed, device=device)
    theta, steps, wall, loss = timed_train(prob, budget, lr, seed)
    return {"rel_l2": rel_l2(kind, prob, theta), "steps": steps,
            "wall_s": wall, "final_loss": loss}


def run_adaptive(kind, factory, budget, lr, seed, device="cuda") -> dict:
    """`refine_weak` (hp) between `ROUNDS` rounds of ``budget / ROUNDS``
    seconds each, the refinement and re-lowering charged to the budget."""
    _, _, prob = build_problem(kind, factory(), seed, device=device)
    steps, wall = 0, 0.0
    for r in range(ROUNDS):
        theta, n, seconds, loss = timed_train(prob, budget / ROUNDS, lr, seed)
        steps += n
        wall += seconds
        if r == ROUNDS - 1:
            break
        t0 = time.perf_counter()
        strategy = npde.refine_weak(prob, theta, frac=0.3, mode="hp")
        _, _, prob = build_problem(kind, strategy, seed, device=device)
        prob = prob.with_params(theta)
        wall += time.perf_counter() - t0
    return {"rel_l2": rel_l2(kind, prob, theta), "steps": steps,
            "wall_s": wall, "final_loss": loss}


def configs(kind: str) -> list:
    """(label, strategy factory, runner) of each configuration."""
    g = GEOM[kind]
    n = g["E"] * g["q"]

    def weak(ibp):
        return lambda: npde.WeakTraining(elements=g["E"], n_test=g["K"],
                                         quad=g["q"], ibp=ibp)

    out = [("strong", lambda: npde.GridTraining(1.0 / (n - 1)), run_fixed)]
    out += [(f"weak ibp={ibp}", weak(ibp), run_fixed) for ibp in (0, 1, 2)]
    if kind == "front":
        out.append((f"weak ibp=1 + hp-adaptive ({ROUNDS} rounds)", weak(1),
                    run_adaptive))
    return out


def run(budget: float = 20.0, seeds: int = 3, lr: float = 2e-3,
        problems=("smooth", "front"), labels=None, out: str | None = None,
        device="cuda") -> list[dict]:
    """Every (problem, configuration, seed) whose label is in ``labels``
    (all by default); print and return one line each."""
    bench_torch.require_card(device)
    card = bench_torch.card_fields(device)
    rows = []
    for kind in problems:
        for label, factory, runner in configs(kind):
            if labels is not None and label not in labels:
                continue
            rels = []
            for seed in range(seeds):
                row = {**runner(kind, factory, budget, lr, seed,
                                device=device),
                       "problem": kind, "config": label, "seed": seed,
                       "device": card["device"],
                       "power_limit": card["power_limit_w"]}
                print(json.dumps(row), flush=True)
                rows.append(row)
                rels.append(row["rel_l2"])
            print(f"## {kind:6s} {label:34s} median rel L2 "
                  f"{float(np.median(rels)):.4g}  (n={len(rels)})",
                  flush=True)
    if out:
        with open(out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=float, default=20.0,
                    help="timed wall-clock seconds a configuration")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default=None, help="write the JSON rows here too")
    args = ap.parse_args(argv)
    run(args.budget, args.seeds, args.lr, out=args.out)


if __name__ == "__main__":
    main()
