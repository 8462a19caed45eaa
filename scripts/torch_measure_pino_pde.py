"""Wall time and throughput of the PINOPDE operator families on one NVIDIA
H100: the twin of `scripts/measure_pino_pde_tpu.py`.

Three families, each trained by `solve_pino_pde` through its captured
graph (Adam 3e-3, float32 with TF32 off):

* the heat family u_t = nu u_xx (`accuracy.heat_family_system`), FNO2D
  w16 m6 d2, a 17^2 grid, 10 values of nu in [0.05, 0.5]: 800 steps in
  blocks of 25, then rel L2 against exp(-nu pi^2 t) sin(pi x) on 33^2 and
  7 values of nu (`accuracy.heat_family_rel_l2`);
* the 2-D heat family (`heat2d_system`), FNO3D w12 m5 d2, 9^3 x 6: 400
  steps;
* the serving-scale probe: the heat family on 65^2 x 256: 100 steps.

Timing: ``first_chunk_s`` is a `solve_pino_pde` of one block (the eager
step, the capture, the replays); ``train_s`` the family's whole solve,
its capture included; ``per_step_ms`` the median replayed block of that
solve over its steps (the JAX script's median of five warm chunks), and
``family_points_per_sec`` the grid points times the family members over
it.

One JSON line a family: ``{"family", "first_chunk_s", "iters",
"train_s", "per_step_ms", "family_points_per_sec", "rel_l2" (null where
the JAX script prints none), "device", "power_limit"}`` (``power_limit``
in watts).  Needs a CUDA card; without one it raises.

    python3 scripts/torch_measure_pino_pde.py
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:    # the port, when this file runs as a script
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
import neuralpde_tpu_torch as npde  # noqa: E402
from neuralpde_tpu_torch import accuracy  # noqa: E402

KEYS = ("family", "first_chunk_s", "iters", "train_s", "per_step_ms",
        "family_points_per_sec", "rel_l2", "device", "power_limit")


def heat2d_system():
    """u_t = nu (u_xx + u_yy) on [0, 1]^3 over nu, u(x, y, 0) = sin(pi x)
    sin(pi y), zero on the four sides."""
    x, y, t = npde.symbols("x y t")
    nu, u = npde.parameters("nu"), npde.DepVar("u")
    U = u(x, y, t)
    Dxx, Dyy = npde.Differential(x) ** 2, npde.Differential(y) ** 2
    eq = npde.Eq(npde.Differential(t)(U), nu * (Dxx(U) + Dyy(U)))
    bcs = [npde.Eq(u(x, y, 0.0),
                   npde.sin(np.pi * x) * npde.sin(np.pi * y)),
           npde.Eq(u(0.0, y, t), 0.0), npde.Eq(u(1.0, y, t), 0.0),
           npde.Eq(u(x, 0.0, t), 0.0), npde.Eq(u(x, 1.0, t), 0.0)]
    return npde.PDESystem(eq, bcs, [npde.Domain(x, npde.Interval(0.0, 1.0)),
                                    npde.Domain(y, npde.Interval(0.0, 1.0)),
                                    npde.Domain(t, npde.Interval(0.0, 1.0))],
                          ivs=[x, y, t], dvs=[U], ps=[nu])


def families() -> list[tuple]:
    """(name, system, alg, steps, block, grid points, members, accuracy)
    of each family, as the JAX script's ``main`` builds them."""
    heat = accuracy.heat_family_system()
    ps = np.linspace(0.1, 0.45, 7)

    def fno2d(members, dx):
        return npde.PINOPDE(chain=npde.FNO2D(1, width=16, modes=6, depth=2),
                            opt=npde.adam(3e-3), bounds=[(0.05, 0.5)],
                            number_of_parameters=members,
                            strategy=npde.GridTraining(dx))

    return [
        ("heat 17^2 x10 (PERF accuracy budget)", heat, fno2d(10, 1 / 16),
         800, 25, 17 * 17, 10,
         lambda sol: accuracy.heat_family_rel_l2(sol, ps)),
        ("2-D heat 9^3 x6 (FNO3D)", heat2d_system(),
         npde.PINOPDE(chain=npde.FNO3D(1, width=12, modes=5, depth=2),
                      opt=npde.adam(3e-3), bounds=[(0.05, 0.3)],
                      number_of_parameters=6,
                      strategy=npde.GridTraining(1 / 8)),
         400, 25, 9 ** 3, 6, None),
        ("heat 65^2 x256 (serving-scale)", heat, fno2d(256, 1 / 64), 100,
         25, 65 * 65, 256, None)]


def run(device="cuda", steps=None) -> list[dict]:
    """Every family (``steps`` in place of each family's own, for a smoke
    run); print and return one line each."""
    bench_torch.require_card(device)
    card = bench_torch.card_fields(device)
    rows = []
    for name, system, alg, iters, block, points, members, acc in families():
        iters = iters if steps is None else steps
        block = min(block, iters // 2)
        t0 = time.perf_counter()
        npde.solve_pino_pde(system, alg, maxiters=block, inner_steps=block,
                            device=device)
        first = time.perf_counter() - t0
        stamps = []
        t0 = time.perf_counter()
        sol = npde.solve_pino_pde(
            system, alg, maxiters=iters, inner_steps=block, device=device,
            callback=lambda it, loss, aux: stamps.append(time.perf_counter()))
        train = time.perf_counter() - t0
        per_step = statistics.median(
            b - a for a, b in zip(stamps, stamps[1:])) / block
        rows.append({"family": name, "first_chunk_s": first, "iters": iters,
                     "train_s": train, "per_step_ms": 1e3 * per_step,
                     "family_points_per_sec": points * members / per_step,
                     "rel_l2": None if acc is None else float(acc(sol)),
                     "device": card["device"],
                     "power_limit": card["power_limit_w"]})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    run()
