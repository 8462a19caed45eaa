"""What deep-ensemble training (`solve_ensemble`) costs against one member
on one NVIDIA H100: the twin of `scripts/measure_ensemble_tpu.py`.

2-D Poisson (bench's problem), ``mlp([2, 64, 64, 1])``, `GridTraining` on
a 64^2 grid, Adam 1e-3, float32 with TF32 off: ms a step of a solo `solve`
and of `solve_ensemble` at n = 2, 4, 8 and 16 members, and the per-member
efficiency n * t_solo / t_ensemble(n).  The port evaluates the members one
after another inside one captured step, not under ``vmap``, so the JAX
script's answer (members nearly free while the batch is small) need not
carry over.

Timing is the JAX script's two-point difference: each call is a whole
`solve` (one eager step, the capture, replays) of ``small`` or ``big``
steps in blocks of ``chunk``, and t_step = (T(big) - T(small)) / (big -
small) cancels the per-call cost, the capture included; the median of
``reps`` pairs after one warm-up call.

One JSON line a run: ``{"config" ("solo" or "ensemble"), "n",
"ms_per_step", "vs_solo", "efficiency", "device", "power_limit"}``
(``power_limit`` in watts).  Needs a CUDA card; without one it raises.

    python3 scripts/torch_measure_ensemble.py
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

CHUNK = 100
MEMBERS = (2, 4, 8, 16)
KEYS = ("config", "n", "ms_per_step", "vs_solo", "efficiency", "device",
        "power_limit")


def poisson_prob(*, dtype=torch.float32, device="cuda", init_params=None):
    """The JAX script's ``poisson_prob``: bench's 2-D Poisson on
    ``mlp([2, 64, 64, 1])`` with `GridTraining(1 / 63)`."""
    bench_torch.require_card(device)
    return npde.discretize(accuracy.poisson_2d_system(), npde.PhysicsInformedNN(
        npde.mlp([2, 64, 64, 1], dtype=dtype), npde.GridTraining(1 / 63),
        dtype=dtype, device=device, init_params=init_params))


def per_step(run, reps: int, small: int, big: int) -> float:
    """Seconds a step by two-point timing of ``run(iterations)``."""
    run(small)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(small)
        t1 = time.perf_counter()
        run(big)
        t2 = time.perf_counter()
        ts.append(((t2 - t1) - (t1 - t0)) / (big - small))
    return float(np.median(ts))


def run(members=MEMBERS, chunk: int = CHUNK, reps: int = 3,
        device="cuda") -> list[dict]:
    """Solo, then an ensemble of each size in ``members``; print and return
    one line each.  Calls of ``chunk`` and ``6 * chunk`` steps."""
    bench_torch.require_card(device)
    card = bench_torch.card_fields(device)
    prob = poisson_prob(device=device)

    def solo(it):
        npde.solve(prob, npde.adam(1e-3), maxiters=it, inner_steps=chunk)
        torch.cuda.synchronize()

    def ensemble(n):
        def call(it):
            npde.solve_ensemble(prob, npde.adam(1e-3), maxiters=it,
                                inner_steps=chunk, n_ensemble=n)
            torch.cuda.synchronize()
        return call

    rows = []

    def line(config, n, t):
        rows.append({"config": config, "n": n, "ms_per_step": 1e3 * t,
                     "vs_solo": t / t_solo, "efficiency": n * t_solo / t,
                     "device": card["device"],
                     "power_limit": card["power_limit_w"]})
        print(json.dumps(rows[-1]), flush=True)

    t_solo = per_step(solo, reps, chunk, 6 * chunk)
    line("solo", 1, t_solo)
    for n in members:
        line("ensemble", n, per_step(ensemble(n), reps, chunk, 6 * chunk))
    return rows


if __name__ == "__main__":
    run()
