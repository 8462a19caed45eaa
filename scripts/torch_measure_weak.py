"""us a replayed step of hp-VPINN `WeakTraining` against strong-form
collocation on the same 2-D Poisson problem and network, on one NVIDIA
H100: the twin of `scripts/measure_weak_tpu.py`.

At matched residual-evaluation nodes: 32 elements x 12 quadrature nodes =
384 nodes an axis for the weak form (``n_test=8``, ``bc_dx=1/383``) at ibp
0, 1 and 2, and `GridTraining(1/383)` on the same tensor grid.  The net is
``mlp([2, 64, 64, 1])`` with jet derivatives, Adam 1e-3, float32 with TF32
off.  Each configuration runs one `solve` of four blocks of 50 steps
through its captured graph; the first block holds the eager step and the
capture, and a configuration's time is the best of the other three
(`bench_torch.block_seconds`).

One JSON line a configuration: ``{"config", "us_per_step", "device",
"power_limit"}`` (``power_limit`` in watts).  Needs a CUDA card; without
one it raises.

    python3 scripts/torch_measure_weak.py
"""

from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:    # the port, when this file runs as a script
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
import neuralpde_tpu_torch as npde  # noqa: E402
from neuralpde_tpu_torch import accuracy  # noqa: E402

STEPS = 50
REPEATS = 3
ELEMENTS, QUAD = 32, 12
KEYS = ("config", "us_per_step", "device", "power_limit")


def strategies() -> dict:
    """The JAX script's configurations: label -> strategy factory."""
    n = ELEMENTS * QUAD

    def weak(ibp):
        return lambda: npde.WeakTraining(elements=ELEMENTS, n_test=8,
                                         ibp=ibp, bc_dx=1.0 / (n - 1))

    return {"weak_ibp0": weak(0), "weak_ibp1": weak(1), "weak_ibp2": weak(2),
            "strong_grid_same_nodes": lambda: npde.GridTraining(1.0 /
                                                                (n - 1))}


def build(strategy, *, dtype=torch.float32, device="cuda", init_params=None):
    """bench's 2-D Poisson problem (`accuracy.poisson_2d_system`) on
    ``mlp([2, 64, 64, 1])`` with jet derivatives and ``strategy``."""
    bench_torch.require_card(device)
    return npde.discretize(accuracy.poisson_2d_system(), npde.PhysicsInformedNN(
        npde.mlp([2, 64, 64, 1], dtype=dtype), strategy, derivative="jet",
        dtype=dtype, device=device, init_params=init_params))


def run(steps: int = STEPS, repeats: int = REPEATS,
        device="cuda") -> list[dict]:
    """Time every configuration; print and return one line each."""
    bench_torch.require_card(device)
    card = bench_torch.card_fields(device)
    rows = []
    for label, factory in strategies().items():
        seconds = bench_torch.block_seconds(
            build(factory(), device=device), npde.adam(1e-3), steps,
            1 + repeats, f"weak timing {label}")
        row = {"config": label, "us_per_step": 1e6 * min(seconds) / steps,
               "device": card["device"], "power_limit": card["power_limit_w"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    run()
