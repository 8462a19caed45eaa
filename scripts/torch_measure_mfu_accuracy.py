"""rel L2, wall time, TFLOP/s and MFU in one run for each width of the dense
causal Allen-Cahn recipe on one NVIDIA H100: the twin of
`scripts/measure_mfu_accuracy.py`.

A row is (hidden width w, collocation batch): the net
``Chain(PeriodicEmbedding(2, axis=0, period=2, n_modes=10), *mlp([21, w, w,
w, w, 1]).layers)`` under ``CausalTraining(batch, t, bcs_points=1024,
n_slabs=32)``, BC weights (100, 1, 1), jet, float32 with TF32 off
(`accuracy.dense_allen_cahn_problem`).  Protocol, as the JAX script's:

* the replayed step time is calibrated first on the stage-1 problem (the
  second of two blocks of ``inner`` steps, `bench_torch.block_seconds`),
  and the row's iterations are set to the shared wall target, split
  30/30/40 over the eps = 1 -> 10 -> 100 stages, each a fresh Adam (lr
  1e-3, 5e-4, 2e-4) from the last stage's parameters;
* FLOPs a step are the GEMM FLOPs `FlopCounterMode` counts in one eager
  step of the stage-1 problem (`bench_torch.step_flops`; the counter sees
  the matmul family only);
* each stage is one `solve` in blocks of ``inner``; its first block (the
  eager step and the capture) trains but is not timed, so ``wall_s``
  covers the replayed blocks, ``tflops`` = FLOPs a step x replayed steps /
  ``wall_s`` and ``iters`` counts every step;
* ``mfu_pct`` divides by the published float32 peak of one H100 SXM at
  700 W (67 TFLOP/s), as `bench_torch.py` does; the float32 ceiling
  measured in the same process (`scripts/torch_probe_matmul_peak.py`'s
  8192^3 chain) stands beside it as ``fp32_ceiling_tflops``;
* rel L2 against the spectral reference (`accuracy.allen_cahn_ground_truth`).

One JSON line a row: ``{"width", "batch", "iters", "wall_s", "rel_l2",
"step_us", "flops_per_step", "tflops", "mfu_pct", "fp32_ceiling_tflops",
"device", "power_limit"}`` (``power_limit`` in watts), then a table.
Needs a CUDA card; without one it raises.

    python3 scripts/torch_measure_mfu_accuracy.py [--budget 240] [--rows
        64:8192,128:8192,256:8192,256:65536] [--inner 500]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:    # the port, when this file runs as a script
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
import neuralpde_tpu_torch as npde  # noqa: E402
from neuralpde_tpu_torch import accuracy  # noqa: E402

ROWS = "64:8192,128:8192,256:8192,256:65536"
STAGES = ((1.0, 1e-3, 0.3), (10.0, 5e-4, 0.3), (100.0, 2e-4, 0.4))
KEYS = ("width", "batch", "iters", "wall_s", "rel_l2", "step_us",
        "flops_per_step", "tflops", "mfu_pct", "fp32_ceiling_tflops",
        "device", "power_limit")


def make_problem(width: int, batch: int, eps: float, **kw):
    """The JAX script's ``make_disc`` discretized: one causal stage."""
    prob, _ = accuracy.dense_allen_cahn_problem(eps, points=batch,
                                                hidden=width, **kw)
    return prob


def _stage(prob, lr: float, iters: int, inner: int):
    """One stage: ``(theta, replayed steps, their seconds)``."""
    stamps = []
    res = npde.solve(prob, npde.adam(lr), maxiters=iters, inner_steps=inner,
                     callback=lambda it, loss, aux: stamps.append(
                         (it, time.perf_counter())))
    return (res.u, stamps[-1][0] - stamps[0][0],
            stamps[-1][1] - stamps[0][1])


def run_row(width: int, batch: int, budget: float, inner: int,
            device="cuda") -> dict:
    bench_torch.require_card(device)
    prob = make_problem(width, batch, STAGES[0][0], device=device)
    print(f"[mfu] row w{width} b{batch}: calibrating", file=sys.stderr,
          flush=True)
    step_s = bench_torch.block_seconds(prob, npde.adam(1e-3), inner, 2,
                                       f"w{width} b{batch} stage 1")[0] / inner
    flops = bench_torch.step_flops(prob, npde.adam(1e-3))
    total = max(3 * inner, int(budget / step_s / inner) * inner)
    theta, iters, timed, wall = None, 0, 0, 0.0
    for eps, lr, frac in STAGES:
        its = max(2 * inner, int(total * frac / inner) * inner)
        print(f"[mfu] stage eps={eps} lr={lr}: {its} iters", file=sys.stderr,
              flush=True)
        prob = make_problem(width, batch, eps, device=device)
        if theta is not None:
            prob = prob.with_params(theta)
        theta, steps, seconds = _stage(prob, lr, its, inner)
        iters += its
        timed += steps
        wall += seconds
    tflops = flops * timed / wall / 1e12
    return {"width": width, "batch": batch, "iters": iters, "wall_s": wall,
            "rel_l2": accuracy.dense_allen_cahn_rel_l2(prob, theta),
            "step_us": 1e6 * step_s, "flops_per_step": flops,
            "tflops": tflops, "mfu_pct": 100 * tflops /
            bench_torch._probe().PEAK_TFLOPS["float32"]}


def run(rows: str = ROWS, budget: float = 240.0, inner: int = 500,
        device="cuda") -> list[dict]:
    """Every row of ``rows`` ("width:batch,..."); print and return one line
    each."""
    bench_torch.require_card(device)
    card = bench_torch.card_fields(device)
    size = bench_torch.CEILING_SIZE
    ceiling = bench_torch._probe().chain_tflops(
        size, size, size, "float32", bench_torch.CEILING_REPS, device)[0]
    out = []
    for spec in rows.split(","):
        width, batch = (int(v) for v in spec.split(":"))
        row = {**run_row(width, batch, budget, inner, device),
               "fp32_ceiling_tflops": ceiling, "device": card["device"],
               "power_limit": card["power_limit_w"]}
        print(json.dumps(row), flush=True)
        out.append(row)
    print("\nwidth  batch    iters     wall     rel L2  TFLOP/s   MFU%")
    for r in out:
        print(f"{r['width']:5d}  {r['batch']:6d}  {r['iters']:7d}  "
              f"{r['wall_s']:6.1f}s  {r['rel_l2']:.5f}  {r['tflops']:7.3f}  "
              f"{r['mfu_pct']:5.2f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=float, default=240.0,
                    help="train wall target a row, seconds")
    ap.add_argument("--rows", default=ROWS,
                    help="comma list of width:batch rows")
    ap.add_argument("--inner", type=int, default=500)
    args = ap.parse_args(argv)
    run(args.rows, args.budget, args.inner)


if __name__ == "__main__":
    main()
