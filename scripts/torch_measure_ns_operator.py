"""The Navier-Stokes vorticity operator under one evaluation protocol, row
by row, on one NVIDIA H100: the twin of `scripts/measure_ns_operator_tpu.py`.

Every row is scored alike: the 8 held-out initial vorticities of the
protocol (the JAX package's zero-mean GRF, l = 0.25, sigma = 3, key 4242,
on the 65-node grid; `accuracy.ns_eval_ics`) spectrally downsampled to the
row's grid; truth per IC from the pseudo-spectral solver at n = 128
(`accuracy.reference_ns_vorticity`); per-IC rel L2 of the vorticity over
the row's space-time grid, and for a scaled row also over the base 33^2 x 9
node subset.

Rows (``--rows``, comma-separated; default base-fd, base-spectral,
scaled-spectral):

* base-fd: 33^2 x 9 grid, FNO3D w16 m(8,8,4) d3, second-order differences;
* base-spectral: the same with FFT derivatives in x and y;
* scaled-spectral: 65^2 x 17, FNO3D w20 m(12,12,6) d3, spectral;
* scaled-fd: the scaled grid with differences;
* scaled-nu01: scaled-spectral at nu = 0.01.

Each trains 12 GRF ICs with Adam 2e-3 and the gauge loss for ``--iters``
steps in blocks of 50 through `solve_pino_pde`'s captured graph, float32
with TF32 off (the JAX script's "highest").  ``wall_s`` is the replayed
blocks' time (the first block, with the eager step and the capture, is left
out); ``ms_per_step`` divides it by their steps.

One JSON line a row: the JAX script's keys (``row``, ``backend``,
``grid``, ``nu``, ``derivative``, ``width``, ``modes``, ``iters``,
``wall_s``, ``final_loss``, ``per_ic_rel_l2``, ``mean_rel_l2``,
``eval_protocol`` and, scaled, ``mean_rel_l2_base_subset``) with
``ms_per_step``, ``device`` and ``power_limit`` (watts); then a table.
Needs a CUDA card; without one it raises.

    python3 scripts/torch_measure_ns_operator.py [--rows base-fd,...]
        [--iters 8000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:    # the port, when this file runs as a script
    sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
import neuralpde_tpu_torch as npde  # noqa: E402
from neuralpde_tpu_torch import accuracy  # noqa: E402

NU, SIGMA, LSCALE, TMAX = 0.02, 3.0, 0.25, 0.5
ROWS = {
    # name: (x elements, t elements, width, modes, nu, spectral)
    "base-fd": (32, 8, 16, (8, 8, 4), NU, False),
    "base-spectral": (32, 8, 16, (8, 8, 4), NU, True),
    "scaled-spectral": (64, 16, 20, (12, 12, 6), NU, True),
    "scaled-fd": (64, 16, 20, (12, 12, 6), NU, False),
    "scaled-nu01": (64, 16, 20, (12, 12, 6), 0.01, True),
}
DEFAULT_ROWS = "base-fd,base-spectral,scaled-spectral"
BLOCK = 50
KEYS = ("row", "backend", "grid", "nu", "derivative", "width", "modes",
        "iters", "wall_s", "final_loss", "per_ic_rel_l2", "mean_rel_l2",
        "eval_protocol", "mean_rel_l2_base_subset", "ms_per_step", "device",
        "power_limit")


def build(name: str):
    """``(system, alg)`` of row ``name``."""
    nxe, nte, width, modes, nu, spectral = ROWS[name]
    system, w0 = accuracy.ns_vorticity_system(
        nu, accuracy.ns_stream_scale(SIGMA, LSCALE), TMAX)
    x, y = system.ivs[0], system.ivs[1]
    alg = npde.PINOPDE(
        chain=npde.FNO3D(1, width=width, modes=modes, depth=3,
                         out_channels=2),
        opt=npde.adam(2e-3), number_of_parameters=12,
        input_functions={w0: accuracy.zero_mean_grf(LSCALE, SIGMA ** 2)},
        additional_loss=accuracy.ns_gauge,
        spectral_axes=(x, y) if spectral else None,
        strategy=npde.GridTraining([1 / nxe, 1 / nxe, TMAX / nte]))
    return system, alg


def scores(sol, nxe: int, nte: int, nu: float):
    """Per-IC rel L2 over the row's grid and over the base 33^2 x 9 subset
    (None on the base grid)."""
    eval65 = accuracy.ns_eval_ics().astype(np.float64)
    test_ic = np.stack([accuracy.spectral_downsample(eval65[:, :, j], nxe)
                        for j in range(eval65.shape[-1])], axis=-1)
    pred = sol(input_values={"w0": test_ic}).cpu().numpy()
    ts = sol.grids[2].cpu().numpy().astype(np.float64)
    rels, subset = [], []
    for j in range(test_ic.shape[-1]):
        want = accuracy.reference_ns_vorticity(test_ic[:, :, j], nu, ts)
        got = pred[0, :, :, :, j]
        rels.append(float(np.linalg.norm(got - want) / np.linalg.norm(want)))
        if nxe > 32:
            st = (nxe // 32, nxe // 32, nte // 8)
            gs = got[::st[0], ::st[1], ::st[2]]
            ws = want[::st[0], ::st[1], ::st[2]]
            subset.append(float(np.linalg.norm(gs - ws)
                                / np.linalg.norm(ws)))
    return rels, (subset or None)


def run_row(name: str, iters: int, device="cuda") -> dict:
    bench_torch.require_card(device)
    nxe, nte, width, modes, nu, spectral = ROWS[name]
    system, alg = build(name)
    stamps = []
    sol = npde.solve_pino_pde(system, alg, maxiters=iters,
                              inner_steps=min(BLOCK, iters // 2),
                              device=device,
                              callback=lambda it, loss, aux: stamps.append(
                                  (it, time.perf_counter())))
    wall = stamps[-1][1] - stamps[0][1]
    rels, subset = scores(sol, nxe, nte, nu)
    return {"row": name, "backend": "cuda", "grid": f"{nxe + 1}^2x{nte + 1}",
            "nu": nu, "derivative": "spectral-xy" if spectral else "fd2",
            "width": width, "modes": list(modes), "iters": iters,
            "wall_s": wall, "final_loss": float(sol.original.objective),
            "per_ic_rel_l2": rels, "mean_rel_l2": float(np.mean(rels)),
            "eval_protocol": "8 ICs key 4242 on 65-grid",
            "mean_rel_l2_base_subset": (None if subset is None
                                        else float(np.mean(subset))),
            "ms_per_step": 1e3 * wall / (stamps[-1][0] - stamps[0][0])}


def run(rows: str = DEFAULT_ROWS, iters: int = 8000,
        device="cuda") -> list[dict]:
    """Every row of ``rows``; print and return one line each."""
    bench_torch.require_card(device)
    card = bench_torch.card_fields(device)
    out = []
    for name in rows.split(","):
        name = name.strip()
        if name not in ROWS:
            raise SystemExit(f"unknown row {name!r}; have {sorted(ROWS)}")
        out.append({**run_row(name, iters, device),
                    "device": card["device"],
                    "power_limit": card["power_limit_w"]})
        print(json.dumps(out[-1]), flush=True)
    print("\nrow                 grid       deriv        mean relL2   wall")
    for r in out:
        sub = ("" if r["mean_rel_l2_base_subset"] is None else
               f"  (base subset {r['mean_rel_l2_base_subset']:.4f})")
        print(f"{r['row']:<19} {r['grid']:<10} {r['derivative']:<12} "
              f"{r['mean_rel_l2']:<12.4f} {r['wall_s']:.1f}s{sub}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default=DEFAULT_ROWS)
    ap.add_argument("--iters", type=int, default=8000)
    args = ap.parse_args(argv)
    run(args.rows, args.iters)


if __name__ == "__main__":
    main()
