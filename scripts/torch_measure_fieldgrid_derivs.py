"""Second-order differences against FFT derivatives of the evaluated field,
and the grid's resolution, on the field-grid PINO path on one NVIDIA H100:
the twin of `scripts/measure_fieldgrid_derivs.py`.

The periodic heat IC operator u0 -> u(x, t), u_t = 0.05 u_xx on [0, 1) x
[0, 0.5], is trained on an (m + 1) x 17 grid for m in ``--grids``, with
differences and with spectral derivatives in x, for seeds 0 and 1: FNO2D
w16 m(min(10, m/2 - 1), 6) d2, 16 GRF ICs (l = 0.15), Adam 2e-3, ``--iters``
steps in blocks of 25 through `solve_pino_pde`'s captured graph, float32
with TF32 off.  Every row is scored on the same 8 held-out ICs: the JAX
package's GRF draw from key 4242 on the 65-node grid
(`torch_measure_fieldgrid_derivs_ics.npy`, float32), spectrally
downsampled to the row's grid, against the exact Fourier evolution on the
row's own nodes.  ``wall_s`` is the mean over seeds of the replayed
blocks' time (the first block, with the capture, left out).

One JSON line a row: ``{"row", "backend", "grid", "derivative", "iters",
"seeds", "wall_s", "rel_l2_by_seed", "mean_rel_l2", "eval_protocol",
"device", "power_limit"}`` (``power_limit`` in watts); then a table.
Needs a CUDA card; without one it raises.

    python3 scripts/torch_measure_fieldgrid_derivs.py [--iters 800]
        [--grids 16,32,64]
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

NU = 0.05
SEEDS = (0, 1)
EVAL_ICS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_measure_fieldgrid_derivs_ics.npy")
KEYS = ("row", "backend", "grid", "derivative", "iters", "seeds", "wall_s",
        "rel_l2_by_seed", "mean_rel_l2", "eval_protocol", "device",
        "power_limit")


def spectral_downsample_1d(f, m_out):
    """(M+1, N) periodic-in-axis-0 fields -> (m_out+1, N) by Fourier
    truncation (exact for band-limited fields)."""
    m_in = f.shape[0] - 1
    if m_in == m_out:
        return f
    fh = np.fft.rfft(f[:-1, :], axis=0)
    h = m_out // 2
    out = np.zeros((m_out // 2 + 1, f.shape[1]), dtype=complex)
    out[:h + 1] = fh[:h + 1]
    g = np.fft.irfft(out, n=m_out, axis=0) * (m_out / m_in)
    return np.concatenate([g, g[:1]], axis=0)


def exact_heat(ic, ts):
    """Exact periodic heat evolution of an (m+1,) nodal IC at times ts."""
    m = len(ic) - 1
    k = 2 * np.pi * np.fft.rfftfreq(m, d=1.0 / m)
    uh0 = np.fft.rfft(ic[:-1])
    sol = np.stack([np.fft.irfft(uh0 * np.exp(-NU * k ** 2 * t), n=m)
                    for t in ts], axis=1)
    return np.concatenate([sol, sol[:1]], axis=0)


def build(m: int, spectral: bool, seed: int):
    """``(system, alg)`` of one row and seed."""
    x, t = npde.symbols("x t")
    u, f0 = npde.DepVar("u"), npde.DepVar("f0")
    Dx = npde.Differential(x)
    eq = npde.Eq(npde.Differential(t)(u(x, t)), NU * (Dx ** 2)(u(x, t)))
    bcs = [npde.Eq(u(x, 0.0), f0(x)),
           npde.Eq(u(0.0, t), u(1.0, t)),
           npde.Eq(Dx(u(0.0, t)), Dx(u(1.0, t)))]
    system = npde.PDESystem(eq, bcs, [npde.Domain(x, npde.Interval(0, 1)),
                                      npde.Domain(t, npde.Interval(0, 0.5))],
                            ivs=[x, t], dvs=[u(x, t)])
    alg = npde.PINOPDE(
        chain=npde.FNO2D(1, width=16, modes=(min(10, m // 2 - 1), 6),
                         depth=2),
        opt=npde.adam(2e-3), number_of_parameters=16,
        input_functions={f0(x): npde.GaussianRandomField(length_scale=0.15)},
        spectral_axes=(x,) if spectral else None, seed=seed,
        strategy=npde.GridTraining([1 / m, 1 / 16]))
    return system, alg


def run_row(m: int, spectral: bool, iters: int, device="cuda") -> dict:
    bench_torch.require_card(device)
    test_ic = spectral_downsample_1d(np.load(EVAL_ICS).astype(np.float64), m)
    rels_by_seed, walls = [], []
    for seed in SEEDS:
        system, alg = build(m, spectral, seed)
        stamps = []
        sol = npde.solve_pino_pde(
            system, alg, maxiters=iters, inner_steps=min(25, iters // 2),
            seed=seed, device=device,
            callback=lambda it, loss, aux: stamps.append(time.perf_counter()))
        walls.append(stamps[-1] - stamps[0])
        pred = sol(input_values={"f0": test_ic}).cpu().numpy()
        ts = sol.grids[1].cpu().numpy().astype(np.float64)
        rels = []
        for j in range(test_ic.shape[1]):
            want = exact_heat(test_ic[:, j], ts)
            rels.append(float(np.linalg.norm(pred[:, :, j] - want)
                              / np.linalg.norm(want)))
        rels_by_seed.append(float(np.mean(rels)))
    return {"row": f"m{m}-{'spectral' if spectral else 'fd2'}",
            "backend": "cuda", "grid": f"{m + 1}x17",
            "derivative": "spectral-x" if spectral else "fd2",
            "iters": iters, "seeds": list(SEEDS),
            "wall_s": float(np.mean(walls)), "rel_l2_by_seed": rels_by_seed,
            "mean_rel_l2": float(np.mean(rels_by_seed)),
            "eval_protocol": "8 ICs key 4242 on 65-grid"}


def run(iters: int = 800, grids=(16, 32, 64), device="cuda") -> list[dict]:
    """Every grid with differences and with spectral derivatives; print
    and return one line each."""
    bench_torch.require_card(device)
    card = bench_torch.card_fields(device)
    out = []
    for m in grids:
        for spectral in (False, True):
            out.append({**run_row(m, spectral, iters, device),
                        "device": card["device"],
                        "power_limit": card["power_limit_w"]})
            print(json.dumps(out[-1]), flush=True)
    print("\nrow              grid    deriv       mean relL2  by-seed")
    for r in out:
        print(f"{r['row']:<16} {r['grid']:<7} {r['derivative']:<11} "
              f"{r['mean_rel_l2']:<11.4f} "
              f"{[round(v, 4) for v in r['rel_l2_by_seed']]}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--grids", default="16,32,64")
    args = ap.parse_args(argv)
    run(args.iters, [int(s) for s in args.grids.split(",")])


if __name__ == "__main__":
    main()
