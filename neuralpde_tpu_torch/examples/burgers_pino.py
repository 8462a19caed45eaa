"""Parametric viscous Burgers with PINOPDE: one FNO2D learns the viscosity
family (`examples/burgers_pino.py` in the port).

    u_t + u u_x = nu u_xx,  x in [0,1] periodic,  t in [0, 0.5]
    u(x, 0) = sin(2 pi x),  nu in [0.05, 0.3]

The operator maps the scalar viscosity to the full space-time field; the
physics loss lowers the symbolic system onto the 129 x 33 training grid
through the field-grid lowering (grid-axis finite differences, the
periodic pair and periodic-derivative pair as boundary slices).
Evaluation: rel L2 over 7 held-out viscosities in [0.07, 0.27] on a
257 x 65 grid (twice the training resolution) against a Fourier
pseudo-spectral reference (`reference_burgers`).

Run:

    python -m neuralpde_tpu_torch.examples.burgers_pino [--iters 8000]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import neuralpde_tpu_torch as npde
from neuralpde_tpu_torch import (
    FNO2D, PINOPDE, DepVar, Differential, Domain, Eq, GridTraining, Interval,
    PDESystem, adam, parameters, solve_pino_pde, symbols,
)

NU_BOUNDS = (0.05, 0.3)
HELD_OUT = np.linspace(0.07, 0.27, 7)


def reference_burgers(nu, xs, ts, n_modes=256, substeps=32):
    """Fourier pseudo-spectral integrating-factor RK4 on [0, 1):
    u_t = -(u^2/2)_x + nu u_xx, diffusion integrated exactly in Fourier
    space, 2/3-rule dealiasing; ``ts`` uniformly spaced, each output
    interval split into ``substeps`` RK4 steps.  Returns (X, T)."""
    n = n_modes
    xg = np.arange(n) / n
    k = 2 * np.pi * np.fft.rfftfreq(n, d=1.0 / n)
    dealias = (k <= (2 / 3) * np.pi * n).astype(float)
    dt = (ts[1] - ts[0]) / substeps
    E = np.exp(-nu * k ** 2 * dt / 2)
    E2 = E * E

    def Nh(v):
        u = np.fft.irfft(v, n=n)
        return -0.5j * k * dealias * np.fft.rfft(u * u) * dt

    v = np.fft.rfft(np.sin(2 * np.pi * xg))
    out = []
    for i in range(len(ts)):
        if i > 0:
            for _ in range(substeps):
                a = Nh(v)
                b = Nh(E * (v + a / 2))
                c = Nh(E * v + b / 2)
                d = Nh(E2 * v + E * c)
                v = E2 * v + (E2 * a + 2 * E * (b + c) + d) / 6
        u = np.fft.irfft(v, n=n)
        out.append(np.interp(xs, np.append(xg, 1.0), np.append(u, u[0])))
    return np.stack(out, axis=1)


def build_system() -> PDESystem:
    x, t = symbols("x t")
    nu = parameters("nu")
    u = DepVar("u")
    Dt, Dx, Dxx = Differential(t), Differential(x), Differential(x) ** 2
    U = u(x, t)
    eq = Eq(Dt(U) + U * Dx(U), nu * Dxx(U))
    bcs = [Eq(u(x, 0.0), npde.sin(2 * np.pi * x)),
           Eq(u(0.0, t), u(1.0, t)),                 # periodic pair
           Eq(Dx(u(0.0, t)), Dx(u(1.0, t)))]         # periodic derivative
    return PDESystem(eq, bcs, [Domain(x, Interval(0, 1)),
                               Domain(t, Interval(0, 0.5))],
                     ivs=[x, t], dvs=[U], ps=[nu])


def make_alg(*, width: int = 32, modes=(16, 10), depth: int = 4,
             members: int = 24, dx=(1 / 128, 1 / 64)) -> PINOPDE:
    return PINOPDE(chain=FNO2D(1, width=width, modes=modes, depth=depth),
                   opt=adam(2e-3), bounds=[NU_BOUNDS],
                   number_of_parameters=members,
                   strategy=GridTraining(list(dx)))


def rel_l2(sol, nus=HELD_OUT, nx: int = 257, nt: int = 65) -> list:
    """rel L2 of each held-out viscosity on an nx x nt grid against
    `reference_burgers`."""
    xs, ts = np.linspace(0, 1, nx), np.linspace(0, 0.5, nt)
    pred = sol(p=np.asarray(nus)[None, :], grids=[xs, ts]).cpu().numpy()
    rels = []
    for j, v in enumerate(nus):
        want = reference_burgers(float(v), xs, ts)
        rels.append(float(np.linalg.norm(pred[:, :, j] - want)
                          / np.linalg.norm(want)))
    return rels


def run(iters: int = 8000, *, verbose: bool = True, device="cuda",
        alg_kw=None, eval_kw=None) -> dict:
    """Train the family, then score the held-out viscosities.  Returns
    ``{"rel_l2" (the mean), "wall_s" (training), "per_nu", "loss"}``."""
    alg = make_alg(**(alg_kw or {}))
    t0 = time.perf_counter()
    sol = solve_pino_pde(build_system(), alg, maxiters=iters,
                         inner_steps=min(50, iters), verbose=verbose,
                         device=device)
    wall = time.perf_counter() - t0
    rels = rel_l2(sol, **(eval_kw or {}))
    if verbose:
        print(f"train wall {wall:.1f} s   final loss "
              f"{float(sol.original.objective):.3e}; mean rel L2 over the "
              f"held-out family: {np.mean(rels):.4f}", flush=True)
    return {"rel_l2": float(np.mean(rels)), "wall_s": round(wall, 1),
            "per_nu": rels, "loss": float(sol.original.objective)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=8000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.iters, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
