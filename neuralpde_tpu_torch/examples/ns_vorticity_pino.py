"""2-D Navier-Stokes (decaying turbulence) operator with PINOPDE
(`examples/ns_vorticity_pino.py` in the port): one FNO3D learns the map
from a random initial vorticity field to the full space-time flow,
physics-informed, with no solver data.

Vorticity-streamfunction form on the periodic unit torus
(`accuracy.ns_vorticity_system`), the stream function rescaled by ``s`` so
that both operator outputs are O(1); the input is a zero-mean GRF
initial vorticity (`accuracy.zero_mean_grf`); both equations, the IC and
the periodic pairs lower onto the 33^2 x 9 training grid through the
field-grid lowering; the gauge of the periodic Poisson equation is pinned
by `accuracy.ns_gauge`.  FNO3D(1, width=16, modes=(8, 8, 4), depth=3,
out_channels=2), 12 family members, 8,000 Adam(2e-3) steps.  Error: mean
rel L2 of the vorticity over the 8 held-out ICs (the JAX package's draws
from key 4242, `accuracy.ns_eval_ics`) against the pseudo-spectral
reference (`accuracy.ns_rel_l2`).

Run:

    python -m neuralpde_tpu_torch.examples.ns_vorticity_pino [--iters 8000]
        [--precision highest] [--device cuda]
    python -m neuralpde_tpu_torch.examples.ns_vorticity_pino --check
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from neuralpde_tpu_torch import (
    FNO3D, PINOPDE, GridTraining, adam, solve_pino_pde,
)
from neuralpde_tpu_torch.accuracy import (
    NS, ns_gauge, ns_rel_l2, ns_vorticity_system, reference_ns_vorticity,
    zero_mean_grf,
)


def check_reference() -> None:
    """Self-check of the spectral solver: grid and substep refinement
    converge, and the zero-advection limit decays as the heat equation."""
    m = 32
    g = np.linspace(0, 1, m + 1)
    X, Y = np.meshgrid(g, g, indexing="ij")
    w0 = (np.sin(2 * np.pi * X) * np.cos(4 * np.pi * Y)
          + 0.5 * np.cos(2 * np.pi * (X + Y)))
    ts = np.linspace(0, 0.5, 6)
    nu = 0.02
    a = reference_ns_vorticity(w0, nu, ts, n=64, substeps=8)
    b = reference_ns_vorticity(w0, nu, ts, n=128, substeps=32)
    rel = np.linalg.norm(a - b) / np.linalg.norm(b)
    print(f"[check] refinement rel diff {rel:.2e}")
    if not rel < 1e-6:
        raise AssertionError(rel)
    w1 = np.sin(2 * np.pi * X)
    c = reference_ns_vorticity(w1, nu, ts, n=64, substeps=8)
    want = w1[:, :, None] * np.exp(-nu * (2 * np.pi) ** 2 * ts)[None, None, :]
    rel = np.linalg.norm(c - want) / np.linalg.norm(want)
    print(f"[check] heat-limit rel err {rel:.2e}")
    if not rel < 1e-10:
        raise AssertionError(rel)
    print("[check] spectral reference OK")


def make_alg(*, width: int = 16, modes=(8, 8, 4), depth: int = 3,
             nodes: int = 33, members: int = 12, spectral: bool = False,
             **kw):
    """``(system, alg)``: the operator on a ``nodes``^2 x 9 grid;
    ``spectral`` takes exact FFT derivatives in x and y; ``kw`` sets other
    `PINOPDE` fields (``additional_loss`` defaults to the gauge)."""
    system, w0 = ns_vorticity_system()
    if spectral:
        kw["spectral_axes"] = (system.ivs[0], system.ivs[1])
    kw.setdefault("additional_loss", ns_gauge)
    alg = PINOPDE(
        chain=FNO3D(1, width=width, modes=modes, depth=depth,
                    out_channels=2),
        opt=adam(2e-3), number_of_parameters=members,
        input_functions={w0: zero_mean_grf()},
        strategy=GridTraining([1 / (nodes - 1), 1 / (nodes - 1),
                               NS["tmax"] / 8]), **kw)
    return system, alg


def run(iters: int = 8000, precision: str | None = None, *,
        verbose: bool = True, device="cuda", **alg_kw) -> dict:
    """Returns ``{"rel_l2" (mean over the held-out ICs), "wall_s"
    (training), "per_ic", "loss"}``."""
    system, alg = make_alg(matmul_precision=precision, **alg_kw)
    t0 = time.perf_counter()
    sol = solve_pino_pde(system, alg, maxiters=iters,
                         inner_steps=min(50, iters), verbose=verbose,
                         device=device)
    wall = time.perf_counter() - t0
    mean, rels = ns_rel_l2(sol, alg_kw.get("nodes", 33))
    if verbose:
        print(f"train wall {wall:.1f} s   final loss "
              f"{float(sol.original.objective):.3e}", flush=True)
        for j, r in enumerate(rels):
            print(f"  IC {j}: rel L2(w) {r:.4f}")
        print(f"mean rel L2 over held-out ICs: {mean:.4f}", flush=True)
    return {"rel_l2": mean, "wall_s": round(wall, 1), "per_ic": rels,
            "loss": float(sol.original.objective)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=8000)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--precision", default=None,
                    choices=[None, "default", "high", "highest"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.check:
        return check_reference()
    out = run(args.iters, args.precision, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
