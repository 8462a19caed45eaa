"""Train a PINN, export the solution network as a `torch.export`
artifact, reload it and serve it (`examples/export_serving.py` in the
port).

u' = -u, u(0) = 1 on [0, 1] with ``mlp([1, 16, 1])`` on `GridTraining(0.05)`,
1,500 Adam(5e-2) steps; `utils.export.export_phi` bakes the trained
parameters into a program of batch 64, `save_exported` writes it, and
`load_exported` serves it.  A process that imports only torch loads the
same file with ``torch.export.load(path).module()``.  Error: rel L2 of the
served values at 64 points against exp(-t).

Run:

    python -m neuralpde_tpu_torch.examples.export_serving [--out PATH]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from neuralpde_tpu_torch import (
    DepVar, Differential, Domain, Eq, GridTraining, Interval, PDESystem,
    PhysicsInformedNN, adam, default_float, depvar_params, discretize, mlp,
    solve, symbols,
)
from neuralpde_tpu_torch.utils.export import (
    export_phi, load_exported, save_exported,
)


def build_system() -> PDESystem:
    t = symbols("t")
    u = DepVar("u")
    return PDESystem(Eq(Differential(t)(u(t)), -u(t)), [Eq(u(0.0), 1.0)],
                     [Domain(t, Interval(0, 1))], [t], [u(t)])


def run(iters: int = 1500, out: str | None = None, *, batch: int = 64,
        verbose: bool = True, device="cuda") -> dict:
    """Train, export to ``out`` (a temporary file if None), load and
    serve.  Returns ``{"rel_l2", "max_abs_error", "wall_s", "bytes"}``."""
    disc = PhysicsInformedNN(mlp([1, 16, 1]), GridTraining(0.05),
                             device=device)
    prob = discretize(build_system(), disc)
    t0 = time.perf_counter()
    res = solve(prob, adam(5e-2), maxiters=iters, inner_steps=25)
    wall = time.perf_counter() - t0
    dtype = default_float()
    blob, _ = export_phi(disc.phi, depvar_params(res.u), in_dim=1,
                         batch=batch, dtype=dtype)
    with tempfile.TemporaryDirectory() as tmp:
        path = out or os.path.join(tmp, "solution.pt2")
        save_exported(path, blob)
        serve = load_exported(path)
        ts = torch.linspace(0, 1, batch, dtype=dtype,
                            device=disc.device)[None, :]
        with torch.no_grad():
            got = serve(ts)[0]
    want = torch.exp(-ts[0])
    err = float((got - want).abs().max())
    rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    if verbose:
        print(f"serving max err vs exp(-t): {err:.3e} (artifact "
              f"{len(blob)} bytes)", flush=True)
    return {"rel_l2": rel, "max_abs_error": err, "wall_s": round(wall, 2),
            "bytes": len(blob)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--out", default=None,
                    help="where to write the artifact (default: a "
                         "temporary file)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.iters, args.out, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
