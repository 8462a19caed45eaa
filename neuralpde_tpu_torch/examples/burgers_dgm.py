"""Viscous Burgers with the Deep Galerkin Method and the MiniMax adaptive
loss (`examples/burgers_dgm.py` in the port).

u_t + u u_x = 0.05 u_xx on [-1, 1] x [0, 1], u(x, 0) = -sin(pi x), zero at
both ends (`accuracy.burgers_dgm_example`); ``DeepGalerkin(2, 1, 24, 3,
tanh, tanh, identity)`` on `QuasiRandomTraining(512, "sobol")` with
`MiniMaxAdaptiveLoss(100)`, 5,000 Adam(1e-2) steps.  The port's `identity`
stands for the script's ``lambda z: z`` (a lambda has no Taylor rule).
rel L2 on a 41 x 21 grid against the Cole-Hopf solution (`cole_hopf`).

Run:

    python -m neuralpde_tpu_torch.examples.burgers_dgm [--iters 5000]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from neuralpde_tpu_torch import (
    DeepGalerkin, MiniMaxAdaptiveLoss, QuasiRandomTraining, adam,
    depvar_params, discretize, matmul_precision, solve,
)
from neuralpde_tpu_torch.accuracy import burgers_dgm_example
from neuralpde_tpu_torch.nn import identity, tanh

NU = 0.05


def cole_hopf(x, t, nu=NU, n: int = 200):
    """The Cole-Hopf solution of the example's problem (Basdevant et al.
    1986): u = -int sin(pi(x - s)) f(x - s) e^{-s^2/4 nu t} ds / int
    f(x - s) e^{-s^2/4 nu t} ds with f(y) = exp(-cos(pi y) / (2 pi nu)),
    by ``n``-point Gauss-Hermite quadrature; the initial condition at t =
    0."""
    x, t = np.broadcast_arrays(np.asarray(x, float), np.asarray(t, float))
    out = -np.sin(np.pi * x)
    s, w = np.polynomial.hermite.hermgauss(n)
    pos = t > 0
    xp, tp = x[pos][:, None], t[pos][:, None]
    y = xp - np.sqrt(4 * nu * tp) * s[None, :]
    f = np.exp(-np.cos(np.pi * y) / (2 * np.pi * nu))
    out[pos] = (-(w * np.sin(np.pi * y) * f).sum(1) / (w * f).sum(1))
    return out


def make_problem(width: int = 24, layers: int = 3, points: int = 512, *,
                 device="cuda"):
    disc = DeepGalerkin(2, 1, width, layers, tanh, tanh, identity,
                        QuasiRandomTraining(points, sampling_alg="sobol"),
                        adaptive_loss=MiniMaxAdaptiveLoss(100),
                        device=device)
    return discretize(burgers_dgm_example(), disc)


def rel_l2(prob, theta: dict, nx: int = 41, nt: int = 21) -> float:
    X, T = np.meshgrid(np.linspace(-1, 1, nx), np.linspace(0, 1, nt),
                       indexing="ij")
    with torch.no_grad(), matmul_precision("highest"):
        got = prob.pinnrep.phi(np.stack([X.ravel(), T.ravel()]),
                               depvar_params(theta))[0]
    got = got.double().cpu().numpy()
    want = cole_hopf(X.ravel(), T.ravel())
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def run(iters: int = 5000, *, width: int = 24, layers: int = 3,
        points: int = 512, verbose: bool = True, device="cuda") -> dict:
    """Returns ``{"rel_l2", "wall_s", "loss"}``."""
    prob = make_problem(width, layers, points, device=device)
    t0 = time.perf_counter()
    res = solve(prob, adam(1e-2), maxiters=iters, inner_steps=25)
    wall = time.perf_counter() - t0
    rel = rel_l2(prob, res.u)
    if verbose:
        print(f"final loss {res.objective:.3e}; rel L2 against Cole-Hopf "
              f"{rel:.4e}", flush=True)
    return {"rel_l2": rel, "wall_s": round(wall, 2), "loss": res.objective}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.iters, device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
