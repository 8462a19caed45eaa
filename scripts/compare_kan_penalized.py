#!/usr/bin/env python3
"""Does `kan([2, 8, 8, 1], degree=5)` with penalized boundary values stall on
bench's 2-D Poisson problem in both packages?

A comparison tool in the manner of `tests/test_torch_*.py` (it imports the
JAX package and the PyTorch port, and runs both on the CPU): the same
initial parameters, `derivative="jet"`, Adam(2e-2), 2,000 steps, once with
`StochasticTraining(8192, bcs_points=1024)` in float32 (each package draws
its own points) and once with `GridTraining(1/63)` in float64, where both
see the same nodes and the loss histories must agree.  One JSON line a run:
losses and rel L2 against sin(pi x) sin(pi y) / (2 pi^2) on 51^2 points.

    python scripts/compare_kan_penalized.py [--steps 2000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tests"))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=2000)
    args = parser.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import optax
    import torch

    import neuralpde_tpu as jpkg
    import neuralpde_tpu_torch as tpkg
    from _torch_parity import poisson_2d

    xs = np.linspace(0, 1, 51)
    cord = np.stack([g.ravel() for g in np.meshgrid(xs, xs, indexing="ij")])
    exact = (np.sin(np.pi * cord[0]) * np.sin(np.pi * cord[1])
             / (2 * np.pi ** 2))

    def rel_l2(pred):
        pred = np.asarray(pred, np.float64).ravel()
        return float(np.linalg.norm(pred - exact) / np.linalg.norm(exact))

    jnet = jpkg.kan([2, 8, 8, 1], degree=5)
    tree = jax.tree.map(np.asarray, jnet.init(jax.random.key(0)))
    runs = {
        "StochasticTraining(8192, bcs_points=1024) float32": (
            lambda pkg: pkg.StochasticTraining(8192, bcs_points=1024),
            jnp.float32, torch.float32),
        "GridTraining(1/63) float64": (
            lambda pkg: pkg.GridTraining(1.0 / 63), jnp.float64,
            torch.float64),
    }
    for name, (strategy, jdt, tdt) in runs.items():
        jprob = jpkg.discretize(poisson_2d(jpkg), jpkg.PhysicsInformedNN(
            jnet, strategy(jpkg), derivative="jet", dtype=jdt,
            init_params=jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)))
        jres = jpkg.solve(jprob, optax.adam(2e-2), maxiters=args.steps,
                          inner_steps=100)
        jrel = rel_l2(jprob.pinnrep.phi(jnp.asarray(cord, jdt),
                                        jres.u["depvar"]))

        tprob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
            tpkg.kan([2, 8, 8, 1], degree=5), strategy(tpkg),
            derivative="jet", dtype=tdt, device="cpu",
            init_params=tpkg.params_from_jax(tree, dtype=tdt)))
        tres = tpkg.solve(tprob, tpkg.adam(2e-2), maxiters=args.steps,
                          inner_steps=100)
        trel = rel_l2(tprob.pinnrep.phi(
            torch.as_tensor(cord, dtype=tdt),
            tpkg.depvar_params(tres.u)).cpu().numpy())
        print(json.dumps({
            "run": name, "steps": args.steps,
            "jax": {"loss_first": float(jres.history[0]),
                    "loss_last": float(jres.history[-1]), "rel_l2": jrel},
            "torch_cpu": {"loss_first": float(tres.history[0]),
                          "loss_last": float(tres.history[-1]),
                          "rel_l2": trel}}), flush=True)


if __name__ == "__main__":
    main()
