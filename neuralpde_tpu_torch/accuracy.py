"""`bench.py`'s accuracy recipes (`accuracy_suite`) in the port.

Each recipe trains at a fixed budget and reports rel L2 against a known
solution, the number the port is held to beside the JAX package's record:

* `poisson_spinn_rel_l2`: item 1, a hard-constrained `SeparableNet` on the
  2-D Poisson problem, 500 Adam steps on a 128^2 grid;
* `allen_cahn_rel_l2`: item 3, the causal separable Allen-Cahn recipe, three
  stages of 15,000 Adam steps (causal eps 1e2, 1e3, 1e4), against the
  spectral reference of `examples/allen_cahn_spinn.py`.

Item 2 (Gauss-Newton) is `solve_gauss_newton` on `poisson_spinn(33, 24, 24)`.
The full Allen-Cahn recipe takes about ten minutes on one card:

    python -m neuralpde_tpu_torch.accuracy

prints its result as one JSON line.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from . import (
    Chain, DepVar, Differential, Domain, Eq, Interval, NonAdaptiveLoss,
    PDESystem, PeriodicEmbedding, PhysicsInformedNN, SeparableNet,
    SeparableTraining, Transformed, adam, cos, depvar_params, discretize, mlp,
    sin, solve, symbols,
)
from .config import matmul_precision

AC_STAGES = ((100.0, 1e-3), (1e3, 5e-4), (1e4, 2e-4))   # (causal eps, lr)


def _hard(c, o):
    """The hard constraint of `bench.py`: zero at both ends of [0, 1]."""
    return c * (1 - c) * o


def poisson_spinn(n: int, hidden: int = 64, rank: int = 64, *,
                  dtype=torch.float32, device="cuda", seed: int = 0,
                  init_params=None, matmul_precision=None):
    """`bench.py`'s SPINN problem (`spinn_points_per_sec`, `accuracy_suite`):
    2-D Poisson ``u_xx + u_yy = -sin(pi x) sin(pi y)`` on the unit square
    with no boundary conditions, one hard-constrained ``mlp([1, hidden,
    hidden, rank])`` per axis, an n x n static grid.  Returns the problem
    and its `SeparableNet`."""
    x, y = symbols("x y")
    u = DepVar("u")
    eq = Eq((Differential(x) ** 2)(u(x, y)) + (Differential(y) ** 2)(u(x, y)),
            -sin(np.pi * x) * sin(np.pi * y))
    system = PDESystem(eq, [], [Domain(x, Interval(0, 1)),
                                Domain(y, Interval(0, 1))], [x, y], [u(x, y)])
    net = SeparableNet([
        Transformed(mlp([1, hidden, hidden, rank], dtype=dtype), _hard)
        for _ in range(2)])
    disc = PhysicsInformedNN(
        net, SeparableTraining(dx=1.0 / (n - 1)), dtype=dtype, device=device,
        seed=seed, init_params=init_params, matmul_precision=matmul_precision)
    return discretize(system, disc), net


def poisson_rel_l2(net: SeparableNet, theta: dict) -> float:
    """rel L2 of a trained `poisson_spinn` net on `bench.py`'s 101^2 grid
    against sin(pi x) sin(pi y) / (2 pi^2)."""
    xs = np.linspace(0, 1, 101)
    like = next(iter(theta.values()))
    nodes = torch.tensor(xs, dtype=like.dtype, device=like.device)
    with matmul_precision("highest"):
        pred = net.grid(depvar_params(theta), [nodes, nodes])
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    want = np.sin(np.pi * X) * np.sin(np.pi * Y) / (2 * np.pi ** 2)
    got = pred.detach().double().cpu().numpy()
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def poisson_spinn_rel_l2(*, seed: int = 0, dtype=torch.float32,
                         device="cuda", maxiters: int = 500) -> dict:
    """`accuracy_suite` item 1: Adam(2e-3) on the 128^2 grid in blocks of
    100 steps.  Returns ``{"rel_l2", "seconds", "history"}``."""
    prob, net = poisson_spinn(128, dtype=dtype, device=device, seed=seed)
    t0 = time.perf_counter()
    res = solve(prob, adam(2e-3), maxiters=maxiters, inner_steps=100)
    if prob.pinnrep.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"rel_l2": poisson_rel_l2(net, res.u), "seconds": seconds,
            "history": res.history}


def allen_cahn_system() -> PDESystem:
    """``u_t = 1e-4 u_xx + 5 (u - u^3)`` on [-1, 1] x [0, 1], periodic in x,
    ``u(x, 0) = x^2 cos(pi x)``."""
    x, t = symbols("x t")
    u = DepVar("u")
    eq = Eq(Differential(t)(u(x, t)),
            1e-4 * (Differential(x) ** 2)(u(x, t))
            + 5.0 * (u(x, t) - u(x, t) ** 3))
    return PDESystem(eq, [Eq(u(x, 0.0), x ** 2 * cos(np.pi * x))],
                     [Domain(x, Interval(-1, 1)), Domain(t, Interval(0, 1))],
                     [x, t], [u(x, t)])


def allen_cahn_net(rank: int = 256, hidden=(64, 64, 64), n_modes: int = 10,
                   dtype=torch.float32) -> SeparableNet:
    """`examples/allen_cahn_spinn.py`'s ``build_net``: a periodic embedding
    of x in front of its MLP, a plain MLP in t."""
    x_net = Chain(PeriodicEmbedding(1, axis=0, period=2.0, n_modes=n_modes),
                  *mlp([2 * n_modes, *hidden, rank], dtype=dtype).layers)
    return SeparableNet([x_net, mlp([1, *hidden, rank], dtype=dtype)])


def allen_cahn_stage(net: SeparableNet, causal_eps: float, *,
                     nodes: int = 256, dtype=torch.float32, device="cuda"):
    """One causal stage of the recipe: ``nodes`` per axis, IC weight 100,
    true float32 matmuls.  Returns the problem and its strategy (whose
    ``causal_weights`` monitor the stage)."""
    system = allen_cahn_system()
    strategy = SeparableTraining(dx=[2.0 / (nodes - 1), 1.0 / (nodes - 1)],
                                 causal=system.ivs[1], causal_eps=causal_eps)
    prob = discretize(system, PhysicsInformedNN(
        net, strategy, dtype=dtype, device=device,
        matmul_precision="highest",
        adaptive_loss=NonAdaptiveLoss(bc_loss_weights=[100.0])))
    return prob, strategy


def allen_cahn_ground_truth():
    """Spectral FFT-in-x, RK4-in-t reference on 512 points in x, 101
    snapshots in t (`examples/allen_cahn_spinn.py`): ``(xg, ts, U)`` with
    ``U`` of shape (101, 512)."""
    n = 512
    xg = -1 + 2 * np.arange(n) / n
    k = np.pi * np.fft.fftfreq(n, d=1.0 / n)
    ug = xg ** 2 * np.cos(np.pi * xg)

    def rhs(v):
        vxx = np.real(np.fft.ifft(-(k ** 2) * np.fft.fft(v)))
        return 1e-4 * vxx + 5.0 * (v - v ** 3)

    snaps = [ug.copy()]
    dt = 5e-4
    for i in range(2000):
        k1 = rhs(ug)
        k2 = rhs(ug + 0.5 * dt * k1)
        k3 = rhs(ug + 0.5 * dt * k2)
        k4 = rhs(ug + dt * k3)
        ug = ug + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        if (i + 1) % 20 == 0:
            snaps.append(ug.copy())
    return xg, np.linspace(0, 1, len(snaps)), np.stack(snaps)


def allen_cahn_rel_l2(*, rank: int = 256, nodes: int = 256,
                      iters: int = 15_000, device="cuda") -> dict:
    """`accuracy_suite` item 3 in float32: the causal stages of `AC_STAGES`
    in turn, each from the last one's parameters, ``iters`` Adam steps each
    in blocks of 1000 (or ``iters``, if fewer).  Returns ``{"rel_l2",
    "seconds", "per_stage": [(eps, rel_l2, last causal weight), ...]}``."""
    xg, ts, U = allen_cahn_ground_truth()
    X, T = np.meshgrid(xg, ts, indexing="ij")
    cord = torch.tensor(np.stack([X.ravel(), T.ravel()]),
                        dtype=torch.float32, device=device)
    want = U.T.reshape(-1)
    net = allen_cahn_net(rank)

    def rel_l2(theta):
        with torch.no_grad(), matmul_precision("highest"):
            pred = net.apply(depvar_params(theta), cord)[0]
        got = pred.double().cpu().numpy()
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    theta, per_stage = None, []
    t0 = time.perf_counter()
    for eps, lr in AC_STAGES:
        prob, strategy = allen_cahn_stage(net, eps, nodes=nodes,
                                          device=device)
        if theta is not None:
            prob = prob.with_params(theta)
        theta = solve(prob, adam(lr), maxiters=iters,
                      inner_steps=min(1000, iters)).u
        with torch.no_grad():
            last_weight = float(strategy.causal_weights(theta)[0][-1])
        per_stage.append((eps, rel_l2(theta), last_weight))
    seconds = time.perf_counter() - t0
    return {"rel_l2": per_stage[-1][1], "seconds": seconds,
            "per_stage": per_stage}


def main() -> None:
    print(json.dumps({"allen_cahn": allen_cahn_rel_l2()}))


if __name__ == "__main__":
    main()
