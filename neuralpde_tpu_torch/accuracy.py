"""`bench.py`'s accuracy recipes (`accuracy_suite`) in the port.

Each recipe trains at a fixed budget and reports rel L2 against a known
solution, the number the port is held to beside the JAX package's record:

* `poisson_spinn_rel_l2`: item 1, a hard-constrained `SeparableNet` on the
  2-D Poisson problem, 500 Adam steps on a 128^2 grid;
* `allen_cahn_rel_l2`: item 3, the causal separable Allen-Cahn recipe, three
  stages of 15,000 Adam steps (causal eps 1e2, 1e3, 1e4), against the
  spectral reference of `examples/allen_cahn_spinn.py`.

Item 2 (`gn_rel_l2`) is `gauss_newton_rel_l2`: `solve_gauss_newton` on
`poisson_spinn(33, 24, 24)`.

Bench's dense recipes:

* `dense_allen_cahn`: ``accuracy_dense_full``, the dense causal Allen-Cahn
  recipe (`CausalTraining`, three stages of 333k, 333k and 444k Adam
  steps, causal eps 1, 10, 100), JAX's best accuracy;
* `time_to_l2`, `time_to_l2_hard`, `time_to_l2_hybrid` and
  `time_to_l2_spinn`: ``--to-l2``, ``--to-l2-hard``, ``--to-l2-hybrid``
  and ``--to-l2-spinn``, seconds to an RMS error below 1e-3 on the 2-D
  Poisson problem (penalized Adam; hard-constrained Adam; Adam then
  L-BFGS; the hard-constrained SPINN).

The problems of the trial-function zoo and the weak forms, each with its
error measure: `two_scale_ode` and `multiscale_laplace`
(`examples/fbpinn_multiscale.py`), `front_system`
(`scripts/measure_weak_accuracy_tpu.py`), `poisson_1d_system`, the Burgers
systems of `examples/burgers_dgm.py` and of the DGM test, and
`ritz_poisson_2d`.  The operator problems: the Navier-Stokes vorticity
family with its held-out initial conditions and pseudo-spectral reference
(`ns_vorticity_system`, `ns_rel_l2`) and the heat family
(`heat_family_system`).

A step of the separable Allen-Cahn recipe takes about 0.9 ms on an H100
(PERF.md), the dense recipe about 44 minutes in all:

    python -m neuralpde_tpu_torch.accuracy            # separable
    python -m neuralpde_tpu_torch.accuracy --dense    # dense
    python -m neuralpde_tpu_torch.accuracy --dense --checkpoint DIR

each prints its result as one JSON line; with ``--checkpoint`` a dense run
that stopped resumes where it stopped when run again.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from . import (
    FBPINN, CausalTraining, Chain, DeepRitz, DepVar, Differential, Domain, Eq,
    GridTraining, Interval, NonAdaptiveLoss, PDESystem, PeriodicEmbedding,
    PhysicsInformedNN, SeparableNet, SeparableTraining, StochasticTraining,
    Transformed, adam, cos, depvar_params, discretize, discretize_ritz, lbfgs,
    mlp, parameters, sin, solve, solve_gauss_newton, symbols, tanh,
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
    res = solve(prob, adam(2e-3), maxiters=maxiters,
                inner_steps=min(100, maxiters))
    _synchronize(prob)
    seconds = time.perf_counter() - t0
    return {"rel_l2": poisson_rel_l2(net, res.u), "seconds": seconds,
            "history": res.history}


def gauss_newton_rel_l2(*, maxiters: int = 200, cg_iters: int = 200,
                        device="cuda") -> dict:
    """`accuracy_suite` item 2: Levenberg-Marquardt with ``cg_iters``
    LSQR iterations (float64 scalars) on the float32 `poisson_spinn(33, 24,
    24)` for ``maxiters`` outer iterations.  Returns ``{"rel_l2",
    "seconds", "iterations", "history"}``."""
    prob, net = poisson_spinn(33, 24, 24, device=device)
    t0 = time.perf_counter()
    res = solve_gauss_newton(prob, maxiters=maxiters, cg_iters=cg_iters,
                             solver="lsqr", scalar_dtype=torch.float64)
    _synchronize(prob)
    seconds = time.perf_counter() - t0
    return {"rel_l2": poisson_rel_l2(net, res.u), "seconds": seconds,
            "iterations": res.iterations, "history": res.history}


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
                     nodes: int = 256, dtype=torch.float32, device="cuda",
                     matmul_precision: str = "highest"):
    """One causal stage of the recipe: ``nodes`` per axis, IC weight 100,
    true float32 matmuls unless ``matmul_precision`` says otherwise
    ("default": TF32 on the card).  Returns the problem and its strategy
    (whose ``causal_weights`` monitor the stage)."""
    system = allen_cahn_system()
    strategy = SeparableTraining(dx=[2.0 / (nodes - 1), 1.0 / (nodes - 1)],
                                 causal=system.ivs[1], causal_eps=causal_eps)
    prob = discretize(system, PhysicsInformedNN(
        net, strategy, dtype=dtype, device=device,
        matmul_precision=matmul_precision,
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


DENSE_AC_STAGES = ((1.0, 1e-3), (10.0, 5e-4), (100.0, 2e-4))  # (eps, lr)
DENSE_AC_ITERS = (333_000, 333_000, 444_000)


def dense_allen_cahn_system() -> PDESystem:
    """`allen_cahn_system` with bench's dense boundary conditions: the
    initial condition, ``u(-1, t) = u(1, t)`` and ``u_x(-1, t) =
    u_x(1, t)`` (a derivative at a fixed coordinate)."""
    x, t = symbols("x t")
    u = DepVar("u")
    Dx = Differential(x)
    eq = Eq(Differential(t)(u(x, t)),
            1e-4 * (Dx ** 2)(u(x, t)) + 5.0 * (u(x, t) - u(x, t) ** 3))
    bcs = [Eq(u(x, 0.0), x ** 2 * cos(np.pi * x)),
           Eq(u(-1.0, t), u(1.0, t)),
           Eq(Dx(u(-1.0, t)), Dx(u(1.0, t)))]
    return PDESystem(eq, bcs, [Domain(x, Interval(-1, 1)),
                               Domain(t, Interval(0, 1))], [x, t], [u(x, t)])


def dense_allen_cahn_problem(causal_eps: float, *, points: int = 8192,
                             bcs_points: int = 1024, n_slabs: int = 32,
                             hidden: int = 64, depth: int = 4,
                             dtype=torch.float32, device="cuda",
                             init_params=None):
    """One stage of `bench.py`'s ``accuracy_dense_full``: the net
    ``Chain(PeriodicEmbedding(2, axis=0, period=2, n_modes=10),
    *mlp([21, 64, 64, 64, 64, 1]).layers)``, ``CausalTraining(8192, t,
    bcs_points=1024, n_slabs=32, causal_eps=eps)``, BC weights (100, 1, 1),
    jet derivatives, true float32 matmuls.  Returns the problem and its
    strategy."""
    system = dense_allen_cahn_system()
    net = Chain(PeriodicEmbedding(2, axis=0, period=2.0, n_modes=10),
                *mlp([21, *([hidden] * depth), 1], dtype=dtype).layers)
    strategy = CausalTraining(points, system.ivs[1], bcs_points=bcs_points,
                              n_slabs=n_slabs, causal_eps=causal_eps)
    prob = discretize(system, PhysicsInformedNN(
        net, strategy, derivative="jet", dtype=dtype, device=device,
        init_params=init_params,
        adaptive_loss=NonAdaptiveLoss(bc_loss_weights=[100.0, 1.0, 1.0])))
    return prob, strategy


def dense_allen_cahn_rel_l2(prob, theta: dict) -> float:
    """rel L2 of a dense Allen-Cahn solution against the spectral reference
    on its 512 x 101 grid."""
    xg, ts, U = allen_cahn_ground_truth()
    X, T = np.meshgrid(xg, ts, indexing="ij")
    with torch.no_grad(), matmul_precision("highest"):
        got = prob.pinnrep.phi(np.stack([X.ravel(), T.ravel()]),
                               depvar_params(theta))[0]
    got = got.double().cpu().numpy()
    want = U.T.reshape(-1)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def dense_allen_cahn(iters_per_stage=DENSE_AC_ITERS, *, device="cuda",
                     inner_steps: int = 500, checkpoint_dir: str | None = None,
                     checkpoint_every: int = 10_000, **kw) -> dict:
    """`bench.py`'s ``accuracy_dense_full``: Adam through the causal stages
    of `DENSE_AC_STAGES` in turn, each from the last one's parameters,
    ``iters_per_stage`` steps each in blocks of ``inner_steps`` (a shorter
    ``iters_per_stage`` runs the first stages only).  Returns
    ``{"rel_l2", "seconds", "per_stage": [{"stage", "eps", "iters",
    "rel_l2", "seconds", "last_weight", "loss"}, ...]}``.

    ``checkpoint_dir`` gives each stage's `solve` a checkpoint directory,
    ``<checkpoint_dir>/stage<k>``, saved every ``checkpoint_every`` steps:
    run again, the recipe takes a finished stage's parameters from its
    checkpoint and resumes an unfinished one where it stopped, drawing the
    points of a run that never stopped.  A stage's ``seconds`` and
    ``loss`` are this run's (``loss`` None for a stage finished before)."""
    theta, per_stage = None, []
    t0 = time.perf_counter()
    for k, ((eps, lr), iters) in enumerate(
            zip(DENSE_AC_STAGES, iters_per_stage), start=1):
        ts = time.perf_counter()
        prob, strategy = dense_allen_cahn_problem(eps, device=device, **kw)
        if theta is not None:
            prob = prob.with_params(theta)
        res = solve(prob, adam(lr), maxiters=iters, inner_steps=inner_steps,
                    checkpoint_dir=(None if checkpoint_dir is None
                                    else f"{checkpoint_dir}/stage{k}"),
                    checkpoint_every=checkpoint_every)
        theta = res.u
        _synchronize(prob)
        seconds = time.perf_counter() - ts
        with torch.no_grad():
            last = float(strategy.causal_weights(theta)[0][-1])
        per_stage.append({"stage": k, "eps": eps, "iters": res.iterations,
                          "rel_l2": dense_allen_cahn_rel_l2(prob, theta),
                          "seconds": seconds, "last_weight": last,
                          "loss": res.objective})
    return {"rel_l2": per_stage[-1]["rel_l2"],
            "seconds": time.perf_counter() - t0, "per_stage": per_stage}


def _synchronize(prob) -> None:
    if prob.pinnrep.device.type == "cuda":
        torch.cuda.synchronize()


def poisson_2d_system() -> PDESystem:
    """`bench.py`'s dense problem: ``u_xx + u_yy = -sin(pi x) sin(pi y)``
    on the unit square, ``u = 0`` on its four sides."""
    x, y = symbols("x y")
    u = DepVar("u")
    eq = Eq((Differential(x) ** 2)(u(x, y)) + (Differential(y) ** 2)(u(x, y)),
            -sin(np.pi * x) * sin(np.pi * y))
    bcs = [Eq(u(0.0, y), 0.0), Eq(u(1.0, y), 0.0),
           Eq(u(x, 0.0), 0.0), Eq(u(x, 1.0), 0.0)]
    return PDESystem(eq, bcs, [Domain(x, Interval(0, 1)),
                               Domain(y, Interval(0, 1))], [x, y], [u(x, y)])


def poisson_rms(prob, theta: dict) -> float:
    """RMS error of a dense Poisson solution on `bench.py`'s 51^2 grid
    against sin(pi x) sin(pi y) / (2 pi^2)."""
    xs = np.linspace(0, 1, 51)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    with torch.no_grad(), matmul_precision("highest"):
        got = prob.pinnrep.phi(np.stack([X.ravel(), Y.ravel()]),
                               depvar_params(theta))[0]
    want = np.sin(np.pi * X) * np.sin(np.pi * Y) / (2 * np.pi ** 2)
    got = got.double().cpu().numpy().reshape(51, 51)
    return float(np.sqrt(np.mean((got - want) ** 2)))


def _hard_box(c, o):
    """x(1-x) y(1-y) o: zero on the unit square's boundary."""
    return c[0:1] * (1 - c[0:1]) * c[1:2] * (1 - c[1:2]) * o


def _adam_to_l2(prob, target: float, max_seconds: float, warm: int,
                chunk: int = 500, rms=poisson_rms) -> dict:
    """Adam(2e-3) in solves of ``chunk`` steps (blocks of 100) until
    ``rms(prob, theta)`` is below ``target`` or ``max_seconds`` have passed,
    after an untimed solve of ``warm`` steps."""
    solve(prob, adam(2e-3), maxiters=warm, inner_steps=min(100, warm))
    _synchronize(prob)
    theta, it, trace = prob.init_params, 0, []
    t0 = time.perf_counter()
    while True:
        theta = solve(prob.with_params(theta), adam(2e-3), maxiters=chunk,
                      inner_steps=100).u
        it += chunk
        err = rms(prob, theta)
        trace.append((it, err, time.perf_counter() - t0))
        if err < target or trace[-1][2] > max_seconds:
            break
    return {"seconds": trace[-1][2] if err < target else None,
            "iterations": it, "rms": err, "trace": trace}


def time_to_l2(target: float = 1e-3, max_seconds: float = 120.0, *,
               device="cuda") -> dict:
    """`bench.py`'s ``time_to_l2``: ``mlp([2, 64, 64, 1])`` with the four
    boundary losses, ``StochasticTraining(8192, bcs_points=1024)``, jet,
    Adam(2e-3) in solves of 500 steps (blocks of 100) until the RMS error on
    the 51^2 grid is below ``target``.  One untimed solve of 50 steps warms
    up.  Returns ``{"seconds" (None if the cap was hit), "iterations",
    "rms", "trace": [(iterations, rms, seconds), ...]}``."""
    prob = discretize(poisson_2d_system(), PhysicsInformedNN(
        mlp([2, 64, 64, 1]), StochasticTraining(8192, bcs_points=1024),
        derivative="jet", device=device))
    return _adam_to_l2(prob, target, max_seconds, warm=50)


def time_to_l2_hard(target: float = 1e-3, max_seconds: float = 60.0, *,
                    points: int = 8192, device="cuda", seed: int = 0) -> dict:
    """`bench.py`'s ``time_to_l2_hard``: ``Transformed(mlp([2, 64, 64, 1]),
    x(1-x)y(1-y)·o)``, ``StochasticTraining(8192, bcs_points=1024)``, jet,
    Adam(2e-3) in solves of 500 steps (blocks of 100) until the RMS error on
    the 51^2 grid is below ``target``.  One untimed solve warms up.
    Returns ``{"seconds" (None if the cap was hit), "iterations", "rms",
    "trace": [(iterations, rms, seconds), ...]}``."""
    net = Transformed(mlp([2, 64, 64, 1]), _hard_box)
    prob = discretize(poisson_2d_system(), PhysicsInformedNN(
        net, StochasticTraining(points, bcs_points=points // 8),
        derivative="jet", device=device, seed=seed))
    return _adam_to_l2(prob, target, max_seconds, warm=500)


def time_to_l2_hybrid(target: float = 1e-3, max_seconds: float = 120.0, *,
                      points: int = 8192, grid_dx: float = 1.0 / 127.0,
                      adam_iters: int = 4000, device="cuda",
                      seed: int = 0) -> dict:
    """`bench.py`'s ``time_to_l2_hybrid``: Adam(2e-3) for ``adam_iters``
    steps on ``StochasticTraining(8192, bcs_points=1024)``, then L-BFGS in
    solves of 500 steps on ``GridTraining(1/127)`` until the RMS error on
    the 51^2 grid is below ``target``; ``mlp([2, 64, 64, 1])``, jet.  One
    untimed Adam and one L-BFGS solve warm up.  Returns ``{"seconds" (None
    if the cap was hit), "iterations", "rms", "adam_seconds",
    "lbfgs_ms_per_step", "trace"}``; the L-BFGS steps (`lbfgs`, optax's
    rule) replay a captured CUDA graph on the card, each 500-step solve
    from a fresh memory and with a capture of its own."""
    system = poisson_2d_system()
    prob = discretize(system, PhysicsInformedNN(
        mlp([2, 64, 64, 1]), StochasticTraining(points, bcs_points=points // 8),
        derivative="jet", device=device, seed=seed))
    prob_g = discretize(system, PhysicsInformedNN(
        mlp([2, 64, 64, 1]), GridTraining(grid_dx), derivative="jet",
        device=device))
    r = solve(prob, adam(2e-3), maxiters=100, inner_steps=100)
    solve(prob_g.with_params(r.u), lbfgs(), maxiters=100, inner_steps=100)
    _synchronize(prob)
    t0 = time.perf_counter()
    theta = solve(prob, adam(2e-3), maxiters=adam_iters, inner_steps=100).u
    _synchronize(prob)
    adam_seconds = time.perf_counter() - t0
    it, trace, lbfgs_seconds = adam_iters, [], 0.0
    trace.append((it, poisson_rms(prob, theta), adam_seconds))
    while True:
        ts = time.perf_counter()
        theta = solve(prob_g.with_params(theta), lbfgs(), maxiters=500,
                      inner_steps=100).u
        _synchronize(prob)
        lbfgs_seconds += time.perf_counter() - ts
        it += 500
        rms = poisson_rms(prob, theta)
        trace.append((it, rms, time.perf_counter() - t0))
        if rms < target or trace[-1][2] > max_seconds:
            break
    return {"seconds": trace[-1][2] if rms < target else None,
            "iterations": it, "rms": rms, "adam_seconds": adam_seconds,
            "lbfgs_ms_per_step": 1e3 * lbfgs_seconds / (it - adam_iters),
            "trace": trace}


def time_to_l2_spinn(target: float = 1e-3, max_seconds: float = 60.0, *,
                     device="cuda") -> dict:
    """`bench.py`'s ``time_to_l2_spinn``: `poisson_spinn` on the 128^2
    grid (rank 64, hard constraints), Adam(2e-3) in solves of 100 steps
    until the RMS error of ``net.grid`` on the 51^2 grid is below
    ``target``.  One untimed solve of 100 steps warms up.  Returns
    ``{"seconds" (None if the cap was hit), "iterations", "rms",
    "trace"}``."""
    prob, net = poisson_spinn(128, device=device)
    xs = np.linspace(0, 1, 51)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    want = np.sin(np.pi * X) * np.sin(np.pi * Y) / (2 * np.pi ** 2)

    def rms(prob, theta):
        nodes = torch.tensor(xs, dtype=torch.float32, device=device)
        with torch.no_grad(), matmul_precision("highest"):
            got = net.grid(depvar_params(theta), [nodes, nodes])
        got = got.double().cpu().numpy()
        return float(np.sqrt(np.mean((got - want) ** 2)))

    return _adam_to_l2(prob, target, max_seconds, warm=100, chunk=100,
                       rms=rms)


# ---------------------------------------------------------------------------
# Trial-function zoo and weak forms: the problems that `chip_smoke.py` runs
# at full width and the parity tests at a small one
# ---------------------------------------------------------------------------

TWO_SCALE = (1.0, 25.0)        # the slow and the fast frequency of the ODE


def two_scale_ode(net, *, dx: float = 4 * np.pi / 1200, device="cuda"):
    """Part 1 of `examples/fbpinn_multiscale.py`: ``u' = w1 cos(w1 x) + w2
    cos(w2 x)`` on [-2 pi, 2 pi] (50 fast periods), ``u(0) = 0`` through the
    ansatz ``tanh(w2 x) * net``, `GridTraining` (1201 nodes).  ``net`` is
    the trial function under the ansatz, e.g. `two_scale_fbpinn()`."""
    w1, w2 = TWO_SCALE
    lo, hi = -2 * np.pi, 2 * np.pi
    x = symbols("x")
    u = DepVar("u")
    system = PDESystem(
        [Eq(Differential(x)(u(x)), w1 * cos(w1 * x) + w2 * cos(w2 * x))],
        [Eq(u(0.0), 0.0)], [Domain(x, Interval(lo, hi))], ivs=[x], dvs=[u(x)])
    hard = Transformed(net, lambda c, out: torch.tanh(w2 * c[0:1]) * out)
    return discretize(system, PhysicsInformedNN(
        hard, GridTraining(dx), dtype=torch.float32, device=device,
        matmul_precision="highest"))


def two_scale_fbpinn(subdivisions: int = 50):
    return FBPINN([(-2 * np.pi, 2 * np.pi)], subdivisions=subdivisions,
                  hidden=(16,))


def two_scale_rel_l2(prob, theta: dict, n: int = 4001) -> float:
    """rel L2 against ``sin(w1 x) + sin(w2 x)`` on ``n`` points."""
    w1, w2 = TWO_SCALE
    g = np.linspace(-2 * np.pi, 2 * np.pi, n)
    with torch.no_grad(), matmul_precision("highest"):
        got = prob.pinnrep.phi(g[None, :], depvar_params(theta))[0]
    want = np.sin(w1 * g) + np.sin(w2 * g)
    return _rel_l2(got, want)


def _rel_l2(got: torch.Tensor, want: np.ndarray) -> float:
    got = got.detach().double().cpu().numpy().reshape(-1)
    want = want.reshape(-1)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def multiscale_laplace(L: int = 4, *, dx: float = 1 / 128, device="cuda",
                       net=None, strategy=None):
    """Part 2 of `examples/fbpinn_multiscale.py`: ``-Lap u = f`` on the unit
    square with ``u = (1/L) sum_l sin(2^l pi x) sin(2^l pi y)``, l = 1..L,
    a multilevel `FBPINN` (levels of 1, 2, ..., 2^L subdomains per axis,
    hidden width 16; or ``net``) under the hard constraint ``16 x(1-x)
    y(1-y) * net``, `GridTraining` (129^2 nodes at L = 4; or
    ``strategy``), Taylor-mode derivatives, true float32 matmuls."""
    omegas = [2.0 ** l for l in range(1, L + 1)]
    x, y = symbols("x y")
    u = DepVar("u")
    lap = (Differential(x) ** 2)(u(x, y)) + (Differential(y) ** 2)(u(x, y))
    f = sum((2 * (w * np.pi) ** 2 / L) * sin(w * np.pi * x)
            * sin(w * np.pi * y) for w in omegas)
    system = PDESystem(
        [Eq(-lap, f)],
        [Eq(u(0.0, y), 0.0), Eq(u(1.0, y), 0.0),
         Eq(u(x, 0.0), 0.0), Eq(u(x, 1.0), 0.0)],
        [Domain(x, Interval(0, 1)), Domain(y, Interval(0, 1))],
        ivs=[x, y], dvs=[u(x, y)])
    if net is None:
        net = FBPINN([(0, 1), (0, 1)], levels=[2 ** l for l in range(L + 1)],
                     hidden=(16,))
    net = Transformed(
        net, lambda c, out: 16.0 * c[0:1] * (1 - c[0:1]) * c[1:2]
        * (1 - c[1:2]) * out)
    return discretize(system, PhysicsInformedNN(
        net, strategy or GridTraining(dx), derivative="jet",
        dtype=torch.float32, device=device, matmul_precision="highest"))


def multiscale_laplace_rel_l2(prob, theta: dict, L: int = 4,
                              n: int = 257) -> float:
    g = np.linspace(0, 1, n)
    X, Y = np.meshgrid(g, g, indexing="ij")
    want = sum(np.sin(2.0 ** l * np.pi * X) * np.sin(2.0 ** l * np.pi * Y)
               for l in range(1, L + 1)) / L
    with torch.no_grad(), matmul_precision("highest"):
        got = prob.pinnrep.phi(np.stack([X.ravel(), Y.ravel()]),
                               depvar_params(theta))[0]
    return _rel_l2(got, want)


FRONT = (60.0, 0.7)            # steepness and position of the tanh front
FRONT_MESH = dict(elements=8, n_test=8, quad=12)   # 96 nodes an axis


def front_system(S: float = FRONT[0], X0: float = FRONT[1]) -> PDESystem:
    """The front problem of `scripts/measure_weak_accuracy_tpu.py`:
    ``Lap u = f`` on the unit square with ``u = tanh(S (x - X0)) sin(pi
    y)`` and its values on the four sides."""
    x, y = symbols("x y")
    u = DepVar("u")

    def th(e):
        return tanh(S * (e - X0))

    f = ((-2 * S ** 2) * th(x) * (1.0 - th(x) ** 2) * sin(np.pi * y)
         - np.pi ** 2 * th(x) * sin(np.pi * y))
    eq = Eq((Differential(x) ** 2)(u(x, y)) + (Differential(y) ** 2)(u(x, y)),
            f)
    bcs = [Eq(u(0.0, y), float(np.tanh(-S * X0)) * sin(np.pi * y)),
           Eq(u(1.0, y), float(np.tanh(S * (1 - X0))) * sin(np.pi * y)),
           Eq(u(x, 0.0), 0.0), Eq(u(x, 1.0), 0.0)]
    return PDESystem(eq, bcs, [Domain(x, Interval(0, 1)),
                               Domain(y, Interval(0, 1))], [x, y], [u(x, y)])


def front_discretization(strategy, *, device="cuda") -> PhysicsInformedNN:
    """That script's discretization: ``mlp([2, 64, 64, 1])``, jet, float32,
    seed 0."""
    return PhysicsInformedNN(mlp([2, 64, 64, 1]), strategy, derivative="jet",
                             dtype=torch.float32, device=device)


def front_rel_l2(phi, theta: dict, n: int = 201, S: float = FRONT[0],
                 X0: float = FRONT[1]) -> float:
    xs = np.linspace(0, 1, n)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    with torch.no_grad(), matmul_precision("highest"):
        got = phi(np.stack([X.ravel(), Y.ravel()]), depvar_params(theta))[0]
    return _rel_l2(got, np.tanh(S * (X - X0)) * np.sin(np.pi * Y))


def poisson_1d_system() -> PDESystem:
    """``u'' = -pi^2 sin(pi x)`` on [0, 1], ``u(0) = u(1) = 0``: sin(pi x)."""
    x = symbols("x")
    u = DepVar("u")
    return PDESystem(Eq((Differential(x) ** 2)(u(x)),
                        -np.pi ** 2 * sin(np.pi * x)),
                     [Eq(u(0.0), 0.0), Eq(u(1.0), 0.0)],
                     [Domain(x, Interval(0, 1))], [x], [u(x)])


def poisson_1d_rel_l2(phi, theta: dict, n: int = 201) -> float:
    xs = np.linspace(0, 1, n)
    with torch.no_grad(), matmul_precision("highest"):
        got = phi(xs[None, :], depvar_params(theta))[0]
    return _rel_l2(got, np.sin(np.pi * xs))


def poisson_2d_rel_l2(phi, theta: dict, n: int = 21,
                      scale: float = 1 / (2 * np.pi ** 2)) -> float:
    """rel L2 against ``scale * sin(pi x) sin(pi y)`` on an n x n grid."""
    xs = np.linspace(0, 1, n)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    with torch.no_grad(), matmul_precision("highest"):
        got = phi(np.stack([X.ravel(), Y.ravel()]), depvar_params(theta))[0]
    return _rel_l2(got, scale * np.sin(np.pi * X) * np.sin(np.pi * Y))


def burgers_system(nu: float, ic, left, right, x_span=(0.0, 1.0)):
    """Viscous Burgers ``u_t + u u_x = nu u_xx`` on ``x_span`` x [0, 1] with
    ``u(x, 0) = ic(x)`` and ``u = left(t)``, ``right(t)`` at the ends."""
    x, t = symbols("x t")
    u = DepVar("u")
    Dt, Dx = Differential(t), Differential(x)
    eq = Eq(Dt(u(x, t)) + u(x, t) * Dx(u(x, t)), nu * (Dx ** 2)(u(x, t)))
    a, b = (float(v) for v in x_span)
    bcs = [Eq(u(x, 0.0), ic(x)), Eq(u(a, t), left(t)), Eq(u(b, t), right(t))]
    return PDESystem(eq, bcs, [Domain(x, Interval(a, b)),
                               Domain(t, Interval(0, 1))], [x, t], [u(x, t)])


def burgers_dgm_example() -> PDESystem:
    """`examples/burgers_dgm.py`'s system: nu = 0.05 on [-1, 1], ``u(x, 0) =
    -sin(pi x)``, zero at both ends."""
    return burgers_system(0.05, lambda x: -sin(np.pi * x), lambda t: 0.0,
                          lambda t: 0.0, (-1.0, 1.0))


WAVE = (0.2, 1.0, 0.5)         # nu, c, a of the travelling wave


def burgers_wave_exact(xe, te, lib=np):
    """``c - a tanh(a (x - c t) / 2 nu)``, an exact solution of Burgers."""
    nu, c, a = WAVE
    return c - a * lib.tanh(a / (2 * nu) * (xe - c * te))


def burgers_wave_system() -> PDESystem:
    """The travelling-wave problem of the JAX package's DGM test."""
    import neuralpde_tpu_torch as lib

    return burgers_system(WAVE[0], lambda x: burgers_wave_exact(x, 0.0, lib),
                          lambda t: burgers_wave_exact(0.0, t, lib),
                          lambda t: burgers_wave_exact(1.0, t, lib))


def burgers_wave_max_error(phi, theta: dict, n: int = 21) -> float:
    xs = np.linspace(0, 1, n)
    X, T = np.meshgrid(xs, xs, indexing="ij")
    with torch.no_grad(), matmul_precision("highest"):
        got = phi(np.stack([X.ravel(), T.ravel()]), depvar_params(theta))[0]
    got = got.double().cpu().numpy()
    return float(np.max(np.abs(got - burgers_wave_exact(X, T).ravel())))


def ritz_poisson_2d(strategy, *, sizes=(2, 32, 32, 1), device="cuda"):
    """The JAX package's hard-constrained Deep Ritz test problem: ``-Lap u =
    2 pi^2 sin(pi x) sin(pi y)`` on the unit square as the energy ``1/2
    |grad u|^2 - f u`` with exact boundary values and no penalty term; the
    minimizer is ``sin(pi x) sin(pi y)``."""
    x, y = symbols("x y")
    u = DepVar("u")
    Dx, Dy = Differential(x), Differential(y)
    f = 2 * np.pi ** 2 * sin(np.pi * x) * sin(np.pi * y)
    energy = 0.5 * (Dx(u(x, y)) ** 2 + Dy(u(x, y)) ** 2) - f * u(x, y)
    system = PDESystem([], [], [Domain(x, Interval(0, 1)),
                                Domain(y, Interval(0, 1))], [x, y], [u(x, y)])
    alg = DeepRitz(Transformed(mlp(list(sizes)), _hard_box), energy,
                   strategy=strategy, dtype=torch.float32, device=device,
                   seed=1)
    return discretize_ritz(system, alg)


# ---------------------------------------------------------------------------
# Operator problems (PINOPDE): the Navier-Stokes vorticity family of
# examples/ns_vorticity_pino.py with the evaluation protocol of
# scripts/measure_ns_operator_tpu.py, and the heat family of the PINOPDE
# tests.  numpy copies: the example and the script import JAX.
# ---------------------------------------------------------------------------

NS = dict(nu=0.02, sigma=3.0, length_scale=0.25, tmax=0.5)
NS_EVAL = dict(key=4242, n=8, nodes=65)     # the protocol's held-out ICs
NS_EVAL_ICS = "ns_eval_ics.npy"             # (65, 65, 8) float32, beside this file


def ns_stream_scale(sigma=NS["sigma"], length_scale=NS["length_scale"]):
    """The stream-function rescaling s that keeps both operator outputs
    O(1) (examples/ns_vorticity_pino.py)."""
    return sigma * (length_scale / (2 * np.pi)) ** 2 * 10


def ns_vorticity_system(nu=NS["nu"], s=None, tmax=NS["tmax"]):
    """Vorticity-streamfunction Navier-Stokes on the periodic unit torus:

        w_t + s (psi_y w_x - psi_x w_y) = nu (w_xx + w_yy)
        s (psi_xx + psi_yy) + w = 0,    w(x, y, 0) = w0(x, y)

    with periodic pairs for w and psi.  Returns ``(system, w0(x, y))``;
    ``w0`` is the input function."""
    s = ns_stream_scale() if s is None else s
    x, y, t = symbols("x y t")
    w, psi, w0 = DepVar("w"), DepVar("psi"), DepVar("w0")
    Dt, Dx, Dy = Differential(t), Differential(x), Differential(y)
    Dxx, Dyy = Differential(x) ** 2, Differential(y) ** 2
    W, PSI = w(x, y, t), psi(x, y, t)
    eqs = [Eq(Dt(W) + s * (Dy(PSI) * Dx(W) - Dx(PSI) * Dy(W)),
              nu * (Dxx(W) + Dyy(W))),
           Eq(s * (Dxx(PSI) + Dyy(PSI)) + W, 0.0)]
    bcs = [Eq(w(x, y, 0.0), w0(x, y))]
    for f in (w, psi):
        bcs += [Eq(f(0.0, y, t), f(1.0, y, t)),
                Eq(Dx(f(0.0, y, t)), Dx(f(1.0, y, t))),
                Eq(f(x, 0.0, t), f(x, 1.0, t)),
                Eq(Dy(f(x, 0.0, t)), Dy(f(x, 1.0, t)))]
    system = PDESystem(eqs, bcs,
                       [Domain(x, Interval(0, 1)), Domain(y, Interval(0, 1)),
                        Domain(t, Interval(0, tmax))],
                       ivs=[x, y, t], dvs=[W, PSI])
    return system, w0(x, y)


def zero_mean_grf(length_scale=NS["length_scale"],
                  variance=NS["sigma"] ** 2):
    """GRF vorticity sampler with zero mean (mean vorticity has no stream
    function on the torus), over the nodes without the wrap nodes."""
    from .solvers.pino_pde import GaussianRandomField

    grf = GaussianRandomField(length_scale=length_scale, variance=variance)

    def sampler(generator, axis_grids, n):
        f = grf(generator, axis_grids, n)
        return f - torch.mean(f[:-1, :-1, :], dim=(0, 1))

    return sampler


def ns_gauge(fields, theta):
    """The additional loss that pins the periodic Poisson equation's
    gauge (psi + const): the per-slice mean of psi."""
    return 10.0 * torch.mean(torch.mean(fields["psi"], dim=(0, 1)) ** 2)


def reference_ns_vorticity(w0, nu, ts, n=128, substeps=16):
    """Pseudo-spectral 2-D vorticity solver on [0,1)^2
    (examples/ns_vorticity_pino.py): ``w0`` (X, Y) on a uniform grid with
    both endpoints; returns (X, Y, T) at the input nodes for uniformly
    spaced ``ts`` (integrating-factor RK4, 2/3-rule dealiasing)."""
    m = w0.shape[0] - 1
    wh = np.fft.rfft2(w0[:-1, :-1])
    vh = np.zeros((n, n // 2 + 1), dtype=complex)
    half = min(m, n) // 2
    vh[:half, :half + 1] = wh[:half, :half + 1]
    vh[-half:, :half + 1] = wh[-half:, :half + 1]
    vh *= (n / m) ** 2

    kx = 2 * np.pi * np.fft.fftfreq(n, d=1.0 / n)[:, None]
    ky = 2 * np.pi * np.fft.rfftfreq(n, d=1.0 / n)[None, :]
    k2 = kx**2 + ky**2
    k2_inv = np.where(k2 > 0, 1.0 / np.where(k2 > 0, k2, 1.0), 0.0)
    kcut = (2 / 3) * np.pi * n
    dealias = (np.abs(kx) <= kcut) & (np.abs(ky) <= kcut)
    dt = (ts[1] - ts[0]) / substeps
    E = np.exp(-nu * k2 * dt / 2)
    E2 = E * E

    def rhs(v):
        ph = v * k2_inv                       # psi_hat (Delta psi = -w)
        u = np.fft.irfft2(1j * ky * ph, s=(n, n))      # u = psi_y
        vvel = np.fft.irfft2(-1j * kx * ph, s=(n, n))  # v = -psi_x
        wx = np.fft.irfft2(1j * kx * v, s=(n, n))
        wy = np.fft.irfft2(1j * ky * v, s=(n, n))
        return -np.fft.rfft2(u * wx + vvel * wy) * dealias * dt

    out = []
    idx = np.round(np.linspace(0, n, m + 1)).astype(int) % n
    v = vh
    for i in range(len(ts)):
        if i > 0:
            for _ in range(substeps):
                a = rhs(v)
                b = rhs(E * (v + a / 2))
                c = rhs(E * v + b / 2)
                d = rhs(E2 * v + E * c)
                v = E2 * v + (E2 * a + 2 * E * (b + c) + d) / 6
        w = np.fft.irfft2(v, s=(n, n))
        out.append(w[np.ix_(idx, idx)])
    return np.stack(out, axis=-1)            # (X, Y, T)


def spectral_downsample(f, m_out):
    """(M+1, M+1) periodic field (wrap nodes included) -> (m_out+1,
    m_out+1) by Fourier truncation, exact for band-limited fields
    (scripts/measure_ns_operator_tpu.py)."""
    m_in = f.shape[0] - 1
    if m_in == m_out:
        return f
    fh = np.fft.rfft2(f[:-1, :-1])
    out = np.zeros((m_out, m_out // 2 + 1), dtype=complex)
    h = m_out // 2
    out[:h, :h + 1] = fh[:h, :h + 1]
    out[-h:, :h + 1] = fh[-h:, :h + 1]
    g = np.fft.irfft2(out, s=(m_out, m_out)) * (m_out / m_in) ** 2
    g = np.concatenate([g, g[:1]], axis=0)
    return np.concatenate([g, g[:, :1]], axis=1)


def ns_eval_ics() -> np.ndarray:
    """The protocol's 8 held-out initial vorticities on the 65-node grid
    (wrap nodes included), (65, 65, 8): the JAX package's zero-mean GRF
    (l = 0.25, sigma = 3) drawn from key 4242 in float32, kept as a file
    of this package."""
    import os

    return np.load(os.path.join(os.path.dirname(__file__), NS_EVAL_ICS))


def ns_rel_l2(sol, nodes: int, nu=NS["nu"], n_ref: int = 128):
    """Mean and per-IC rel L2 of a trained NS operator's vorticity over
    its space-time grid, on the held-out ICs spectrally downsampled to the
    ``nodes``-node grid, against `reference_ns_vorticity` at ``n_ref``."""
    eval65 = ns_eval_ics().astype(np.float64)
    m = nodes - 1
    test_ic = np.stack([spectral_downsample(eval65[:, :, j], m)
                        for j in range(eval65.shape[-1])], axis=-1)
    pred = sol(input_values={"w0": test_ic}).cpu().numpy()
    ts = sol.grids[2].cpu().numpy().astype(np.float64)
    rels = []
    for j in range(test_ic.shape[-1]):
        want = reference_ns_vorticity(test_ic[:, :, j], nu, ts, n=n_ref)
        got = pred[0, :, :, :, j]
        rels.append(float(np.linalg.norm(got - want)
                          / np.linalg.norm(want)))
    return float(np.mean(rels)), rels


def heat_family_system() -> PDESystem:
    """u_t = nu u_xx on [0, 1]^2 over the parameter nu, u(x, 0) =
    sin(pi x), u(0, t) = u(1, t) = 0: exp(-nu pi^2 t) sin(pi x)
    (the heat family of the PINOPDE tests)."""
    x, t = symbols("x t")
    nu, u = parameters("nu"), DepVar("u")
    eq = Eq(Differential(t)(u(x, t)), nu * (Differential(x) ** 2)(u(x, t)))
    bcs = [Eq(u(x, 0.0), sin(np.pi * x)), Eq(u(0.0, t), 0.0),
           Eq(u(1.0, t), 0.0)]
    return PDESystem(eq, bcs, [Domain(x, Interval(0.0, 1.0)),
                               Domain(t, Interval(0.0, 1.0))],
                     ivs=[x, t], dvs=[u(x, t)], ps=[nu])


def heat_family_rel_l2(sol, ps, n: int = 33) -> float:
    """rel L2 of a heat-family operator at parameters ``ps`` on an n×n grid
    (a finer grid than training: discretization transfer)."""
    g = np.linspace(0, 1, n)
    pred = sol(p=np.asarray(ps)[None, :], grids=[g, g]).cpu().numpy()
    want = (np.exp(-np.asarray(ps)[None, None, :] * np.pi**2
                   * g[None, :, None]) * np.sin(np.pi * g[:, None, None]))
    return float(np.linalg.norm(pred - want) / np.linalg.norm(want))


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dense", action="store_true",
                        help="run the dense causal Allen-Cahn recipe "
                             "(3 stages, 1.11M Adam steps) instead of the "
                             "separable one")
    parser.add_argument("--checkpoint", metavar="DIR",
                        help="with --dense: keep each stage's checkpoints "
                             "in DIR, and resume from them when run again")
    args = parser.parse_args(argv)
    if args.checkpoint and not args.dense:
        parser.error("--checkpoint applies to --dense only")
    if args.dense:
        out = dense_allen_cahn(checkpoint_dir=args.checkpoint)
        print(json.dumps({"allen_cahn_dense": out}))
    else:
        print(json.dumps({"allen_cahn": allen_cahn_rel_l2()}))


if __name__ == "__main__":
    main()
