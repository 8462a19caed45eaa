"""The cells' problems, built through the program's public API, and the
inputs the benchmark makes from ``--seed``.

A configuration file (`configs/*.json`) names the trial function and its
widths, the sampling, the optimizer and the precision; a workload file
(`workloads/*.json`) may replace the sampling and the learning rate and
turn on the hard box (its ``problem`` key).  Initial parameters are made
here, on the device, from one seeded generator in one draw: Glorot-uniform
weights and zero biases, under the benchmark's own leaf names
(``layer_0.weight``; ``axis_0.layer_0.weight`` for a separable net).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import flops

# the program's name of a leaf is its own under "depvar."
PREFIX = "depvar."


def seeds(seed: int, n: int) -> list:
    """``n`` independent 63-bit seeds derived from ``seed``."""
    state = np.random.SeedSequence(seed).generate_state(n, dtype=np.uint64)
    return [int(s) >> 1 for s in state]


def problem_of(config: dict, workload: dict) -> dict:
    """The problem a cell trains: the configuration with the workload's
    ``problem`` keys laid over it."""
    return {**config, **workload.get("problem", {})}


def leaf_shapes(problem: dict) -> dict:
    """``{leaf: shape}`` of the trial function's parameters."""
    def mlp(layers, prefix=""):
        out = {}
        for i, (a, b) in enumerate(zip(layers, layers[1:])):
            out[f"{prefix}layer_{i}.weight"] = (b, a)
            out[f"{prefix}layer_{i}.bias"] = (b, 1)
        return out

    if problem["trial_function"] == "separable":
        return {**mlp(problem["axis_layers"], "axis_0."),
                **mlp(problem["axis_layers"], "axis_1.")}
    return mlp(problem["layers"])


def init_params(problem: dict, seed: int, device) -> dict:
    """Initial float32 parameters from one draw of a generator seeded
    ``seed`` on ``device``."""
    shapes = leaf_shapes(problem)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, dtype=torch.float32,
                      device=device)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = (2 * part.view(shape) - 1) * limit
    return out


def _hard_box(c, o):
    return c[0:1] * (1 - c[0:1]) * c[1:2] * (1 - c[1:2]) * o


def _hard_unit(c, o):
    return c * (1 - c) * o


def poisson_system(npde, with_bcs: bool):
    """``u_xx + u_yy = -sin(pi x) sin(pi y)`` on the unit square, with the
    four zero sides as boundary conditions or none."""
    x, y = npde.symbols("x y")
    u = npde.DepVar("u")
    eq = npde.Eq((npde.Differential(x) ** 2)(u(x, y))
                 + (npde.Differential(y) ** 2)(u(x, y)),
                 -npde.sin(np.pi * x) * npde.sin(np.pi * y))
    bcs = ([npde.Eq(u(0.0, y), 0.0), npde.Eq(u(1.0, y), 0.0),
            npde.Eq(u(x, 0.0), 0.0), npde.Eq(u(x, 1.0), 0.0)]
           if with_bcs else [])
    return npde.PDESystem(eq, bcs, [npde.Domain(x, npde.Interval(0, 1)),
                                    npde.Domain(y, npde.Interval(0, 1))],
                          [x, y], [u(x, y)])


def build(npde, problem: dict, params: dict, device):
    """The program's `TrainingProblem` of ``problem`` from ``params`` (the
    benchmark's leaves), through ``discretize``."""
    init = {k: v.clone() for k, v in params.items()}
    if problem["trial_function"] == "separable":
        layers = problem["axis_layers"]
        net = npde.SeparableNet([
            npde.Transformed(npde.mlp(layers, device=device), _hard_unit)
            for _ in range(2)])
        strategy = npde.SeparableTraining(dx=1.0 / (problem["grid"] - 1))
        system = poisson_system(npde, with_bcs=False)
    else:
        base = npde.mlp(problem["layers"], device=device)
        net = (npde.Transformed(base, _hard_box) if problem.get("hard_box")
               else base)
        sampling = problem["sampling"]
        strategy = npde.StochasticTraining(
            sampling["points"], bcs_points=sampling["bcs_points"],
            microbatch=sampling.get("microbatch"))
        system = poisson_system(npde, with_bcs=True)
    return npde.discretize(system, npde.PhysicsInformedNN(
        net, strategy, derivative=problem["derivative"], dtype=torch.float32,
        device=device, init_params=init, matmul_precision=None))


def counted_points(problem: dict) -> int:
    """Points a step as the cell counts them: bench's ``batch + 4 *
    (batch // 8)`` interior and boundary points of a dense step (its four
    sides at ``bcs_points`` each), the grid points of a separable one."""
    if problem["trial_function"] == "separable":
        return problem["grid"] ** 2
    sampling = problem["sampling"]
    return sampling["points"] + 4 * sampling["bcs_points"]


def model_flops(problem: dict) -> int:
    """Model FLOPs of one step (`reference.flops`)."""
    if problem["trial_function"] == "separable":
        return flops.separable_step_flops(problem["axis_layers"],
                                          problem["axis_layers"][-1],
                                          problem["grid"])
    sampling = problem["sampling"]
    return flops.dense_step_flops(problem["layers"], sampling["points"],
                                  4 * sampling["bcs_points"])


def follow_reference(problem: dict, params: dict, points_seed: int,
                     steps: int, dtype=torch.float64, **fault) -> dict:
    """The reference's ``steps`` first steps from ``params`` on the points
    of a generator seeded ``points_seed`` (`reference.dense.follow` or
    `reference.spinn.follow`; ``fault`` is passed on to plant one)."""
    lr = problem["optimizer"]["lr"]
    if problem["trial_function"] == "separable":
        from reference import spinn
        return spinn.follow(params, problem["axis_layers"], problem["grid"],
                            lr, steps, dtype, **fault)
    from reference import dense
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device).manual_seed(points_seed)
    sampling = problem["sampling"]
    return dense.follow(params, problem["layers"],
                        bool(problem.get("hard_box")), lr, gen,
                        sampling["points"], sampling["bcs_points"], steps,
                        dtype, **fault)
