"""The Beltrami SPINN configuration's problem (``configs/spinn-beltrami-
r64.json``), built through the program's public API, and the inputs the
benchmark makes from ``--seed``.

The system is the package's recipe (``examples/beltrami_spinn.py``),
written here with the public API so that the benchmark's problem does not
move with the example: the Ethier-Steinman Beltrami flow (a = d = nu = 1)
on ``[-1, 1]^3 x [0, 1]``, three momentum equations and continuity, three
initial conditions, 18 Dirichlet faces and a pressure gauge.  Each field u,
v, w, p is a `SeparableNet` of four axis nets ``mlp(axis_layers)``.
Initial parameters come from one seeded draw as in `problems`:
Glorot-uniform weights and zero biases, under the benchmark's leaf names
(``u.axis_0.layer_0.weight``).
"""

from __future__ import annotations

import math

import torch

from reference import beltrami, flops_beltrami

FIELDS = beltrami.FIELDS


def counts(problem: dict) -> list:
    """Nodes on the axes x, y, z, t: ``grid`` on each, or one count an
    axis."""
    grid = problem["grid"]
    return [grid] * 4 if isinstance(grid, int) else list(grid)


def dtype_of(problem: dict) -> torch.dtype:
    return getattr(torch, problem["dtype"])


def leaf_shapes(problem: dict) -> dict:
    """``{leaf: shape}``: the 4 x 4 axis nets' layers."""
    layers = problem["axis_layers"]
    out = {}
    for f in FIELDS:
        for a in range(4):
            for i, (m, n) in enumerate(zip(layers, layers[1:])):
                out[f"{f}.axis_{a}.layer_{i}.weight"] = (n, m)
                out[f"{f}.axis_{a}.layer_{i}.bias"] = (n, 1)
    return out


def init_params(problem: dict, seed: int, device) -> dict:
    """Initial parameters in the configuration's dtype from one draw of a
    generator seeded ``seed`` on ``device``."""
    shapes = leaf_shapes(problem)
    sizes = [math.prod(s) for s in shapes.values()]
    dtype = dtype_of(problem)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, dtype=dtype, device=device)
    out = {}
    for (name, shape), part in zip(shapes.items(), flat.split(sizes)):
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = (2 * part.view(shape) - 1) * limit
    return out


def _analytic(npde, x, y, z, t):
    """The analytic (u, v, w, p), symbolically, at numbers or symbols."""
    e, s, c = npde.exp, npde.sin, npde.cos
    a, d = beltrami.A, beltrami.D
    dec = e(-(d ** 2) * t)
    u = -a * (e(a * x) * s(a * y + d * z) + e(a * z) * c(a * x + d * y)) * dec
    v = -a * (e(a * y) * s(a * z + d * x) + e(a * x) * c(a * y + d * z)) * dec
    w = -a * (e(a * z) * s(a * x + d * y) + e(a * y) * c(a * z + d * x)) * dec
    p = (-(a ** 2) / 2.0) * (
        e(2 * a * x) + e(2 * a * y) + e(2 * a * z)
        + 2 * s(a * x + d * y) * c(a * z + d * x) * e(a * (y + z))
        + 2 * s(a * y + d * z) * c(a * x + d * y) * e(a * (z + x))
        + 2 * s(a * z + d * x) * c(a * y + d * z) * e(a * (x + y))
    ) * e(-2 * (d ** 2) * t)
    return u, v, w, p


def system(npde):
    """The four equations and the 22 conditions, in the recipe's order:
    the initial u, v, w; each face (x = -1, 1, y = -1, 1, z = -1, 1) for
    u, v, w; the gauge."""
    x, y, z, t = npde.symbols("x y z t")
    u, v, w, p = (npde.DepVar(f) for f in FIELDS)
    Dt, Dx, Dy, Dz = (npde.Differential(s) for s in (t, x, y, z))
    U, V, W, P = (f(x, y, z, t) for f in (u, v, w, p))

    def lap(F):
        return (Dx ** 2)(F) + (Dy ** 2)(F) + (Dz ** 2)(F)

    nu = beltrami.NU
    eqs = [npde.Eq(Dt(F) + U * Dx(F) + V * Dy(F) + W * Dz(F) + Dp(P),
                   nu * lap(F))
           for F, Dp in ((U, Dx), (V, Dy), (W, Dz))]
    eqs.append(npde.Eq(Dx(U) + Dy(V) + Dz(W), 0.0))
    bcs = [npde.Eq(f(x, y, z, 0.0), g)
           for f, g in zip((u, v, w), _analytic(npde, x, y, z, 0.0))]
    for axis in range(3):
        for value in (-1.0, 1.0):
            at = [x, y, z]
            at[axis] = value
            bcs += [npde.Eq(f(*at, t), g) for f, g in
                    zip((u, v, w), _analytic(npde, *at, t))]
    bcs.append(npde.Eq(p(0.0, 0.0, 0.0, t),
                       _analytic(npde, 0.0, 0.0, 0.0, t)[3]))
    domains = [npde.Domain(s, npde.Interval(*span))
               for s, span in zip((x, y, z, t), beltrami.SPANS)]
    return npde.PDESystem(eqs, bcs, domains, [x, y, z, t], [U, V, W, P])


def bc_weights(problem: dict) -> list:
    """The 22 conditions' weights in `system`'s order."""
    w = problem["bc_loss_weights"]
    return [w["initial"]] * 3 + [w["face"]] * 18 + [w["gauge"]]


def build(npde, problem: dict, params: dict, device):
    """The program's `TrainingProblem` from ``params`` (the benchmark's
    leaves), through ``discretize``: one causal stage on the static grid."""
    init = {k: v.clone() for k, v in params.items()}
    n = counts(problem)
    dx = [(hi - lo) / (k - 1) for k, (lo, hi) in zip(n, beltrami.SPANS)]
    nets = [npde.SeparableNet([npde.mlp(problem["axis_layers"],
                                        dtype=dtype_of(problem),
                                        device=device)
                               for _ in range(4)]) for _ in FIELDS]
    sampling = problem["sampling"]
    strategy = npde.SeparableTraining(dx=dx, causal=sampling["causal"],
                                      causal_eps=sampling["causal_eps"])
    return npde.discretize(system(npde), npde.PhysicsInformedNN(
        nets, strategy, dtype=dtype_of(problem), device=device,
        init_params=init, matmul_precision=None,
        adaptive_loss=npde.NonAdaptiveLoss(
            bc_loss_weights=bc_weights(problem))))


def counted_points(problem: dict) -> int:
    """Points a step at which a residual is evaluated: the interior grid
    once, and each condition's own points (21 three-axis grids and the
    gauge's time nodes)."""
    nx, ny, nz, nt = counts(problem)
    faces = 2 * (ny * nz + nx * nz + nx * ny) * nt
    return nx * ny * nz * nt + 3 * (nx * ny * nz + faces) + nt


def model_flops(problem: dict) -> int:
    """Model FLOPs of one step (`reference.flops_beltrami`)."""
    return flops_beltrami.step_flops(problem["axis_layers"],
                                     problem["rank"], counts(problem))


def follow_reference(problem: dict, params: dict, steps: int,
                     dtype=torch.float64, **fault) -> dict:
    """The reference's ``steps`` first steps from ``params``
    (`reference.beltrami.follow`; ``fault`` is passed on: ``keep`` plants
    one, ``tf32`` makes the control)."""
    return beltrami.follow(params, counts(problem),
                           problem["sampling"]["causal_eps"],
                           problem["optimizer"]["lr"], steps, dtype,
                           node_dtype=dtype_of(problem),
                           weights=problem["bc_loss_weights"], **fault)
