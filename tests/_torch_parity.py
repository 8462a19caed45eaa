"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same numpy arrays: parameters and points are made
with `numpy.random.default_rng(seed)`, never from either framework's RNG.
The 2-D Poisson problem is the one `bench.py` trains.
"""

import numpy as np


def mlp_params(rng, sizes):
    """JAX-layout parameter tree for `mlp(sizes)`: weight (out, in) drawn
    like glorot_uniform, bias (out, 1) small and non-zero."""
    tree = {}
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        lim = np.sqrt(6.0 / (n_in + n_out))
        tree[f"layer_{i}"] = {
            "weight": rng.uniform(-lim, lim, (n_out, n_in)),
            "bias": rng.uniform(-0.1, 0.1, (n_out, 1)),
        }
    return tree


def poisson_2d(pkg):
    """u_xx + u_yy = -sin(pi x) sin(pi y) on the unit square, u = 0 on the
    boundary, written in either package's symbolic front end."""
    x, y = pkg.symbols("x y")
    u = pkg.DepVar("u")
    dxx = pkg.Differential(x) ** 2
    dyy = pkg.Differential(y) ** 2
    eq = pkg.Eq(dxx(u(x, y)) + dyy(u(x, y)),
                -pkg.sin(np.pi * x) * pkg.sin(np.pi * y))
    bcs = [pkg.Eq(u(0.0, y), 0.0), pkg.Eq(u(1.0, y), 0.0),
           pkg.Eq(u(x, 0.0), 0.0), pkg.Eq(u(x, 1.0), 0.0)]
    return pkg.PDESystem(eq, bcs, [pkg.Domain(x, pkg.Interval(0, 1)),
                                   pkg.Domain(y, pkg.Interval(0, 1))],
                         [x, y], [u(x, y)])


def tree_like(template, rng, scale=0.5):
    """Normal draws (std ``scale``) in the layout of a JAX parameter tree
    (nested dicts and lists of arrays, e.g. ``net.init(key)``)."""
    if isinstance(template, dict):
        return {k: tree_like(v, rng, scale) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [tree_like(v, rng, scale) for v in template]
    return rng.normal(scale=scale, size=template.shape)


def hard(c, o):
    """bench.py's hard constraint: zero at both ends of [0, 1]."""
    return c * (1 - c) * o


def poisson_2d_hard(pkg):
    """`poisson_2d` with no boundary conditions, for hard-constrained trial
    functions (bench.py's SPINN problem)."""
    x, y = pkg.symbols("x y")
    u = pkg.DepVar("u")
    eq = pkg.Eq((pkg.Differential(x) ** 2)(u(x, y))
                + (pkg.Differential(y) ** 2)(u(x, y)),
                -pkg.sin(np.pi * x) * pkg.sin(np.pi * y))
    return pkg.PDESystem(eq, [], [pkg.Domain(x, pkg.Interval(0, 1)),
                                  pkg.Domain(y, pkg.Interval(0, 1))],
                         [x, y], [u(x, y)])


def poisson_1d(pkg):
    """u'' = -pi^2 sin(pi x) on [0, 1], u(0) = u(1) = 0; u = sin(pi x)."""
    x = pkg.symbols("x")
    u = pkg.DepVar("u")
    eq = pkg.Eq((pkg.Differential(x) ** 2)(u(x)),
                -(np.pi ** 2) * pkg.sin(np.pi * x))
    bcs = [pkg.Eq(u(0.0), 0.0), pkg.Eq(u(1.0), 0.0)]
    return pkg.PDESystem(eq, bcs, [pkg.Domain(x, pkg.Interval(0, 1))], [x],
                         [u(x)])


def rel_err(got, want):
    """max |got - want| / max |want| over all entries."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))
