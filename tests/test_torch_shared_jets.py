"""One Taylor pass for all pure partials of one order of one call: the
shared pass (`Directions`, `jet_directions`) against one `jet_series` pass
per direction, the gradients of a Poisson residual through it, and the
engine's `jet_passes` and `jet_terms` counters.

Tolerances: float64 1e-12 and float32 1e-6, relative to the largest |value|
(the shared pass makes the same products on the same operands; only the
sum of the two directions' cotangents of a shared pre-activation reorders a
gradient's additions).
"""

import math

import pytest
import torch

import neuralpde_tpu_torch as tpkg
from _torch_parity import poisson_2d
from neuralpde_tpu_torch.compile import lower as tlower
from neuralpde_tpu_torch.nn import core as tcore
from neuralpde_tpu_torch.nn.kan import kan
from neuralpde_tpu_torch.ops.derivatives import (
    DerivativeEngine, jet_derivative, jet_directions, jet_series,
)

TOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def _rel(got, want):
    got, want = got.detach(), want.detach()
    scale = float(torch.max(torch.abs(want)))
    return float(torch.max(torch.abs(got - want))) / max(scale, 1e-300)


def _box(c, o):
    return c[0:1] * (1 - c[0:1]) * c[1:2] * (1 - c[1:2]) * o


MODULES = {
    "tanh": lambda dt: tcore.mlp([2, 16, 16, 1], dtype=dt),
    "sigmoid": lambda dt: tcore.mlp([2, 16, 16, 1], tcore.sigmoid, dtype=dt),
    "sin": lambda dt: tcore.mlp([2, 16, 16, 1], tcore.sin, dtype=dt),
    "hard_box": lambda dt: tcore.Transformed(
        tcore.mlp([2, 16, 16, 1], dtype=dt), _box),
    "skip": lambda dt: tcore.Chain(
        tcore.Dense(2, 16, tcore.tanh, dtype=dt),
        tcore.SkipConnection(tcore.Dense(16, 16, tcore.tanh, dtype=dt),
                             lambda a, b: a + torch.sin(b)),
        tcore.Dense(16, 1, dtype=dt)),
    "fourier": lambda dt: tcore.mlp([2, 16, 1], fourier_features=4,
                                    dtype=dt),
    "periodic": lambda dt: tcore.Chain(
        tcore.PeriodicEmbedding(2, 1, 1.0, 2),
        tcore.Dense(5, 16, tcore.tanh, dtype=dt),
        tcore.Dense(16, 1, dtype=dt)),
}

CASES = [("tanh", torch.float64, 2), ("tanh", torch.float32, 2),
         ("tanh", torch.float64, 3), ("sigmoid", torch.float64, 2),
         ("sin", torch.float64, 2), ("hard_box", torch.float64, 2),
         ("hard_box", torch.float32, 2), ("skip", torch.float64, 2),
         ("fourier", torch.float64, 2), ("periodic", torch.float64, 2)]


def _trial(name, dtype, seed=0):
    torch.manual_seed(seed)
    net = MODULES[name](dtype)
    return tcore.TrialFunction(net, {k: v.detach().clone()
                                     for k, v in net.named_parameters()})


@pytest.mark.parametrize("name,dtype,order", CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_shared_pass_matches_one_pass_per_direction(name, dtype, order):
    """Primal and every coefficient of each direction's series."""
    u = _trial(name, dtype)
    assert u.has_directions_rule
    x = torch.rand(2, 13, dtype=dtype, generator=torch.Generator()
                   .manual_seed(1))
    zeros = [torch.zeros_like(x)] * (order - 1)
    units = [torch.eye(2, dtype=dtype)[:, v:v + 1].expand_as(x)
             for v in (0, 1)]
    primal, shared = u.taylor_directions(x, [[e] + zeros for e in units])
    assert len(shared) == 2
    for v in (0, 1):
        want = jet_series(u, x, v, order)
        assert _rel(primal, want[0]) < TOL[dtype]
        assert len(shared[v]) == order
        for k in range(order):
            assert _rel(shared[v][k], want[k + 1]) < TOL[dtype]
    got = jet_directions(u, x, [1, 0], order)
    for g, v in zip(got, (1, 0)):
        assert _rel(g, jet_derivative(u, x, v, order)) < TOL[dtype]


def _context(indvars, module, mode="jet"):
    return tlower.LoweringContext(
        depvars=["u"], indvars=indvars,
        dict_depvar_input={"u": list(indvars)}, modules=[module],
        multioutput=False, derivative=DerivativeEngine(mode))


def _theta(module):
    return {f"depvar.{k}": v.detach().clone().requires_grad_(True)
            for k, v in module.named_parameters()}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_poisson_gradients_through_the_shared_pass(dtype):
    """The Poisson residual's loss and its parameter gradients against the
    same residual from one `jet_derivative` pass per term."""
    torch.manual_seed(2)
    net = tcore.mlp([2, 16, 16, 1], dtype=dtype)
    ctx = _context(["x", "y"], net)
    eq = poisson_2d(tpkg).eqs[0]
    res = tpkg.build_residual_function(eq, tpkg.get_argument(eq, ["u"]), ctx)
    cord = torch.rand(2, 29, dtype=dtype,
                      generator=torch.Generator().manual_seed(3))
    theta = _theta(net)
    loss = torch.mean(res(cord, theta) ** 2)
    grads = torch.autograd.grad(loss, list(theta.values()), allow_unused=True)
    assert ctx.derivative.jet_passes == 1

    theta2 = {k: v.detach().clone().requires_grad_(True)
              for k, v in theta.items()}
    u = tcore.TrialFunction(net, tlower.depvar_params(theta2))
    rhs = -torch.sin(math.pi * cord[0]) * torch.sin(math.pi * cord[1])
    sep = (jet_derivative(u, cord, 0, 2) + jet_derivative(u, cord, 1, 2))[0]
    loss2 = torch.mean((sep - rhs) ** 2)
    grads2 = torch.autograd.grad(loss2, list(theta2.values()),
                                 allow_unused=True)
    assert _rel(loss, loss2) < TOL[dtype]
    assert [g is None for g in grads] == [g is None for g in grads2] \
        == [k == "depvar.layer_2.bias" for k in theta]
    for g, w in zip(grads, grads2):
        if g is not None:
            assert _rel(g, w) < TOL[dtype]


def _equation(kind):
    x, y = tpkg.symbols("x y")
    u = tpkg.DepVar("u")
    dx, dy = tpkg.Differential(x), tpkg.Differential(y)
    if kind == "laplacian":
        return ["x", "y"], tpkg.Eq((dx ** 2)(u(x, y)) + (dy ** 2)(u(x, y)),
                                   0.0)
    if kind == "1d":
        return ["x"], tpkg.Eq((dx ** 2)(u(x)), tpkg.sin(x))
    if kind == "mixed":
        return ["x", "y"], tpkg.Eq(dx(dy(u(x, y))), 0.0)
    if kind == "two_calls":
        return ["x", "y"], tpkg.Eq((dx ** 2)(u(x, y)) + (dy ** 2)(u(x, 0.0)),
                                   0.0)
    if kind == "repeated":     # u_xx twice, u_yy and u_xxxx: two passes
        return ["x", "y"], tpkg.Eq(
            (dx ** 2)(u(x, y)) * (dx ** 2)(u(x, y)) + (dy ** 2)(u(x, y))
            + (dx ** 4)(u(x, y)), 0.0)
    raise ValueError(kind)


@pytest.mark.parametrize("kind,module,passes,terms", [
    ("laplacian", "mlp", 1, 2), ("1d", "mlp", 1, 1), ("mixed", "mlp", 0, 0),
    ("two_calls", "mlp", 2, 2), ("repeated", "mlp", 2, 4),
    ("laplacian", "kan", 2, 2)])
def test_engine_counts_passes_and_terms(kind, module, passes, terms):
    """Per evaluation of the residual: the passes run and the terms they
    served; a module without rules for several directions (a KAN) takes
    one pass per direction.  Values equal the terms' own passes."""
    indvars, eq = _equation(kind)
    dim = len(indvars)
    torch.manual_seed(4)
    net = (tcore.mlp([dim, 8, 1], dtype=torch.float64) if module == "mlp"
           else kan([dim, 4, 1], degree=3, dtype=torch.float64))
    ctx = _context(indvars, net)
    args = tpkg.get_argument(eq, ["u"])
    res = tpkg.build_residual_function(
        eq, [a if isinstance(a, tpkg.Sym) else None for a in args], ctx)
    cord = torch.rand(len(args), 11, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(5))
    theta = _theta(net)
    got = res(cord, theta)
    engine = ctx.derivative
    assert (engine.jet_passes, engine.jet_terms) == (passes, terms)
    res(cord, theta)                       # a new evaluation, a new pass
    assert (engine.jet_passes, engine.jet_terms) == (2 * passes, 2 * terms)
    want = tlower._ev(tlower.Call("-", (tlower.expand_derivatives(eq.lhs),
                                        tlower.expand_derivatives(eq.rhs))),
                      {s.name: cord[i] for i, s in enumerate(args)
                       if isinstance(s, tpkg.Sym)},
                      theta, None, ctx, 11)
    assert _rel(got, torch.broadcast_to(want, (11,))) < 1e-12
