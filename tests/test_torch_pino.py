"""Parity of the port's operator solvers with the JAX package:
`solvers/pino.py` (PINOODE's loss and gradient for an FNO, a DeepONet and
an MLP on stacked (p, t), on grid and on injected random train sets, and a
few Adam steps against optax's), `solvers/pino_pde.py` (the PINOPDE loss
and gradient of the Navier-Stokes vorticity system at the JAX test's
downscaled size, with ``spectral_axes`` and with ``causal_eps``, and of a
`DeepONetPDE` heat family; `PINOPDESolution` on a finer grid), the
Gauss-Newton residual vectors of both solvers with their jvp and vjp, and
the validation errors of the JAX tests under the same messages.

Parameters are normal draws from `numpy.random.default_rng(seed)` in the
JAX package's layout; random train sets and the input-function family are
the JAX package's draws handed across as arrays (a sampler passed to
``input_functions`` may be any callable that returns the draws, the
reference's own sampler contract), never a shared seed.

Tolerances (float64): 1e-10 relative for losses, gradients, fields and
residual vectors, except where du/dt is the forward difference of two
network values over sqrt(eps) = 1.5e-8 (DeepONet and MLP PINOODE), whose
last bits it carries up to ~1e-8 of the result: 1e-6 there, as the NNODE
parity tests hold it; 1e-8 for parameters after Adam steps.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import rel_err, tree_like
from neuralpde_tpu import gauss_newton as jgn
from neuralpde_tpu.solvers import pino as jpino
from neuralpde_tpu.solvers import pino_pde as jpde
from neuralpde_tpu.symbolic import expr as JE
from neuralpde_tpu_torch import accuracy
from neuralpde_tpu_torch.solvers import pino as tpino
from neuralpde_tpu_torch.solvers import pino_pde as tpde

sys.path.append(os.path.join(os.path.dirname(__file__), "..", "examples"))

F64 = torch.float64
PI = float(np.pi)


@pytest.fixture(autouse=True)
def float64_default():
    """The solvers work in the default float dtype, as the JAX package's
    do: float64 here, where the test suite turns on JAX's x64."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    yield
    torch.set_default_dtype(before)


def _trees(jchain, seed, scale=0.3):
    """Parameters in the JAX layout: (numpy tree, JAX theta, port flat)."""
    tree = tree_like(jax.eval_shape(jchain.init, jax.random.key(0)),
                     np.random.default_rng(seed), scale)
    return (tree, {"depvar": jax.tree.map(jnp.asarray, tree)},
            {f"depvar.{k}": v.requires_grad_(True) for k, v in
             tpkg.params_from_jax(tree, dtype=F64).items()})


def _value_and_grad(jfun, tfun, jtheta, ttheta):
    """(JAX loss, port loss, max gradient error relative to the largest)."""
    want, jg = jax.jit(jax.value_and_grad(jfun))(jtheta)
    got = tfun(ttheta)
    grads = torch.autograd.grad(got, list(ttheta.values()))
    jflat = {f"depvar.{k}": v for k, v in tpkg.params_from_jax(
        jax.tree.map(np.asarray, jg["depvar"]), dtype=F64).items()}
    scale = max(float(v.abs().max()) for v in jflat.values())
    err = max(float((g - jflat[k]).abs().max()) / scale
              for k, g in zip(ttheta, grads))
    return float(want), float(got.detach()), err


def _ode(xp, vector=False):
    if vector:
        return lambda u, p, t: xp.stack([p[0] * u[0] + u[1],
                                         -p[1] * u[0] + xp.sin(t)])
    return lambda u, p, t: xp.cos(p * t)


def _chains(kind):
    if kind == "fno":
        return (jpkg.FNO1D(1, width=8, modes=4, depth=2),
                tpkg.FNO1D(1, width=8, modes=4, depth=2))
    if kind == "deeponet":
        return (jpkg.DeepONet(jpkg.mlp([1, 8, 8]), jpkg.mlp([1, 8, 8])),
                tpkg.DeepONet(tpkg.mlp([1, 8, 8]), tpkg.mlp([1, 8, 8])))
    return jpkg.mlp([3, 10, 2]), tpkg.mlp([3, 10, 2])


# ------------------------------------------------------------- PINOODE

@pytest.mark.parametrize("kind,train", [("fno", "grid"),
                                        ("deeponet", "grid"),
                                        ("deeponet", "random"),
                                        ("mlp", "random")])
def test_pinoode_loss_and_gradient_match_jax(kind, train):
    vector = kind == "mlp"
    jchain, tchain = _chains(kind)
    u0 = np.array([1.0, 0.5]) if vector else 1.0
    bounds = [(0.1, 2.0), (0.5, 1.5)] if vector else [(0.1, 2.0)]
    jprob = jpkg.ODEProblem(_ode(jnp, vector), u0, (0.0, 1.0))
    tprob = tpkg.ODEProblem(_ode(torch, vector), u0, (0.0, 1.0))
    if train == "grid":
        p, t = jpino._grid_trainset(bounds, 6, (0.0, 1.0), 0.1, jnp.float64)
    else:
        p, t = jpino._stochastic_trainset(jax.random.key(3), bounds, 6,
                                          (0.0, 1.0), 9, jnp.float64)
    tp, tt = torch.tensor(np.asarray(p)), torch.tensor(np.asarray(t))
    _, jtheta, ttheta = _trees(jchain, 1)
    jphi, tphi = jpino.PINOPhi(jchain), tpino.PINOPhi(tchain)
    want, got, gerr = _value_and_grad(
        lambda th: jpino._losses(jphi, jprob, p, t, th),
        lambda th: tpino._losses(tphi, tprob, tp, tt, th), jtheta, ttheta)
    tol = 1e-10 if kind == "fno" else 1e-6
    assert abs(got - want) < tol * abs(want)
    assert gerr < tol


def test_pinoode_grid_train_set_matches_jax():
    p, t = jpino._grid_trainset([(0.1, 2.0)], 7, (0.25, 1.0), 0.05,
                                jnp.float64)
    tp, tt = tpino._grid_trainset([(0.1, 2.0)], 7, (0.25, 1.0), 0.05, F64)
    assert rel_err(tp, p) == 0.0 and rel_err(tt, t) == 0.0
    assert float(tt[0, 0]) == 0.25          # the FNO reads the IC off row 0


def test_solve_pino_ode_adam_steps_match_optax():
    jchain, tchain = _chains("fno")
    tree, _, _ = _trees(jchain, 2)
    kw = dict(bounds=[(0.1, 2.0)], number_of_parameters=5)
    jsol = jpkg.solve_pino_ode(
        jpkg.ODEProblem(_ode(jnp), 1.0, (0.0, 1.0)),
        jpkg.PINOODE(jchain, optax.adam(5e-3), init_params=jax.tree.map(
            jnp.asarray, tree), strategy=jpkg.GridTraining(0.1), **kw),
        maxiters=6, inner_steps=3)
    tsol = tpkg.solve_pino_ode(
        tpkg.ODEProblem(_ode(torch), 1.0, (0.0, 1.0)),
        tpkg.PINOODE(tchain, tpkg.adam(5e-3), init_params=tpkg.params_from_jax(
            tree, dtype=F64), strategy=tpkg.GridTraining(0.1), **kw),
        maxiters=6, inner_steps=3, device="cpu")
    want = tpkg.params_from_jax(jax.tree.map(
        np.asarray, jsol.original.u["depvar"]), dtype=F64)
    for k, v in tpkg.depvar_params(tsol.original.u).items():
        assert rel_err(v, want[k]) < 1e-8, k
    ps, ts = np.linspace(0.2, 1.9, 4)[None], np.linspace(0, 1, 21)[None]
    assert rel_err(tsol(ps, ts), np.asarray(jsol(ps, ts))) < 1e-8
    assert tsol.u.shape == (11, 5)


def test_pinoode_errors_match_jax():
    prob = tpkg.ODEProblem(_ode(torch), 1.0, (0.0, 1.0))
    fno = tpkg.FNO1D(1, width=8, modes=4, depth=2)
    with pytest.raises(ValueError, match="GridTraining"):
        tpkg.solve_pino_ode(prob, tpkg.PINOODE(
            fno, bounds=[(0.1, 2.0)], strategy=tpkg.StochasticTraining(40)),
            maxiters=1, device="cpu")
    with pytest.raises(ValueError, match="bounds"):
        tpkg.solve_pino_ode(prob, tpkg.PINOODE(fno), maxiters=1, device="cpu")
    with pytest.raises(TypeError, match="deterministic PINO train set"):
        tpkg.solve_pino_gauss_newton(prob, tpkg.PINOODE(
            fno, bounds=[(0.1, 2.0)], strategy=tpkg.StochasticTraining(4)),
            device="cpu")
    with pytest.raises(ValueError, match="additional_loss"):
        tpkg.solve_pino_gauss_newton(prob, tpkg.PINOODE(
            fno, bounds=[(0.1, 2.0)], strategy=tpkg.GridTraining(0.1),
            additional_loss=lambda phi, th: 0.0), device="cpu")


# ------------------------------------------------------------- PINOPDE

def _ns(pkg, draws, chain, **kw):
    """The JAX test's downscaled NS operator (tests/test_pino_pde.py:601):
    FNO3D w8 m(4, 4, 3) d2, two family members on a 9 x 9 x 5 grid, with
    the input-function family ``draws`` handed to both packages."""
    if pkg is jpkg:
        import ns_vorticity_pino as nsv

        system, w0 = nsv.build_system(0.02, accuracy.ns_stream_scale(), 0.5)
        sampler = lambda key, grids, n: jnp.asarray(draws)     # noqa: E731
        gauge = lambda f, th: 10.0 * jnp.mean(                  # noqa: E731
            jnp.mean(f["psi"], axis=(0, 1)) ** 2)
    else:
        system, w0 = accuracy.ns_vorticity_system()
        sampler = lambda gen, grids, n: draws                   # noqa: E731
        gauge = accuracy.ns_gauge
    x, y = system.ivs[0], system.ivs[1]
    if kw.pop("spectral", False):
        kw["spectral_axes"] = (x, y)
    alg = pkg.PINOPDE(chain=chain, number_of_parameters=2,
                      input_functions={w0: sampler}, additional_loss=gauge,
                      strategy=pkg.GridTraining([1 / 8, 1 / 8, 0.5 / 4]),
                      **kw)
    return system, alg


def _ns_chains():
    kw = dict(width=8, modes=(4, 4, 3), depth=2, out_channels=2)
    return jpkg.FNO3D(1, **kw), tpkg.FNO3D(1, **kw)


@pytest.mark.parametrize("variant", ["fd", "spectral", "causal"])
def test_pinopde_ns_loss_and_gradient_match_jax(variant):
    draws = np.random.default_rng(4).normal(size=(9, 9, 2))
    jchain, tchain = _ns_chains()
    kw = {"spectral": {"spectral": True},
          "causal": {"causal_eps": 1.0}}.get(variant, {})
    jb = jpde._build(*_ns(jpkg, draws, jchain, **kw))
    tb = tpde._build(*_ns(tpkg, draws, tchain, **kw), device="cpu")
    _, jtheta, ttheta = _trees(jchain, 5)
    want, got, gerr = _value_and_grad(
        lambda th: jb.total_loss(th, jax.random.key(0)),
        lambda th: tb.total_loss(th, None), jtheta, ttheta)
    assert abs(got - want) < 1e-10 * abs(want)
    assert gerr < 1e-10


def _heat(pkg, chain, **kw):
    system = (accuracy.heat_family_system() if pkg is tpkg else
              _jax_heat_system())
    alg = pkg.PINOPDE(chain=chain, bounds=[(0.05, 0.5)],
                      number_of_parameters=4,
                      strategy=pkg.GridTraining(1 / 8), **kw)
    return system, alg


def _jax_heat_system():
    """tests/test_pino_pde.py::_heat_system."""
    E = JE
    x, t = E.Sym("x"), E.Sym("t")
    nu, u = E.Param("nu"), E.DepVar("u")
    eq = E.Eq(E.Deriv(u(x, t), (t,)), nu * E.Deriv(u(x, t), (x, x)))
    bcs = [E.Eq(u(x, E.Num(0.0)), E.sin(E.Num(PI) * x)),
           E.Eq(u(E.Num(0.0), t), E.Num(0.0)),
           E.Eq(u(E.Num(1.0), t), E.Num(0.0))]
    return jpkg.PDESystem(eq, bcs, [jpkg.Domain(x, jpkg.Interval(0.0, 1.0)),
                                    jpkg.Domain(t, jpkg.Interval(0.0, 1.0))],
                          ivs=[x, t], dvs=[u(x, t)], ps=[nu])


def test_pinopde_deeponet_family_matches_jax():
    kw = dict(latent=8, branch_sizes=(8,), trunk_sizes=(8,))
    jchain, tchain = jpkg.DeepONetPDE(1, 2, **kw), tpkg.DeepONetPDE(1, 2, **kw)
    jb = jpde._build(*_heat(jpkg, jchain))
    tb = tpde._build(*_heat(tpkg, tchain), device="cpu")
    _, jtheta, ttheta = _trees(jchain, 6)
    want, got, gerr = _value_and_grad(
        lambda th: jb.total_loss(th, jax.random.key(0)),
        lambda th: tb.total_loss(th, None), jtheta, ttheta)
    assert abs(got - want) < 1e-10 * abs(want)
    assert gerr < 1e-10


def test_pinopde_solution_on_a_finer_grid_matches_jax():
    kw = dict(width=6, modes=3, depth=2)
    jchain, tchain = jpkg.FNO2D(1, **kw), tpkg.FNO2D(1, **kw)
    jb = jpde._build(*_heat(jpkg, jchain))
    tb = tpde._build(*_heat(tpkg, tchain), device="cpu")
    _, jtheta, ttheta = _trees(jchain, 7)
    jsol = jpde._make_solution(jb, jtheta["depvar"], None)
    tsol = tpde._make_solution(tb, {k: v.detach()
                                    for k, v in ttheta.items()}, None)
    assert rel_err(tsol.u, np.asarray(jsol.u)) < 1e-10
    ps, g = np.linspace(0.1, 0.45, 5), np.linspace(0, 1, 17)
    want = np.asarray(jsol(p=ps[None], grids=[g, g]))
    got = tsol(p=ps[None], grids=[g, g])
    assert got.shape == (17, 17, 5) and rel_err(got, want) < 1e-10


# -------------------------------------------------- Gauss-Newton residuals

def _jvp_vjp_check(jr, tr, jtheta0, ttheta0, seed):
    """The residual vector, its jvp along one direction and its vjp of one
    cotangent, against `jax.jvp`/`jax.vjp` on the same arrays."""
    rng = np.random.default_rng(seed)
    tangent = {k: rng.normal(size=tuple(v.shape)) for k, v in ttheta0.items()}
    primal = {k: v.detach() for k, v in ttheta0.items()}
    r, dr = torch.func.jvp(tr, (primal,), ({k: torch.as_tensor(v) for k, v
                                            in tangent.items()},))
    jtan = jax.tree.map(jnp.asarray, tpkg.params_to_numpy(
        {k: torch.as_tensor(v) for k, v in tangent.items()}))
    jr_val, jdr = jax.jit(lambda th, v: jax.jvp(jr, (th,), (v,)))(jtheta0,
                                                                   jtan)
    assert rel_err(r, np.asarray(jr_val)) < 1e-10
    assert rel_err(dr, np.asarray(jdr)) < 1e-10
    cot = rng.normal(size=tuple(r.shape))
    (g,) = torch.func.vjp(tr, primal)[1](torch.as_tensor(cot))
    (jg,) = jax.jit(lambda th, c: jax.vjp(jr, th)[1](c))(jtheta0,
                                                         jnp.asarray(cot))
    jflat = tpkg.params_from_jax(jax.tree.map(np.asarray, jg), dtype=F64)
    scale = max(float(v.abs().max()) for v in jflat.values())
    for k, v in g.items():
        assert float((v - jflat[k]).abs().max()) < 1e-10 * scale, k


def test_pino_residual_vector_and_its_jvp_vjp_match_jax():
    jchain, tchain = _chains("fno")
    tree, _, _ = _trees(jchain, 8)
    kw = dict(bounds=[(0.5, 1.5)], number_of_parameters=4,
              strategy=None)
    jr, jtheta0, _ = jgn.build_pino_residual_vector(
        jpkg.ODEProblem(_ode(jnp), 1.0, (0.0, 1.0)),
        jpkg.PINOODE(jchain, init_params=jax.tree.map(jnp.asarray, tree),
                     **kw), dt=0.1)
    tr, ttheta0, _ = tpkg.build_pino_residual_vector(
        tpkg.ODEProblem(_ode(torch), 1.0, (0.0, 1.0)),
        tpkg.PINOODE(tchain, init_params=tpkg.params_from_jax(tree,
                                                              dtype=F64),
                     **kw), dt=0.1, device="cpu")
    _jvp_vjp_check(jr, tr, jtheta0, ttheta0, 9)


def test_pino_pde_residual_vector_and_its_jvp_vjp_match_jax():
    kw = dict(width=6, modes=3, depth=2)
    jchain, tchain = jpkg.FNO2D(1, **kw), tpkg.FNO2D(1, **kw)
    tree, _, _ = _trees(jchain, 10)
    jr, jtheta0, _ = jgn.build_pino_pde_residual_vector(*_heat(
        jpkg, jchain, init_params=jax.tree.map(jnp.asarray, tree)))
    tr, ttheta0, _ = tpkg.build_pino_pde_residual_vector(*_heat(
        tpkg, tchain, init_params=tpkg.params_from_jax(tree, dtype=F64)),
        device="cpu")
    _jvp_vjp_check(jr, tr, jtheta0, ttheta0, 11)


def test_pino_pde_gauss_newton_rejects_what_jax_rejects():
    tchain = tpkg.FNO2D(1, width=4, modes=2, depth=1)
    for kw, match in [(dict(resample=True), "resample"),
                      (dict(additional_loss=lambda f, th: 0.0),
                       "additional_loss"),
                      (dict(causal_eps=1.0), "causal")]:
        with pytest.raises(ValueError, match=match):
            tpkg.solve_pino_pde_gauss_newton(*_heat(tpkg, tchain, **kw),
                                             maxiters=1, device="cpu")


# ---------------------------------------------------------- validation

def test_pinopde_validation_errors_match_jax():
    """tests/test_pino_pde.py:290, 430 and 682 under the same messages."""
    sysd = accuracy.heat_family_system()
    fno = lambda c=1: tpkg.FNO2D(c, width=8, modes=4, depth=2)  # noqa: E731

    def solve(system, **kw):
        kw.setdefault("strategy", tpkg.GridTraining(0.25))
        return tpkg.solve_pino_pde(system, tpkg.PINOPDE(**kw), maxiters=1,
                                   device="cpu")

    with pytest.raises(ValueError, match="GridTraining"):
        solve(sysd, chain=fno(), bounds=[(0.05, 0.5)],
              strategy=tpkg.StochasticTraining(16))
    with pytest.raises(ValueError, match="one .lb, ub. bound"):
        solve(sysd, chain=fno())
    with pytest.raises(ValueError, match="in_channels"):
        solve(sysd, chain=fno(2), bounds=[(0.05, 0.5)])
    with pytest.raises(ValueError, match="1 independent variable"):
        solve(sysd, chain=tpkg.FNO1D(1, width=8, modes=4, depth=2),
              bounds=[(0.05, 0.5)])
    with pytest.raises(ValueError, match="grid_ndim"):
        solve(sysd, chain=tpkg.DeepONetPDE(1, 3), bounds=[(0.05, 0.5)])
    x, t = tpkg.symbols("x t")
    u, f0, g0 = tpkg.DepVar("u"), tpkg.DepVar("f0"), tpkg.DepVar("g0")
    nop = tpkg.PDESystem(tpkg.Eq(tpkg.Differential(t)(u(x, t)), 0.0), [],
                         [tpkg.Domain(x, tpkg.Interval(0, 1)),
                          tpkg.Domain(t, tpkg.Interval(0, 1))],
                         ivs=[x, t], dvs=[u(x, t)])
    with pytest.raises(ValueError, match="parametric"):
        solve(nop, chain=fno(), bounds=[(0.05, 0.5)])
    grf = tpkg.GaussianRandomField(0.2)
    fam = dict(number_of_parameters=4)
    with pytest.raises(ValueError, match="subset"):
        solve(nop, chain=fno(2), input_functions={g0(t, x): grf}, **fam)
    with pytest.raises(ValueError, match="also a solved depvar"):
        solve(nop, chain=fno(), input_functions={u(x, t): grf}, **fam)
    with pytest.raises(ValueError, match="n_input_functions"):
        solve(nop, chain=fno(2), input_functions={f0(x): grf}, **fam)
    with pytest.raises(ValueError, match="FNO backbone"):
        solve(sysd, chain=tpkg.DeepONetPDE(2, 2), bounds=[(0.05, 0.5)],
              input_functions={f0(x): grf})
    sol = solve(nop, chain=fno(), input_functions={f0(x): grf}, **fam)
    with pytest.raises(ValueError, match="input_values"):
        sol(grids=[np.linspace(0, 1, 9), np.linspace(0, 1, 9)])


def test_operator_entry_points_default_to_cuda():
    """With no ``device`` the entry points build on "cuda" (here, with no
    card, torch refuses)."""
    system, alg = _heat(tpkg, tpkg.FNO2D(1, width=4, modes=2, depth=1))
    prob = tpkg.ODEProblem(_ode(torch), 1.0, (0.0, 1.0))
    ode_alg = tpkg.PINOODE(tpkg.FNO1D(1, width=4, modes=2, depth=1),
                           bounds=[(0.5, 1.5)],
                           strategy=tpkg.GridTraining(0.1))
    calls = [lambda: tpde._build(system, alg),
             lambda: tpkg.solve_pino_ode(prob, ode_alg, maxiters=1),
             lambda: tpkg.build_pino_residual_vector(prob, ode_alg)]
    for call in calls:
        if torch.cuda.is_available():
            call()
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()
    if torch.cuda.is_available():
        assert tpde._build(system, alg).device.type == "cuda"
