"""Parity of the port's integral layer with the JAX package: the lowering of
integral terms (`compile.lower._ev_integral`: 1-D with parametric bounds,
n-D iterated, n-D tensor rule; infinite and symbolic bounds),
`get_numeric_integral` (static and h-adaptive), `QuadratureTraining` (loss,
gradient, the auto-refined panel count), integrals on the factorized grid
(`compile.separable._integral_grid`), Gauss-Newton's Quadrature residual
vector, `solve(quad_adapt=True)`, and a short integro-differential `solve`.

The same parameters (`numpy.random.default_rng(seed)`, crossing through
`params_from_jax`) and the same points go through both packages.

Tolerances: float64 1e-10 relative to the largest |value| (the order of
the sums is the only difference); float32 1e-5 (the JAX package promotes
its node arithmetic to float64 under x64, the port stays in float32).  The
loss curve of a 100-step float64 solve agrees to 1e-6.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, rel_err, tree_like
from neuralpde_tpu.compile import lower as jlower
from neuralpde_tpu.compile.separable import (
    build_separable_residual as j_sep,
)
from neuralpde_tpu_torch.compile import lower as tlower
from neuralpde_tpu_torch.compile.separable import (
    build_separable_residual as t_sep,
)

F64, F32 = torch.float64, torch.float32
JDT = {F64: jnp.float64, F32: jnp.float32}
INF = float("inf")


# --- the lowering of integral terms ------------------------------------------

def _equations(pkg):
    """name -> (equation, inputs of u, integral rule) in ``pkg``'s front
    end; the shapes of tests/test_integrodiff.py."""
    x, y, s = pkg.symbols("x y s")
    u = pkg.DepVar("u")
    I = pkg.Integral
    D = pkg.Differential
    return {
        # 1-D, parametric upper bound (Volterra)
        "parametric_1d": (pkg.Eq(D(x)(u(x)) + 2.0 * u(x)
                                 + 5.0 * I(x, 0.0, x)(u(x)), 1.0), ["x"], (10, 1)),
        # integrand with a coefficient in the integration variable
        "coefficient": (pkg.Eq(I(x, 0.0, x)(u(x) * pkg.cos(x)), x ** 3 / 3.0),
                        ["x"], (10, 2)),
        # n-D, static bounds: tensor rule
        "static_2d": (pkg.Eq(I((x, y), (0.0, 0.0), (1.0, 1.0))(u(x, y)),
                             1.0 / 3.0), ["x", "y"], (6, 2)),
        # n-D, the inner bound names the outer variable: iterated 1-D
        "iterated_2d": (pkg.Eq(I((x, y), (0.0, 0.0), (1.0, x))(u(x, y)),
                               5.0 / 12.0), ["x", "y"], (8, 1)),
        # infinite upper bound, and beside a parametric one
        "infinite": (pkg.Eq(I(x, 1.0, x)(u(x)),
                            I(x, 1.0, INF)(u(x)) - 1.0 / x), ["x"], (12, 2)),
        # symbolic lower bound with an infinite upper bound
        "symbolic_lower": (pkg.Eq(I(x, x, INF)(u(x)), 1.0 / x), ["x"], (12, 4)),
        # both bounds infinite, integrand in another variable
        "whole_line": (pkg.Eq(u(x), I(s, -INF, INF)(
            pkg.exp(-(s ** 2)) * u(s))), ["x"], (16, 2)),
    }


def _pair(name, dtype, seed=0):
    """Both packages' residual functions of equation ``name``, their
    parameters, and the equation's argument layout."""
    (jeq, inputs, rule) = _equations(jpkg)[name]
    teq = _equations(tpkg)[name][0]
    sizes = [len(inputs), 12, 12, 1]
    tree = mlp_params(np.random.default_rng(seed), sizes)
    common = dict(depvars=["u"], indvars=inputs,
                  dict_depvar_input={"u": inputs}, multioutput=False,
                  integral_order=rule[0], integral_panels=rule[1])
    jctx = jlower.LoweringContext(
        phis=[jpkg.Phi(jpkg.mlp(sizes)).apply],
        derivative=jpkg.DerivativeEngine("jvp"), **common)
    tctx = tlower.LoweringContext(
        modules=[tpkg.mlp(sizes, dtype=dtype)],
        derivative=tpkg.DerivativeEngine("jvp"), **common)
    jtheta = {"depvar": jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), tree)}
    ttheta = tpkg.params_from_jax({"depvar": tree}, dtype=dtype)
    jargs = jpkg.get_argument(jeq, ["u"])
    targs = tpkg.get_argument(teq, ["u"])
    assert [repr(a) for a in jargs] == [repr(a) for a in targs]
    assert ([v.name for v in jpkg.get_integration_variables(jeq)]
            == [v.name for v in tpkg.get_integration_variables(teq)])
    jres = jpkg.build_residual_function(jeq, jargs, jctx)
    tres = tpkg.build_residual_function(teq, targs, tctx)
    return (jres, jtheta, jctx), (tres, ttheta, tctx), jargs


@pytest.mark.parametrize("dtype", [F64, F32], ids=str)
@pytest.mark.parametrize("name", sorted(_equations(tpkg)))
def test_integral_residuals_match_jax(name, dtype):
    (jres, jtheta, _), (tres, ttheta, _), args = _pair(name, dtype)
    lo = 1.0 if name in ("infinite", "symbolic_lower") else 0.0
    cord = np.random.default_rng(3).uniform(lo + 0.05, lo + 1.0,
                                            (len(args), 13))
    want = np.asarray(jres(jnp.asarray(cord, JDT[dtype]), jtheta))
    got = tres(torch.tensor(cord, dtype=dtype), ttheta)
    assert got.shape == (13,)
    # a float32 problem stays float32 through nodes, weights and constants
    assert got.dtype == dtype
    assert rel_err(got.detach().numpy(), want) < (1e-10 if dtype == F64
                                                  else 1e-5)


def test_integral_gradient_matches_jax():
    """d/dθ of a mean-square integro-differential residual."""
    (jres, jtheta, _), (tres, ttheta, _), args = _pair("parametric_1d", F64)
    cord = np.random.default_rng(4).uniform(0.05, 2.0, (1, 11))
    jgrad = jax.grad(lambda th: jnp.mean(
        jres(jnp.asarray(cord), th) ** 2))(jtheta)
    theta = {k: v.clone().requires_grad_(True) for k, v in ttheta.items()}
    torch.mean(tres(torch.tensor(cord), theta) ** 2).backward()
    want = tpkg.params_from_jax(jgrad)
    for k, v in theta.items():
        assert rel_err(v.grad.numpy(), want[k].numpy()) < 1e-10, k


@pytest.mark.parametrize("dtype", [F64, F32], ids=str)
@pytest.mark.parametrize("shape", ["1d", "2d"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "adaptive"])
def test_get_numeric_integral_matches_jax(adaptive, shape, dtype):
    """∫₀ˣ u(s) ds, and ∫∫ u(s)·u(t) over the parametric box [0, x]²: the
    static rule, and the host-side h-adaptive path with its tolerances (the
    same bisections in both packages in float64; in float32 the estimates
    differ in their last bits, so the answers agree to the tolerance)."""
    (_, jtheta, jctx), (_, ttheta, tctx), _ = _pair("parametric_1d", dtype)
    exprs = []
    for pkg in (jpkg, tpkg):
        x, s, t = pkg.symbols("x s t")
        u = pkg.DepVar("u")
        exprs.append(pkg.IntegralExpr(u(x), (x,), (0.0,), (x,)) if shape == "1d"
                     else pkg.IntegralExpr(u(s) * u(t), (s, t), (0.0, 0.0),
                                           (x, x)))
    cord = np.linspace(0.2, 1.0, 5)[None, :]
    kw = dict(adaptive=True, reltol=1e-9, abstol=1e-10,
              maxiters=60) if adaptive else {}
    want = jpkg.get_numeric_integral(jctx, **kw)(
        exprs[0], jnp.asarray(cord, JDT[dtype]), jtheta, [jpkg.symbols("x")])
    got = tpkg.get_numeric_integral(tctx, **kw)(
        exprs[1], cord, ttheta, [tpkg.symbols("x")])
    assert got.shape == (5,) and got.dtype == dtype
    assert rel_err(got.numpy(), np.asarray(want)) < (1e-10 if dtype == F64
                                                     else 1e-5)
    if adaptive and dtype == F64:
        static = tpkg.get_numeric_integral(tctx)(exprs[1], cord, ttheta,
                                                 [tpkg.symbols("x")])
        assert rel_err(got.numpy(), static.detach().numpy()) < 1e-6


# --- QuadratureTraining ----------------------------------------------------

def _osc(pkg, freq):
    """u'' = -(freq·π)² sin(freq·π·x) on [0,1], u(0) = u(1) = 0."""
    x = pkg.symbols("x")
    u = pkg.DepVar("u")
    eq = pkg.Eq((pkg.Differential(x) ** 2)(u(x)),
                -(freq * np.pi) ** 2 * pkg.sin(freq * np.pi * x))
    return pkg.PDESystem(eq, [pkg.Eq(u(0.0), 0.0), pkg.Eq(u(1.0), 0.0)],
                         [pkg.Domain(x, pkg.Interval(0, 1))], [x], [u(x)])


def _poisson_source_2d(pkg):
    """u_xx + u_yy = -sin(πx) sin(πy), u(0, y) = 0, u_x(x, 0) = x: a 2-D
    rule, a boundary with one free variable each."""
    x, y = pkg.symbols("x y")
    u = pkg.DepVar("u")
    eq = pkg.Eq((pkg.Differential(x) ** 2)(u(x, y))
                + (pkg.Differential(y) ** 2)(u(x, y)),
                -pkg.sin(np.pi * x) * pkg.sin(np.pi * y))
    bcs = [pkg.Eq(u(0.0, y), 0.0), pkg.Eq(pkg.Differential(x)(u(x, 0.0)), x)]
    return pkg.PDESystem(eq, bcs, [pkg.Domain(x, pkg.Interval(0, 1)),
                                   pkg.Domain(y, pkg.Interval(0, 2))],
                         [x, y], [u(x, y)])


def _quad_problems(system, sizes, kw, dtype=F64, seed=0, **disc):
    tree = mlp_params(np.random.default_rng(seed), sizes)
    jstrat, tstrat = jpkg.QuadratureTraining(**kw), tpkg.QuadratureTraining(**kw)
    jprob = jpkg.discretize(system(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp(sizes), jstrat, init_params=tree, dtype=JDT[dtype], **disc))
    tprob = tpkg.discretize(system(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp(sizes, dtype=dtype), tstrat,
        init_params=tpkg.params_from_jax(tree), dtype=dtype, device="cpu",
        **disc))
    return jprob, tprob


def _ada(prob, pkg):
    lf = prob.pinnrep.loss_functions
    n = (len(lf.pde_loss_functions), len(lf.bc_loss_functions))
    if pkg is jpkg:
        return prob.pinnrep.adaloss.init_state(*n, prob.pinnrep.dtype)
    return prob.pinnrep.adaloss.init_state(*n, prob.pinnrep.dtype, "cpu")


def _loss_and_grad(jprob, tprob):
    jl = {"key": jax.random.key(0), "adaptive": _ada(jprob, jpkg)}
    (want, jaux), jgrad = jax.value_and_grad(jprob.loss, has_aux=True)(
        jprob.init_params, jl)
    theta = {k: v.clone().requires_grad_(True)
             for k, v in tprob.init_params.items()}
    got, aux = tprob.loss(theta, {"generator": None,
                                  "adaptive": _ada(tprob, tpkg)})
    got.backward()
    return (got, aux, theta), (want, jaux, tpkg.params_from_jax(jgrad))


QUAD_CASES = {
    "osc_auto": (lambda pkg: _osc(pkg, 4.0), [1, 12, 12, 1],
                 dict(order=4, abstol=1e-3, reltol=1e-4, maxiters=100)),
    "osc_loose": (lambda pkg: _osc(pkg, 4.0), [1, 12, 12, 1],
                  dict(order=2, abstol=1e8, reltol=1e8)),
    "osc_pinned": (lambda pkg: _osc(pkg, 2.0), [1, 12, 12, 1],
                   dict(order=8, panels=3)),
    "2d_auto": (_poisson_source_2d, [2, 10, 10, 1],
                dict(order=3, abstol=1e-3, reltol=1e-3, maxiters=200)),
}


@pytest.mark.parametrize("case,dtype", [
    ("osc_auto", F64), ("osc_loose", F32), ("osc_pinned", F64),
    ("osc_pinned", F32), ("2d_auto", F64)],
    ids=lambda v: str(v))
def test_quadrature_training_matches_jax(case, dtype):
    """Loss, per-equation losses, gradient and the auto-refined panel
    counts (tolerances that float32 sums can decide: the JAX package
    evaluates each refinement step eagerly, which sets this test's
    length).  The float32 tolerance is 1e-4: squared second derivatives."""
    system, sizes, kw = QUAD_CASES[case]
    jprob, tprob = _quad_problems(system, sizes, kw, dtype)
    (got, aux, theta), (want, jaux, jgrad) = _loss_and_grad(jprob, tprob)
    tol = 1e-10 if dtype == F64 else 1e-4
    assert got.dtype == dtype
    assert rel_err(float(got), float(want)) < tol
    for key in ("pde_losses", "bc_losses"):
        assert rel_err(aux[key].detach().numpy(), np.asarray(jaux[key])) < tol
    for k, v in theta.items():
        assert rel_err(v.grad.numpy(), jgrad[k].numpy()) < 10 * tol, k
    # the JAX package's panel counts are read off its registered checks
    # (each holds its count as a default argument): evaluating them, eagerly
    # and twice per equation, would take most of this test's time
    jpanels = [c.__defaults__[2]
               for c in jprob.pinnrep.strategy._trained_checks]
    trep = tprob.pinnrep.strategy.validate_trained(tprob.init_params,
                                                   warn=False)
    assert [r["panels"] for r in trep] == jpanels
    assert bool(trep) == ("panels" not in kw)
    assert all(r["ok"] for r in trep)


def test_quadrature_layout_holds_symbols_only():
    """Under QuadratureTraining the cord rows are the symbol arguments
    (`pde_indvars` keeps the full argument lists), as in the JAX package."""
    jprob, tprob = _quad_problems(_poisson_source_2d, [2, 8, 1],
                                  dict(order=2, panels=1))
    for key in ("pde_indvars", "bc_indvars", "pde_integration_vars"):
        assert (repr(getattr(tprob.pinnrep, key))
                == repr(getattr(jprob.pinnrep, key))), key
    f = tprob.pinnrep.loss_functions.datafree_bc_loss_functions[0]
    out = f(torch.linspace(0, 2, 5, dtype=F64)[None, :], tprob.init_params)
    assert out.shape == (5,)


def test_resolve_panels_matches_jax():
    def integral_at(p):
        return 1.0 + p ** -4.0

    for kw in (dict(order=4, abstol=1e-1, reltol=0.0),
               dict(order=4, abstol=1e-8, reltol=0.0, maxiters=10000),
               dict(order=8, abstol=0.0, reltol=0.0, maxiters=100),
               dict(order=4, panels=3)):
        assert (tpkg.QuadratureTraining(**kw).resolve_panels(integral_at, 1)
                == jpkg.QuadratureTraining(**kw).resolve_panels(integral_at, 1))
    assert tpkg.QuadratureTraining().resolve_panels() == 4
    assert tpkg.QuadratureTraining(panels=7).static_panels == 7


# --- Gauss-Newton on a quadrature rule --------------------------------------

@pytest.mark.parametrize("case", ["osc_auto", "2d_auto"])
def test_gauss_newton_quadrature_residual_vector_matches_jax(case):
    system, sizes, kw = QUAD_CASES[case]
    jprob, tprob = _quad_problems(system, sizes, kw)
    jr = jpkg.build_residual_vector(jprob.pinnrep)(jprob.init_params)
    tr = tpkg.build_residual_vector(tprob.pinnrep)(tprob.init_params)
    assert tr.shape == tuple(jr.shape)
    assert rel_err(tr.detach().numpy(), np.asarray(jr)) < 1e-10
    (loss, _, _), _ = _loss_and_grad(jprob, tprob)
    assert rel_err(float(torch.sum(tr * tr)), float(loss)) < 1e-10


def test_gauss_newton_on_quadrature_trains():
    """Two LM steps on the fixed rule: the objective falls as in the JAX
    package from the same start (1e-6: twenty CG iterations a step)."""
    system, sizes, kw = QUAD_CASES["osc_pinned"]
    jprob, tprob = _quad_problems(system, sizes, kw)
    kw = dict(maxiters=2, cg_iters=20, damping=1.0)
    jres = jpkg.solve_gauss_newton(jprob, **kw)
    tres = tpkg.solve_gauss_newton(tprob, **kw)
    assert tres.history[-1] < 0.5 * tres.history[0]
    assert rel_err(tres.history, jres.history) < 1e-6


# --- integrals on the factorized grid ----------------------------------------

def _sep_pair(dims, hidden, rank, rule, seed):
    jnet = jpkg.separable_mlp(dims, hidden, rank)
    tnet = tpkg.separable_mlp(dims, hidden, rank, dtype=F64)
    tree = tree_like(jnet.init(jax.random.key(0)),
                     np.random.default_rng(seed))
    inputs = ["x", "t"][:dims]
    common = dict(depvars=["u"], indvars=inputs,
                  dict_depvar_input={"u": inputs}, multioutput=False,
                  integral_order=rule[0], integral_panels=rule[1])
    jctx = jlower.LoweringContext(phis=[jnet.apply],
                                  derivative=jpkg.DerivativeEngine("jvp"),
                                  **common)
    tctx = tlower.LoweringContext(modules=[tnet],
                                  derivative=tpkg.DerivativeEngine("jvp"),
                                  **common)
    jtheta = {"depvar": jax.tree.map(jnp.asarray, tree)}
    ttheta = tpkg.params_from_jax({"depvar": tree}, dtype=F64)
    return (jnet, jctx, jtheta), (tnet, tctx, ttheta)


def _sep_equations(pkg):
    x, t, s = pkg.symbols("x t s")
    u = pkg.DepVar("u")
    return {
        # u_t + u = ∫₀¹ u(s, t) ds: a nonlocal coupling in x
        "nonlocal": (pkg.Eq(pkg.Differential(t)(u(x, t)) + u(x, t),
                            pkg.Integral(s, 0.0, 1.0)(u(s, t))), 2, (16, 2)),
        # a nonlinear integrand and an infinite bound
        "nonlinear_inf": (pkg.Eq(u(x), pkg.Integral(s, 0.0, INF)(
            pkg.exp(-(s ** 2)) * u(s) ** 2)), 1, (24, 4)),
        # the integrand does not depend on the integration variable
        "constant_integrand": (pkg.Eq(u(x), pkg.Integral(s, 0.0, 2.0)(
            u(x) * 3.0)), 1, (4, 1)),
    }


@pytest.mark.parametrize("name", sorted(_sep_equations(tpkg)))
def test_integral_grid_matches_jax_and_dense(name):
    jeq, dims, rule = _sep_equations(jpkg)[name]
    teq = _sep_equations(tpkg)[name][0]
    (jnet, jctx, jtheta), (tnet, tctx, ttheta) = _sep_pair(
        dims, (10,), 5, rule, seed=7)
    jres, jaxes = j_sep(jeq, jctx, {"u": jnet}, jnp.float64)
    tres, taxes = t_sep(teq, tctx, {"u": tnet}, F64)
    assert [a.name for a in taxes] == [a.name for a in jaxes]
    nodes = [np.linspace(0, 1, 7), np.linspace(0, 1, 5)][:dims]
    got = tres(nodes, ttheta)
    assert rel_err(got.detach().numpy(), np.asarray(jres(nodes, jtheta))) < 1e-10
    dense = tpkg.build_residual_function(teq, taxes, tctx)
    grid = np.meshgrid(*nodes, indexing="ij")
    cord = torch.tensor(np.stack([g.ravel() for g in grid]))
    assert rel_err(got.detach().numpy().ravel(),
                   dense(cord, ttheta).detach().numpy()) < 1e-9


def test_separable_training_routes_symbolic_bounds_to_the_dense_block():
    """u'(x) = x − ∫₀ˣ u(s) ds cannot factorize (the bound couples axes):
    the equation trains densely on the same grid, with a warning, and the
    loss is the JAX package's."""
    def system(pkg):
        x, s = pkg.symbols("x s")
        u = pkg.DepVar("u")
        eq = pkg.Eq(pkg.Differential(x)(u(x)),
                    x - pkg.Integral(s, 0.0, x)(u(s)))
        return pkg.PDESystem(eq, [pkg.Eq(u(0.0), 0.0)],
                             [pkg.Domain(x, pkg.Interval(0, 1))], [x], [u(x)])

    jnet = jpkg.separable_mlp(1, (8,), 4)
    tree = tree_like(jnet.init(jax.random.key(0)), np.random.default_rng(8))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        jprob = jpkg.discretize(system(jpkg), jpkg.PhysicsInformedNN(
            jnet, jpkg.SeparableTraining(dx=0.125), init_params=tree,
            integral_order=8, dtype=jnp.float64))
        tprob = tpkg.discretize(system(tpkg), tpkg.PhysicsInformedNN(
            tpkg.separable_mlp(1, (8,), 4, dtype=F64),
            tpkg.SeparableTraining(dx=0.125),
            init_params=tpkg.params_from_jax(tree), integral_order=8,
            dtype=F64, device="cpu"))
    assert sum("cannot factorize" in str(w.message) for w in rec) == 2
    (got, _, _), (want, _, _) = _loss_and_grad(jprob, tprob)
    assert rel_err(float(got), float(want)) < 1e-10


# --- solve: the post-solve check and quad_adapt --------------------------------

def _rff(pkg, dtype=None):
    kw = {} if pkg is jpkg else {"dtype": dtype}
    tanh = jnp.tanh if pkg is jpkg else torch.tanh
    return pkg.Chain(pkg.FourierFeatures(1, 16, sigma=6.0, **kw),
                     pkg.Dense(32, 24, tanh, **kw), pkg.Dense(24, 1, **kw))


def _rel_l2(prob, u):
    xs = np.linspace(0, 1, 301)
    pred = prob.pinnrep.phi(xs[None, :], tpkg.depvar_params(u))
    want = np.sin(np.pi * xs)
    return float(np.linalg.norm(pred.detach().numpy().ravel() - want)
                 / np.linalg.norm(want))


def test_quad_adapt_loop_fixes_aliased_solution():
    """The case of tests/test_quadrature_adaptive.py: a coarse auto-refined
    rule (loose reltol, small node budget) lets a random-Fourier-feature net
    train to a small residual at the frozen nodes and a large one between
    them: `solve` warns.  With ``quad_adapt=True`` the rule is refined
    against the trained params and a warm-started re-solve trains on it:
    the final check passes, the true residual (the doubled rule's) falls,
    and the callback fires through both solves.  From the JAX package's
    initial parameters, the first rule has its panel count.  300 steps a
    solve here (Taylor-mode derivatives); the JAX test's 3000 also bring
    the rel L2 against sin(pi x) under half the aliased run's."""
    kw = dict(order=3, reltol=0.05, abstol=1e-8, maxiters=400)
    tree = jax.tree.map(np.asarray, _rff(jpkg).init(jax.random.key(0)))
    jstrat = jpkg.QuadratureTraining(**kw)
    jpkg.discretize(_osc(jpkg, 1.0), jpkg.PhysicsInformedNN(
        _rff(jpkg), jstrat, init_params=tree))

    def make():
        strat = tpkg.QuadratureTraining(**kw)
        return strat, tpkg.discretize(_osc(tpkg, 1.0), tpkg.PhysicsInformedNN(
            _rff(tpkg, F64), strat, init_params=tpkg.params_from_jax(tree),
            derivative="jet", dtype=F64, device="cpu"))

    strat1, prob1 = make()
    jrep = jstrat.validate_trained({"depvar": tree}, warn=False)
    rep0 = strat1.validate_trained(prob1.init_params, warn=False)
    assert rep0[0]["panels"] == jrep[0]["panels"]
    assert rel_err(rep0[0]["loss_at_panels"], jrep[0]["loss_at_panels"]) < 1e-9
    solve_kw = dict(maxiters=300, inner_steps=50)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res1 = tpkg.solve(prob1, tpkg.adam(1e-3), **solve_kw)
    rep1 = strat1.validate_trained(res1.u, warn=False)
    assert not all(r["ok"] for r in rep1)          # the frozen rule fails
    assert any("no longer meets" in str(w.message) for w in rec)
    assert _rel_l2(prob1, res1.u) > 0.5            # and the solution is wrong

    strat2, prob2 = make()
    fired = []
    with warnings.catch_warnings():
        warnings.simplefilter("error")             # the final check is quiet
        res2 = tpkg.solve(prob2, tpkg.adam(1e-3), quad_adapt=True,
                          quad_adapt_rounds=2, **solve_kw,
                          callback=lambda it, loss, aux: fired.append(it)
                          and False)
    rep2 = strat2.validate_trained(res2.u, warn=False)
    assert all(r["ok"] for r in rep2)              # the check now passes
    assert rep2[0]["panels"] > rep1[0]["panels"]   # the rule was refined
    assert rep2[0]["loss_at_2x_panels"] < 0.05 * rep1[0]["loss_at_2x_panels"]
    assert res2.iterations == 600                  # one warm-started re-solve
    assert len(fired) == 12 and len(res2.history) == 12


def test_quad_adapt_noop_when_rule_holds():
    strat = tpkg.QuadratureTraining(order=8, reltol=1e-3, abstol=1e-6,
                                    maxiters=1000)
    tree = mlp_params(np.random.default_rng(2), [1, 16, 1])
    prob = tpkg.discretize(_osc(tpkg, 1.0), tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 16, 1], dtype=F64), strat,
        init_params=tpkg.params_from_jax(tree), dtype=F64, device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = tpkg.solve(prob, tpkg.adam(2e-3), maxiters=300, inner_steps=50,
                         quad_adapt=True)
    assert res.iterations == 300
    assert all(r["ok"] for r in strat.validate_trained(res.u, warn=False))


# --- the slice as a whole ------------------------------------------------------

def _second_order_ide(pkg):
    """u''(x) + ∫₀ˣ u(s) ds = 1 − cos x − sin x... with u(0) = 0, u'(0) = 1
    the solution is sin x."""
    x = pkg.symbols("x")
    u = pkg.DepVar("u")
    eq = pkg.Eq((pkg.Differential(x) ** 2)(u(x)) + pkg.Integral(x, 0.0, x)(u(x)),
                1.0 - pkg.cos(x) - pkg.sin(x))
    bcs = [pkg.Eq(u(0.0), 0.0), pkg.Eq(pkg.Differential(x)(u(0.0)), 1.0)]
    return pkg.PDESystem(eq, bcs, [pkg.Domain(x, pkg.Interval(0, np.pi))],
                         [x], [u(x)])


@pytest.mark.parametrize("strategy", ["grid", "quadrature"])
def test_integro_differential_solve_matches_jax(strategy):
    """100 Adam steps of the second-order integro-differential problem under
    Taylor-mode derivatives, from the same parameters: the same loss curve
    (1e-6 relative) and the same parameters at the end (1e-6)."""
    sizes = [1, 12, 12, 1]
    tree = mlp_params(np.random.default_rng(9), sizes)
    js = (jpkg.GridTraining(0.1) if strategy == "grid"
          else jpkg.QuadratureTraining(order=6))
    ts = (tpkg.GridTraining(0.1) if strategy == "grid"
          else tpkg.QuadratureTraining(order=6))
    jprob = jpkg.discretize(_second_order_ide(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp(sizes), js, init_params=tree, derivative="jet",
        integral_order=10, dtype=jnp.float64))
    tprob = tpkg.discretize(_second_order_ide(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp(sizes, dtype=F64), ts, init_params=tpkg.params_from_jax(tree),
        derivative="jet", integral_order=10, dtype=F64, device="cpu"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the post-solve rule check
        jres = jpkg.solve(jprob, optax.adam(1e-2), maxiters=100, inner_steps=25)
        tres = tpkg.solve(tprob, tpkg.adam(1e-2), maxiters=100, inner_steps=25)
    assert len(tres.history) == 4 and tres.history[-1] < tres.history[0]
    assert rel_err(tres.history, jres.history) < 1e-6
    want = tpkg.params_from_jax(jres.u)
    for k, v in tres.u.items():
        assert rel_err(v.numpy(), want[k].numpy()) < 1e-6, k
