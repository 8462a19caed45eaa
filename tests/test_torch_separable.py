"""The port's separable (SPINN) path against the JAX package, mirroring
tests/test_separable.py: the factorized residual, grid and axis features,
causal weighting, the dense-fallback route, gPINN rows and remat, the error
cases, and Adam steps of the hard-constrained Poisson problem; and the
factored route of a two-axis residual (its mean square and gradients
against the grid route's and the JAX package's, each loss's route).

Parameters are numpy draws in the JAX tree's layout, converted with
`params_from_jax`; nodes are numpy arrays, or JAX's own draws fed through
`SeparableTraining.sampler`.  Tolerances: float64 1e-10 relative (1e-8
after Adam steps, whose sqrt(v) + eps division amplifies rounding); float32
1e-5 relative.
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
from _torch_parity import hard as _hard
from _torch_parity import poisson_2d_hard as hard_poisson
from _torch_parity import rel_err, tree_like
from neuralpde_tpu.compile.lower import LoweringContext as JContext
from neuralpde_tpu.compile.lower import build_residual_function as j_dense
from neuralpde_tpu.compile.separable import build_separable_residual as j_sep
from neuralpde_tpu.ops.derivatives import DerivativeEngine as JEngine
from neuralpde_tpu.train import make_step as jax_make_step
from neuralpde_tpu_torch.compile.lower import LoweringContext as TContext
from neuralpde_tpu_torch.compile.separable import build_factored_residual as t_fac
from neuralpde_tpu_torch.compile.separable import build_separable_residual as t_sep
from neuralpde_tpu_torch.compile.separable import factored_msq
from neuralpde_tpu_torch.ops.derivatives import DerivativeEngine as TEngine
from neuralpde_tpu_torch.strategies import _msq

F64 = torch.float64


def _tree(jnet, seed):
    return tree_like(jnet.init(jax.random.key(0)),
                     np.random.default_rng(seed))


def _nets(builder, n_depvars=1):
    """``builder(pkg, kw)`` -> one net per dependent variable, both
    packages."""
    jn = [builder(jpkg, {}) for _ in range(n_depvars)]
    tn = [builder(tpkg, {"dtype": F64}) for _ in range(n_depvars)]
    return jn, tn


def _contexts(jn, tn, depvars=("u",), inputs=("x", "y")):
    names = list(depvars)
    common = dict(depvars=names, indvars=list(inputs),
                  dict_depvar_input={d: list(inputs) for d in names},
                  multioutput=len(names) > 1)
    return (JContext(phis=[n.apply for n in jn], derivative=JEngine("jvp"),
                     **common),
            TContext(modules=tn, derivative=TEngine("jet"), **common))


def _thetas(jn, seed, depvars=("u",)):
    trees = [_tree(n, seed + i) for i, n in enumerate(jn)]
    dep = trees[0] if len(depvars) == 1 else dict(zip(depvars, trees))
    jtheta = {"depvar": jax.tree.map(jnp.asarray, dep)}
    return jtheta, tpkg.params_from_jax({"depvar": dep}, dtype=F64)


def poisson_eq(pkg):
    x, y = pkg.symbols("x y")
    u = pkg.DepVar("u")
    eq = pkg.Eq((pkg.Differential(x) ** 2)(u(x, y))
                + (pkg.Differential(y) ** 2)(u(x, y)),
                -pkg.sin(np.pi * x) * pkg.sin(np.pi * y))
    return x, y, u, eq


def _case(name, pkg):
    """(equation, depvars, inputs, net builder, node counts)."""
    x, y, u, eq = poisson_eq(pkg)
    sep = lambda hidden, rank, n=2: (                       # noqa: E731
        lambda p, kw: p.separable_mlp(n, hidden, rank, **kw))
    if name == "interior":
        return eq, ("u",), ("x", "y"), sep((16, 16), 8), (9, 7)
    if name == "dirichlet":
        return pkg.Eq(u(0.0, y), 0.0), ("u",), ("x", "y"), sep((16, 16), 8), (11,)
    if name == "neumann":
        return (pkg.Eq(pkg.Differential(x)(u(1.0, y)), pkg.sin(np.pi * y)),
                ("u",), ("x", "y"), sep((16, 16), 8), (11,))
    if name == "pinned":
        return pkg.Eq(u(0.0, 0.0), 0.0), ("u",), ("x", "y"), sep((8,), 4), ()
    if name == "3d":
        x, y, z = pkg.symbols("x y z")
        Dxx, Dyy, Dzz = ((pkg.Differential(v) ** 2) for v in (x, y, z))
        eq = pkg.Eq(Dxx(u(x, y, z)) + Dyy(u(x, y, z)) + Dzz(u(x, y, z)),
                    u(x, y, z))
        return eq, ("u",), ("x", "y", "z"), sep((8, 8), 6, 3), (5, 4, 3)
    if name == "fourth_order":
        x, t = pkg.symbols("x t")
        Dt, Dx = pkg.Differential(t), pkg.Differential(x)
        eq = pkg.Eq(Dt(u(x, t)) + u(x, t) * Dx(u(x, t))
                    + (Dx ** 2)(u(x, t)) + (Dx ** 4)(u(x, t)), 0.0)
        return eq, ("u",), ("x", "t"), sep((12, 12), 6), (7, 5)
    if name == "transformed":
        return eq, ("u",), ("x", "y"), lambda p, kw: p.SeparableNet(
            [p.Transformed(p.mlp([1, 8, 6], **kw), _hard) for _ in range(2)]), (6, 6)
    if name == "multioutput":
        v = pkg.DepVar("v")
        Dx, Dy = pkg.Differential(x), pkg.Differential(y)
        eq = pkg.Eq(Dx(u(x, y)) + Dy(v(x, y)), u(x, y) * v(x, y))
        return eq, ("u", "v"), ("x", "y"), sep((8,), 4), (5, 5)
    Dxx, Dyy = pkg.Differential(x) ** 2, pkg.Differential(y) ** 2
    if name == "coefficient":
        # a(x) u_xx + u_yy / b(y): axis values scale one side of a term
        eq = pkg.Eq((1 + x * x) * Dxx(u(x, y))
                    + Dyy(u(x, y)) / (2 + pkg.cos(np.pi * y)),
                    -pkg.sin(np.pi * x) * pkg.sin(np.pi * y))
        return eq, ("u",), ("x", "y"), sep((12, 12), 6), (9, 7)
    if name == "source":
        # a constant, axis-only terms and a product of two axis values
        eq = pkg.Eq(Dxx(u(x, y)) + Dyy(u(x, y)) - 0.5 * u(x, y),
                    3.0 + pkg.exp(x) - 2 * pkg.sin(np.pi * y) + x * y)
        return eq, ("u",), ("x", "y"), sep((12, 12), 6), (8, 9)
    if name == "face_terms":
        # a face of a 3-D box, u(x, y, 0): a constant slot scales a side; a
        # call along one grid axis, u(x, 0, 0), and a pinned one, u(0, 0, 0),
        # are rank-1 terms
        z = pkg.symbols("z")
        Dz = pkg.Differential(z)
        eq = pkg.Eq(u(x, y, 0.0) + 0.5 * Dz(u(x, y, 0.0))
                    - 0.25 * u(x, 0.0, 0.0) + u(0.0, 0.0, 0.0),
                    pkg.sin(np.pi * x) * pkg.sin(np.pi * y))
        return eq, ("u",), ("x", "y", "z"), sep((8, 8), 6, 3), (7, 6)
    raise KeyError(name)


CASES = ["interior", "dirichlet", "neumann", "pinned", "3d", "fourth_order",
         "transformed", "multioutput"]


@pytest.mark.parametrize("name", CASES)
def test_factorized_residual_matches_jax(name):
    jeq, depvars, inputs, builder, counts = _case(name, jpkg)
    teq = _case(name, tpkg)[0]
    jn, tn = _nets(builder, len(depvars))
    jctx, tctx = _contexts(jn, tn, depvars, inputs)
    jtheta, ttheta = _thetas(jn, CASES.index(name), depvars)
    jres, jaxes = j_sep(jeq, jctx, dict(zip(depvars, jn)), jnp.float64)
    tres, taxes = t_sep(teq, tctx, dict(zip(depvars, tn)), F64)
    assert [a.name for a in taxes] == [a.name for a in jaxes]
    nodes = [np.linspace(0.05, 0.95, n) for n in counts]
    want = np.asarray(jres(nodes, jtheta))
    got = tres(nodes, ttheta)
    assert tuple(got.shape) == want.shape == tuple(counts)
    assert rel_err(got.detach().numpy(), want) < 1e-10
    if len(counts) >= 2 and len(depvars) == 1:
        # and the port's own dense lowering on the same grid (Taylor mode)
        grids = np.meshgrid(*nodes, indexing="ij")
        cord = torch.tensor(np.stack([g.ravel() for g in grids]))
        dense = tpkg.build_residual_function(
            teq, [tpkg.Sym(n) for n in inputs], tctx)(cord, ttheta)
        assert rel_err(dense.reshape(counts).detach().numpy(), want) < 1e-9


FACTORED = ["interior", "transformed", "coefficient", "source", "face_terms"]


def _value_and_grad(loss_fn, theta):
    theta = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
    loss = loss_fn(theta)
    grads = torch.autograd.grad(loss, list(theta.values()))
    return float(loss.detach()), dict(zip(theta, grads))


@pytest.mark.parametrize("name", FACTORED)
def test_factored_route_matches_grid_route_and_jax(name):
    """The factored route's mean square and every parameter's gradient
    against the grid route's (`_msq` of the grid residual) and the JAX
    package's mean square of its grid residual."""
    jeq, depvars, inputs, builder, counts = _case(name, jpkg)
    teq = _case(name, tpkg)[0]
    jn, tn = _nets(builder)
    jctx, tctx = _contexts(jn, tn, depvars, inputs)
    jtheta, ttheta = _thetas(jn, 20 + FACTORED.index(name))
    jres, _ = j_sep(jeq, jctx, {"u": jn[0]}, jnp.float64)
    tres, _ = t_sep(teq, tctx, {"u": tn[0]}, F64)
    factors = t_fac(teq, tctx, {"u": tn[0]}, F64, ttheta)
    nodes = [np.linspace(0.05, 0.95, n) for n in counts]
    a, b, _ = factors(nodes, ttheta)
    assert a.shape[0] % 4 == 0 and a.shape[0] == b.shape[0]
    assert (a.shape[1], b.shape[1]) == counts
    assert rel_err((a.T @ b).detach().numpy(),
                   tres(nodes, ttheta).detach().numpy()) < 1e-10

    def factored(th, all_rows=False):
        a, b, rows = factors(nodes, th)
        return factored_msq(a, b, None, a.shape[0] if all_rows else rows)

    loss, grad = _value_and_grad(factored, ttheta)
    # the backward's products over the rows that carry a gradient give what
    # they give over all rows
    all_loss, all_grad = _value_and_grad(
        lambda th: factored(th, all_rows=True), ttheta)
    assert loss == all_loss
    _assert_grads(grad, all_grad, 1e-14)
    gloss, ggrad = _value_and_grad(lambda th: _msq(tres(nodes, th)), ttheta)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda th: jnp.mean(jres(nodes, th) ** 2)))(jtheta)
    assert rel_err(loss, gloss) < 1e-10
    assert rel_err(loss, float(jloss)) < 1e-10
    _assert_grads(grad, ggrad, 1e-10)
    _assert_grads(grad, tpkg.params_from_jax(jax.tree.map(np.asarray, jgrad)),
                  1e-10)


def _case_problem(name):
    """`_case`'s equation on the unit box, with no conditions, and its
    nets."""
    eq, depvars, inputs, builder, _ = _case(name, tpkg)
    syms = tpkg.symbols(" ".join(inputs))
    nets = [builder(tpkg, {"dtype": F64}) for _ in depvars]
    system = tpkg.PDESystem(eq, [], [tpkg.Domain(s, tpkg.Interval(0, 1))
                                     for s in syms], list(syms),
                            [tpkg.DepVar(d)(*syms) for d in depvars])
    return system, nets if len(nets) > 1 else nets[0]


def face(pkg):
    """3-D Laplace with a condition on a face (two grid axes) and on an
    edge (one)."""
    x, y, z = pkg.symbols("x y z")
    u = pkg.DepVar("u")
    Dxx, Dyy, Dzz = ((pkg.Differential(v) ** 2) for v in (x, y, z))
    return pkg.PDESystem(
        pkg.Eq(Dxx(u(x, y, z)) + Dyy(u(x, y, z)) + Dzz(u(x, y, z)), 0.0),
        [pkg.Eq(u(x, y, 0.0), pkg.sin(np.pi * x) * pkg.sin(np.pi * y)),
         pkg.Eq(u(x, 0.0, 0.0), 0.0)],
        [pkg.Domain(v, pkg.Interval(0, 1)) for v in (x, y, z)], [x, y, z],
        [u(x, y, z)])


ROUTES = {"interior": ["factored"], "coefficient": ["factored"],
          "face_terms": ["factored"],
          "fourth_order": ["grid"], "multioutput": ["grid"], "3d": ["grid"],
          "face": ["grid", "factored", "grid"],
          "heat": ["factored", "grid", "grid", "grid"],
          "causal": ["grid"] * 4, "gpinn": ["grid"] * 3,
          "remat": ["grid"] * 3, "dense": ["factored", "grid", "dense"]}


@pytest.mark.parametrize("kind", list(ROUTES))
def test_routes_follow_the_expression(kind):
    """Each loss's route: a two-axis residual of rank-factored terms (a
    face of a 3-D box too) factors; products of depvar terms, three axes,
    causal weighting, gPINN rows and remat keep the grid route; one-axis
    conditions are grid losses, a coupled argument a dense one."""
    strategy = tpkg.SeparableTraining(dx=1 / 8)
    net, kw = _sep((8,), 4)(tpkg, {"dtype": F64}), {}
    if kind in CASES + FACTORED:
        system, net = _case_problem(kind)
    elif kind == "face":
        system, net = face(tpkg), tpkg.separable_mlp(3, (8,), 4, dtype=F64)
    else:
        system = {"heat": heat, "causal": heat, "gpinn": gpinn_system,
                  "remat": gpinn_system, "dense": coupled}[kind](tpkg)
        if kind == "causal":
            strategy = tpkg.SeparableTraining(dx=1 / 8, causal="t")
        kw = {"gpinn": {"gradient_enhanced": 0.3},
              "remat": {"remat": True}}.get(kind, {})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)    # the dense route's
        prob = tpkg.discretize(system, tpkg.PhysicsInformedNN(
            net, strategy, dtype=F64, device="cpu", **kw))
    assert prob.pinnrep.strategy.routes == ROUTES[kind]


def test_grid_and_axis_features_match_jax():
    jnet = jpkg.SeparableNet([jpkg.Transformed(jpkg.mlp([1, 8, 4]), _hard),
                              jpkg.mlp([1, 8, 8, 4])])
    tnet = tpkg.SeparableNet([
        tpkg.Transformed(tpkg.mlp([1, 8, 4], dtype=F64), _hard),
        tpkg.mlp([1, 8, 8, 4], dtype=F64)])
    tree = _tree(jnet, 9)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tpkg.params_from_jax(tree, dtype=F64)
    xs, ys = np.linspace(0, 1, 4), np.linspace(0.1, 0.9, 3)
    grid = tnet.grid(tp, [xs, ys])
    assert tuple(grid.shape) == (4, 3)
    assert rel_err(grid.detach().numpy(),
                   np.asarray(jnet.grid(jp, [jnp.asarray(xs),
                                             jnp.asarray(ys)]))) < 1e-10
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    pointwise = tnet.apply(tp, torch.tensor(np.stack([X.ravel(), Y.ravel()])))
    assert rel_err(pointwise.reshape(4, 3).detach().numpy(),
                   grid.detach().numpy()) < 1e-12
    with pytest.raises(ValueError, match="node arrays"):
        tnet.grid(tp, [xs])
    nodes = np.linspace(0.1, 0.9, 7)
    for a in range(2):
        for order in range(4):
            want = jnet.axis_features(jp, a, jnp.asarray(nodes), order)
            got = tnet.axis_features(tp, a, nodes, order)
            assert rel_err(got.detach().numpy(), np.asarray(want)) < 1e-10, (
                a, order)


def heat(pkg):
    x, t = pkg.symbols("x t")
    u = pkg.DepVar("u")
    eq = pkg.Eq(pkg.Differential(t)(u(x, t)),
                0.1 * (pkg.Differential(x) ** 2)(u(x, t)))
    bcs = [pkg.Eq(u(x, 0.0), pkg.sin(np.pi * x)),
           pkg.Eq(u(0.0, t), 0.0), pkg.Eq(u(1.0, t), 0.0)]
    return pkg.PDESystem(eq, bcs, [pkg.Domain(x, pkg.Interval(0, 1)),
                                   pkg.Domain(t, pkg.Interval(0, 1))],
                         [x, t], [u(x, t)])


def _problems(system, builder, strategy, seed=0, **kw):
    jnet = builder(jpkg, {})
    tree = _tree(jnet, seed)
    jprob = jpkg.discretize(system(jpkg), jpkg.PhysicsInformedNN(
        jnet, strategy(jpkg), init_params=tree, dtype=jnp.float64, **kw))
    tprob = tpkg.discretize(system(tpkg), tpkg.PhysicsInformedNN(
        builder(tpkg, {"dtype": F64}), strategy(tpkg),
        init_params=tpkg.params_from_jax(tree), dtype=F64, **kw, device="cpu"))
    return jprob, tprob


def _losses(prob, theta, generator=None):
    lf = prob.pinnrep.loss_functions
    return [float(f(theta, generator))
            for f in lf.pde_loss_functions + lf.bc_loss_functions]


def _jlosses(prob, key=None):
    lf = prob.pinnrep.loss_functions
    key = jax.random.key(0) if key is None else key
    return [float(f(prob.init_params, key))
            for f in lf.pde_loss_functions + lf.bc_loss_functions]


def _sep(hidden, rank):
    return lambda pkg, kw: pkg.separable_mlp(2, hidden, rank, **kw)


def test_causal_eps_zero_equals_plain_and_weights_match_jax():
    strat = lambda eps: (lambda pkg: pkg.SeparableTraining(  # noqa: E731
        dx=1 / 16, causal="t", causal_eps=eps))
    _, plain = _problems(heat, _sep((16, 16), 12),
                         lambda pkg: pkg.SeparableTraining(dx=1 / 16), seed=3)
    _, zero = _problems(heat, _sep((16, 16), 12), strat(0.0), seed=3)
    l0, lc = _losses(plain, plain.init_params), _losses(zero, zero.init_params)
    assert rel_err(lc, l0) < 1e-12
    jprob, tprob = _problems(heat, _sep((16, 16), 12), strat(5.0), seed=3)
    assert rel_err(_losses(tprob, tprob.init_params), _jlosses(jprob)) < 1e-10
    want = np.asarray(jprob.pinnrep.strategy.causal_weights(
        jprob.init_params, jax.random.key(0))[0])
    got = tprob.pinnrep.strategy.causal_weights(tprob.init_params)[0]
    assert got.shape == (17,) and float(got[0]) == 1.0
    assert np.all(np.diff(got.numpy()) <= 1e-12)
    assert rel_err(got.numpy(), want) < 1e-10


def _jax_nodes(key, eq_tag, bounds, points):
    """The nodes JAX's resampling SeparableTraining draws for one equation."""
    kb = jax.random.fold_in(key, eq_tag)
    return [np.asarray(lb + (ub - lb) * jax.random.uniform(
        jax.random.fold_in(kb, i), (points,), jnp.float64))
        for i, (lb, ub) in enumerate(bounds)]


def test_resampled_causal_nodes_fed_from_jax_match():
    strat = lambda pkg: pkg.SeparableTraining(  # noqa: E731
        points=12, resample=True, causal="t", causal_eps=2.0)
    jprob, tprob = _problems(heat, _sep((12,), 8), strat, seed=4)
    key = jax.random.key(2)
    draws = _jax_nodes(key, 0, [(0.0, 1.0), (0.0, 1.0)], 12)
    fed = iter(draws)
    tprob.pinnrep.strategy.sampler = (
        lambda n, lb, ub, generator: torch.tensor(next(fed)))
    got = tprob.pinnrep.loss_functions.pde_loss_functions[0](
        tprob.init_params, torch.Generator())
    want = jprob.pinnrep.loss_functions.pde_loss_functions[0](
        jprob.init_params, key)
    assert rel_err(float(got), float(want)) < 1e-10


def test_rad_resampling_runs_with_causal_weights():
    _, tprob = _problems(heat, _sep((8,), 4), lambda pkg: pkg.SeparableTraining(
        points=10, resample=True, causal="t", causal_eps=1.0,
        rad_candidates=40), seed=5)
    res = tpkg.solve(tprob, tpkg.adam(2e-3), maxiters=5)
    assert np.isfinite(res.objective)
    w = tprob.pinnrep.strategy.causal_weights(res.u, torch.Generator())[0]
    assert w.shape == (10,) and float(w[0]) == 1.0


def coupled(pkg):
    """Poisson with one condition whose argument couples both grid axes."""
    x, y, u, eq = poisson_eq(pkg)
    return pkg.PDESystem(eq, [pkg.Eq(u(x, 0.0), 0.0),
                              pkg.Eq(u(x * y, y), 0.0)],
                         [pkg.Domain(x, pkg.Interval(0, 1)),
                          pkg.Domain(y, pkg.Interval(0, 1))],
                         [x, y], [u(x, y)])


def test_dense_fallback_route_warns_and_matches_jax():
    with pytest.warns(UserWarning, match="cannot factorize"):
        jprob, tprob = _problems(coupled, _sep((8,), 4),
                                 lambda pkg: pkg.SeparableTraining(dx=1 / 8),
                                 seed=6)
    got = _losses(tprob, tprob.init_params)
    assert len(got) == 3 and got[2] > 0
    assert rel_err(got, _jlosses(jprob)) < 1e-10


def gpinn_system(pkg):
    x, y, u, eq = poisson_eq(pkg)
    return pkg.PDESystem(eq, [pkg.Eq(u(0.0, y), 0.0), pkg.Eq(u(x, 0.0), 0.0)],
                         [pkg.Domain(x, pkg.Interval(0, 1)),
                          pkg.Domain(y, pkg.Interval(0, 1))],
                         [x, y], [u(x, y)])


def _loss_and_grad(prob, n_bc):
    theta = {k: v.clone().requires_grad_(True)
             for k, v in prob.init_params.items()}
    loss, _ = prob.loss(theta, {
        "generator": None,
        "adaptive": prob.pinnrep.adaloss.init_state(1, n_bc, F64, "cpu")})
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in theta.items()}


def _jax_loss_and_grad(prob, n_bc):
    ada = prob.pinnrep.adaloss.init_state(1, n_bc, jnp.float64)
    loss, grad = jax.value_and_grad(lambda th: prob.loss(
        th, {"key": jax.random.key(0), "adaptive": ada})[0])(prob.init_params)
    return float(loss), tpkg.params_from_jax(jax.tree.map(np.asarray, grad))


def _assert_grads(got, want, tol):
    for k, g in got.items():
        g = torch.zeros_like(want[k]) if g is None else g
        assert np.max(np.abs(g.numpy() - want[k].numpy())) <= tol * max(
            np.max(np.abs(want[k].numpy())), 1e-300), k


@pytest.mark.parametrize("route", ["separable", "dense-jvp", "dense-jet"])
def test_gradient_enhanced_matches_jax(route):
    """gPINN rows: symbolic on the factorized grid, exact jvps in the
    coordinates on the dense grid (through `tanh_jet2` under "jet")."""
    if route == "separable":
        strategy, builder, kw = (lambda pkg: pkg.SeparableTraining(dx=1 / 8),
                                 _sep((12, 12), 8), {})
    else:
        strategy = lambda pkg: pkg.GridTraining(1 / 8)  # noqa: E731
        builder = lambda pkg, kw: pkg.mlp([2, 8, 8, 1], **kw)  # noqa: E731
        kw = {"derivative": route.split("-")[1]}
    jprob, tprob = _problems(gpinn_system, builder, strategy, seed=7,
                             gradient_enhanced=0.3, **kw)
    loss, grad = _loss_and_grad(tprob, 2)
    jloss, jgrad = _jax_loss_and_grad(jprob, 2)
    assert rel_err(loss, jloss) < 1e-10
    _assert_grads(grad, jgrad, 1e-10)
    _, plain = _problems(gpinn_system, builder, strategy, seed=7, **kw)
    assert abs(loss - _loss_and_grad(plain, 2)[0]) > 1e-6


def cubic_system(pkg):
    """Dt(u) ~ u**3 on [0, 1], u(0) = -1: a power of the network output."""
    t = pkg.symbols("t")
    u = pkg.DepVar("u")
    return pkg.PDESystem(pkg.Eq(pkg.Differential(t)(u(t)), u(t) ** 3),
                         [pkg.Eq(u(0.0), -1.0)],
                         [pkg.Domain(t, pkg.Interval(0, 1))], [t], [u(t)])


@pytest.mark.parametrize("derivative", ["jvp", "jet"])
def test_gradient_enhanced_power_of_the_output_matches_jax(derivative):
    """gPINN rows of ``u**3`` at negative u: the exponent stays a Python
    number, so the backward pass through the rows' tangent is finite (a
    tensor exponent made every gradient NaN) and equals the JAX package's."""
    tree = _tree(jpkg.mlp([1, 8, 8, 1]), 11)
    tree["layer_2"]["weight"] = 0.3 * tree["layer_2"]["weight"]
    tree["layer_2"]["bias"] = np.full((1, 1), -2.0)
    kw = dict(derivative=derivative, gradient_enhanced=0.3)
    jprob = jpkg.discretize(cubic_system(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp([1, 8, 8, 1]), jpkg.GridTraining(0.1), init_params=tree,
        dtype=jnp.float64, **kw))
    tprob = tpkg.discretize(cubic_system(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 8, 8, 1], dtype=F64), tpkg.GridTraining(0.1),
        init_params=tpkg.params_from_jax(tree), dtype=F64, device="cpu",
        **kw))
    u = jprob.pinnrep.phi(jnp.linspace(0, 1, 11)[None, :],
                          jprob.init_params["depvar"])
    assert bool(jnp.all(u < 0))
    loss, grad = _loss_and_grad(tprob, 1)
    jloss, jgrad = _jax_loss_and_grad(jprob, 1)
    assert np.isfinite(loss) and np.isfinite(jloss)
    assert all(bool(torch.isfinite(g).all()) for g in grad.values())
    assert rel_err(loss, jloss) < 1e-10
    _assert_grads(grad, jgrad, 1e-10)


@pytest.mark.parametrize("strategy", ["separable", "grid"])
def test_remat_matches_plain_and_jax(strategy):
    if strategy == "separable":
        strat, builder = (lambda pkg: pkg.SeparableTraining(dx=1 / 8),
                          _sep((12,), 8))
    else:
        strat = lambda pkg: pkg.GridTraining(1 / 8)  # noqa: E731
        builder = lambda pkg, kw: pkg.mlp([2, 8, 1], **kw)  # noqa: E731
    jprob, tprob = _problems(gpinn_system, builder, strat, seed=8, remat=True)
    _, plain = _problems(gpinn_system, builder, strat, seed=8)
    loss, grad = _loss_and_grad(tprob, 2)
    ploss, pgrad = _loss_and_grad(plain, 2)
    jloss, jgrad = _jax_loss_and_grad(jprob, 2)
    assert loss == ploss and rel_err(loss, jloss) < 1e-10
    _assert_grads(grad, pgrad, 1e-14)
    _assert_grads(grad, jgrad, 1e-10)


def test_gradient_enhanced_causal_eps_zero_reduces_to_plain():
    kw = dict(gradient_enhanced=0.2)
    _, zero = _problems(heat, _sep((12,), 8), lambda pkg: pkg.SeparableTraining(
        dx=1 / 16, causal="t", causal_eps=0.0), seed=2, **kw)
    _, plain = _problems(heat, _sep((12,), 8),
                         lambda pkg: pkg.SeparableTraining(dx=1 / 16), seed=2,
                         **kw)
    assert rel_err(_losses(zero, zero.init_params)[0],
                   _losses(plain, plain.init_params)[0]) < 1e-12
    _, probe = _problems(heat, _sep((12,), 8), lambda pkg: pkg.SeparableTraining(
        dx=1 / 16, causal="t", causal_eps=5.0), seed=2, **kw)
    w = probe.pinnrep.strategy.causal_weights(probe.init_params)[0].numpy()
    assert w.shape == (17,) and w[0] == 1.0 and np.all(np.diff(w) <= 1e-12)


def hard_net(pkg, kw):
    return pkg.SeparableNet([pkg.Transformed(pkg.mlp([1, 16, 16, 8], **kw),
                                             _hard) for _ in range(2)])


def test_adam_steps_of_the_hard_constrained_problem_match_optax():
    jprob, tprob = _problems(hard_poisson, hard_net,
                             lambda pkg: pkg.SeparableTraining(dx=1 / 16),
                             seed=10)
    jlf, tlf = jprob.pinnrep.loss_functions, tprob.pinnrep.loss_functions
    opt = optax.adam(2e-3)
    jstep = jax.jit(jax_make_step(jprob.loss, opt, jprob.pinnrep.adaloss,
                                  jlf.pde_loss_functions,
                                  jlf.bc_loss_functions))
    jada = jprob.pinnrep.adaloss.init_state(1, 0, jnp.float64)
    jcarry = (jprob.init_params, opt.init(jprob.init_params), jada,
              jnp.asarray(0, jnp.int32))
    tstep = tpkg.make_step(tprob.loss, tpkg.adam(2e-3), tprob.pinnrep.adaloss)
    tcarry = tstep.init(tprob.init_params,
                        tprob.pinnrep.adaloss.init_state(1, 0, F64, "cpu"))
    for _ in range(5):
        jcarry, (jloss, _) = jstep(jcarry, jax.random.key(0))
        tcarry, (tloss, _) = tstep(tcarry, torch.Generator())
        assert rel_err(float(tloss), float(jloss)) < 1e-8
    want = tpkg.params_from_jax(jax.tree.map(np.asarray, jcarry[0]))
    for k, v in tcarry[0].items():
        assert rel_err(v.detach().numpy(), want[k].numpy()) < 1e-8, k


def test_float32_loss_matches_jax():
    jnet = hard_net(jpkg, {})
    tree = _tree(jnet, 11)
    jprob = jpkg.discretize(hard_poisson(jpkg), jpkg.PhysicsInformedNN(
        jnet, jpkg.SeparableTraining(dx=1 / 16), init_params=tree,
        dtype=jnp.float32, matmul_precision="highest"))
    tprob = tpkg.discretize(hard_poisson(tpkg), tpkg.PhysicsInformedNN(
        hard_net(tpkg, {"dtype": torch.float32}),
        tpkg.SeparableTraining(dx=1 / 16), init_params=tpkg.params_from_jax(
            tree), dtype=torch.float32, matmul_precision="highest",
        device="cpu"))
    got = _losses(tprob, tprob.init_params)
    assert tprob.init_params["depvar.axis_0.layer_0.weight"].dtype == torch.float32
    assert rel_err(got, _jlosses(jprob)) < 1e-5


class TestErrors:
    def test_dense_chain_rejected(self):
        with pytest.raises(TypeError, match="SeparableNet"):
            tpkg.discretize(hard_poisson(tpkg), tpkg.PhysicsInformedNN(
                tpkg.mlp([2, 8, 1]), tpkg.SeparableTraining(dx=0.5),
                device="cpu"))

    def test_axis_coupling_argument_rejected(self):
        x, y = tpkg.symbols("x y")
        u = tpkg.DepVar("u")
        net = tpkg.separable_mlp(2, (8,), 4)
        _, tctx = _contexts([], [net])
        res, _ = t_sep(tpkg.Eq(u(x * y, y), 0.0), tctx, {"u": net},
                       torch.float32)
        theta = {f"depvar.{k}": v for k, v in net.named_parameters()}
        with pytest.raises(ValueError, match="couples"):
            res([np.linspace(0, 1, 4), np.linspace(0, 1, 4)], theta)

    def test_integral_terms_wait_for_a_later_slice(self):
        x, y, s = tpkg.symbols("x y s")
        u = tpkg.DepVar("u")
        net = tpkg.separable_mlp(2, (8,), 4)
        _, tctx = _contexts([], [net])
        res, _ = t_sep(tpkg.Eq(u(x, y), tpkg.Integral(s, 0.0, 1.0)(u(s, y))),
                       tctx, {"u": net}, torch.float32)
        theta = {f"depvar.{k}": v for k, v in net.named_parameters()}
        # they waited for the quadrature slice; now the integration variable
        # is a temporary grid axis (tests/test_torch_integrals.py holds the
        # values to the JAX package's), and symbolic bounds route the
        # equation to the dense block
        out = res([np.linspace(0, 1, 4), np.linspace(0, 1, 5)], theta)
        assert out.shape == (4, 5) and out.dtype == torch.float32
        res, _ = t_sep(tpkg.Eq(u(x, y), tpkg.Integral(s, 0.0, x)(u(s, y))),
                       tctx, {"u": net}, torch.float32)
        with pytest.raises(NotImplementedError, match="separable fast path"):
            res([np.linspace(0, 1, 4), np.linspace(0, 1, 4)], theta)

    def test_strategy_arg_validation(self):
        with pytest.raises(ValueError, match="exactly one"):
            tpkg.SeparableTraining()
        with pytest.raises(ValueError, match="exactly one"):
            tpkg.SeparableTraining(dx=0.1, points=8)
        with pytest.raises(ValueError, match="resample"):
            tpkg.SeparableTraining(points=8)
        with pytest.raises(ValueError, match="rad_candidates"):
            tpkg.SeparableTraining(dx=0.1, rad_candidates=64)

    def test_mismatched_axis_ranks_rejected(self):
        with pytest.raises(ValueError, match="rank"):
            tpkg.SeparableNet([tpkg.mlp([1, 8, 4]), tpkg.mlp([1, 8, 6])])
        with pytest.raises(ValueError, match="scalar input"):
            tpkg.SeparableNet([tpkg.mlp([2, 8, 4]), tpkg.mlp([1, 8, 4])])
