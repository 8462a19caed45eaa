"""The port's example programs (`neuralpde_tpu_torch/examples/`) against
`examples/*.py` and the JAX package.

* Every `examples/*.py` has a module of the same name in the port; each
  parses and its `neuralpde_tpu_torch` imports resolve.
* The five systems the port had never run before its examples, at a small
  size, from the same parameters (numpy draws in the JAX tree's layout,
  `params_from_jax`) and, for the stochastic strategy, the JAX package's
  own points: the (3+1)-D Beltrami SPINN with all 22 conditions and their
  weights under causal weighting, the Taylor-Green SPINN, the dense
  Taylor-Green net (chained periodic embeddings) under `CausalTraining`,
  the hard-constrained 3-D Helmholtz SPINN, and Kuramoto-Sivashinsky at
  order 4 under Taylor mode.  The JAX side is built from the JAX
  package's API by the functions below, which follow the example scripts
  (those scripts set JAX's compilation cache or train when imported); the
  port's side comes from the example modules.  Tolerances: float64 loss
  and gradient 1e-9 relative (gradients against each parameter's largest
  entry); the port's float32 loss 1e-5 relative to the JAX package's
  float64 loss.
* Every example's ``run()`` completes at a toy size on the CPU with a
  finite ``rel_l2``.
"""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import hard, mlp_params, rel_err, tree_like
from neuralpde_tpu.ops import sampling as jsampling

F64 = torch.float64
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
PORT_EXAMPLES = os.path.join(os.path.dirname(tpkg.__file__), "examples")


def _scripts():
    return sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py"))


@pytest.mark.parametrize("script", _scripts())
def test_every_example_has_a_port_that_parses_and_resolves(script):
    path = os.path.join(PORT_EXAMPLES, script)
    assert os.path.exists(path), f"no port of examples/{script}"
    tree = ast.parse(open(path).read())
    missing = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] == "neuralpde_tpu_torch":
            mod = importlib.import_module(node.module)
            missing += [f"{node.module}.{a.name}" for a in node.names
                        if not hasattr(mod, a.name)
                        and not importlib.util.find_spec(
                            f"{node.module}.{a.name}")]
    assert not missing, f"{script}: unresolved imports {missing}"
    mod = importlib.import_module(
        f"neuralpde_tpu_torch.examples.{script[:-3]}")
    assert callable(mod.run) and callable(mod.main)


# ---------------------------------------------------------------------------
# JAX-side systems and nets (examples/*.py, in the JAX package's API)
# ---------------------------------------------------------------------------

def _beltrami_analytic(pkg, sx, sy, sz, st):
    e, s, c = pkg.exp, pkg.sin, pkg.cos
    dec = e(-st)
    ua = -(e(sx) * s(sy + sz) + e(sz) * c(sx + sy)) * dec
    va = -(e(sy) * s(sz + sx) + e(sx) * c(sy + sz)) * dec
    wa = -(e(sz) * s(sx + sy) + e(sy) * c(sz + sx)) * dec
    pa = -0.5 * (e(2 * sx) + e(2 * sy) + e(2 * sz)
                 + 2 * s(sx + sy) * c(sz + sx) * e(sy + sz)
                 + 2 * s(sy + sz) * c(sx + sy) * e(sz + sx)
                 + 2 * s(sz + sx) * c(sy + sz) * e(sx + sy)) * e(-2 * st)
    return ua, va, wa, pa


def beltrami_system(pkg):
    """examples/beltrami_spinn.py:102-134 (a = d = nu = 1)."""
    x, y, z, t = pkg.symbols("x y z t")
    u, v, w, p = (pkg.DepVar(n) for n in "uvwp")
    Dt, Dx, Dy, Dz = (pkg.Differential(s) for s in (t, x, y, z))
    U, V, W, P = u(x, y, z, t), v(x, y, z, t), w(x, y, z, t), p(x, y, z, t)

    def lap(F):
        return (Dx ** 2)(F) + (Dy ** 2)(F) + (Dz ** 2)(F)

    eqs = [pkg.Eq(Dt(U) + U * Dx(U) + V * Dy(U) + W * Dz(U) + Dx(P), lap(U)),
           pkg.Eq(Dt(V) + U * Dx(V) + V * Dy(V) + W * Dz(V) + Dy(P), lap(V)),
           pkg.Eq(Dt(W) + U * Dx(W) + V * Dy(W) + W * Dz(W) + Dz(P), lap(W)),
           pkg.Eq(Dx(U) + Dy(V) + Dz(W), 0.0)]
    ua0, va0, wa0, _ = _beltrami_analytic(pkg, x, y, z, 0.0)
    bcs = [pkg.Eq(u(x, y, z, 0.0), ua0), pkg.Eq(v(x, y, z, 0.0), va0),
           pkg.Eq(w(x, y, z, 0.0), wa0)]
    for const, sym in [(-1.0, "x"), (1.0, "x"), (-1.0, "y"), (1.0, "y"),
                       (-1.0, "z"), (1.0, "z")]:
        sub = {"x": x, "y": y, "z": z}
        sub[sym] = const
        ua, va, wa, _ = _beltrami_analytic(pkg, sub["x"], sub["y"],
                                           sub["z"], t)
        bcs += [pkg.Eq(f(sub["x"], sub["y"], sub["z"], t), a)
                for f, a in ((u, ua), (v, va), (w, wa))]
    bcs.append(pkg.Eq(p(0.0, 0.0, 0.0, t),
                      _beltrami_analytic(pkg, 0.0, 0.0, 0.0, t)[3]))
    return pkg.PDESystem(
        eqs, bcs, [pkg.Domain(x, pkg.Interval(-1, 1)),
                   pkg.Domain(y, pkg.Interval(-1, 1)),
                   pkg.Domain(z, pkg.Interval(-1, 1)),
                   pkg.Domain(t, pkg.Interval(0, 1))],
        [x, y, z, t], [U, V, W, P])


def _ns2d_equations(pkg, nu=0.1):
    """The Taylor-Green system of examples/taylor_green_spinn.py:41-57 and
    examples/taylor_green_ns.py:47-69."""
    x, y, t = pkg.symbols("x y t")
    u, v, p = pkg.DepVar("u"), pkg.DepVar("v"), pkg.DepVar("p")
    Dt, Dx, Dy = (pkg.Differential(s) for s in (t, x, y))
    U, V, P = u(x, y, t), v(x, y, t), p(x, y, t)
    eqs = [pkg.Eq(Dt(U) + U * Dx(U) + V * Dy(U) + Dx(P),
                  nu * ((Dx ** 2)(U) + (Dy ** 2)(U))),
           pkg.Eq(Dt(V) + U * Dx(V) + V * Dy(V) + Dy(P),
                  nu * ((Dx ** 2)(V) + (Dy ** 2)(V))),
           pkg.Eq(Dx(U) + Dy(V), 0.0)]
    bcs = [pkg.Eq(u(x, y, 0.0), -pkg.cos(x) * pkg.sin(y)),
           pkg.Eq(v(x, y, 0.0), pkg.sin(x) * pkg.cos(y)),
           pkg.Eq(p(x, y, 0.0), -0.25 * (pkg.cos(2.0 * x)
                                         + pkg.cos(2.0 * y))),
           pkg.Eq(p(0.0, 0.0, t), -0.5 * pkg.exp(-4.0 * nu * t))]
    pi2 = 2 * np.pi
    return pkg.PDESystem(eqs, bcs, [pkg.Domain(x, pkg.Interval(0, pi2)),
                                    pkg.Domain(y, pkg.Interval(0, pi2)),
                                    pkg.Domain(t, pkg.Interval(0, 1))],
                         [x, y, t], [U, V, P])


def _tg_axis_net(pkg, periodic, hidden, rank):
    if periodic:
        return pkg.Chain(pkg.PeriodicEmbedding(1, axis=0, period=2 * np.pi,
                                               n_modes=6),
                         pkg.Dense(12, hidden, jpkg.nn.core.tanh),
                         pkg.Dense(hidden, hidden, jpkg.nn.core.tanh),
                         pkg.Dense(hidden, rank))
    return pkg.mlp([1, hidden, hidden, rank])


def helmholtz_system(pkg, a=2, k=1.0):
    """examples/helmholtz3d_spinn.py:46-61."""
    x, y, z = pkg.symbols("x y z")
    u = pkg.DepVar("u")
    api = a * np.pi
    q = (k ** 2 - 3 * api ** 2) * pkg.sin(api * x) * pkg.sin(api * y) \
        * pkg.sin(api * z)
    U = u(x, y, z)
    eq = pkg.Eq((pkg.Differential(x) ** 2)(U) + (pkg.Differential(y) ** 2)(U)
                + (pkg.Differential(z) ** 2)(U) + k ** 2 * U, q)
    return pkg.PDESystem(eq, [], [pkg.Domain(s, pkg.Interval(0, 1))
                                  for s in (x, y, z)], [x, y, z], [U])


def ks_system(pkg):
    """examples/kuramoto_sivashinsky.py:15-39."""
    x, t = pkg.symbols("x t")
    u = pkg.DepVar("u")
    Dt, Dx = pkg.Differential(t), pkg.Differential(x)

    def exact(xe, te):
        th = pkg.tanh(-xe / 2.0 + te)
        return 11 + 15 * th - 15 * th ** 2 - 15 * th ** 3

    def dexact(xe, te):
        th = pkg.tanh(-xe / 2.0 + te)
        return 15 / 2 * (th + 1) * (3 * th - 1) * (1 - th ** 2)

    U = u(x, t)
    eq = pkg.Eq(Dt(U) + U * Dx(U) + (Dx ** 2)(U) + 4.0 * (Dx ** 3)(U)
                + (Dx ** 4)(U), 0.0)
    bcs = [pkg.Eq(u(x, 0.0), exact(x, 0.0)),
           pkg.Eq(u(-10.0, t), exact(-10.0, t)),
           pkg.Eq(u(10.0, t), exact(10.0, t)),
           pkg.Eq(Dx(u(-10.0, t)), dexact(-10.0, t)),
           pkg.Eq(Dx(u(10.0, t)), dexact(10.0, t))]
    return pkg.PDESystem(eq, bcs, [pkg.Domain(x, pkg.Interval(-10, 10)),
                                   pkg.Domain(t, pkg.Interval(0, 1))],
                         [x, t], [U])


# ---------------------------------------------------------------------------
# loss and gradient of both packages
# ---------------------------------------------------------------------------

def _jax_loss_and_grad(prob, n_pde, n_bc):
    ada = prob.pinnrep.adaloss.init_state(n_pde, n_bc, prob.pinnrep.dtype)
    loss, grad = jax.jit(jax.value_and_grad(lambda th: prob.loss(
        th, {"key": jax.random.key(0), "adaptive": ada})[0]))(
            prob.init_params)
    return float(loss), tpkg.params_from_jax(jax.tree.map(np.asarray, grad))


def _loss_and_grad(prob, n_pde, n_bc):
    pinnrep = prob.pinnrep
    theta = {k: v.clone().requires_grad_(True)
             for k, v in prob.init_params.items()}
    with tpkg.matmul_precision("highest"):
        loss, _ = prob.loss(theta, {
            "generator": None,
            "adaptive": pinnrep.adaloss.init_state(n_pde, n_bc,
                                                   pinnrep.dtype, "cpu")})
    grads = torch.autograd.grad(loss, list(theta.values()),
                                materialize_grads=True)
    return float(loss.detach()), dict(zip(theta, grads))


def _assert_parity(jprob, tprob, tprob32, n_pde, n_bc):
    """Loss and gradient in float64 to 1e-9; the port's float32 loss to
    1e-5 of the JAX package's float64 loss."""
    loss, grad = _loss_and_grad(tprob, n_pde, n_bc)
    jloss, jgrad = _jax_loss_and_grad(jprob, n_pde, n_bc)
    assert np.isfinite(loss) and rel_err(loss, jloss) < 1e-9, (loss, jloss)
    assert set(grad) == set(jgrad)
    for k, g in grad.items():
        assert rel_err(g.numpy(), jgrad[k].numpy()) < 1e-9, k
    assert tprob32.init_params[next(iter(grad))].dtype == torch.float32
    assert rel_err(_loss_and_grad(tprob32, n_pde, n_bc)[0], jloss) < 1e-5


def _trees(jnets, names, seed, scale=0.5):
    rng = np.random.default_rng(seed)
    return {n: tree_like(net.init(jax.random.key(0)), rng, scale)
            for n, net in zip(names, jnets)}


def _port_pair(build, params):
    """The port's problem in float64 and in float32 from ``params``."""
    return (build(F64, tpkg.params_from_jax(params, dtype=F64)),
            build(torch.float32,
                  tpkg.params_from_jax(params, dtype=torch.float32)))


# ---------------------------------------------------------------------------
# (3+1)-D Beltrami SPINN
# ---------------------------------------------------------------------------

BELTRAMI_NODES = (5, 4, 4, 3)


@pytest.mark.parametrize("eps", [1.0, 30.0])
def test_beltrami_loss_and_gradient_match_jax(eps):
    from neuralpde_tpu_torch.examples import beltrami_spinn as ex

    jnets = [jpkg.SeparableNet([jpkg.mlp([1, 8, 8, 4]) for _ in range(4)])
             for _ in range(4)]
    trees = _trees(jnets, "uvwp", 40, scale=0.4)
    h = [2.0 / (n - 1) for n in BELTRAMI_NODES[:3]]
    t = jpkg.symbols("t")
    jprob = jpkg.discretize(beltrami_system(jpkg), jpkg.PhysicsInformedNN(
        jnets, jpkg.SeparableTraining(dx=h + [1.0 / (BELTRAMI_NODES[3] - 1)],
                                      causal=t, causal_eps=eps),
        init_params=trees, dtype=jnp.float64,
        adaptive_loss=jpkg.NonAdaptiveLoss(bc_loss_weights=ex.BC_WEIGHTS)))
    tprob, tprob32 = _port_pair(lambda dtype, init: ex.make_problem(
        ex.make_nets(4, 8, dtype), eps, nodes=BELTRAMI_NODES, dtype=dtype,
        device="cpu", init_params=init), trees)
    assert len(tprob.pinnrep.loss_functions.bc_loss_functions) == 22
    _assert_parity(jprob, tprob, tprob32, 4, 22)
    w = tprob.pinnrep.strategy.causal_weights(tprob.init_params)
    assert len(w) == 4 and all(tuple(c.shape) == (3,) for c in w)


# ---------------------------------------------------------------------------
# Taylor-Green: separable and dense
# ---------------------------------------------------------------------------

def test_taylor_green_spinn_loss_and_gradient_match_jax():
    from neuralpde_tpu_torch.examples import taylor_green_spinn as ex

    nodes = (6, 5, 4)
    jnets = [jpkg.SeparableNet([_tg_axis_net(jpkg, True, 8, 4),
                                _tg_axis_net(jpkg, True, 8, 4),
                                _tg_axis_net(jpkg, False, 8, 4)])
             for _ in range(3)]
    trees = _trees(jnets, "uvp", 41)
    pi2 = 2 * np.pi
    jprob = jpkg.discretize(_ns2d_equations(jpkg), jpkg.PhysicsInformedNN(
        jnets, jpkg.SeparableTraining(
            dx=[pi2 / (nodes[0] - 1), pi2 / (nodes[1] - 1),
                1.0 / (nodes[2] - 1)], causal=jpkg.symbols("t"),
            causal_eps=3.0),
        init_params=trees, dtype=jnp.float64,
        adaptive_loss=jpkg.NonAdaptiveLoss(bc_loss_weights=ex.BC_WEIGHTS)))
    tprob, tprob32 = _port_pair(lambda dtype, init: ex.make_problem(
        ex.make_nets(4, 8, dtype), 3.0, nodes=nodes, dtype=dtype,
        device="cpu", init_params=init), trees)
    _assert_parity(jprob, tprob, tprob32, 3, 4)


def test_taylor_green_dense_causal_loss_and_gradient_match_jax():
    """Every loss of the dense net under `CausalTraining` on the JAX
    package's points (its draw from key 30 + i for loss i), and their sum
    under the example's weights."""
    from neuralpde_tpu_torch.examples import taylor_green_ns as ex

    sizes = dict(points=64, bcs_points=16, n_slabs=4)
    pe = [jpkg.PeriodicEmbedding(3, axis=0, period=2 * np.pi, n_modes=6),
          jpkg.PeriodicEmbedding(14, axis=0, period=2 * np.pi, n_modes=6)]
    jnets = [jpkg.Chain(*pe, *jpkg.mlp([25, 8, 8, 8, 1]).layers)
             for _ in range(3)]
    trees = _trees(jnets, "uvp", 42)
    jstrategy = jpkg.CausalTraining(sizes["points"], jpkg.symbols("t"),
                                    bcs_points=sizes["bcs_points"],
                                    n_slabs=sizes["n_slabs"], causal_eps=10.0)
    jprob = jpkg.discretize(_ns2d_equations(jpkg), jpkg.PhysicsInformedNN(
        jnets, jstrategy, derivative="jet", init_params=trees,
        dtype=jnp.float64))
    jrep = jprob.pinnrep
    jfns = (jrep.loss_functions.pde_loss_functions
            + jrep.loss_functions.bc_loss_functions)
    weights = [1.0] * 3 + ex.BC_WEIGHTS
    keys, points = [], []
    for i in range(len(jfns)):
        keys.append(jax.random.key(30 + i))
        n = jstrategy.points if i < 3 else jstrategy.bcs_points
        lb, ub = jpkg.get_bounds(jrep.domains, [(jrep.pde_args
                                                 + jrep.bc_args)[i]], n,
                                 jnp.float64)[0]
        points.append(np.asarray(jsampling.uniform_random(
            keys[-1], n, lb, ub, dtype=jnp.float64)))
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda th: sum(
        w * f(th, k) for w, f, k in zip(weights, jfns, keys))))(
            jprob.init_params)
    jgrad = tpkg.params_from_jax(jax.tree.map(np.asarray, jgrad))

    def port(dtype):
        tprob, tstrategy = ex.make_problem(
            10.0, hidden=8, dtype=dtype, device="cpu",
            init_params=tpkg.params_from_jax(trees, dtype=dtype), **sizes)
        rep = tprob.pinnrep
        theta = {k: v.clone().requires_grad_(True)
                 for k, v in tprob.init_params.items()}
        total = 0.0
        for w, f, pts in zip(weights, rep.loss_functions.pde_loss_functions
                             + rep.loss_functions.bc_loss_functions, points):
            tstrategy.sampler = (lambda n, lb, ub, g, pts=pts:
                                 torch.tensor(pts, dtype=dtype))
            with tpkg.matmul_precision("highest"):
                total = total + w * f(theta, None)
        grads = torch.autograd.grad(total, list(theta.values()))
        return float(total.detach()), dict(zip(theta, grads))

    loss, grad = port(F64)
    assert np.isfinite(loss) and rel_err(loss, float(jloss)) < 1e-9
    for k, g in grad.items():
        assert rel_err(g.numpy(), jgrad[k].numpy()) < 1e-9, k
    assert rel_err(port(torch.float32)[0], float(jloss)) < 1e-5


# ---------------------------------------------------------------------------
# Helmholtz (hard constraint on every axis) and Kuramoto-Sivashinsky
# ---------------------------------------------------------------------------

def test_helmholtz_loss_and_gradient_match_jax():
    from neuralpde_tpu_torch.examples import helmholtz3d_spinn as ex

    jnet = jpkg.SeparableNet([jpkg.Transformed(jpkg.mlp([1, 8, 8, 4]), hard)
                              for _ in range(3)])
    tree = tree_like(jnet.init(jax.random.key(0)), np.random.default_rng(43))
    jprob = jpkg.discretize(helmholtz_system(jpkg), jpkg.PhysicsInformedNN(
        jnet, jpkg.SeparableTraining(dx=[1 / 5, 1 / 4, 1 / 3]),
        init_params=tree, dtype=jnp.float64))
    tprob, tprob32 = _port_pair(lambda dtype, init: ex.build_problem(
        (6, 5, 4), 4, 8, dtype=dtype, device="cpu", init_params=init)[0],
        tree)
    _assert_parity(jprob, tprob, tprob32, 1, 0)


def test_kuramoto_sivashinsky_order_4_jet_matches_jax():
    from neuralpde_tpu_torch.examples import kuramoto_sivashinsky as ex

    tree = mlp_params(np.random.default_rng(44), [2, 8, 8, 1])
    jprob = jpkg.discretize(ks_system(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp([2, 8, 8, 1]), jpkg.GridTraining([4.0, 0.25]),
        derivative="jet", init_params=tree, dtype=jnp.float64))
    tprob, tprob32 = _port_pair(lambda dtype, init: ex.make_problem(
        (4.0, 0.25), (2, 8, 8, 1), dtype=dtype, device="cpu",
        init_params=init), tree)
    _assert_parity(jprob, tprob, tprob32, 1, 5)


# ---------------------------------------------------------------------------
# every example's run() at a toy size
# ---------------------------------------------------------------------------

TOY = {
    "allen_cahn_causal": dict(stages=((1.0, 2, 1e-3),), points=32,
                              bcs_points=8, n_slabs=2, hidden=4, depth=1),
    "allen_cahn_spinn": dict(rank=4, nodes=8, iters=2, hidden=(4,),
                             stages=((100.0, 1e-3), (1e3, 5e-4))),
    "beltrami_spinn": dict(nodes=(4, 3, 3, 3), rank=2, iters=2, hidden=4,
                           stages=((1.0, 1e-3), (30.0, 5e-4)), n_eval=3),
    "burgers_dgm": dict(iters=2, width=4, layers=1, points=16),
    "burgers_pino": dict(iters=2, alg_kw=dict(width=4, modes=(2, 2), depth=1,
                                              members=2, dx=(1 / 8, 1 / 4)),
                         eval_kw=dict(nus=[0.1], nx=9, nt=5)),
    "export_serving": dict(iters=2, batch=8),
    "fbpinn_multiscale": dict(part="all", iters=2,
                              ode=dict(subdivisions=2, width=4, inner=1),
                              laplace=dict(L=1, dx=0.25, width=4, inner=1)),
    "gauss_newton_frontier": dict(n=5, width=4, maxiters=2, cg_iters=3),
    "gbm_sde": dict(iters=2, hidden=4, numensemble=4, dt=1 / 4),
    "helmholtz3d_spinn": dict(iters=2, n_grid=(4, 3, 3), rank=2, hidden=4,
                              n_eval=5),
    "kuramoto_sivashinsky": dict(adam_iters=2, lbfgs_iters=2, dx=(5.0, 0.5),
                                 sizes=(2, 4, 1)),
    "lotka_volterra_bpinn": dict(draws=12, n_leapfrog=2, n_data=10),
    "ns_vorticity_pino": dict(iters=2, width=4, modes=(2, 2, 2), depth=1,
                              nodes=9, members=2),
    "poisson_2d": dict(iters=2, dx=0.25, sizes=(2, 4, 1)),
    "taylor_green_ns": dict(iters=2, points=32, bcs_points=8, n_slabs=2,
                            hidden=4),
    "taylor_green_spinn": dict(nodes=(4, 4, 3), rank=2, iters=2, hidden=4,
                               n_eval=5),
}


@pytest.mark.parametrize("name", sorted(TOY))
def test_run_at_a_toy_size_on_the_cpu(name):
    mod = importlib.import_module(f"neuralpde_tpu_torch.examples.{name}")
    out = mod.run(verbose=False, device="cpu", **TOY[name])
    assert np.isfinite(out["rel_l2"]) and out["wall_s"] >= 0
    assert all(np.isfinite(stage[-1]) for stage in out.get("per_stage", []))


def test_sharded_training_main_runs_in_a_group_of_one_on_the_cpu(
        monkeypatch):
    from neuralpde_tpu_torch.examples import sharded_training

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    out = sharded_training.main(["--iters", "2", "--device", "cpu"])
    assert out["ranks"] == 1 and np.isfinite(out["rel_l2"])
    assert not torch.distributed.is_initialized()
