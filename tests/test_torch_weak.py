"""Parity of the port's hp-VPINN weak form with the JAX package: the host
side (`_test_basis`, `_axis_matrices`, `_ibp_groups`), `WeakTraining` loss
and gradient at ibp 0, 1 and 2 in 1-D and 2-D (explicit edges, per-element
test counts, the integral routing, the `gradient_enhanced` rejection),
`refine_weak` in its three modes, `solve_weak_adaptive`, and Gauss-Newton's
Weak branch.

The same parameters (`numpy.random.default_rng(seed)`, crossing through
`params_from_jax`) go through both packages; the nodes are each package's
own, computed by the same float64 numpy code.

Tolerances, relative to the largest |value|: float64 1e-10 (weak rows are
sums of ~q products; the two einsum orders differ in the last bits),
float32 1e-5 for the loss and 1e-4 for its gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, poisson_1d, poisson_2d, rel_err
from neuralpde_tpu.compile import weak as jweak
from neuralpde_tpu_torch.compile import weak as tweak

F64, F32 = torch.float64, torch.float32
JDT = {F64: jnp.float64, F32: jnp.float32}


# --- the host side, entry for entry -------------------------------------------

@pytest.mark.parametrize("vanish", [0, 1, 2])
def test_test_basis_entry_for_entry(vanish):
    got, want = tweak._test_basis(6, vanish), jweak._test_basis(6, vanish)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="vanish"):
        tweak._test_basis(4, 3)


@pytest.mark.parametrize("case", [
    dict(n_test=5, vanish=0, quad=9, lo=0.0, hi=2.0, elements=3, max_order=0),
    dict(n_test=7, vanish=1, quad=16, lo=-1.0, hi=3.0, elements=4,
         max_order=1),
    dict(n_test=6, vanish=2, quad=12, lo=0.0, hi=1.0,
         elements=np.array([0.0, 0.1, 0.3, 0.35, 0.6, 1.0]), max_order=2),
    dict(n_test=np.array([3, 6, 3]), vanish=1, quad=10, lo=0.0, hi=1.0,
         elements=3, max_order=1),
], ids=["uniform", "ibp1", "edges-ibp2", "per-element"])
def test_axis_matrices_entry_for_entry(case):
    got, want = tweak._axis_matrices(**case), jweak._axis_matrices(**case)
    np.testing.assert_array_equal(got[0], want[0])            # nodes
    np.testing.assert_array_equal(got[1], want[1])            # weights
    assert len(got[2]) == len(want[2]) == case["max_order"] + 1
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)                   # C[m]
    np.testing.assert_array_equal(got[3], want[3])            # mask


def test_axis_matrices_rejects_bad_meshes():
    with pytest.raises(ValueError, match="edges must increase"):
        tweak._axis_matrices(4, 1, 6, 0.0, 1.0, np.array([0.0, 0.6, 0.5, 1.0]),
                             1)
    with pytest.raises(ValueError, match="one entry per element"):
        tweak._axis_matrices(np.array([3, 3]), 1, 6, 0.0, 1.0, 3, 1)
    with pytest.raises(ValueError, match=">= 1"):
        tweak._axis_matrices(np.array([3, 0, 3]), 1, 6, 0.0, 1.0, 3, 1)
    with pytest.raises(ValueError, match="ibp"):
        tpkg.WeakTraining(ibp=3)


def _burgers_like(pkg):
    x, y = pkg.symbols("x y")
    u = pkg.DepVar("u")
    Dx, Dy = pkg.Differential(x), pkg.Differential(y)
    lhs = (u(x, y) * Dx(u(x, y)) - 0.07 * (Dx ** 2)(u(x, y))
           + (Dy ** 2)(u(x, y)) / 2.0 - Dx(Dy(u(x, y))))
    return pkg.expand_derivatives(lhs) - pkg.expand_derivatives(
        pkg.sin(np.pi * x))


@pytest.mark.parametrize("ibp", [0, 1, 2])
def test_ibp_groups_entry_for_entry(ibp):
    """The same groups, and the same expression in each (compared by their
    printed form, which both front ends share)."""
    got = tweak._ibp_groups(_burgers_like(tpkg), {"x", "y"}, ibp)
    want = jweak._ibp_groups(_burgers_like(jpkg), {"x", "y"}, ibp)
    assert list(got) == list(want)
    for key in want:
        assert repr(got[key]) == repr(want[key]), key
    if ibp == 1:
        assert set(got) == {(), (("x", 1),), (("y", 1),),
                            (("x", 1), ("y", 1))}


def test_hp_action_decision_rule():
    for args in [(10.0 ** -np.arange(8), 8, 4, 24, 0.1),
                 (np.ones(8), 8, 4, 24, 0.1),
                 (10.0 ** -np.arange(8), 22, 4, 24, 0.1),
                 (np.array([1.0, 1e-4, 1e-8, 1e-12, 777.0, 777.0]), 4, 4, 24,
                  0.1)]:
        assert tweak._hp_action(*args) == jweak._hp_action(*args)


# --- loss and gradient --------------------------------------------------------

def _pair(system, sizes, strategy_kw, dtype, mode="jet", seed=0, **disc_kw):
    tree = mlp_params(np.random.default_rng(seed), sizes)
    jprob = jpkg.discretize(system(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp(sizes), jpkg.WeakTraining(**strategy_kw), init_params=tree,
        derivative=mode, dtype=JDT[dtype], **disc_kw))
    tprob = tpkg.discretize(system(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp(sizes, dtype=dtype), tpkg.WeakTraining(**strategy_kw),
        init_params=tpkg.params_from_jax(tree), derivative=mode, dtype=dtype,
        device="cpu", **disc_kw))
    return jprob, tprob


def _loss_and_grad(jprob, tprob, dtype):
    n_pde = len(jprob.pinnrep.eqs)
    n_bc = len(jprob.pinnrep.bcs)
    lstate = {"key": jax.random.key(0),
              "adaptive": jprob.pinnrep.adaloss.init_state(n_pde, n_bc,
                                                           JDT[dtype])}
    want, jgrad = jax.value_and_grad(
        lambda th: jprob.loss(th, lstate)[0])(jprob.init_params)
    theta = {k: v.clone().requires_grad_(True)
             for k, v in tprob.init_params.items()}
    ada = tprob.pinnrep.adaloss.init_state(n_pde, n_bc, dtype, "cpu")
    got, aux = tprob.loss(theta, {"generator": None, "adaptive": ada})
    got.backward()
    grad = tpkg.parameters_to_vector({k: v.grad for k, v in theta.items()})[0]
    return (got.detach(), grad, aux), (want, ravel_pytree(jgrad)[0])


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("ibp", [0, 1, 2])
@pytest.mark.parametrize("dim", [1, 2])
def test_weak_loss_and_gradient(dim, ibp, dtype):
    system, sizes = ((poisson_1d, [1, 10, 10, 1]) if dim == 1
                     else (poisson_2d, [2, 10, 10, 1]))
    jprob, tprob = _pair(system, sizes, dict(elements=3, n_test=4, ibp=ibp),
                         dtype)
    (got, grad, aux), (want, jgrad) = _loss_and_grad(jprob, tprob, dtype)
    assert aux["pde_losses"].dtype == dtype
    tol = 1e-10 if dtype == F64 else 1e-5
    assert rel_err(got, want) < tol
    assert rel_err(grad, jgrad) < (1e-9 if dtype == F64 else 1e-4)


@pytest.mark.parametrize("kw", [
    dict(elements={"x": np.array([0.0, 0.1, 0.3, 0.35, 0.6, 1.0]), "y": 2},
         n_test=5, ibp=1),
    dict(elements=3, n_test={"x": np.array([3, 6, 3]), "y": 4}, ibp=1,
         quad=9),
    dict(elements=2, n_test=4, ibp=2, quad={"x": 7, "y": 9}, bc_dx=0.1),
], ids=["edges", "per-element-n_test", "quad-dict-bc_dx"])
def test_weak_loss_on_refined_meshes(kw):
    jprob, tprob = _pair(poisson_2d, [2, 8, 1], kw, F64, mode="jvp", seed=1)
    (got, grad, _), (want, jgrad) = _loss_and_grad(jprob, tprob, F64)
    assert rel_err(got, want) < 1e-10
    assert rel_err(grad, jgrad) < 1e-9


def _ide(pkg):
    x = pkg.symbols("x")
    u = pkg.DepVar("u")
    eq = pkg.Eq(u(x) + pkg.Integral(x, 0.0, 1.0)(u(x)), 1.0 + x)
    return pkg.PDESystem(eq, [pkg.Eq(u(0.0), 0.5)],
                         [pkg.Domain(x, pkg.Interval(0, 1))], [x], [u(x)])


def test_integral_equation_routes_to_quadrature_loss():
    """An integro-differential equation falls back to the quadrature-weighted
    pointwise loss on the same nodes, in both packages alike; `refine_weak`
    then has nothing to score."""
    jprob, tprob = _pair(_ide, [1, 8, 1], dict(elements=3, n_test=4), F64,
                         mode="jvp")
    (got, grad, _), (want, jgrad) = _loss_and_grad(jprob, tprob, F64)
    assert rel_err(got, want) < 1e-10
    assert rel_err(grad, jgrad) < 1e-9
    with pytest.raises(ValueError, match="quadrature-routed"):
        tpkg.refine_weak(tprob, tprob.init_params)


def test_gradient_enhanced_is_rejected_and_options_compose():
    disc = tpkg.PhysicsInformedNN(tpkg.mlp([1, 8, 1]), tpkg.WeakTraining(),
                                  gradient_enhanced=0.1, device="cpu")
    with pytest.raises(ValueError, match="gradient_enhanced"):
        tpkg.discretize(poisson_1d(tpkg), disc)
    # remat and a wider accumulation dtype leave the loss where it was
    kw = dict(elements=3, n_test=4, ibp=0)
    _, plain = _pair(poisson_1d, [1, 8, 1], kw, F32)
    _, remat = _pair(poisson_1d, [1, 8, 1], kw, F32, remat=True)
    _, wide = _pair(poisson_1d, [1, 8, 1], kw, F32, loss_accum_dtype=F64)
    values = []
    for prob in (plain, remat, wide):
        theta = {k: v.clone().requires_grad_(True)
                 for k, v in prob.init_params.items()}
        ada = prob.pinnrep.adaloss.init_state(1, 2, F32, "cpu")
        loss, _ = prob.loss(theta, {"generator": None, "adaptive": ada})
        loss.backward()
        values.append((float(loss), theta["depvar.layer_0.weight"].grad))
    assert values[0][0] == values[1][0]
    assert torch.equal(values[0][1], values[1][1])
    assert abs(values[2][0] - values[0][0]) < 1e-5 * abs(values[0][0])
    # an adaptive loss composes: its reweighting step runs
    disc = tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 8, 1]), tpkg.WeakTraining(elements=3, n_test=4),
        adaptive_loss=tpkg.MiniMaxAdaptiveLoss(reweight_every=5),
        device="cpu")
    res = tpkg.solve(tpkg.discretize(poisson_1d(tpkg), disc), tpkg.adam(1e-3),
                     maxiters=12)
    assert np.isfinite(res.objective)


# --- refinement ---------------------------------------------------------------

def _front(pkg, S=20.0, X0=0.7):
    x = pkg.symbols("x")
    u = pkg.DepVar("u")

    def th(e):
        return pkg.tanh(S * (e - X0))

    eq = pkg.Eq((pkg.Differential(x) ** 2)(u(x)),
                -2 * S ** 2 * th(x) * (1.0 - th(x) ** 2))
    bcs = [pkg.Eq(u(0.0), float(np.tanh(-S * X0))),
           pkg.Eq(u(1.0), float(np.tanh(S * (1 - X0))))]
    return pkg.PDESystem(eq, bcs, [pkg.Domain(x, pkg.Interval(0, 1))], [x],
                         [u(x)])


@pytest.mark.parametrize("mode,kw", [
    ("h", dict(frac=0.34)), ("h", dict(frac=0.5, parts=3)),
    ("p", dict(frac=0.5, p_inc=3)), ("p", dict(frac=0.34, p_inc=4, p_max=8)),
    ("hp", dict(frac=0.34, p_inc=4)), ("hp", dict(frac=1.0, smooth_tol=0.5)),
], ids=["h", "h-parts3", "p", "p-capped", "hp", "hp-all"])
def test_refine_weak_edges_and_counts(mode, kw):
    """With the same (untrained, injected) parameters in float64, both
    packages refine the front problem's mesh to the same edges, test counts
    and quadrature order.  The front's top elements are not tied."""
    jprob, tprob = _pair(_front, [1, 12, 12, 1],
                         dict(elements=6, n_test=5, ibp=1, quad=9), F64,
                         mode="jvp", seed=3)
    want = jpkg.refine_weak(jprob, jprob.init_params, mode=mode, **kw)
    got = tpkg.refine_weak(tprob, tprob.init_params, mode=mode, **kw)
    assert isinstance(got, tpkg.WeakTraining)
    np.testing.assert_allclose(np.asarray(got.elements["x"]),
                               np.asarray(want.elements["x"]), rtol=0,
                               atol=1e-15)
    np.testing.assert_array_equal(np.asarray(got.n_test["x"]),
                                  np.asarray(want.n_test["x"]))
    assert got.quad == want.quad and got.ibp == want.ibp
    assert got.bc_dx == want.bc_dx
    # the refined strategy builds and evaluates
    prob2 = tpkg.discretize(_front(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 12, 12, 1], dtype=F64), got, dtype=F64, device="cpu"))
    ada = prob2.pinnrep.adaloss.init_state(1, 2, F64, "cpu")
    loss, _ = prob2.loss(tprob.init_params, {"generator": None,
                                             "adaptive": ada})
    assert np.isfinite(float(loss))


def test_refine_weak_2d_scores_each_axis_and_keeps_unscored_settings():
    jprob, tprob = _pair(poisson_2d, [2, 8, 8, 1],
                         dict(elements={"x": 4, "y": 3},
                              n_test={"x": 5, "y": 4}, ibp=1), F64,
                         mode="jvp", seed=4)
    want = jpkg.refine_weak(jprob, jprob.init_params, frac=0.25)
    got = tpkg.refine_weak(tprob, tprob.init_params, frac=0.25)
    for axis in ("x", "y"):
        np.testing.assert_allclose(np.asarray(got.elements[axis]),
                                   np.asarray(want.elements[axis]), atol=1e-15)
        assert got.n_test[axis] == want.n_test[axis]


def test_refine_weak_argument_checks():
    grid = tpkg.discretize(poisson_1d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 8, 1]), tpkg.GridTraining(0.1), device="cpu"))
    with pytest.raises(TypeError, match="WeakTraining"):
        tpkg.refine_weak(grid, grid.init_params)
    prob = tpkg.discretize(poisson_1d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 8, 1]), tpkg.WeakTraining(elements=3, n_test=4),
        device="cpu"))
    for kw, match in ((dict(frac=0.0), "frac"), (dict(parts=1), "parts"),
                      (dict(mode="q"), "mode"), (dict(p_inc=0), "p_inc")):
        with pytest.raises(ValueError, match=match):
            tpkg.refine_weak(prob, prob.init_params, **kw)


def test_solve_weak_adaptive_argument_checks_and_short_run():
    system = poisson_1d(tpkg)
    grid = tpkg.PhysicsInformedNN(tpkg.mlp([1, 8, 1]), tpkg.GridTraining(0.1),
                                  device="cpu")
    with pytest.raises(TypeError, match="WeakTraining"):
        tpkg.solve_weak_adaptive(system, grid)
    disc = tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 12, 12, 1]), tpkg.WeakTraining(elements=4, n_test=4,
                                                     ibp=1),
        device="cpu", dtype=F32, derivative="jet", seed=3)
    with pytest.raises(ValueError, match="rounds"):
        tpkg.solve_weak_adaptive(system, disc, rounds=0)
    with pytest.raises(ValueError, match="entries"):
        tpkg.solve_weak_adaptive(system, disc, rounds=2, maxiters=[100])

    ares = tpkg.solve_weak_adaptive(
        _front(tpkg), disc, tpkg.adam(2e-3), rounds=3, maxiters=[60, 40, 40],
        frac=0.3, mode="hp", inner_steps=20)
    assert len(ares.strategies) == len(ares.results) == 3
    assert ares.iterations == 140 and len(ares.history) == 7
    assert ares.strategy is ares.strategies[-1]
    assert ares.params is ares.u and ares.objective == ares.results[-1].objective
    # the mesh moved every round, parameters carried over, device kept
    first, last = ares.strategies[0], ares.strategies[-1]
    assert (len(np.asarray(last.elements["x"])) - 1 > 4
            or np.ndim(last.n_test["x"]) or last.n_test["x"] > first.n_test)
    assert ares.prob.pinnrep.device.type == "cpu"
    assert ares.prob.pinnrep.strategy is last
    assert all(torch.equal(ares.prob.init_params[k], ares.results[1].u[k])
               for k in ares.u)
    # abstol ends the loop after the round that crosses it
    early = tpkg.solve_weak_adaptive(
        poisson_1d(tpkg), disc, tpkg.adam(2e-3), rounds=3, maxiters=20,
        abstol=1e9, inner_steps=20)
    assert len(early.strategies) == 1 and early.iterations == 20


# --- Gauss-Newton on weak rows -------------------------------------------------

@pytest.mark.parametrize("case", ["weights", "edges", "ide"])
def test_gauss_newton_weak_residual_vector(case):
    """r(theta) against the JAX package's vector, and ||r||^2 == loss."""
    if case == "weights":
        kw = dict(adaptive_loss=(jpkg.NonAdaptiveLoss, tpkg.NonAdaptiveLoss))
        system, strat = poisson_1d, dict(elements=4, n_test=6, ibp=1)
    elif case == "edges":
        kw = {}
        system = poisson_1d
        strat = dict(elements={"x": np.array([0.0, 0.1, 0.3, 0.35, 0.6, 1.0])},
                     n_test=5)
    else:
        kw, system, strat = {}, _ide, dict(elements=3, n_test=4)
    tree = mlp_params(np.random.default_rng(5), [1, 10, 10, 1])

    def ada(cls):
        return cls(pde_loss_weights=2.0, bc_loss_weights=[3.0, 5.0])

    extra = [dict(adaptive_loss=ada(c)) for c in kw["adaptive_loss"]] \
        if kw else [{}, {}]
    jprob = jpkg.discretize(system(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp([1, 10, 10, 1]), jpkg.WeakTraining(**strat),
        init_params=tree, dtype=jnp.float64, **extra[0]))
    tprob = tpkg.discretize(system(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 10, 10, 1], dtype=F64), tpkg.WeakTraining(**strat),
        init_params=tpkg.params_from_jax(tree), dtype=F64, device="cpu",
        **extra[1]))
    want = jpkg.build_residual_vector(jprob.pinnrep)(jprob.init_params)
    r = tpkg.build_residual_vector(tprob.pinnrep)(tprob.init_params)
    assert rel_err(r, want) < 1e-10
    n_bc = len(tprob.pinnrep.bcs)
    state = tprob.pinnrep.adaloss.init_state(1, n_bc, F64, "cpu")
    loss, _ = tprob.loss(tprob.init_params, {"generator": None,
                                             "adaptive": state})
    assert rel_err((r * r).sum(), loss) < 1e-12


def test_solve_gauss_newton_weak_step_sequence():
    """Three LM iterations (two accepted, one rejected) on weak rows with
    a Jacobi preconditioner whose probes are injected: the objective follows
    the JAX package's step for step (float64; 1e-6, since the truncated CG
    recurrences amplify the last bits: 3e-6 was seen after five)."""
    tree = mlp_params(np.random.default_rng(6), [1, 8, 8, 1])
    strat = dict(elements=4, n_test=5, ibp=1)
    jprob = jpkg.discretize(poisson_1d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp([1, 8, 8, 1]), jpkg.WeakTraining(**strat), init_params=tree,
        dtype=jnp.float64))
    tprob = tpkg.discretize(poisson_1d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 8, 8, 1], dtype=F64), tpkg.WeakTraining(**strat),
        init_params=tpkg.params_from_jax(tree), dtype=F64, device="cpu"))

    def jax_probes(n, dtype, device):
        """The JAX package's own probes (its fixed key), injected."""
        return torch.tensor(np.asarray(jax.random.rademacher(
            jax.random.key(0), (8, n), jnp.float64)), dtype=dtype)

    # damping 1: from these parameters the default 1e-3 finds no descent
    kw = dict(maxiters=3, cg_iters=60, precondition=True, damping=1.0)
    want = jpkg.solve_gauss_newton(jprob, **kw)
    got = tpkg.solve_gauss_newton(tprob, probes=jax_probes, **kw)
    assert got.iterations == want.iterations == 3
    np.testing.assert_allclose(got.history, np.asarray(want.history),
                               rtol=1e-6)
    assert got.history[2] == got.history[1]          # a rejected step
    assert got.objective < 0.6 * got.history[0]
    # on the CPU the inner steps run as they are: no graph is captured
    assert got.aux["cuda_graph"] == {"captures": 0, "replays": 0}
