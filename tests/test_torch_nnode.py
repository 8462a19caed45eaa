"""Parity of the port's ODE/DAE solver surface with the JAX package:
`solvers/ode.py` (NNODE's loss and gradient under each strategy at the same
time points, `tstops`, the data losses, complex u, the dense solution),
`solvers/dae.py` (NNDAE), Gauss-Newton on the NNODE objective, and `solve`
on a bare ``(loss, init_params)`` problem (no `PINNRepresentation`).

Parameters come from `numpy.random.default_rng(seed)` and cross through
`params_from_jax` (``"p"`` and complex leaves included).  Random time
points are drawn by the JAX package from its key and handed to the port
through `StochasticTraining.sampler`, never through a shared seed.

Tolerances: float64, 1e-10 relative for losses, residual vectors and
gradients of one evaluation with du/dt by forward mode; 1e-6 with du/dt by
the forward difference (a difference of two network values over
sqrt(eps) = 1.5e-8 carries their last bits up to 1e-8 of the result); 1e-6
for loss curves and parameters after some tens of Adam steps.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, rel_err
from neuralpde_tpu.solvers import ode as jode
from neuralpde_tpu_torch.solvers import dae as tdae
from neuralpde_tpu_torch.solvers import ode as tode

F64 = torch.float64
SIZES = [1, 10, 10, 2]
TSPAN = (0.0, 1.5)
U0 = np.array([1.0, 0.5])
P = np.array([-0.7, 1.3])


@pytest.fixture(autouse=True)
def float64_default():
    """The solvers work in the default float dtype, as the JAX package's
    do: float64 here, where the test suite turns on JAX's x64."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    yield
    torch.set_default_dtype(before)


def _f(xp):
    """u0' = p0 u0 + u1, u1' = -p1 u0 + sin t, in jax.numpy or torch."""
    def f(u, p, t):
        return xp.stack([p[0] * u[0] + u[1], -p[1] * u[0] + xp.sin(t)])
    return f


def _f_list(u, p, t):
    """The same system returning a list, as users of the port may."""
    return [p[0] * u[0] + u[1], -p[1] * u[0] + torch.sin(t)]


def _problems(**kw):
    return (jpkg.ODEProblem(_f(jnp), U0, TSPAN, p=P, **kw),
            tpkg.ODEProblem(_f(torch), U0, TSPAN, p=P, **kw))


def _theta(seed=0, sizes=SIZES, param_estim=False):
    tree = {"depvar": mlp_params(np.random.default_rng(seed), sizes)}
    if param_estim:
        tree["p"] = P.copy()
    jtheta = jax.tree.map(jnp.asarray, tree)
    return tree, jtheta, tpkg.params_from_jax(tree, dtype=F64)


def _value_and_grad(jloss, tloss, jtheta, ttheta, key=None, generator=None):
    want, jgrad = jax.value_and_grad(lambda th: jloss(th, key))(jtheta)
    theta = {k: v.clone().requires_grad_(True) for k, v in ttheta.items()}
    got = tloss(theta, generator)
    got.backward()
    return (float(got.detach()), {k: v.grad for k, v in theta.items()},
            float(want), tpkg.params_from_jax(jgrad))


def _dataset(n=12):
    ts = np.linspace(*TSPAN, n)
    rng = np.random.default_rng(5)
    return [np.cos(ts) + 0.01 * rng.normal(size=n),
            0.5 * np.exp(-ts) + 0.01 * rng.normal(size=n), ts,
            np.full(n, ts[1] - ts[0])]


STRATEGIES = {
    "grid": lambda pkg: pkg.GridTraining(0.1),
    "weighted": lambda pkg: pkg.WeightedIntervalTraining([0.6, 0.3, 0.1], 40,
                                                         seed=3),
    "quadrature_auto": lambda pkg: pkg.QuadratureTraining(
        order=4, abstol=1e-8, reltol=1e-8, maxiters=200),
    "quadrature_pinned": lambda pkg: pkg.QuadratureTraining(order=6, panels=2),
    "stochastic": lambda pkg: pkg.StochasticTraining(24),
}


@pytest.mark.parametrize("autodiff", [False, True], ids=["fd", "autodiff"])
@pytest.mark.parametrize("param_estim", [False, True], ids=["p", "theta_p"])
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_nnode_strategy_loss_and_gradient_match_jax(name, param_estim,
                                                    autodiff):
    """NNODE's loss (the quartic quadrature loss included: the JAX package
    integrates the square of the squared residual, and so does the port)."""
    _, jtheta, ttheta = _theta(param_estim=param_estim)
    jphi = jode.ODEPhi(jpkg.mlp(SIZES), TSPAN[0], U0)
    tphi = tode.ODEPhi(tpkg.mlp(SIZES, dtype=F64), TSPAN[0], U0,
                       like=ttheta["depvar.layer_0.weight"])
    jstrat, tstrat = STRATEGIES[name](jpkg), STRATEGIES[name](tpkg)
    jloss = jode._strategy_loss(jstrat, jphi, _f(jnp), autodiff, TSPAN,
                                jnp.asarray(P), param_estim, False,
                                jnp.float64, theta0=jtheta)
    tloss = tode._strategy_loss(tstrat, tphi, _f(torch), autodiff, TSPAN,
                                torch.tensor(P), param_estim, False, F64,
                                torch.device("cpu"), theta0=ttheta)
    key = jax.random.key(7)
    if name == "stochastic":
        points = TSPAN[0] + (TSPAN[1] - TSPAN[0]) * np.asarray(
            jax.random.uniform(key, (24,), dtype=jnp.float64))

        def sampler(n, lb, ub, generator):
            assert n == 24 and float(lb) == TSPAN[0] and float(ub) == TSPAN[1]
            return torch.tensor(points)[None, :]

        tstrat.sampler = sampler
    got, tgrad, want, jgrad = _value_and_grad(jloss, tloss, jtheta, ttheta,
                                              key, torch.Generator())
    tol = 1e-10 if autodiff else 1e-6
    assert rel_err(got, want) < tol
    for k, g in tgrad.items():
        assert rel_err(g.numpy(), jgrad[k].numpy()) < tol, k


def test_stochastic_draws_fresh_times_in_the_span():
    tstrat = tpkg.StochasticTraining(16)
    _, _, ttheta = _theta()
    tphi = tode.ODEPhi(tpkg.mlp(SIZES, dtype=F64), TSPAN[0], U0,
                       like=ttheta["depvar.layer_0.weight"])
    seen = []
    plain = tstrat.sampler

    def sampler(n, lb, ub, generator):
        seen.append(plain(n, lb, ub, generator))
        return seen[-1]

    tstrat.sampler = sampler
    loss = tode._strategy_loss(tstrat, tphi, _f(torch), True, TSPAN,
                               torch.tensor(P), False, False, F64,
                               torch.device("cpu"))
    g = torch.Generator().manual_seed(1)
    loss(ttheta, g), loss(ttheta, g)
    a, b = seen
    assert a.shape == (1, 16) and not torch.equal(a, b)
    assert bool(((a >= TSPAN[0]) & (a <= TSPAN[1])).all())


CONFIGS = {
    "grid_tstops": dict(alg={}, solve=dict(dt=0.1, tstops=[0.33, 0.66, 1.2])),
    "stochasticless_quadrature_tstops": dict(
        alg=dict(strategy="quadrature_pinned"), solve=dict(tstops=[0.5])),
    "weighted_tstops": dict(alg=dict(strategy="weighted"),
                            solve=dict(tstops=[0.2, 0.9])),
    "default_quadrature": dict(alg={}, solve={}),
    "param_estim_data": dict(alg=dict(param_estim=True, dataset=True),
                             solve=dict(dt=0.1)),
    "param_estim_collocate": dict(
        alg=dict(param_estim=True, dataset=True, estim_collocate=True,
                 autodiff=True), solve=dict(dt=0.1)),
    "additional_loss": dict(alg=dict(additional=True), solve=dict(dt=0.1)),
}


def _algs(config, tree, lr=1e-2):
    kw = dict(config["alg"])
    name = kw.pop("strategy", None)
    dataset = _dataset() if kw.pop("dataset", False) else None
    additional = kw.pop("additional", False)
    jadd = tadd = None
    if additional:
        def jadd(phi, theta):
            return jnp.sum(phi(jnp.asarray([0.5, 1.0]), theta) ** 2)

        def tadd(phi, theta):
            return torch.sum(phi(torch.tensor([0.5, 1.0], dtype=F64),
                                 theta) ** 2)
    jalg = jpkg.NNODE(jpkg.mlp(SIZES), optax.adam(lr),
                      init_params=tree["depvar"],
                      strategy=STRATEGIES[name](jpkg) if name else None,
                      dataset=dataset, additional_loss=jadd, **kw)
    talg = tpkg.NNODE(tpkg.mlp(SIZES, dtype=F64), tpkg.adam(lr),
                      init_params=tpkg.params_from_jax(tree["depvar"]),
                      strategy=STRATEGIES[name](tpkg) if name else None,
                      dataset=dataset, additional_loss=tadd, **kw)
    return jalg, talg


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_solve_ode_matches_jax(name):
    """The slice as a whole: 30 Adam steps of `solve_ode` from the same
    parameters give the same loss curve, parameters (the estimated ``p``
    too) and saved solution; `tstops`, the data losses and an additional
    loss enter the objective as in the JAX package."""
    config = CONFIGS[name]
    tree, _, _ = _theta(seed=1)
    analytic = lambda u0, p, t: np.array([np.cos(t), np.sin(t)])  # noqa: E731
    jprob, tprob = _problems(analytic=analytic)
    jalg, talg = _algs(config, tree)
    kw = dict(maxiters=30, inner_steps=10, abstol=1e-12, **config["solve"])
    jsol = jpkg.solve_ode(jprob, jalg, **kw)
    tsol = tpkg.solve_ode(tprob, talg, device="cpu", **kw)
    assert len(tsol.original.history) == 3
    assert rel_err(tsol.original.history, jsol.original.history) < 1e-6
    want = tpkg.params_from_jax(jsol.original.u)
    assert sorted(tsol.original.u) == sorted(want)
    for k, v in tsol.original.u.items():
        assert rel_err(v.numpy(), want[k].numpy()) < 1e-6, k
    np.testing.assert_array_equal(tsol.ts, jsol.ts)
    assert tsol.us.shape == jsol.us.shape
    assert rel_err(tsol.us, jsol.us) < 1e-6
    for k, v in jsol.errors.items():
        assert abs(tsol.errors[k] - v) < 1e-6 * max(abs(v), 1.0), k
    assert rel_err(tsol(0.77).numpy(), np.asarray(jsol(0.77))) < 1e-6
    assert tsol.retcode == "Success" and tsol.resid == tsol.original.objective


def test_user_function_may_return_a_list_or_a_scalar():
    tree, _, ttheta = _theta(seed=1)
    prob = tpkg.ODEProblem(_f(torch), U0, TSPAN, p=P)
    alg = tpkg.NNODE(tpkg.mlp(SIZES, dtype=F64),
                     init_params=tpkg.params_from_jax(tree["depvar"]))
    a, theta0, _ = tode.build_ode_loss(prob, alg, dt=0.1, device="cpu")
    b, _, _ = tode.build_ode_loss(prob.remake(f=_f_list), alg, dt=0.1,
                                  device="cpu")
    assert float(a(theta0, None)) == float(b(theta0, None))
    # scalar u0, f returns a number for a constant right-hand side
    net = tpkg.mlp([1, 6, 1], dtype=F64)
    scalar = tpkg.ODEProblem(lambda u, p, t: 2.0, 1.0, (0.0, 1.0))
    loss, theta0, phi = tode.build_ode_loss(scalar, tpkg.NNODE(net, autodiff=True),
                                            dt=0.25, device="cpu")
    ts = torch.linspace(0, 1, 5, dtype=F64)
    du = tode.ode_dfdx(phi, ts, theta0, True)
    want = torch.sum((2.0 - du) ** 2) / 5
    torch.testing.assert_close(loss(theta0, None), want)


@pytest.mark.parametrize("kw", [
    dict(dt=0.25), dict(saveat=0.5), dict(saveat=[0.1, 0.2, 1.4]),
    dict(), dict(save_everystep=False)], ids=str)
@pytest.mark.parametrize("scalar", [False, True], ids=["vector", "scalar"])
def test_build_ode_solution_matches_jax(kw, scalar):
    sizes = [1, 8, 1] if scalar else SIZES
    tree, jtheta, ttheta = _theta(seed=2, sizes=sizes)
    u0 = 0.5 if scalar else U0
    analytic = ((lambda u0, p, t: np.exp(-t)) if scalar
                else (lambda u0, p, t: np.array([np.cos(t), np.sin(t)])))
    jprob = jpkg.ODEProblem(None, u0, TSPAN, analytic=analytic)
    tprob = tpkg.ODEProblem(None, u0, TSPAN, analytic=analytic)
    jphi = jode.ODEPhi(jpkg.mlp(sizes), TSPAN[0], u0)
    tphi = tode.ODEPhi(tpkg.mlp(sizes, dtype=F64), TSPAN[0], u0,
                       like=ttheta["depvar.layer_0.weight"])
    jsol = jode.build_ode_solution(
        jprob, jphi, types.SimpleNamespace(u=jtheta, objective=0.0), **kw)
    tsol = tode.build_ode_solution(
        tprob, tphi, types.SimpleNamespace(u=ttheta, objective=0.0), **kw)
    np.testing.assert_allclose(tsol.ts, jsol.ts, rtol=0, atol=0)
    assert tsol.us.shape == jsol.us.shape and tsol.u is tsol.us
    assert rel_err(tsol.us, jsol.us) < 1e-10
    for k, v in jsol.errors.items():
        assert abs(tsol.errors[k] - v) < 1e-10, k
    t = np.array([0.3, 0.9])
    assert rel_err(tsol(t).numpy(), np.asarray(jsol(jnp.asarray(t)))) < 1e-10


def test_complex_ode_loss_gradient_and_training_match_jax():
    """u' = i u with complex parameters.  JAX returns the conjugate of the
    descent direction for complex leaves and its trainer conjugates it;
    torch's autograd returns the descent direction itself, so the port's
    gradient is the conjugate of `jax.grad`'s.

    The JAX package's `Dense` asks `jnp.dot` for the input's element type,
    so with the real input t its first layer keeps only Re(W0)·t; the port
    multiplies in complex.  The two agree where Im(W0) = 0, which this
    test's parameters have, and there the JAX package's gradient for W0 is
    the real part of the port's.  Training therefore leaves the JAX
    package's curve (the port's W0 turns complex); the port's run is held to
    the exact solution instead, and `train.Adam` on complex leaves to
    optax in `test_solve_trains_a_bare_problem_like_jax`."""
    rng = np.random.default_rng(11)
    sizes = [1, 8, 1]
    re, im = mlp_params(rng, sizes), mlp_params(rng, sizes)
    tree = jax.tree.map(lambda a, b: a + 0.3j * b, re, im)
    tree["layer_0"]["weight"] = re["layer_0"]["weight"] + 0.0j
    u0 = np.complex128(1.0 + 0.0j)
    tspan = (0.0, 2.0)
    jprob = jpkg.ODEProblem(lambda u, p, t: 1j * u, u0, tspan)
    tprob = tpkg.ODEProblem(lambda u, p, t: 1j * u, u0, tspan)
    tparams = tpkg.params_from_jax(tree)
    assert all(v.dtype == torch.complex128 for v in tparams.values())
    mixed = tpkg.params_from_jax({"depvar": tree, "p": P}, dtype=torch.float32)
    assert mixed["p"].dtype == torch.float32 and sorted(mixed)[-1] == "p"
    assert mixed["depvar.layer_1.bias"].dtype == torch.complex64
    talg = tpkg.NNODE(tpkg.mlp(sizes, dtype=torch.complex128), tpkg.adam(2e-2),
                      init_params=tparams)
    tloss, ttheta, tphi = tode.build_ode_loss(tprob, talg, dt=0.1,
                                              device="cpu")
    jtheta = {"depvar": jax.tree.map(jnp.asarray, tree)}
    jphi = jode.ODEPhi(jpkg.mlp(sizes), 0.0, u0)
    jloss = jode._strategy_loss(jpkg.GridTraining(0.1), jphi, jprob.f, False,
                                tspan, None, False, True, jnp.float64)
    want, jgrad = jax.value_and_grad(lambda th: jloss(th, None))(jtheta)
    theta = {k: v.clone().requires_grad_(True) for k, v in ttheta.items()}
    got = tloss(theta, None)
    assert not got.is_complex() and got.dtype == F64
    got.backward()
    assert rel_err(float(got.detach()), float(want)) < 1e-6
    jgrad = tpkg.params_from_jax(jgrad)
    for k, v in theta.items():
        g, jg = v.grad.numpy(), np.conj(jgrad[k].numpy())
        if k == "depvar.layer_0.weight":
            assert np.max(np.abs(jg.imag)) == 0 and np.max(np.abs(g.imag)) > 0
            g = g.real
        assert np.max(np.abs(g - jg)) < 1e-6 * np.max(np.abs(jg)), k

    sol = tpkg.solve_ode(tprob, talg, dt=0.05, maxiters=600, inner_steps=50,
                         abstol=1e-10, device="cpu")
    ts = np.linspace(0, 2, 20)
    assert np.iscomplexobj(sol.us)
    # measured 0.012 after 600 steps (the JAX package's test: < 0.1 after 2000)
    assert np.abs(sol(ts).numpy() - np.exp(1j * ts)).max() < 0.05


# --- NNDAE -------------------------------------------------------------------

def _dae(xp):
    def f(du, u, p, t):
        return xp.stack([du[0] - u[0], u[0] + u[1]])
    return f


def test_solve_dae_matches_jax():
    """The example of tests/test_solvers_extra.py: u1' = u1, 0 = u1 + u2.
    The loss at the initial parameters, then 30 Adam steps: the same curve,
    parameters and saved solution."""
    sizes = [1, 10, 2]
    tree = mlp_params(np.random.default_rng(3), sizes)
    common = dict(u0=np.array([1.0, -1.0]), du0=np.array([1.0, -1.0]),
                  tspan=(0.0, 1.0), differential_vars=[True, False],
                  analytic=lambda u0, p, t: np.array([np.exp(t), -np.exp(t)]))
    jprob = jpkg.DAEProblem(f=_dae(jnp), **common)
    tprob = tpkg.DAEProblem(f=_dae(torch), **common)
    jalg = jpkg.NNDAE(jpkg.mlp(sizes), optax.adam(1e-2), init_params=tree)
    talg = tpkg.NNDAE(tpkg.mlp(sizes, dtype=F64), tpkg.adam(1e-2),
                      init_params=tpkg.params_from_jax(tree))
    kw = dict(dt=0.05, maxiters=30, inner_steps=10, abstol=1e-14)
    jsol = jpkg.solve_dae(jprob, jalg, **kw)
    tsol = tpkg.solve_dae(tprob, talg, device="cpu", **kw)
    tloss, theta0, _ = tdae.build_dae_loss(tprob, talg, dt=0.05, device="cpu")
    first = jpkg.solve_dae(jprob, jalg, dt=0.05, maxiters=1, abstol=1e-14)
    assert rel_err(float(tloss(theta0)), first.original.history[0]) < 1e-10
    assert rel_err(tsol.original.history, jsol.original.history) < 1e-6
    assert tsol.us.shape == jsol.us.shape == (21, 2)
    assert rel_err(tsol.us, jsol.us) < 1e-6
    for k, v in jsol.errors.items():
        assert abs(tsol.errors[k] - v) < 1e-6, k
    # the algebraic row gets no derivative
    ts = torch.linspace(0, 1, 4, dtype=F64)
    d = tdae.dae_dfdx(tode.make_phi(tprob, talg, theta0), ts, theta0, False,
                      [True, False])
    assert bool((d[1] == 0).all()) and bool((d[0] != 0).any())


def test_dae_argument_checks():
    prob = tpkg.DAEProblem(_dae(torch), np.array([1.0, -1.0]),
                           np.array([1.0, -1.0]), (0.0, 1.0))
    alg = tpkg.NNDAE(tpkg.mlp([1, 4, 2]))
    with pytest.raises(ValueError, match="dt"):
        tpkg.solve_dae(prob, alg, device="cpu")
    with pytest.raises(ValueError, match="GridTraining only"):
        tpkg.solve_dae(prob, tpkg.NNDAE(tpkg.mlp([1, 4, 2]),
                                        strategy=tpkg.StochasticTraining(8)),
                       device="cpu")
    with pytest.raises(ValueError, match="autodiff"):
        tpkg.solve_dae(prob, tpkg.NNDAE(tpkg.mlp([1, 4, 2]), autodiff=True),
                       dt=0.5, maxiters=1, device="cpu")


# --- Gauss-Newton on the NNODE objective -----------------------------------------

@pytest.mark.parametrize("name", ["grid", "weighted", "param_estim_collocate"])
def test_ode_residual_vector_matches_jax(name):
    tree, _, _ = _theta(seed=4)
    jprob, tprob = _problems()
    config = (CONFIGS[name] if name in CONFIGS
              else dict(alg=dict(strategy=name), solve={}))
    jalg, talg = _algs(config, tree)
    dt = config["solve"].get("dt", 0.1 if name == "grid" else None)
    jr, jtheta0, _ = jpkg.build_ode_residual_vector(jprob, jalg, dt=dt)
    tr, ttheta0, _ = tpkg.build_ode_residual_vector(tprob, talg, dt=dt,
                                                    device="cpu")
    got, want = tr(ttheta0), np.asarray(jr(jtheta0))
    assert got.shape == want.shape
    assert rel_err(got.detach().numpy(), want) < (1e-10 if talg.autodiff
                                                  else 1e-6)
    tloss, theta0, _ = tode.build_ode_loss(tprob, talg, dt=dt, device="cpu")
    assert rel_err(float(torch.sum(got * got)), float(tloss(theta0, None))) \
        < 1e-10


def test_solve_ode_gauss_newton_matches_jax():
    tree, _, _ = _theta(seed=4)
    analytic = lambda u0, p, t: np.array([np.cos(t), np.sin(t)])  # noqa: E731
    jprob, tprob = _problems(analytic=analytic)
    jalg, talg = _algs(dict(alg=dict(autodiff=True), solve={}), tree)
    kw = dict(dt=0.1, maxiters=3, cg_iters=15)
    jsol = jpkg.solve_ode_gauss_newton(jprob, jalg, **kw)
    tsol = tpkg.solve_ode_gauss_newton(tprob, talg, device="cpu", **kw)
    assert tsol.original.history[-1] < 0.1 * tsol.original.history[0]
    assert rel_err(tsol.original.history, jsol.original.history) < 1e-6
    assert rel_err(tsol.us, jsol.us) < 1e-5
    with pytest.raises(TypeError, match="deterministic"):
        tpkg.solve_ode_gauss_newton(tprob, tpkg.NNODE(
            tpkg.mlp(SIZES), strategy=tpkg.StochasticTraining(8)),
            device="cpu")
    with pytest.raises(ValueError, match="real u"):
        tpkg.build_ode_residual_vector(
            tpkg.ODEProblem(lambda u, p, t: 1j * u, np.complex64(1), (0, 1)),
            tpkg.NNODE(tpkg.mlp([1, 4, 1])), dt=0.1, device="cpu")


# --- argument checks, the default device, bare problems ------------------------

def test_solve_ode_argument_checks():
    prob = tpkg.ODEProblem(lambda u, p, t: p[0] * u, 1.0, (0.0, 1.0),
                           p=np.array([1.0]))
    net = tpkg.mlp([1, 4, 1])
    with pytest.raises(ValueError, match="StochasticTraining"):
        tpkg.solve_ode(prob, tpkg.NNODE(
            net, strategy=tpkg.QuasiRandomTraining(8)), device="cpu")
    with pytest.raises(ValueError, match="[Dd]ataset"):
        tpkg.solve_ode(prob, tpkg.NNODE(net, param_estim=True), dt=0.1,
                       device="cpu")
    with pytest.raises(ValueError, match="Data Quadrature"):
        tpkg.solve_ode(prob, tpkg.NNODE(net, estim_collocate=True), dt=0.1,
                       device="cpu")
    with pytest.raises(ValueError, match="Invalid dataset"):
        tpkg.solve_ode(prob, tpkg.NNODE(net, dataset=[[1.0], [0.0]]), dt=0.1,
                       device="cpu")


@pytest.mark.parametrize("entry", ["solve_ode", "solve_dae",
                                   "solve_ode_gauss_newton", "neural_adapter"])
def test_solver_entry_points_default_to_cuda_and_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("needs a host without a card: it checks that nothing "
                    "falls back to the CPU")
    net = tpkg.mlp([1, 4, 1])
    prob = tpkg.ODEProblem(lambda u, p, t: -u, 1.0, (0.0, 1.0))
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        if entry == "solve_ode":
            tpkg.solve_ode(prob, tpkg.NNODE(net), dt=0.1, maxiters=1)
        elif entry == "solve_dae":
            tpkg.solve_dae(tpkg.DAEProblem(_dae(torch), np.ones(2), np.ones(2),
                                           (0.0, 1.0)),
                           tpkg.NNDAE(tpkg.mlp([1, 4, 2])), dt=0.1, maxiters=1)
        elif entry == "solve_ode_gauss_newton":
            tpkg.solve_ode_gauss_newton(prob, tpkg.NNODE(net), dt=0.1,
                                        maxiters=1)
        else:
            x = tpkg.symbols("x")
            u = tpkg.DepVar("u")
            system = tpkg.PDESystem([tpkg.Eq(u(x), 0.0)], [],
                                    [tpkg.Domain(x, tpkg.Interval(0, 1))],
                                    [x], [u(x)])
            tpkg.neural_adapter(lambda c, th: c[0], dict(net.named_parameters()),
                                system, tpkg.GridTraining(0.5))


class _Bare:
    """A problem with no `PINNRepresentation`: a loss and parameters."""

    pinnrep = None

    def __init__(self, loss, init_params):
        self._loss, self.init_params = loss, init_params

    def loss(self, theta, lstate):
        return self._loss(theta), {}


@pytest.mark.parametrize("dtype", [F64, torch.float32, torch.complex128],
                         ids=str)
def test_solve_trains_a_bare_problem_like_jax(dtype):
    """`solve` takes the device and dtype from the parameters of a problem
    whose ``pinnrep`` is None (it read ``prob.pinnrep.adaloss`` and failed
    before), and follows the JAX package's `solve` on the same least-squares
    problem: 1e-6 in float64/complex128 over 40 steps, 1e-4 in float32."""
    rng = np.random.default_rng(6)
    a, y = rng.normal(size=(7, 3)), rng.normal(size=(7, 1))
    w0 = rng.normal(size=(3, 1))
    if dtype.is_complex:
        a, y, w0 = a + 0.5j * a[::-1], y * (1 - 0.2j), w0 * (1 + 0.4j)
    jdt = {F64: jnp.float64, torch.float32: jnp.float32,
           torch.complex128: jnp.complex128}[dtype]
    ja, jy = jnp.asarray(a, jdt), jnp.asarray(y, jdt)
    ta, ty = torch.tensor(a, dtype=dtype), torch.tensor(y, dtype=dtype)

    def jloss(theta):
        r = ja @ theta["w"] - jy
        return jnp.sum(jnp.real(r * jnp.conj(r)))

    def tloss(theta):
        r = ta @ theta["w"] - ty
        return torch.sum((r * r.conj()).real)

    jprob = _Bare(jloss, {"w": jnp.asarray(w0, jdt)})
    tprob = _Bare(tloss, {"w": torch.tensor(w0, dtype=dtype)})
    jres = jpkg.solve(jprob, optax.adam(5e-2), maxiters=40, inner_steps=10)
    calls = []
    tres = tpkg.solve(tprob, tpkg.adam(5e-2), maxiters=40, inner_steps=10,
                      callback=lambda it, loss, aux: calls.append((it, aux))
                      and False)
    assert tres.iterations == 40 and [c[0] for c in calls] == [10, 20, 30, 40]
    assert calls[0][1] == {} and "cuda_graph" not in tres.aux
    assert tres.u["w"].dtype == dtype and tres.u["w"].device.type == "cpu"
    weights = tres.aux["adaptive_state"]
    assert weights["additional_weights"].dtype == dtype.to_real()
    assert weights["pde_weights"].shape == (0,)
    tol = 1e-4 if dtype == torch.float32 else 1e-6
    assert tres.history[-1] < tres.history[0]
    assert rel_err(tres.history, jres.history) < tol
    assert np.max(np.abs(tres.u["w"].numpy() - np.asarray(jres.u["w"]))) < tol
