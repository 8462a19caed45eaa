"""Parity of the port's stochastic solvers with the JAX package:
`ops/distributions.py` (log-densities, `Particles`), `solvers/sde.py`
(`SDEPhi`, `du_dt`, `_kl_drive`, `inner_sde_loss`, the quadrature integrand,
the Euler-Maruyama and moments losses, each with its gradient) and
`solve_sde`/`solve_sde_weak` by the error bands of tests/test_sde.py.

The normal draws cannot be reproduced across the packages, so the losses
are evaluated on the JAX package's own `add_rand_coeff*` tensors, crossed
as numpy arrays.  Tolerances: float64, 1e-12 for log-densities, 1e-10
relative for losses and gradients with du/dt by forward mode, 1e-6 with
du/dt by the forward difference (a difference of two network values over
sqrt(eps) carries their last bits up to 1e-8 of the result).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, rel_err
from neuralpde_tpu import mlp as jmlp
from neuralpde_tpu.nn.core import sigmoid as jsigmoid
from neuralpde_tpu.ops import distributions as jdist
from neuralpde_tpu.solvers import sde as jsde
from neuralpde_tpu_torch.nn.core import sigmoid, softplus
from neuralpde_tpu_torch.ops import distributions as tdist
from neuralpde_tpu_torch.solvers import sde as tsde
from neuralpde_tpu_torch.solvers import sde_weak as tweak

F64 = torch.float64
SIZES = [4, 10, 10, 1]
N_Z = 3


@pytest.fixture(autouse=True)
def float64_default():
    """The solvers work in the default float dtype, as the JAX package's
    do: float64 here, where the test suite turns on JAX's x64."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    yield
    torch.set_default_dtype(before)


# --- distributions ----------------------------------------------------------

DISTS = {"normal": (0.3, 1.7), "uniform": (-0.5, 2.0), "lognormal": (0.2, 0.6)}


@pytest.mark.parametrize("name", sorted(DISTS))
def test_logpdf_matches_jax_on_tensors_and_numbers(name):
    cls = {"normal": "Normal", "uniform": "Uniform", "lognormal": "LogNormal"}
    a, b = DISTS[name]
    jd, td = getattr(jdist, cls[name])(a, b), getattr(tdist, cls[name])(a, b)
    x = np.random.default_rng(0).normal(0.5, 1.5, 40)
    want = np.asarray(jd.logpdf(jnp.asarray(x)))
    got = td.logpdf(torch.tensor(x)).numpy()
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-12)
    for v in (float(x[3]), 1.0):
        w = float(jd.logpdf(v))
        g = td.logpdf(v)
        assert isinstance(g, float)
        assert g == w or abs(g - w) <= 1e-12 * abs(w)
    assert td.mean == pytest.approx(float(jd.mean), rel=1e-15)


def test_normal_and_mvnormal_logpdf_match_jax():
    rng = np.random.default_rng(1)
    x, mu, s = rng.normal(size=12), rng.normal(size=12), rng.uniform(.1, 2, 12)
    want = jdist.mvnormal_diag_logpdf(jnp.asarray(x), jnp.asarray(mu),
                                      jnp.asarray(s))
    got = tdist.mvnormal_diag_logpdf(torch.tensor(x), torch.tensor(mu),
                                     torch.tensor(s))
    assert rel_err(float(got), float(want)) < 1e-12
    assert rel_err(float(tdist.mvnormal_diag_logpdf(torch.tensor(x), 0.0, 0.05)),
                   float(jdist.mvnormal_diag_logpdf(jnp.asarray(x), 0.0,
                                                    jnp.asarray(0.05)))) < 1e-12


def test_particles_and_samples():
    draws = np.random.default_rng(2).normal(size=(50, 3))
    jp, tp = jdist.Particles(draws), tdist.Particles(draws)
    assert rel_err(tp.mean.numpy(), jp.mean) < 1e-14
    assert rel_err(tp.std.numpy(), jp.std) < 1e-14
    assert rel_err(tp.quantile(0.3).numpy(), jp.quantile(0.3)) < 1e-14
    g = torch.Generator().manual_seed(0)
    s = tdist.LogNormal(0.1, 0.2).sample(g, (4000,))
    assert s.shape == (4000,) and bool((s > 0).all())
    assert float(s.mean()) == pytest.approx(tdist.LogNormal(0.1, 0.2).mean,
                                            rel=0.02)
    u = tdist.Uniform(1.0, 3.0).sample(g, (100,))
    assert bool(((u >= 1) & (u <= 3)).all())


# --- SDE pieces ---------------------------------------------------------------

def _phis(u0=0.7, t0=0.0, sizes=SIZES, seed=0):
    tree = {"depvar": mlp_params(np.random.default_rng(seed), sizes)}
    jtheta = jax.tree.map(jnp.asarray, tree)
    ttheta = tpkg.params_from_jax(tree, dtype=F64)
    jphi = jsde.SDEPhi(jmlp(sizes, jsigmoid), t0, u0)
    tphi = tsde.SDEPhi(tpkg.mlp(sizes, sigmoid), t0, u0,
                       like=ttheta["depvar.layer_0.weight"])
    return jphi, tphi, jtheta, ttheta


def _inputs(strong, T=7, S=5, seed=4):
    ts = jnp.linspace(0.0, 1.0, T)
    mk = jsde.add_rand_coeff_2 if strong else jsde.add_rand_coeff
    return np.asarray(mk(jax.random.key(seed), ts, N_Z, S, jnp.float64))


def _grads(tloss, jloss, ttheta, jtheta):
    want, jgrad = jax.value_and_grad(jloss)(jtheta)
    theta = {k: v.clone().requires_grad_(True) for k, v in ttheta.items()}
    got = tloss(theta)
    got.backward()
    return (float(got), {k: v.grad for k, v in theta.items()}, float(want),
            tpkg.params_from_jax(jgrad))


def _assert_close(got, tgrad, want, jgrad, tol):
    assert rel_err(got, want) < tol
    for k, g in tgrad.items():
        assert rel_err(g.numpy(), jgrad[k].numpy()) < tol, k


def test_rand_coeff_layouts():
    g = torch.Generator().manual_seed(0)
    ts = torch.linspace(0, 1, 5)
    weak = tsde.add_rand_coeff(g, ts, 3, 4, F64)
    strong = tsde.add_rand_coeff_2(g, ts, 3, 4, F64)
    assert weak.shape == strong.shape == (4, 5, 4)
    assert torch.equal(strong[1:, 0], strong[1:, 3])
    assert not torch.equal(weak[1:, 0], weak[1:, 3])
    assert torch.equal(weak[0, :, 0], ts) and torch.equal(strong[0, :, 2], ts)


@pytest.mark.parametrize("autodiff", [True, False], ids=["autodiff", "fd"])
def test_phi_du_dt_and_kl_drive_match_jax(autodiff):
    jphi, tphi, jtheta, ttheta = _phis(t0=0.1)
    inp = _inputs(False).reshape(1 + N_Z, -1)
    want = jsde.du_dt(jphi, jnp.asarray(inp), jtheta, autodiff)
    got = tsde.du_dt(tphi, torch.tensor(inp), ttheta, autodiff)
    assert rel_err(got.numpy(), want) < (1e-10 if autodiff else 1e-6)
    assert rel_err(tphi(torch.tensor(inp), ttheta).numpy(),
                   jphi(jnp.asarray(inp), jtheta)) < 1e-12
    assert rel_err(tsde._kl_drive(torch.tensor(inp), N_Z).numpy(),
                   jsde._kl_drive(jnp.asarray(inp), N_Z)) < 1e-12


def _f(xp):
    return lambda u, p, t: p[0] * u + xp.sin(t)


def _g(u, p, t):
    return 0.2 * u


@pytest.mark.parametrize("param_estim", [False, True], ids=["p", "theta_p"])
@pytest.mark.parametrize("autodiff", [True, False], ids=["autodiff", "fd"])
@pytest.mark.parametrize("strong", [False, True], ids=["weak", "strong"])
def test_inner_sde_loss_and_gradient_match_jax(strong, autodiff, param_estim):
    jphi, tphi, jtheta, ttheta = _phis()
    p = np.array([-0.8])
    if param_estim:
        jtheta = {**jtheta, "p": jnp.asarray(p)}
        ttheta = {**ttheta, "p": torch.tensor(p)}
    inputs = _inputs(strong)
    args = (strong, False)
    got, tgrad, want, jgrad = _grads(
        lambda th: tsde.inner_sde_loss(tphi, _f(torch), _g, autodiff,
                                       torch.tensor(inputs), th,
                                       torch.tensor(p), param_estim, *args),
        lambda th: jsde.inner_sde_loss(jphi, _f(jnp), _g, autodiff,
                                       jnp.asarray(inputs), th,
                                       jnp.asarray(p), param_estim, *args),
        ttheta, jtheta)
    _assert_close(got, tgrad, want, jgrad, 1e-10 if autodiff else 1e-6)


def test_constant_diffusion_and_vector_state_match_jax():
    """``g`` returning a number, and a two-component state."""
    sizes = [4, 8, 2]
    jphi, tphi, jtheta, ttheta = _phis(u0=[0.5, -0.2], sizes=sizes, seed=3)
    inputs = _inputs(False)
    jf = lambda u, p, t: jnp.stack([-u[1], u[0]])  # noqa: E731
    tf = lambda u, p, t: torch.stack([-u[1], u[0]])  # noqa: E731
    g = lambda u, p, t: 0.1  # noqa: E731
    got, tgrad, want, jgrad = _grads(
        lambda th: tsde.inner_sde_loss(tphi, tf, g, True,
                                       torch.tensor(inputs), th, None, False,
                                       False, False),
        lambda th: jsde.inner_sde_loss(jphi, jf, g, True, jnp.asarray(inputs),
                                       th, None, False, False, False),
        ttheta, jtheta)
    _assert_close(got, tgrad, want, jgrad, 1e-10)


def _jax_quadrature_loss(jphi, f, g, inputs, w, theta, p, strong):
    """The JAX package's quadrature integrand (solvers/sde.py:284-303),
    which lives inside `solve_sde`, written out on its own pieces."""
    d, T, S = inputs.shape
    inp = inputs.reshape(d, T * S)
    u = jphi(inp, theta)
    drive = jsde._kl_drive(inp, d - 1)
    fs, gs = jax.vmap(lambda u_col, t_i: (jnp.atleast_1d(f(u_col[0], p, t_i)),
                                          jnp.atleast_1d(g(u_col[0], p, t_i))),
                      in_axes=(1, 0), out_axes=1)(u, inp[0])
    rhs = fs + gs * drive[None, :]
    sq = ((rhs - jsde.du_dt(jphi, inp, theta, True)) ** 2).reshape(-1, T, S)
    agg = jnp.sum(sq, axis=2) if strong else jnp.mean(sq, axis=2)
    return jnp.sum(jnp.sum(agg, axis=0) ** 2 * w)


@pytest.mark.parametrize("strong", [False, True], ids=["weak", "strong"])
def test_quadrature_integrand_matches_jax(strong):
    """The quartic integrand of the JAX package, kept as it is."""
    jphi, tphi, jtheta, ttheta = _phis()
    inputs = _inputs(strong)
    w = np.random.default_rng(3).uniform(0.1, 0.3, inputs.shape[1])
    p = np.array([-0.8])
    got, tgrad, want, jgrad = _grads(
        lambda th: tsde.quadrature_sde_loss(
            tphi, _f(torch), _g, True, torch.tensor(inputs), torch.tensor(w),
            th, torch.tensor(p), False, strong, True),
        lambda th: _jax_quadrature_loss(jphi, _f(jnp), _g, jnp.asarray(inputs),
                                        jnp.asarray(w), th, jnp.asarray(p),
                                        strong),
        ttheta, jtheta)
    _assert_close(got, tgrad, want, jgrad, 1e-10)


def _paths(n=5, T=12, seed=1):
    rng = np.random.default_rng(seed)
    ts = np.linspace(0.0, 1.0, T)
    paths = [1.0 + np.cumsum(0.1 * rng.normal(size=T)) for _ in range(n)]
    return [paths, ts]


def test_em_loss_and_gradient_match_jax():
    dataset = _paths()
    p = np.array([0.6])
    jl = jsde.generate_em_l2_loss(dataset, lambda x, p, t: p[0] * x,
                                  lambda x, p, t: 0.1 * x, jnp.float64)
    tl = tsde.generate_em_l2_loss(dataset, lambda x, p, t: p[0] * x,
                                  lambda x, p, t: 0.1 * x, F64)
    want, jg = jax.value_and_grad(lambda pp: jl({"p": pp}))(jnp.asarray(p))
    pt = torch.tensor(p, requires_grad=True)
    got = tl({"p": pt})
    got.backward()
    assert rel_err(float(got), float(want)) < 1e-12
    assert rel_err(pt.grad.numpy(), jg) < 1e-12


@pytest.mark.parametrize("strong", [False, True], ids=["weak", "strong"])
def test_moments_loss_and_gradient_match_jax(strong):
    """The moments loss on the JAX package's own draws (``inputs=``)."""
    jphi, tphi, jtheta, ttheta = _phis(u0=1.0)
    dataset = _paths(n=4, T=9)
    p = np.array([0.6])
    jtheta = {**jtheta, "p": jnp.asarray(p)}
    ttheta = {**ttheta, "p": torch.tensor(p)}
    f = lambda xp: (lambda u, p, t: p[0] * u)  # noqa: E731
    g = lambda u, p, t: 0.1 * u  # noqa: E731
    dsb, seed = 4, 5
    mk = jsde.add_rand_coeff_2 if strong else jsde.add_rand_coeff
    inputs = np.asarray(mk(jax.random.key(seed), jnp.asarray(dataset[1]), N_Z,
                           dsb, jnp.float64))
    jl = jsde.generate_data_moments_loss(
        dataset, N_Z, jphi, f(jnp), g, True, None, True, dsb, strong, True,
        jnp.float64, seed)
    tl = tsde.generate_data_moments_loss(
        dataset, N_Z, tphi, f(torch), g, True, None, True, dsb, strong, True,
        F64, seed, inputs=inputs)
    got, tgrad, want, jgrad = _grads(tl, jl, ttheta, jtheta)
    _assert_close(got, tgrad, want, jgrad, 1e-10)


# --- the solvers, by the JAX tests' bands --------------------------------------

def test_solve_sde_gbm_weak_solution():
    """tests/test_sde.py::test_nnsde_gbm_weak_solution: E[u(t)] = exp(1.2 t)."""
    prob = tpkg.SDEProblem(f=lambda u, p, t: 1.2 * u,
                           g=lambda u, p, t: 0.2 * u, u0=1.0, tspan=(0.0, 1.0))
    alg = tpkg.NNSDE(tpkg.mlp([4, 16, 16, 1], activation=sigmoid),
                     tpkg.adam(0.02), sub_batch=8, numensemble=40)
    sol = tpkg.solve_sde(prob, alg, dt=1 / 50.0, maxiters=2000, abstol=1e-12,
                         inner_steps=25, device="cpu")
    ts = np.asarray(sol.timepoints)
    mean = np.asarray([float(p.mean) for p in sol.estimated_sol[0]])
    assert np.mean(np.abs(mean - np.exp(1.2 * ts)) / np.exp(1.2 * ts)) < 0.15
    assert sol.training_sets.shape == (4, 51, 8)


@pytest.mark.parametrize("strategy", ["grid", "stochastic", "weighted",
                                      "quadrature"])
def test_solve_sde_strong_training_runs(strategy):
    """tests/test_sde.py::test_nnsde_strong_training_runs, under each
    strategy the port takes (`QuasiRandomTraining` raises)."""
    prob = tpkg.SDEProblem(f=lambda u, p, t: -u, g=lambda u, p, t: 0.1,
                           u0=0.5, tspan=(0.0, 1.0))
    strat = {"grid": None, "stochastic": tpkg.StochasticTraining(20),
             "weighted": tpkg.WeightedIntervalTraining([0.5, 0.5], 20, seed=1),
             "quadrature": tpkg.QuadratureTraining(order=8, panels=2)}
    alg = tpkg.NNSDE(tpkg.mlp([3, 12, 1], activation=sigmoid), tpkg.adam(0.02),
                     sub_batch=3, strong_loss=True, strategy=strat[strategy])
    sol = tpkg.solve_sde(prob, alg, dt=1 / 20.0, maxiters=400, abstol=1e-12,
                         inner_steps=25, device="cpu")
    assert np.isfinite(sol.original.objective)
    assert len(sol.estimated_sol[0]) == len(sol.timepoints)
    with pytest.raises(ValueError, match="QuasiRandomTraining"):
        tpkg.solve_sde(prob, tpkg.NNSDE(tpkg.mlp([3, 4, 1]), strategy=tpkg.
                                        QuasiRandomTraining(8)),
                       maxiters=1, device="cpu")


def _gbm_paths(n, T, seed, mu=0.8):
    rng = np.random.default_rng(seed)
    ts = np.linspace(0.0, 1.0, T)
    dt = ts[1] - ts[0]
    paths = []
    for _ in range(n):
        x = [1.0]
        for _ in range(T - 1):
            x.append(x[-1] + mu * x[-1] * dt
                     + 0.1 * x[-1] * np.sqrt(dt) * rng.standard_normal())
        paths.append(np.asarray(x))
    return paths, ts


def test_solve_sde_inverse_em_loss():
    """tests/test_sde.py::test_nnsde_inverse_em_loss: |mu - 0.8| < 0.15."""
    paths, ts = _gbm_paths(6, 80, 1)
    prob = tpkg.SDEProblem(f=lambda u, p, t: p[0] * u,
                           g=lambda u, p, t: 0.1 * u, u0=1.0, tspan=(0.0, 1.0),
                           p=np.array([0.3]))
    alg = tpkg.NNSDE(tpkg.mlp([3, 12, 1], activation=sigmoid), tpkg.adam(0.02),
                     sub_batch=4, param_estim=True, dataset=[paths, ts])
    sol = tpkg.solve_sde(prob, alg, dt=1 / 25.0, maxiters=1500, abstol=1e-12,
                         inner_steps=25, device="cpu")
    assert abs(sol.estimated_params[0] - 0.8) < 0.15


def test_solve_sde_moment_loss_and_tstops():
    """tests/test_sde.py::test_nnsde_moment_loss_inverse (|mu - 0.8| < 0.2)
    with `tstops` blended in (tests/test_sde.py::test_nnsde_tstops_blending)."""
    paths, ts = _gbm_paths(8, 40, 2)
    prob = tpkg.SDEProblem(f=lambda u, p, t: p[0] * u,
                           g=lambda u, p, t: 0.1 * u, u0=1.0, tspan=(0.0, 1.0),
                           p=np.array([0.4]))
    alg = tpkg.NNSDE(tpkg.mlp([3, 12, 1], activation=sigmoid), tpkg.adam(0.02),
                     sub_batch=4, param_estim=True, dataset=[paths, ts],
                     moment_loss=True)
    sol = tpkg.solve_sde(prob, alg, dt=1 / 25.0, maxiters=1200, abstol=1e-12,
                         inner_steps=25, tstops=[0.33, 0.66], device="cpu")
    assert np.isfinite(sol.original.objective)
    assert abs(sol.estimated_params[0] - 0.8) < 0.2


def test_fokker_planck_system_matches_jax():
    """The SDEPINN's PDE and boundary conditions: the port's residuals
    equal the JAX package's at the same parameters and points."""
    import neuralpde_tpu as jpkg
    from neuralpde_tpu.solvers import sde_weak as jweak

    def probs(pkg):
        return pkg.SDEProblem(f=lambda x, p, t: 0.3 * x - x * x * x,
                              g=lambda x, p, t: 0.25 * x + 0.1, u0=1.0,
                              tspan=(0.0, 1.0))
    sizes = [2, 8, 8, 1]
    tree = mlp_params(np.random.default_rng(7), sizes)
    jalg = jweak.SDEPINN(jpkg.mlp(sizes), x_0=0.2, x_end=2.0, Nt=4, dx=0.3,
                         distrib=jdist.Normal(1.0, 0.1), initial_parameters=tree)
    talg = tweak.SDEPINN(tpkg.mlp(sizes), x_0=0.2, x_end=2.0, Nt=4, dx=0.3,
                         distrib=tdist.Normal(1.0, 0.1),
                         initial_parameters=tpkg.params_from_jax(tree),
                         absorbing_bc=True)
    jalg.absorbing_bc = True
    jres = jpkg.discretize(jweak_system(jweak, jpkg, probs(jpkg), jalg),
                           jpkg.PhysicsInformedNN(jalg.chain,
                                                  jpkg.GridTraining([0.3, 0.25]),
                                                  init_params=tree))
    tres = tpkg.discretize(tweak.fokker_planck_system(probs(tpkg), talg),
                           tpkg.PhysicsInformedNN(
                               talg.chain, tpkg.GridTraining([0.3, 0.25]),
                               init_params=tpkg.params_from_jax(tree),
                               device="cpu"))
    key = jax.random.key(0)
    want = [float(f(jres.init_params, key))
            for f in jres.pinnrep.loss_functions.pde_loss_functions
            + jres.pinnrep.loss_functions.bc_loss_functions]
    got = [float(f(tres.init_params, None))
           for f in tres.pinnrep.loss_functions.pde_loss_functions
           + tres.pinnrep.loss_functions.bc_loss_functions]
    assert len(got) == len(want) == 6
    assert rel_err(got, want) < 1e-12


def jweak_system(jweak, jpkg, prob, alg):
    """The JAX package builds its PDESystem inside `solve_sde_weak`; this
    rebuilds it the same way (solvers/sde_weak.py:68-102)."""
    from neuralpde_tpu.symbolic.expr import (
        DepVar, Deriv, Differential, Eq, Sym, expand_derivatives, substitute,
        wrap)

    t0, t1 = map(float, prob.tspan)
    X, T = Sym("X"), Sym("T")
    p_hat = DepVar("p_hat")
    f_expr, g_expr = wrap(prob.f(X, None, T)), wrap(prob.g(X, None, T))

    def J(x_val):
        ph, dph = p_hat(x_val, T), Deriv(p_hat(x_val, T), (X,))
        g2 = g_expr * g_expr
        dg2 = expand_derivatives(Deriv(g2, (X,)))
        sub = {X: wrap(x_val)}
        return (substitute(f_expr, sub) * ph
                - 0.5 * (substitute(g2, sub) * dph
                         + ph * substitute(dg2, sub)))

    eq = Eq(Differential(T)(p_hat(X, T)),
            -Differential(X)(f_expr * p_hat(X, T))
            + 0.5 * (Differential(X) ** 2)(g_expr * g_expr * p_hat(X, T)))
    bcs = [Eq(p_hat(float(prob.u0), t0),
              float(np.exp(alg.distrib.logpdf(float(prob.u0))))),
           Eq(p_hat(alg.x_0, T), 0.0), Eq(p_hat(alg.x_end, T), 0.0),
           Eq(J(alg.x_0), 0.0), Eq(J(alg.x_end), 0.0)]
    return jpkg.PDESystem(eq, bcs, [
        jpkg.Domain(X, jpkg.Interval(alg.x_0, alg.x_end)),
        jpkg.Domain(T, jpkg.Interval(t0, t1))], [X, T], [p_hat(X, T)])


def test_solve_sde_weak_ou_trains():
    """tests/test_sde.py::test_sdepinn_fokker_planck_ou's problem, net and
    learning rate for 75 of its 2,500 steps: the loss and the density's
    normalization error fall, the density stays positive.  Its band (max
    density error < 0.35 after 2,500 steps) takes about a minute of CPU
    time at ~26 ms a step; `chip_smoke.py` phase 25 holds it on the card."""
    prob = tpkg.SDEProblem(f=lambda x, p, t: -1.0 * x, g=lambda x, p, t: 0.5,
                           u0=0.0, tspan=(0.0, 3.0))
    chain = tpkg.mlp([2, 16, 16, 1], activation=torch.tanh,
                     out_activation=softplus)
    alg = tpkg.SDEPINN(chain=chain, x_0=-2.0, x_end=2.0, Nt=15, dx=0.1,
                       distrib=tpkg.Normal(0.0, 0.2),
                       optimalg=tpkg.adam(0.01), lambda_norm=10.0)
    res, phi, pinnrep = tpkg.solve_sde_weak(prob, alg, maxiters=75,
                                            inner_steps=25, device="cpu")
    assert res.history[-1] < 0.5 * res.history[0]
    norm = pinnrep.loss_functions.additional_loss_function
    first = float(norm(phi, tpkg.depvar_params(pinnrep.flat_init_params)))
    last = float(norm(phi, tpkg.depvar_params(res.u)))
    assert last < first
    xs = np.linspace(-2, 2, 41)
    dens = phi(np.stack([xs, np.full_like(xs, 3.0)]),
               tpkg.depvar_params(res.u))[0].detach().numpy()
    assert np.all(dens > 0) and len(pinnrep.bcs) == 3


def test_sde_entry_points_default_to_cuda():
    for fn in (tpkg.solve_sde, tpkg.solve_sde_weak):
        assert inspect.signature(fn).parameters["device"].default is None
        assert "``\"cuda\"`` unless given" in " ".join(fn.__doc__.split())
    prob = tpkg.SDEProblem(f=lambda u, p, t: -u, g=lambda u, p, t: 0.1,
                           u0=0.5, tspan=(0.0, 1.0))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tpkg.solve_sde(prob, tpkg.NNSDE(tpkg.mlp([3, 4, 1])), dt=0.1,
                           maxiters=1)
