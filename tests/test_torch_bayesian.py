"""Parity of the port's Bayesian layer with the JAX package:
`bayesian/hmc.py` (a whole HMC chain against `_sample_arrays` on the JAX
package's own momenta and accept uniforms), `bayesian/nuts.py`
(`_is_turning`, `_leaf_to_ckpt_idxs`), `bayesian/diagnostics.py`, the
log-densities of `bayesian/ode.py` and `bayesian/pde.py` (value and
gradient), and the samplers and drivers by the statistical bands of
tests/test_bayesian.py and tests/test_bpinn_pde.py (at fewer draws where the
band still holds).

The JAX package draws each transition's momentum and accept uniform from
``split(split(key, draws)[i], 3)`` (hmc.py:175-176,284); the test computes
them there and hands them to the port through `hmc.NoiseTable`.
Tolerances: float64; 1e-10 relative for log-densities and gradients, 1e-9
for a 60-draw chain (the leapfrog steps carry the last bits of each
gradient along).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, poisson_2d, rel_err
from neuralpde_tpu.bayesian import diagnostics as jdiag
from neuralpde_tpu.bayesian import hmc as jhmc
from neuralpde_tpu.bayesian import nuts as jnuts
from neuralpde_tpu.bayesian import ode as jode
from neuralpde_tpu.bayesian import pde as jpde
from neuralpde_tpu.nn.core import sigmoid as jsigmoid
from neuralpde_tpu_torch.bayesian import diagnostics as tdiag
from neuralpde_tpu_torch.bayesian import hmc as thmc
from neuralpde_tpu_torch.bayesian import nuts as tnuts
from neuralpde_tpu_torch.bayesian import ode as tode
from neuralpde_tpu_torch.bayesian import pde as tpde
from neuralpde_tpu_torch.nn.core import sigmoid

F64 = torch.float64
HMC_DRAWS = 1800
NUTS_DRAWS = 80


@pytest.fixture(autouse=True)
def float64_default():
    """The drivers work in the default float dtype, as the JAX package's
    do: float64 here, where the test suite turns on JAX's x64."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    yield
    torch.set_default_dtype(before)


def _jax_noise(key, draws, dim):
    """The momentum normals and accept uniforms of `_sample_arrays`."""
    def one(k):
        kp, ka, _ = jax.random.split(k, 3)
        return jax.random.normal(kp, (dim,)), jax.random.uniform(ka, ())

    z, u = jax.vmap(one)(jax.random.split(key, draws))
    return np.asarray(z), np.asarray(u)


def _value_and_grad(tfn, jfn, theta):
    want, jg = jax.value_and_grad(jfn)(jnp.asarray(theta))
    q = torch.tensor(theta, requires_grad=True)
    got = tfn(q)
    got.backward()
    return float(got), q.grad.numpy(), float(want), np.asarray(jg)


# --- a 1-D ODE problem with data ----------------------------------------------

def _decay(pkg, p=1.0):
    return pkg.ODEProblem(f=lambda u, p, t: -p * u, u0=1.0, tspan=(0.0, 1.5),
                          p=p)


def _decay_data(n=15, noise=0.02):
    rng = np.random.default_rng(0)
    ts = np.linspace(0.0, 1.5, n)
    us = np.exp(-1.5 * ts) + noise * rng.standard_normal(n)
    return [us, ts, np.full_like(ts, ts[1] - ts[0])]


def _ode_densities(strategy, *, data=True, param=True, autodiff=True,
                   sizes=(1, 6, 1), seed=0):
    tree = mlp_params(np.random.default_rng(seed), list(sizes))
    dataset = _decay_data() if data else []
    jprior = [jpkg.Normal(2.0, 1.0)] if param else []
    tprior = [tpkg.Normal(2.0, 1.0)] if param else []
    jl = jode.LogTargetDensity(
        _decay(jpkg), jpkg.mlp(list(sizes), jsigmoid),
        jax.tree.map(jnp.asarray, tree), strategy(jpkg), dataset,
        jpkg.Normal(0.0, 3.0), jprior, [0.05], lambda p: [0.1], [0.05],
        autodiff, 1 / 20.0, data)
    tl = tode.LogTargetDensity(
        _decay(tpkg), tpkg.mlp(list(sizes), sigmoid),
        tpkg.params_from_jax(tree, dtype=F64), strategy(tpkg), dataset,
        tpkg.Normal(0.0, 3.0), tprior, [0.05], lambda p: [0.1], [0.05],
        autodiff, 1 / 20.0, data)
    return jl, tl


def test_trial_function_takes_numpy_times_as_jax():
    """``ltd.phi(ts, theta_nn)`` on numpy times, the documented call of
    `docs/src/manual/bpinns.md`, gives the JAX package's values."""
    jl, tl = _ode_densities(ODE_STRATEGIES["grid"], data=False, param=False)
    theta = np.random.default_rng(4).normal(size=tl.n_nn)
    ts = np.linspace(0.0, 1.5, 11)
    want = np.asarray(jl.phi(ts, jnp.asarray(theta)))
    got = tl.phi(ts, torch.tensor(theta)).numpy()
    assert got.shape == want.shape == (1, 11)
    assert rel_err(got, want) < 1e-12
    assert rel_err(tl.phi(list(ts), torch.tensor(theta)).numpy(), want) < 1e-12


ODE_STRATEGIES = {
    "grid": lambda pkg: pkg.GridTraining(0.1),
    "weighted": lambda pkg: pkg.WeightedIntervalTraining([0.5, 0.3, 0.2], 20,
                                                         seed=2),
    "stochastic": lambda pkg: pkg.StochasticTraining(17),
    "quadrature": lambda pkg: pkg.QuadratureTraining(),
}


@pytest.mark.parametrize("autodiff", [True, False], ids=["autodiff", "fd"])
@pytest.mark.parametrize("case", ["forward", "data", "inverse_collocate"])
@pytest.mark.parametrize("strategy", sorted(ODE_STRATEGIES))
def test_log_target_density_matches_jax(strategy, case, autodiff):
    jl, tl = _ode_densities(ODE_STRATEGIES[strategy], data=case != "forward",
                            param=case == "inverse_collocate",
                            autodiff=autodiff)
    assert tl.dim == jl.dim and tl.n_nn == jl.n_nn
    assert rel_err(tl.init_flat_nn.numpy(), jl.init_flat_nn) == 0.0
    theta = np.random.default_rng(3).normal(size=tl.dim)
    got, g, want, jg = _value_and_grad(tl, jl, theta)
    tol = 1e-10 if autodiff else 1e-6
    assert rel_err(got, want) < tol
    assert rel_err(g, jg) < tol
    for name in ("physloglikelihood", "priorweights", "L2LossData", "L2loss2"):
        assert rel_err(float(getattr(tl, name)(torch.tensor(theta))),
                       float(getattr(jl, name)(jnp.asarray(theta)))) < tol


def _lotka_volterra(pkg, xp):
    def f(u, p, t):
        return xp.stack([p[0] * u[0] - p[1] * u[0] * u[1],
                         -p[2] * u[1] + p[3] * u[0] * u[1]])
    return pkg.ODEProblem(f=f, u0=np.array([1.0, 1.0]), tspan=(0.0, 2.0),
                          p=np.array([1.0, 1.0, 2.0, 1.0]))


def _lv_densities(sizes=(1, 8, 2)):
    tree = mlp_params(np.random.default_rng(4), list(sizes))
    ts = np.linspace(0.0, 2.0, 12)
    rng = np.random.default_rng(5)
    dataset = [1 + 0.3 * np.sin(ts) + 0.01 * rng.normal(size=12),
               1 + 0.3 * np.cos(ts), ts, np.full_like(ts, ts[1] - ts[0])]
    priors = [(2.0, 1.0), (1.5, 1.0), (2.5, 1.0), (1.5, 1.0)]
    jl = jode.LogTargetDensity(
        _lotka_volterra(jpkg, jnp), jpkg.mlp(list(sizes), jsigmoid),
        jax.tree.map(jnp.asarray, tree), jpkg.GridTraining(0.2), dataset,
        jpkg.Normal(0.0, 3.0), [jpkg.Normal(*p) for p in priors],
        [0.05, 0.05], lambda p: [0.05, 0.05], [0.02, 0.02], True, 0.05, True)
    tl = tode.LogTargetDensity(
        _lotka_volterra(tpkg, torch), tpkg.mlp(list(sizes), sigmoid),
        tpkg.params_from_jax(tree, dtype=F64), tpkg.GridTraining(0.2), dataset,
        tpkg.Normal(0.0, 3.0), [tpkg.Normal(*p) for p in priors],
        [0.05, 0.05], lambda p: [0.05, 0.05], [0.02, 0.02], True, 0.05, True)
    return jl, tl


def test_lotka_volterra_log_density_matches_jax():
    """Two outputs, four ODE parameters, data and the Data Quadrature term."""
    jl, tl = _lv_densities()
    theta = np.concatenate([np.asarray(jl.init_flat_nn),
                            [1.4, 0.9, 2.8, 1.1]])
    got, g, want, jg = _value_and_grad(tl, jl, theta)
    assert rel_err(got, want) < 1e-10 and rel_err(g, jg) < 1e-10


# --- HMC chains against the JAX package's ------------------------------------

def _gaussian(xp):
    mu, sigma = np.array([1.0, -2.0]), np.array([0.5, 2.0])
    if xp is torch:
        mu, sigma = torch.tensor(mu), torch.tensor(sigma)
    return lambda q: -0.5 * xp.sum(((q - mu) / sigma) ** 2)


@pytest.mark.parametrize("target", ["gaussian", "bnnode"])
def test_hmc_chain_matches_jax_sample_arrays(target):
    """60 draws of kernel="hmc" (both warm-up windows and the mass reset
    at draw 36): samples, accept probabilities, log-densities, the final
    step size and inverse mass."""
    if target == "gaussian":
        jl, tl, q0, eps0, n_leap = (_gaussian(jnp), _gaussian(torch),
                                    np.zeros(2), 0.3, 10)
    else:
        jl, tl = _ode_densities(ODE_STRATEGIES["grid"], sizes=(1, 5, 1))
        q0 = np.concatenate([np.asarray(jl.init_flat_nn), [1.8]])
        eps0, n_leap = 0.02, 8
    key = jax.random.key(11)
    js, ja, jv, je, jm = jhmc._sample_arrays(
        jl, jnp.asarray(q0), key, 60, kernel="hmc", n_leapfrog=n_leap,
        init_step_size=eps0, return_state=True)
    z, u = _jax_noise(key, 60, q0.shape[0])
    ts, ta, tv, te, tm, stats = thmc._sample_arrays(
        tl, torch.tensor(q0), None, 60, kernel="hmc", n_leapfrog=n_leap,
        init_step_size=eps0, return_state=True,
        noise=thmc.NoiseTable(z, u))
    assert stats["captures"] == 0        # on the CPU every draw is eager
    assert 0 < float(np.mean(np.asarray(ja))) < 1
    assert rel_err(ts.numpy(), js) < 1e-9
    assert rel_err(ta.numpy(), ja) < 1e-9
    assert rel_err(tv.numpy(), jv) < 1e-9
    assert rel_err(float(te), float(je)) < 1e-9
    assert rel_err(tm.numpy(), jm) < 1e-9
    assert not np.allclose(np.asarray(jm), 1.0)   # the mass was reset


def test_dual_averaging_and_leapfrog_match_jax():
    da = jhmc._da_init(jnp.asarray(0.3))
    tda = thmc._da_init(torch.tensor(0.3))
    for a in (0.9, 0.2, 0.75):
        da = jhmc._da_update(da, a, 0.8)
        tda = thmc._da_update(tda, torch.tensor(a), 0.8)
    for k in range(5):
        assert rel_err(float(tda[k]), float(da[k])) < 1e-14
    q, p = np.array([0.3, -1.0]), np.array([1.2, 0.4])
    jq, jp = jhmc._leapfrog(jax.grad(_gaussian(jnp)), jnp.asarray(q),
                            jnp.asarray(p), 0.2, jnp.asarray([1.0, 2.0]), 7)
    tq, tp = thmc._leapfrog(lambda x: torch.func.grad(_gaussian(torch))(x),
                            torch.tensor(q), torch.tensor(p), 0.2,
                            torch.tensor([1.0, 2.0]), 7)
    assert rel_err(tq.numpy(), jq) < 1e-13 and rel_err(tp.numpy(), jp) < 1e-13


def test_nuts_helpers_match_jax():
    for n in range(70):
        want = tuple(int(v) for v in jnuts._leaf_to_ckpt_idxs(jnp.asarray(n)))
        assert tnuts._leaf_to_ckpt_idxs(n) == want, n
    rng = np.random.default_rng(6)
    for _ in range(20):
        a, b, s, m = (rng.normal(size=4) for _ in range(4))
        m = np.abs(m)
        assert bool(tnuts._is_turning(*map(torch.tensor, (a, b, s, m)))) == \
            bool(jnuts._is_turning(*map(jnp.asarray, (a, b, s, m))))


def test_diagnostics_match_jax():
    rng = np.random.default_rng(7)
    draws = np.cumsum(rng.normal(size=(3, 200, 4)), axis=1) * 0.1 + \
        rng.normal(size=(3, 200, 4))
    for x in (draws, draws[0], draws[0, :, 1]):
        np.testing.assert_allclose(tdiag.split_rhat(torch.tensor(x)),
                                   jdiag.split_rhat(x), rtol=1e-14)
        np.testing.assert_allclose(tdiag.ess(x), jdiag.ess(x), rtol=1e-14)
    s = tpkg.mcmc_summarize(draws)
    assert set(s) == {"ess", "split_rhat", "mean", "std"}


# --- the samplers, by the JAX tests' bands ------------------------------------

def test_hmc_gaussian_moments():
    """tests/test_bayesian.py::test_hmc_gaussian_moments at 1,800 of its
    4,000 draws and 10 of its 20 leapfrog steps."""
    res = thmc.sample(_gaussian(torch), torch.zeros(2), seed=0,
                      draw_samples=HMC_DRAWS, kernel="hmc", n_leapfrog=10,
                      init_step_size=0.25)
    tail = res.samples[2 * HMC_DRAWS // 3:].numpy()
    np.testing.assert_allclose(tail.mean(0), [1.0, -2.0], atol=0.3)
    np.testing.assert_allclose(tail.std(0), [0.5, 2.0], rtol=0.3)
    assert float(res.accept_prob[2 * HMC_DRAWS // 3:].mean()) > 0.5
    d = res.diagnostics()
    assert d["ess"].shape == (2,) and np.all(d["split_rhat"] < 1.1)


def test_nuts_correlated_gaussian():
    """tests/test_bayesian.py::test_nuts_correlated_gaussian at 1,200 draws."""
    cov = np.array([[1.0, 0.9], [0.9, 1.0]])
    prec = torch.tensor(np.linalg.inv(cov))
    res = thmc.sample(lambda q: -0.5 * q @ prec @ q, torch.zeros(2) + 3.0,
                      seed=0, draw_samples=1200, kernel="nuts", max_depth=6,
                      init_step_size=0.2)
    tail = res.samples[800:].numpy()
    np.testing.assert_allclose(tail.mean(0), [0.0, 0.0], atol=0.3)
    np.testing.assert_allclose(np.cov(tail.T), cov, atol=0.4)


def test_hmcda_kernel_and_stepsize_search():
    """tests/test_bayesian.py::test_hmcda_kernel and
    ::test_find_good_stepsize_finite."""
    ld = lambda q: -0.5 * torch.sum(q**2)  # noqa: E731
    res = thmc.sample(ld, torch.zeros(2) + 1.5, seed=0, draw_samples=800,
                      kernel="hmcda", lam=1.0, init_step_size=0.3)
    tail = res.samples[550:].numpy()
    np.testing.assert_allclose(tail.mean(0), [0.0, 0.0], atol=0.35)
    np.testing.assert_allclose(tail.std(0), [1.0, 1.0], rtol=0.35)
    g = torch.Generator().manual_seed(0)
    assert 1e-6 < thmc.find_good_stepsize(ld, torch.zeros(3), g) < 1e3
    assert 1e-6 < float(thmc.find_good_stepsize_traced(ld, torch.zeros(3),
                                                       g)) < 1e3


@pytest.mark.parametrize("kernel", ["hmc", "hmcda", "nuts"])
def test_sample_chains_stacks_independent_chains(kernel):
    """Chains batched by vmap ("hmc") or one after another."""
    out = thmc.sample_chains(_gaussian(torch), torch.zeros((3, 2)), seed=1,
                             draw_samples=150, kernel=kernel, n_leapfrog=10,
                             max_depth=5)
    assert out.shape == (3, 150, 2)
    assert not torch.equal(out[0], out[1])
    np.testing.assert_allclose(out[:, 100:].mean((0, 1)).numpy(),
                               [1.0, -2.0], atol=0.6)
    with pytest.raises(TypeError, match="Mesh"):
        thmc.sample_chains(_gaussian(torch), torch.zeros((2, 2)),
                           mesh=object(), draw_samples=4)


def test_bnnode_forward():
    """tests/test_bayesian.py::test_bpinn_ode_forward (RMS < 0.1), 200 of
    its 400 draws at 15 of its 20 leapfrog steps."""
    prob = tpkg.ODEProblem(f=lambda u, p, t: -u, u0=1.0, tspan=(0.0, 1.0))
    alg = tpkg.BNNODE(tpkg.mlp([1, 8, 1]), draw_samples=200, phystd=(0.05,),
                      priorsNNw=(0.0, 3.0), physdt=1 / 20.0, numensemble=70,
                      n_leapfrog=15)
    sol = tpkg.solve_bnnode(prob, alg, device="cpu")
    mean = sol.ensemblesol[0].mean.numpy()
    assert np.sqrt(np.mean((mean - np.exp(-sol.timepoints)) ** 2)) < 0.1
    assert sol.diagnostics()["ess"].shape == (sol.original.samples.shape[1],)


def test_bnnode_inverse_parameter_recovery():
    """tests/test_bayesian.py::test_bpinn_ode_inverse_parameter_recovery
    (|p̂ - p| < 0.2 p), 200 of its 500 draws at 10 of its 20 leapfrog
    steps."""
    rng = np.random.default_rng(0)
    ts = np.linspace(0.0, 1.5, 60)
    us = np.exp(-1.5 * ts) + 0.02 * rng.standard_normal(len(ts))
    samples, stats, ltd = tpkg.ahmc_bayesian_pinn_ode(
        _decay(tpkg), tpkg.mlp([1, 8, 1]),
        dataset=[us, ts, np.full_like(ts, ts[1] - ts[0])], draw_samples=200,
        l2std=(0.05,), phystd=(0.05,), priorsNNw=(0.0, 3.0),
        param=[tpkg.Normal(2.0, 1.0)], n_leapfrog=10, estim_collocate=True,
        device="cpu")
    assert abs(float(samples[-70:, -1].mean()) - 1.5) < 0.2 * 1.5
    assert stats["cuda_graph"]["captures"] == 0


def test_bnnode_multichain_and_errors():
    """tests/test_bayesian.py::test_bnnode_multichain, and the reference's
    dataset errors."""
    prob = tpkg.ODEProblem(f=lambda u, p, t: -u, u0=1.0, tspan=(0.0, 1.0))
    samples, stats, ltd = tpkg.ahmc_bayesian_pinn_ode(
        prob, tpkg.mlp([1, 6, 1]), draw_samples=120, phystd=(0.05,),
        priorsNNw=(0.0, 3.0), nchains=2, n_leapfrog=10, device="cpu")
    assert samples.shape == (2, 120, ltd.dim) and stats is None
    with pytest.raises(ValueError, match="Dataset is Required"):
        tpkg.ahmc_bayesian_pinn_ode(prob, tpkg.mlp([1, 4, 1]),
                                    param=[tpkg.Normal()], device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        tpkg.ahmc_bayesian_pinn_ode(prob, tpkg.mlp([1, 4, 1]), mesh=object(),
                                    device="cpu")


# --- the PDE log-density ------------------------------------------------------

def _pde_pair(system, chains, strategy, *, derivative="jvp", dataset=None,
              param_estim=False, seed=0, **kw):
    """The same BayesianPINN representation in both packages."""
    multi = isinstance(chains, dict)
    rng = np.random.default_rng(seed)
    if multi:
        tree = {n: mlp_params(rng, s) for n, s in chains.items()}
        jnet = [jpkg.mlp(s, jsigmoid) for s in chains.values()]
        tnet = [tpkg.mlp(s, sigmoid) for s in chains.values()]
    else:
        tree = mlp_params(rng, chains)
        jnet, tnet = jpkg.mlp(chains), tpkg.mlp(chains)
    jdisc = jpkg.BayesianPINN(jnet, strategy(jpkg), init_params=tree,
                              dataset=dataset, param_estim=param_estim,
                              derivative=derivative, dtype=jnp.float64)
    tdisc = tpkg.BayesianPINN(tnet, strategy(tpkg),
                              init_params=tpkg.params_from_jax(tree),
                              dataset=dataset, param_estim=param_estim,
                              derivative=derivative, dtype=F64, device="cpu")
    jrep = jpkg.symbolic_discretize(system(jpkg), jdisc)
    trep = tpkg.symbolic_discretize(system(tpkg), tdisc)
    data = None if dataset is None else dataset[0]
    jl = jpde.PDELogTargetDensity(jrep, data, jpkg.Normal(0.0, 2.0),
                                  kw.get("jparam", []), kw["allstd"],
                                  kw.get("phynewstd", [0.05]),
                                  estim_collocate=kw.get("collocate", False))
    tl = tpde.PDELogTargetDensity(trep, data, tpkg.Normal(0.0, 2.0),
                                  kw.get("tparam", []), kw["allstd"],
                                  kw.get("phynewstd", [0.05]),
                                  estim_collocate=kw.get("collocate", False))
    return jl, tl


def _decay_system(pkg):
    t = pkg.symbols("t")
    u = pkg.DepVar("u")
    lam = pkg.Param("lam")
    return pkg.PDESystem(pkg.Eq(pkg.Differential(t)(u(t)), -lam * u(t)),
                         [pkg.Eq(u(0.0), 1.0)],
                         [pkg.Domain(t, pkg.Interval(0, 1))], [t], [u(t)],
                         ps=[lam])


def _oscillator_system(pkg):
    t = pkg.symbols("t")
    u, v = pkg.DepVar("u"), pkg.DepVar("v")
    k = pkg.Param("k")
    dt = pkg.Differential(t)
    return pkg.PDESystem([pkg.Eq(dt(u(t)), v(t)), pkg.Eq(dt(v(t)), -k * u(t))],
                         [pkg.Eq(u(0.0), 0.0), pkg.Eq(v(0.0), 1.0)],
                         [pkg.Domain(t, pkg.Interval(0, 1))], [t],
                         [u(t), v(t)], ps=[k])


def _pde_case(name):
    ts = np.linspace(0.0, 1.0, 9)
    rng = np.random.default_rng(2)
    if name in ("poisson", "poisson-jet"):
        return dict(system=poisson_2d, chains=[2, 8, 8, 1],
                    strategy=lambda pkg: pkg.GridTraining(0.25),
                    derivative="jet" if name.endswith("jet") else "jvp",
                    allstd=([0.05], [0.01] * 4, []))
    if name == "separable":
        return dict(system=lambda pkg: pkg.PDESystem(
            poisson_2d(pkg).eqs, poisson_2d(pkg).bcs[:2],
            poisson_2d(pkg).domains, poisson_2d(pkg).ivs, poisson_2d(pkg).dvs),
            chains=None, strategy=lambda pkg: pkg.SeparableTraining(dx=1 / 4),
            allstd=([0.05], [0.01, 0.01], []))
    us = np.exp(-2.0 * ts) + 0.02 * rng.normal(size=ts.size)
    if name in ("inverse", "inverse-collocate"):
        return dict(system=_decay_system, chains=[1, 6, 1],
                    strategy=lambda pkg: pkg.GridTraining(0.1),
                    dataset=([np.column_stack([us, ts])], None),
                    param_estim=True, allstd=([0.05], [0.02], [0.05]),
                    jparam=[jpkg.Normal(1.0, 1.0)],
                    tparam=[tpkg.Normal(1.0, 1.0)],
                    collocate=name.endswith("collocate"))
    vs = np.cos(2.0 * ts)
    return dict(system=_oscillator_system,
                chains={"u": [1, 5, 1], "v": [1, 5, 1]},
                strategy=lambda pkg: pkg.GridTraining(0.1),
                dataset=([np.column_stack([np.sin(2 * ts) / 2, ts]),
                          np.column_stack([vs, ts])], None),
                param_estim=True, allstd=([0.05, 0.05], [0.02, 0.02],
                                          [0.05, 0.05]),
                jparam=[jpkg.Normal(3.0, 1.0)], tparam=[tpkg.Normal(3.0, 1.0)],
                phynewstd=[0.05, 0.05], collocate=True)


@pytest.mark.parametrize("name", ["poisson", "poisson-jet", "separable",
                                  "inverse", "inverse-collocate",
                                  "multioutput"])
def test_pde_log_target_density_matches_jax(name):
    case = _pde_case(name)
    if name == "separable":
        net_j, net_t = jpkg.separable_mlp(2, (8, 8), 4), \
            tpkg.separable_mlp(2, (8, 8), 4)
        tree = jax.tree.map(lambda a: np.random.default_rng(3).normal(
            scale=0.5, size=a.shape), net_j.init(jax.random.key(0)))
        jrep = jpkg.symbolic_discretize(case["system"](jpkg), jpkg.BayesianPINN(
            net_j, case["strategy"](jpkg), init_params=tree,
            dtype=jnp.float64))
        trep = tpkg.symbolic_discretize(case["system"](tpkg), tpkg.BayesianPINN(
            net_t, case["strategy"](tpkg),
            init_params=tpkg.params_from_jax(tree), dtype=F64, device="cpu"))
        args = (None, None, [], case["allstd"], [0.05])
        jl = jpde.PDELogTargetDensity(jrep, None, jpkg.Normal(0.0, 2.0),
                                      *args[2:])
        tl = tpde.PDELogTargetDensity(trep, None, tpkg.Normal(0.0, 2.0),
                                      *args[2:])
    else:
        jl, tl = _pde_pair(case["system"], case["chains"], case["strategy"],
                           derivative=case.get("derivative", "jvp"),
                           dataset=case.get("dataset"),
                           param_estim=case.get("param_estim", False),
                           **{k: case[k] for k in ("allstd", "jparam",
                                                   "tparam", "phynewstd",
                                                   "collocate") if k in case})
    assert tl.dim == jl.dim
    assert rel_err(tl.init_flat_nn.numpy(), jl.init_flat_nn) == 0.0
    theta = np.concatenate([np.asarray(jl.init_flat_nn),
                            np.full(tl.extraparams, 1.7)])
    theta = theta + 0.1 * np.random.default_rng(8).normal(size=theta.size)
    got, g, want, jg = _value_and_grad(tl, jl, theta)
    assert rel_err(got, want) < 1e-10
    assert rel_err(g, jg) < 1e-10


def test_separable_loglik_matches_grid_and_strategy_is_checked():
    """tests/test_bpinn_pde.py::test_bpinn_separable_loglik_matches_grid
    and ::test_bpinn_non_deterministic_strategy_rejected."""
    case = _pde_case("separable")
    net = tpkg.separable_mlp(2, (8, 8), 6)

    def make(strategy):
        rep = tpkg.symbolic_discretize(case["system"](tpkg), tpkg.BayesianPINN(
            net, strategy, device="cpu"))
        return tpde.PDELogTargetDensity(rep, None, tpkg.Normal(0.0, 3.0), [],
                                        ([0.05], [0.01, 0.01], []), [0.05])

    lg, ls = make(tpkg.GridTraining(1 / 8)), make(tpkg.SeparableTraining(
        dx=1 / 8))
    theta = lg.init_flat_nn
    np.testing.assert_allclose(
        float(ls.full_loglikelihood(ls.setparameters(theta))),
        float(lg.full_loglikelihood(lg.setparameters(theta))), rtol=1e-10)
    with pytest.raises(ValueError, match="deterministic"):
        make(tpkg.StochasticTraining(32))


def test_bpinn_pde_forward():
    """tests/test_bpinn_pde.py::test_bpinn_pde_forward (RMS < 0.1), 150 of
    its 350 draws at 12 of its 20 leapfrog steps.  The BPINN drivers here
    take the port's Taylor mode, which equals its nested jvp to 1e-10
    (`test_pde_log_target_density_matches_jax`) at a third of its cost on
    the CPU."""
    t = tpkg.symbols("t")
    u = tpkg.DepVar("u")
    system = tpkg.PDESystem(
        tpkg.Eq(tpkg.Differential(t)(u(t)), tpkg.cos(2 * np.pi * t)),
        [tpkg.Eq(u(0.0), 0.0)], [tpkg.Domain(t, tpkg.Interval(0, 1))], [t],
        [u(t)])
    disc = tpkg.BayesianPINN(tpkg.mlp([1, 10, 1], activation=sigmoid),
                             tpkg.GridTraining(0.05), derivative="jet",
                             device="cpu")
    sol = tpkg.ahmc_bayesian_pinn_pde(
        system, disc, draw_samples=150, bcstd=[0.02], phystd=[0.05],
        priorsNNw=(0.0, 3.0), saveats=[0.02], n_leapfrog=12)
    curve = sol.ensemblesol[0].mean.numpy()
    ts = sol.timepoints[0][0].numpy()
    assert np.sqrt(np.mean((curve - np.sin(2 * np.pi * ts) / (2 * np.pi))
                           ** 2)) < 0.1


def test_bpinn_pde_inverse_with_collocation_likelihood():
    """tests/test_bpinn_pde.py::test_bpinn_pde_inverse_with_collocation_
    likelihood (|λ̂ - 2| < 0.15·2), 100 of its 400 draws at 10 of its 20
    leapfrog steps."""
    rng = np.random.default_rng(1)
    ts = np.linspace(0.0, 1.0, 40)
    us = np.exp(-2.0 * ts) + 0.02 * rng.standard_normal(len(ts))
    disc = tpkg.BayesianPINN(tpkg.mlp([1, 10, 1], activation=sigmoid),
                             tpkg.GridTraining(0.05),
                             dataset=([np.column_stack([us, ts])], None),
                             param_estim=True, derivative="jet", device="cpu")
    sol = tpkg.ahmc_bayesian_pinn_pde(
        _decay_system(tpkg), disc, draw_samples=100, bcstd=[0.02],
        phystd=[0.05], l2std=[0.05], phynewstd=[0.05], priorsNNw=(0.0, 3.0),
        param=[tpkg.Normal(1.0, 1.0)], saveats=[0.02], n_leapfrog=10,
        estim_collocate=True)
    assert abs(float(sol.estimated_de_params[0].mean) - 2.0) < 0.15 * 2.0


def test_bpinn_2d_poisson_forward():
    """tests/test_bpinn_pde.py::test_bpinn_2d_poisson_forward (RMS < 0.05),
    200 of its 400 draws at 10 of its 20 leapfrog steps."""
    disc = tpkg.BayesianPINN(tpkg.mlp([2, 10, 1], activation=sigmoid),
                             tpkg.GridTraining(0.2), derivative="jet",
                             device="cpu")
    sol = tpkg.ahmc_bayesian_pinn_pde(
        poisson_2d(tpkg), disc, draw_samples=200, bcstd=[0.01] * 4,
        phystd=[0.05], priorsNNw=(0.0, 2.0), saveats=[0.1, 0.1],
        n_leapfrog=10)
    cord = sol.timepoints[0].numpy()
    want = np.sin(np.pi * cord[0]) * np.sin(np.pi * cord[1]) / (2 * np.pi**2)
    assert np.sqrt(np.mean((sol.ensemblesol[0].mean.numpy() - want) ** 2)) < 0.05


def _decay_1d_system(pkg):
    t = pkg.symbols("t")
    u = pkg.DepVar("u")
    return pkg.PDESystem(pkg.Eq(pkg.Differential(t)(u(t)), -u(t)),
                         [pkg.Eq(u(0.0), 1.0)],
                         [pkg.Domain(t, pkg.Interval(0, 1))], [t], [u(t)])


def _decay_1d_disc():
    return tpkg.BayesianPINN(tpkg.mlp([1, 8, 1], activation=sigmoid),
                             tpkg.GridTraining(0.1), derivative="jet",
                             device="cpu")


def test_bpinn_pde_with_nuts_kernel():
    """tests/test_bpinn_pde.py::test_bpinn_ode_with_nuts_kernel (RMS < 0.1)
    at 80 of its 250 draws and depth 5 of its 6."""
    sol = tpkg.ahmc_bayesian_pinn_pde(
        _decay_1d_system(tpkg), _decay_1d_disc(), draw_samples=NUTS_DRAWS,
        bcstd=[0.02], phystd=[0.05], priorsNNw=(0.0, 2.0), saveats=[0.05],
        Kernel="nuts", max_depth=5)
    ts = sol.timepoints[0][0].numpy()
    assert np.sqrt(np.mean((sol.ensemblesol[0].mean.numpy() - np.exp(-ts))
                           ** 2)) < 0.1


def test_bpinn_pde_chains_and_mesh():
    """Two chains of the same problem, one solution each; a ``mesh`` that
    is not a `parallel.mesh.Mesh` raises."""
    system, disc = _decay_1d_system(tpkg), _decay_1d_disc()
    sols = tpkg.ahmc_bayesian_pinn_pde(
        system, disc, draw_samples=40, bcstd=[0.02], phystd=[0.05],
        saveats=[0.05], nchains=2, n_leapfrog=5)
    assert len(sols) == 2 and sols[0].original.samples.shape[0] == 40
    assert not torch.equal(sols[0].original.samples, sols[1].original.samples)
    with pytest.raises(TypeError, match="Mesh"):
        tpkg.ahmc_bayesian_pinn_pde(system, disc, mesh=object(),
                                    saveats=[0.05])


def test_bayesian_entry_points_default_to_cuda():
    for fn in (tpkg.ahmc_bayesian_pinn_ode, tpkg.solve_bnnode):
        assert inspect.signature(fn).parameters["device"].default is None
        assert "``\"cuda\"`` unless given" in " ".join(fn.__doc__.split())
    assert tpkg.BayesianPINN(tpkg.mlp([1, 4, 1]), tpkg.GridTraining(
        0.1)).device == torch.device("cuda")
    assert "``\"cuda\"`` unless" in " ".join(
        tpkg.ahmc_bayesian_pinn_pde.__doc__.split())
