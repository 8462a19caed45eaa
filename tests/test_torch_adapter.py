"""Parity of the port's `neural_adapter` with `neuralpde_tpu.solvers.adapter`:
the adapter loss under each of the four strategies, for one system and for
a list of systems (domain decomposition), and a short training run.

The new network's parameters come from `numpy.random.default_rng(seed)`.
Random points are drawn by the JAX package from its key and handed to the
port through the strategy's ``sampler``.  Tolerances: float64, 1e-10 for one
loss evaluation and its gradient, 1e-6 for a 40-step loss curve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, rel_err
from neuralpde_tpu.ops import sampling as jsampling
from neuralpde_tpu.solvers import adapter as jadapter

F64 = torch.float64
SIZES = [2, 10, 1]


@pytest.fixture(autouse=True)
def float64_default():
    """The adapter works in the default float dtype, as the JAX package's
    does: float64 here, where the test suite turns on JAX's x64."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    yield
    torch.set_default_dtype(before)


def _system(pkg, x_span=(0.0, 1.0), y_span=(0.0, 2.0)):
    x, y = pkg.symbols("x y")
    u = pkg.DepVar("u")
    return pkg.PDESystem([pkg.Eq(u(x, y), 0.0)], [],
                         [pkg.Domain(x, pkg.Interval(*x_span)),
                          pkg.Domain(y, pkg.Interval(*y_span))],
                         [x, y], [u(x, y)])


def _losses(scale=1.0):
    """The adapter loss of both packages: the new net against a known
    function of the point."""
    jnet, tnet = jpkg.mlp(SIZES), tpkg.mlp(SIZES, dtype=F64)

    def jloss(cord, theta):
        return (jnet.apply(theta, cord)
                - scale * jnp.sin(2 * cord[0:1]) * cord[1:2])[0]

    def tloss(cord, theta):
        return (functional_call(tnet, theta, (cord,))
                - scale * torch.sin(2 * cord[0:1]) * cord[1:2])[0]

    return jloss, tloss


def _params(seed=0):
    tree = mlp_params(np.random.default_rng(seed), SIZES)
    return jax.tree.map(jnp.asarray, tree), tpkg.params_from_jax(tree)


def _feed(strategy, batches):
    """Make the port's strategy return ``batches`` in turn."""
    queue = list(batches)

    def sampler(n, lb, ub, generator):
        pts = queue.pop(0)
        assert pts.shape == (lb.shape[0], n)
        assert bool((torch.tensor(pts) >= lb[:, None]).all())
        assert bool((torch.tensor(pts) <= ub[:, None]).all())
        return torch.tensor(pts)

    strategy.sampler = sampler


def _jax_points(strategy, system, key):
    lb, ub = jadapter._domain_bounds(system.domains, jnp.float64)
    if isinstance(strategy, jpkg.StochasticTraining):
        return jsampling.uniform_random(key, strategy.points, lb, ub,
                                        dtype=jnp.float64)
    if strategy.sampling_alg == "sobol":
        return jsampling.sobol_sample(
            jsampling.sobol_bits(strategy.points, 2), lb, ub, key=key,
            dtype=jnp.float64)
    return jsampling.latin_hypercube(key, strategy.points, lb, ub,
                                     dtype=jnp.float64)


STRATEGIES = {
    "grid": lambda pkg: pkg.GridTraining([0.1, 0.25]),
    "stochastic": lambda pkg: pkg.StochasticTraining(32),
    "quasirandom_lhs": lambda pkg: pkg.QuasiRandomTraining(32),
    "quasirandom_sobol": lambda pkg: pkg.QuasiRandomTraining(
        32, sampling_alg="sobol"),
    "quadrature_auto": lambda pkg: pkg.QuadratureTraining(
        order=3, abstol=1e-6, reltol=1e-6, maxiters=400),
    "quadrature_pinned": lambda pkg: pkg.QuadratureTraining(order=4, panels=2),
}


def _value_and_grad(jprob, tprob, key):
    want, jgrad = jax.value_and_grad(
        lambda th: jprob.loss(th, {"key": key})[0])(jprob.init_params)
    theta = {k: v.clone().requires_grad_(True)
             for k, v in tprob.init_params.items()}
    got, aux = tprob.loss(theta, {"generator": torch.Generator()})
    assert aux == {} and tprob.pinnrep is None
    got.backward()
    jgrad = tpkg.params_from_jax(jgrad)
    assert rel_err(float(got.detach()), float(want)) < 1e-10
    for k, v in theta.items():
        assert rel_err(v.grad.numpy(), jgrad[k].numpy()) < 1e-10, k


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_adapter_loss_matches_jax(name):
    jloss, tloss = _losses()
    jparams, tparams = _params()
    jstrat, tstrat = STRATEGIES[name](jpkg), STRATEGIES[name](tpkg)
    jprob = jpkg.neural_adapter(jloss, jparams, _system(jpkg), jstrat)
    tprob = tpkg.neural_adapter(tloss, tparams, _system(tpkg), tstrat,
                                device="cpu")
    key = jax.random.key(5)
    if name in ("stochastic", "quasirandom_lhs", "quasirandom_sobol"):
        _feed(tstrat, [np.asarray(_jax_points(jstrat, _system(jpkg), key))])
    _value_and_grad(jprob, tprob, key)


@pytest.mark.parametrize("name", ["grid", "stochastic", "quadrature_auto"])
def test_adapter_over_a_list_of_systems_matches_jax(name):
    """Domain decomposition: one network against per-subdomain losses,
    summed; each subdomain draws its own points."""
    jl, tl = zip(_losses(1.0), _losses(0.5))
    spans = [dict(x_span=(0.0, 0.5)), dict(x_span=(0.5, 1.0))]
    jparams, tparams = _params(seed=1)
    jstrat, tstrat = STRATEGIES[name](jpkg), STRATEGIES[name](tpkg)
    jsystems = [_system(jpkg, **s) for s in spans]
    jprob = jpkg.neural_adapter(list(jl), jparams, jsystems, jstrat)
    tprob = tpkg.neural_adapter(list(tl), tparams,
                                [_system(tpkg, **s) for s in spans], tstrat,
                                device="cpu")
    key = jax.random.key(9)
    if name == "stochastic":
        keys = jax.random.split(key, 2)
        _feed(tstrat, [np.asarray(_jax_points(jstrat, s, k))
                       for s, k in zip(jsystems, keys)])
    _value_and_grad(jprob, tprob, key)


@pytest.mark.parametrize("alg", ["lhs", "sobol", "lattice"])
def test_adapter_quasirandom_draws_fresh_points_in_the_domain(alg):
    """The port's own designs (the JAX package's adapter takes Latin
    hypercube points for "lattice"; the port's takes the lattice)."""
    seen = []

    def loss(cord, theta):
        seen.append(cord)
        return cord[0] * theta["w"]

    prob = tpkg.neural_adapter(
        loss, {"w": torch.ones(())}, _system(tpkg),
        tpkg.QuasiRandomTraining(64, sampling_alg=alg), device="cpu")
    g = torch.Generator().manual_seed(0)
    prob.loss(prob.init_params, {"generator": g})
    prob.loss(prob.init_params, {"generator": g})
    a, b = seen
    assert a.shape == (2, 64) and not torch.equal(a, b)
    assert bool((a[0] >= 0).all() and (a[0] <= 1).all())
    assert bool((a[1] >= 0).all() and (a[1] <= 2).all() and (a[1] > 1).any())


def test_adapter_training_matches_jax():
    """The slice as a whole: 40 Adam steps through `solve` on the bare
    adapter problem follow the JAX package's curve; with a refined
    quadrature rule the curve falls too."""
    jloss, tloss = _losses()
    jparams, tparams = _params(seed=2)
    jprob = jpkg.neural_adapter(jloss, jparams, _system(jpkg),
                                STRATEGIES["grid"](jpkg))
    tprob = tpkg.neural_adapter(tloss, tparams, _system(tpkg),
                                STRATEGIES["grid"](tpkg), device="cpu")
    jres = jpkg.solve(jprob, optax.adam(2e-2), maxiters=40, inner_steps=10)
    tres = tpkg.solve(tprob, tpkg.adam(2e-2), maxiters=40, inner_steps=10)
    assert tres.history[-1] < 0.5 * tres.history[0]
    assert rel_err(tres.history, jres.history) < 1e-6
    want = tpkg.params_from_jax(jres.u)
    for k, v in tres.u.items():
        assert rel_err(v.numpy(), want[k].numpy()) < 1e-6, k


def test_adapter_rejects_other_strategies():
    with pytest.raises(TypeError, match="unsupported strategy"):
        tpkg.neural_adapter(lambda c, th: c[0], {"w": torch.ones(())},
                            _system(tpkg),
                            tpkg.WeightedIntervalTraining([1.0], 4),
                            device="cpu")
