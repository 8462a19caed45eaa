"""The port's `QuasiRandomTraining`, `ResidualAdaptiveTraining` and
`WeightedIntervalTraining` against `neuralpde_tpu.strategies`, on the 2-D
Poisson problem, with the points the JAX package draws handed to the port
(through the strategies' ``sampler`` and, for RAD, ``categorical``).

Tolerances: float64 losses 1e-10 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, poisson_2d, rel_err
from neuralpde_tpu.ops import sampling as jsampling

F64 = torch.float64
SIZES = [2, 8, 8, 1]
N, N_BC = 64, 16


def _problems(jstrategy, tstrategy, seed=0):
    tree = mlp_params(np.random.default_rng(seed), SIZES)
    jprob = jpkg.discretize(poisson_2d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp(SIZES), jstrategy, init_params=tree, derivative="jet",
        dtype=jnp.float64))
    tprob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp(SIZES, dtype=F64), tstrategy,
        init_params=tpkg.params_from_jax(tree), derivative="jet", dtype=F64,
        device="cpu"))
    return jprob, tprob


def _losses(prob):
    lf = prob.pinnrep.loss_functions
    return lf.pde_loss_functions + lf.bc_loss_functions


def _bounds(pinnrep, i):
    args = (pinnrep.pde_args + pinnrep.bc_args)[i]
    return jpkg.get_bounds(pinnrep.domains, [args], N, jnp.float64)[0]


@pytest.mark.parametrize("alg", ["lhs", "sobol", "lattice"])
@pytest.mark.parametrize("i", [0, 2], ids=["pde", "bc"])
def test_quasi_random_loss_matches_jax_on_its_points(alg, i):
    jprob, tprob = _problems(
        jpkg.QuasiRandomTraining(N, bcs_points=N_BC, sampling_alg=alg),
        tpkg.QuasiRandomTraining(N, bcs_points=N_BC, sampling_alg=alg))
    key = jax.random.key(3 + i)
    n = N if i == 0 else N_BC
    lb, ub = _bounds(jprob.pinnrep, i)
    if alg == "lhs":
        pts = jsampling.latin_hypercube(key, n, lb, ub, dtype=jnp.float64)
    else:
        base = (jsampling.sobol_bits if alg == "sobol"
                else jsampling.lattice_rule_bits)(n, lb.shape[0])
        pts = jsampling.sobol_sample(base, lb, ub, key=key, dtype=jnp.float64)
    want = float(_losses(jprob)[i](jprob.init_params, key))

    def sampler(got_n, got_lb, got_ub, generator):
        assert got_n == n
        np.testing.assert_array_equal(got_lb.numpy(), np.asarray(lb))
        return torch.tensor(np.asarray(pts))

    tprob.pinnrep.strategy.sampler = sampler
    got = float(_losses(tprob)[i](tprob.init_params, None))
    assert rel_err(got, want) < 1e-10


@pytest.mark.parametrize("alg", ["lhs", "sobol", "lattice"])
def test_quasi_random_designs_draw_in_bounds(alg):
    _, tprob = _problems(
        jpkg.QuasiRandomTraining(N, sampling_alg=alg),
        tpkg.QuasiRandomTraining(N, bcs_points=N_BC, sampling_alg=alg))
    g = torch.Generator().manual_seed(0)
    a, b = (float(_losses(tprob)[0](tprob.init_params, g)) for _ in range(2))
    assert np.isfinite(a) and a != b      # a fresh design every call


def test_quasi_random_minibatch_picks_precomputed_designs():
    _, tprob = _problems(
        jpkg.QuasiRandomTraining(N, sampling_alg="sobol", resampling=False,
                                 minibatch=3),
        tpkg.QuasiRandomTraining(N, bcs_points=N_BC, sampling_alg="sobol",
                                 resampling=False, minibatch=3))
    g = torch.Generator().manual_seed(1)
    seen = {round(float(_losses(tprob)[0](tprob.init_params, g)), 14)
            for _ in range(40)}
    assert len(seen) == 3
    with pytest.raises(ValueError, match="minibatch must be > 0"):
        _problems(jpkg.GridTraining(0.5), tpkg.QuasiRandomTraining(
            N, resampling=False))
    with pytest.raises(ValueError, match="sampling_alg"):
        tpkg.QuasiRandomTraining(N, sampling_alg="halton")


@pytest.mark.parametrize("k,c", [(1.0, 1.0), (2.0, 0.5)])
def test_residual_adaptive_loss_matches_jax_on_injected_draws(k, c):
    cand_n = 4 * N
    jprob, tprob = _problems(
        jpkg.ResidualAdaptiveTraining(N, bcs_points=N_BC, k=k, c=c),
        tpkg.ResidualAdaptiveTraining(N, bcs_points=N_BC, k=k, c=c))
    key = jax.random.key(9)
    want = float(_losses(jprob)[0](jprob.init_params, key))
    # the JAX package's own draws for this key
    kc, kr = jax.random.split(key)
    lb, ub = _bounds(jprob.pinnrep, 0)
    cand = jsampling.uniform_random(kc, cand_n, lb, ub, dtype=jnp.float64)
    r = jprob.pinnrep.loss_functions.datafree_pde_loss_functions[0](
        cand, jprob.init_params)
    w = jnp.abs(r) ** k
    w = w + c * jnp.mean(w)
    idx = jax.random.categorical(kr, jnp.log(w + 1e-30), shape=(N,))

    def sampler(n, got_lb, got_ub, generator):
        assert n == cand_n
        return torch.tensor(np.asarray(cand))

    def categorical(weights, n, generator):
        assert n == N
        assert rel_err(weights.numpy(), np.asarray(w)) < 1e-10
        return torch.tensor(np.asarray(idx))

    strategy = tprob.pinnrep.strategy
    strategy.sampler, strategy.categorical = sampler, categorical
    theta = {kk: v.clone().requires_grad_(True)
             for kk, v in tprob.init_params.items()}
    got = _losses(tprob)[0](theta, None)
    got.backward()     # the draw carries no gradient; the loss does
    assert rel_err(float(got.detach()), want) < 1e-10
    assert theta["depvar.layer_0.weight"].grad is not None


def test_residual_adaptive_bcs_take_uniform_points():
    jprob, tprob = _problems(
        jpkg.ResidualAdaptiveTraining(N, bcs_points=N_BC),
        tpkg.ResidualAdaptiveTraining(N, bcs_points=N_BC))
    key = jax.random.key(4)
    lb, ub = _bounds(jprob.pinnrep, 1)
    pts = jsampling.uniform_random(key, N_BC, lb, ub, dtype=jnp.float64)
    tprob.pinnrep.strategy.sampler = (
        lambda n, lb, ub, g: torch.tensor(np.asarray(pts)))
    want = float(_losses(jprob)[1](jprob.init_params, key))
    assert rel_err(float(_losses(tprob)[1](tprob.init_params, None)),
                   want) < 1e-10


def test_weighted_interval_matches_jax_and_is_ode_only():
    jw = jpkg.WeightedIntervalTraining([1.0, 3.0, 0.5], 101)
    tw = tpkg.WeightedIntervalTraining([1.0, 3.0, 0.5], 101)
    np.testing.assert_array_equal(tw.segment_counts(), jw.segment_counts())
    assert tw.segment_counts().sum() == 101
    np.testing.assert_array_equal(
        tw.sample_times(0.0, 2.0, np.random.default_rng(5)),
        jw.sample_times(0.0, 2.0, np.random.default_rng(5)))
    with pytest.raises(ValueError, match="only be used with ODEs"):
        _problems(jpkg.GridTraining(0.5), tw)
