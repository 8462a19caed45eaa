"""Parity of the port's training strategies with `neuralpde_tpu.strategies`
on the 2-D Poisson problem, with the same parameters and the same points.

`StochasticTraining` draws its points through a sampler seam; the tests
draw them with the JAX package's `uniform_random` and hand the same array to
the port, so both evaluate the same sample.

Tolerances: float64 losses 1e-10 relative; float32 1e-4 for the PDE loss
(squared second derivatives) and 1e-5 for the boundary losses.  A chunked
loss and its gradient agree with the unchunked one to 1e-12 in float64
(only the order of the sum differs).
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
from neuralpde_tpu_torch.ops.sampling import uniform_random

JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
SIZES = [2, 16, 16, 1]


def _problems(jstrategy, tstrategy, dtype=torch.float64, seed=0):
    tree = mlp_params(np.random.default_rng(seed), SIZES)
    jprob = jpkg.discretize(poisson_2d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp(SIZES), jstrategy, init_params=tree, derivative="jet",
        dtype=JDT[dtype]))
    tprob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp(SIZES, dtype=dtype), tstrategy,
        init_params=tpkg.params_from_jax(tree), derivative="jet", dtype=dtype,
        device="cpu"))
    return jprob, tprob


def _losses(prob):
    lf = prob.pinnrep.loss_functions
    return lf.pde_loss_functions + lf.bc_loss_functions


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_grid_training_losses_match_jax(dtype):
    jprob, tprob = _problems(jpkg.GridTraining(0.1), tpkg.GridTraining(0.1),
                             dtype)
    for i, (jf, tf) in enumerate(zip(_losses(jprob), _losses(tprob))):
        want = float(jf(jprob.init_params))
        got = tf(tprob.init_params)
        assert got.dtype == dtype
        tol = 1e-10 if dtype == torch.float64 else (1e-4 if i == 0 else 1e-5)
        assert rel_err(float(got), want) < tol


def _stochastic_pair(microbatch):
    n, n_bc = 64, 32
    return _problems(
        jpkg.StochasticTraining(n, bcs_points=n_bc, microbatch=microbatch),
        tpkg.StochasticTraining(n, bcs_points=n_bc, microbatch=microbatch))


def _jax_points(pinnrep, i, key):
    """The points the JAX package draws for equation i (PDE first, then the
    boundary conditions) with `key`, and their bounds."""
    strategy = pinnrep.strategy
    args = pinnrep.pde_args + pinnrep.bc_args
    n = strategy.points if i == 0 else strategy.bcs_points
    lb, ub = jpkg.get_bounds(pinnrep.domains, [args[i]], strategy.points,
                             jnp.float64)[0]
    return np.asarray(jsampling.uniform_random(key, n, lb, ub,
                                               dtype=jnp.float64)), lb, ub


def _feed(tstrategy, points, lb, ub):
    def sampler(n, got_lb, got_ub, generator):
        assert n == points.shape[1]
        np.testing.assert_allclose(got_lb.numpy(), lb, rtol=0, atol=0)
        np.testing.assert_allclose(got_ub.numpy(), ub, rtol=0, atol=0)
        return torch.tensor(points)

    tstrategy.sampler = sampler


@pytest.mark.parametrize("i", range(5), ids=["pde", "bc0", "bc1", "bc2", "bc3"])
def test_stochastic_microbatch_matches_jax_and_unchunked(i):
    jprob, tprob = _stochastic_pair(microbatch=16)
    _, flat = _stochastic_pair(microbatch=None)
    key = jax.random.key(11 + i)
    points, lb, ub = _jax_points(jprob.pinnrep, i, key)
    want = float(_losses(jprob)[i](jprob.init_params, key))

    results = []
    for prob in (tprob, flat):
        _feed(prob.pinnrep.strategy, points, lb, ub)
        theta = {k: v.clone().requires_grad_(True)
                 for k, v in prob.init_params.items()}
        loss = _losses(prob)[i](theta, torch.Generator())
        # the PDE residual does not reach the output bias
        grads = torch.autograd.grad(loss, list(theta.values()),
                                    materialize_grads=True)
        results.append((float(loss.detach()), grads))
    (chunked, g_chunked), (unchunked, g_unchunked) = results
    assert rel_err(chunked, want) < 1e-10
    assert rel_err(chunked, unchunked) < 1e-12
    for a, b in zip(g_chunked, g_unchunked):
        assert rel_err(a.numpy(), b.numpy()) < 1e-12


def test_microbatch_must_divide_points():
    with pytest.raises(ValueError, match="multiple of microbatch"):
        tpkg.StochasticTraining(100, microbatch=32)


def test_uniform_random_is_seeded_and_in_bounds():
    lb = torch.tensor([0.25, -1.0], dtype=torch.float64)
    ub = torch.tensor([0.5, 1.0], dtype=torch.float64)
    a = uniform_random(1000, lb, ub, torch.Generator().manual_seed(3))
    b = uniform_random(1000, lb, ub, torch.Generator().manual_seed(3))
    assert a.shape == (2, 1000) and a.dtype == torch.float64
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool(((a >= lb[:, None]) & (a <= ub[:, None])).all())


def test_get_bounds_and_training_sets_match_jax():
    jsys, tsys = poisson_2d(jpkg), poisson_2d(tpkg)
    jargs = [jpkg.get_argument(e, ["u"]) for e in jsys.eqs + jsys.bcs]
    targs = [tpkg.get_argument(e, ["u"]) for e in tsys.eqs + tsys.bcs]
    for (jl, ju), (tl, tu) in zip(
            jpkg.get_bounds(jsys.domains, jargs, 64, jnp.float64),
            tpkg.get_bounds(tsys.domains, targs, 64, torch.float64)):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    for dx in (0.1, [0.25, 0.2]):
        for js, ts in zip(
                jpkg.generate_training_sets(jsys.domains, dx, jargs, jnp.float64),
                tpkg.generate_training_sets(tsys.domains, dx, targs,
                                            torch.float64)):
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
