"""Parity of the port's Deep Ritz solver with the JAX package: the energy,
the ``aux`` dict and the gradient in grid mode (with boundary energies and
penalized boundary conditions), the error cases, and the stochastic mode by
the error of a short training run.

The same parameters (`numpy.random.default_rng(seed)`, crossing through
`params_from_jax`) go through both packages.  Tolerances, relative to the
largest |value|: float64 1e-10, float32 1e-5 (gradient 1e-4).  The
stochastic mode draws its points from the step's generator, not from a
folded key, so it is held by its trained error, not point for point.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, rel_err
from neuralpde_tpu_torch import accuracy as acc

F64, F32 = torch.float64, torch.float32
JDT = {F64: jnp.float64, F32: jnp.float32}
AUX_KEYS = {"pde_losses", "bc_losses", "weighted_pde_losses",
            "weighted_bc_losses", "energy", "full_weighted_loss"}


def _cases(pkg, name):
    """(system, energy, boundary energies, sizes, dx) in ``pkg``'s front end."""
    x, y = pkg.symbols("x y")
    u = pkg.DepVar("u")
    Dx, Dy = pkg.Differential(x), pkg.Differential(y)
    if name == "dirichlet_1d":
        energy = (0.5 * Dx(u(x)) ** 2
                  - (np.pi ** 2) * pkg.sin(np.pi * x) * u(x))
        system = pkg.PDESystem([], [pkg.Eq(u(0.0), 0.0), pkg.Eq(u(1.0), 0.0)],
                               [pkg.Domain(x, pkg.Interval(0, 1))], [x],
                               [u(x)])
        return system, energy, (), [1, 8, 8, 1], 1 / 16
    if name == "robin_1d":
        energy = (0.5 * Dx(u(x)) ** 2
                  - (np.pi ** 2) * pkg.cos(np.pi * x) * u(x))
        boundary = [0.5 * u(0.0) ** 2 - 1.0 * u(0.0),
                    0.5 * u(1.0) ** 2 - (-1.0) * u(1.0)]
        system = pkg.PDESystem([], [], [pkg.Domain(x, pkg.Interval(0, 1))],
                               [x], [u(x)])
        return system, energy, boundary, [1, 8, 1], 1 / 16
    if name == "face_2d":
        energy = 0.5 * (Dx(u(x, y)) ** 2 + Dy(u(x, y)) ** 2)
        face = 0.5 * u(1.0, y) ** 2 - y * u(1.0, y)
        system = pkg.PDESystem(
            [], [pkg.Eq(u(0.0, y), 0.0)],
            [pkg.Domain(x, pkg.Interval(0, 2)), pkg.Domain(y, pkg.Interval(0, 1))],
            [x, y], [u(x, y)])
        return system, energy, [face], [2, 8, 1], 1 / 8
    raise KeyError(name)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", ["dirichlet_1d", "robin_1d", "face_2d"])
def test_grid_energy_aux_and_gradient(name, dtype):
    jsys, jenergy, jbnd, sizes, dx = _cases(jpkg, name)
    tsys, tenergy, tbnd, _, _ = _cases(tpkg, name)
    tree = mlp_params(np.random.default_rng(0), sizes)
    jprob = jpkg.discretize_ritz(jsys, jpkg.DeepRitz(
        jpkg.mlp(sizes), jenergy, boundary_energies=jbnd,
        strategy=jpkg.GridTraining(dx), bc_weight=37.0, init_params=tree,
        dtype=JDT[dtype]))
    tprob = tpkg.discretize_ritz(tsys, tpkg.DeepRitz(
        tpkg.mlp(sizes, dtype=dtype), tenergy, boundary_energies=tbnd,
        strategy=tpkg.GridTraining(dx), bc_weight=37.0,
        init_params=tpkg.params_from_jax(tree), dtype=dtype, device="cpu"))
    lstate = {"key": jax.random.key(0), "adaptive": None}
    (want, jaux), jgrad = jax.value_and_grad(
        lambda th: jprob.loss(th, lstate), has_aux=True)(jprob.init_params)
    theta = {k: v.clone().requires_grad_(True)
             for k, v in tprob.init_params.items()}
    got, aux = tprob.loss(theta, {"generator": None, "adaptive": None})
    got.backward()
    grad = tpkg.parameters_to_vector({k: v.grad for k, v in theta.items()})[0]

    tol = 1e-10 if dtype == F64 else 1e-5
    assert set(aux) == set(jaux) == AUX_KEYS
    for key in AUX_KEYS:
        assert tuple(aux[key].shape) == tuple(jaux[key].shape), key
        assert aux[key].dtype == dtype and aux[key].device.type == "cpu"
        if jaux[key].size:
            assert rel_err(aux[key].detach(), jaux[key]) < tol, key
    assert rel_err(got.detach(), want) < tol
    assert rel_err(grad, ravel_pytree(jgrad)[0]) < (1e-9 if dtype == F64
                                                    else 1e-4)
    # the loss functions the representation carries are the Ritz ones
    lf = tprob.pinnrep.loss_functions
    assert len(lf.pde_loss_functions) == 1
    assert len(lf.bc_loss_functions) == len(tsys.bcs)
    assert rel_err(lf.pde_loss_functions[0](tprob.init_params, None),
                   jprob.pinnrep.loss_functions.pde_loss_functions[0](
                       jprob.init_params, jax.random.key(0))) < tol


def test_errors():
    x = tpkg.Sym("x")
    u = tpkg.DepVar("u")
    with pytest.raises(TypeError, match="symbolic Expr"):
        tpkg.DeepRitz(tpkg.mlp([1, 8, 1]), energy="not an expr")
    with pytest.raises(TypeError, match="symbolic Expr"):
        tpkg.DeepRitz(tpkg.mlp([1, 8, 1]), u(x) ** 2,
                      boundary_energies=["nope"])
    energy = u(x) ** 2
    system = tpkg.PDESystem([], [], [tpkg.Domain(x, tpkg.Interval(0, 1))],
                            [x], [u(x)])
    alg = tpkg.DeepRitz(tpkg.mlp([1, 8, 1]), energy,
                        strategy=tpkg.QuadratureTraining(), device="cpu")
    with pytest.raises(TypeError, match="GridTraining or StochasticTraining"):
        tpkg.discretize_ritz(system, alg)
    with pytest.raises(ValueError, match="adaptive_loss"):
        tpkg.DeepRitz(tpkg.mlp([1, 8, 1]), energy,
                      adaptive_loss=tpkg.MiniMaxAdaptiveLoss(reweight_every=5))
    assert isinstance(tpkg.DeepRitz(tpkg.mlp([1, 8, 1]), energy).strategy,
                      tpkg.StochasticTraining)


def test_stochastic_energy_draws_from_the_steps_generator():
    """Monte-Carlo energy: a step's points come from the one generator it
    is given (the same seed gives the same energy, the next draw another),
    in the order energy, boundary energies, boundary conditions."""
    tsys, tenergy, tbnd, sizes, _ = _cases(tpkg, "face_2d")
    drawn = []
    strategy = tpkg.StochasticTraining(64, bcs_points=16)
    sample = strategy.sampler

    def sampler(n, lb, ub, generator):
        drawn.append((n, lb.tolist(), ub.tolist()))
        return sample(n, lb, ub, generator)

    strategy.sampler = sampler
    prob = tpkg.discretize_ritz(tsys, tpkg.DeepRitz(
        tpkg.mlp(sizes), tenergy, boundary_energies=tbnd, strategy=strategy,
        dtype=F32, device="cpu"))
    g = torch.Generator().manual_seed(3)
    first, aux = prob.loss(prob.init_params, {"generator": g,
                                              "adaptive": None})
    second, _ = prob.loss(prob.init_params, {"generator": g,
                                             "adaptive": None})
    again, _ = prob.loss(prob.init_params, {
        "generator": torch.Generator().manual_seed(3), "adaptive": None})
    assert float(first) == float(again) != float(second)
    assert set(aux) == AUX_KEYS
    # energy on the box, the face x = 1 (y free), then the BC at x = 0
    assert drawn[:3] == [(64, [0.0, 0.0], [2.0, 1.0]),
                         (64, [1.0, 0.0], [1.0, 1.0]),
                         (16, [0.0, 1 / 64], [0.0, 1 - 1 / 64])]


def test_stochastic_mode_trains_to_the_jax_tests_bound():
    """The hard-constrained 2-D Poisson energy of the JAX package's test
    with `StochasticTraining`, at a smaller width and batch: rel L2 under
    that test's 5e-2 (seen: 4.0e-2)."""
    prob = acc.ritz_poisson_2d(tpkg.StochasticTraining(512),
                               sizes=(2, 16, 16, 1), device="cpu")
    res = tpkg.solve(prob, tpkg.adam(1e-2), maxiters=1000, inner_steps=100)
    rel = acc.poisson_2d_rel_l2(prob.pinnrep.phi, res.u, 33, scale=1.0)
    assert rel < 5e-2, rel
    assert abs(float(res.aux["energy"]) + np.pi ** 2 / 4) < 0.5
    assert set(res.aux) == AUX_KEYS | {"adaptive_state"}
