"""The port's accuracy recipes (`neuralpde_tpu_torch.accuracy`) against the
JAX package's formulation of `bench.py`'s `accuracy_suite`, on the CPU.

Tolerances: 1e-10 relative in float64 (the same formulas on both sides);
the spectral reference is the same numpy code, so it must agree exactly.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import hard, poisson_2d_hard, rel_err, tree_like
from neuralpde_tpu_torch import accuracy

sys.path.append(str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
import allen_cahn_spinn as jax_allen_cahn  # noqa: E402

F64 = torch.float64


def _losses(prob, theta):
    lf = prob.pinnrep.loss_functions
    return [float(f(theta, None))
            for f in lf.pde_loss_functions + lf.bc_loss_functions]


def _jlosses(prob):
    lf = prob.pinnrep.loss_functions
    return [float(f(prob.init_params, jax.random.key(0)))
            for f in lf.pde_loss_functions + lf.bc_loss_functions]


def test_allen_cahn_ground_truth_matches_the_example():
    got = accuracy.allen_cahn_ground_truth()
    want = jax_allen_cahn.ground_truth()
    assert got[2].shape == (101, 512)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_allen_cahn_stage_matches_jax():
    """One causal stage at 9 nodes per axis: loss terms and causal weights
    against the JAX package built as `bench.py` builds it."""
    jnet = jax_allen_cahn.build_net(4, hidden=(8, 8), n_modes=3)
    tree = tree_like(jnet.init(jax.random.key(0)), np.random.default_rng(5))
    x, t = jpkg.symbols("x t")
    u = jpkg.DepVar("u")
    system = jpkg.PDESystem(
        jpkg.Eq(jpkg.Differential(t)(u(x, t)),
                1e-4 * (jpkg.Differential(x) ** 2)(u(x, t))
                + 5.0 * (u(x, t) - u(x, t) ** 3)),
        [jpkg.Eq(u(x, 0.0), x ** 2 * jpkg.cos(np.pi * x))],
        [jpkg.Domain(x, jpkg.Interval(-1, 1)),
         jpkg.Domain(t, jpkg.Interval(0, 1))], [x, t], [u(x, t)])
    jstrategy = jpkg.SeparableTraining(dx=[2.0 / 8, 1.0 / 8], causal=t,
                                       causal_eps=100.0)
    jprob = jpkg.discretize(system, jpkg.PhysicsInformedNN(
        jnet, jstrategy, init_params=tree, dtype=jnp.float64,
        matmul_precision="highest",
        adaptive_loss=jpkg.NonAdaptiveLoss(bc_loss_weights=[100.0])))

    tnet = accuracy.allen_cahn_net(4, hidden=(8, 8), n_modes=3, dtype=F64)
    tprob, tstrategy = accuracy.allen_cahn_stage(tnet, 100.0, nodes=9,
                                                 dtype=F64, device="cpu")
    theta = tpkg.params_from_jax({"depvar": tree}, dtype=F64)
    assert rel_err(_losses(tprob, theta), _jlosses(jprob)) < 1e-10
    got = tstrategy.causal_weights(theta)[0].detach().numpy()
    want = np.asarray(jstrategy.causal_weights(jprob.init_params,
                                               jax.random.key(0))[0])
    assert got.shape == (9,) and rel_err(got, want) < 1e-10


def test_poisson_spinn_and_its_rel_l2_match_jax():
    jnet = jpkg.SeparableNet([jpkg.Transformed(jpkg.mlp([1, 8, 8, 4]), hard)
                              for _ in range(2)])
    tree = tree_like(jnet.init(jax.random.key(0)), np.random.default_rng(6))
    jprob = jpkg.discretize(poisson_2d_hard(jpkg), jpkg.PhysicsInformedNN(
        jnet, jpkg.SeparableTraining(dx=1.0 / 8), init_params=tree,
        dtype=jnp.float64))
    tprob, tnet = accuracy.poisson_spinn(
        9, 8, 4, dtype=F64, device="cpu", init_params=tpkg.params_from_jax(
            tree))
    assert rel_err(_losses(tprob, tprob.init_params), _jlosses(jprob)) < 1e-10

    xs = np.linspace(0, 1, 101)
    pred = np.asarray(jnet.grid(tree, [jnp.asarray(xs)] * 2))
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    want = np.sin(np.pi * X) * np.sin(np.pi * Y) / (2 * np.pi ** 2)
    jax_rel = np.linalg.norm(pred - want) / np.linalg.norm(want)
    got = accuracy.poisson_rel_l2(tnet, tprob.init_params)
    assert abs(got - jax_rel) / jax_rel < 1e-10


def test_recipes_run_end_to_end_on_the_cpu():
    """The recipes' drivers at a cut budget: finite results in their
    documented layout."""
    spinn = accuracy.poisson_spinn_rel_l2(device="cpu", maxiters=100)
    assert len(spinn["history"]) == 1 and spinn["history"][0] > 0
    assert 0 < spinn["rel_l2"] < 1
    ac = accuracy.allen_cahn_rel_l2(rank=4, nodes=8, iters=2, device="cpu")
    assert [s[0] for s in ac["per_stage"]] == [e for e, _ in accuracy.AC_STAGES]
    assert ac["rel_l2"] == ac["per_stage"][-1][1]
    for _, rel, weight in ac["per_stage"]:
        assert np.isfinite(rel) and 0.0 <= weight <= 1.0
