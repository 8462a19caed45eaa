"""The port's `CausalTraining` and bench's dense Allen-Cahn recipe against
`neuralpde_tpu.strategies.CausalTraining`, on points the JAX package draws
and hands to the port through the strategy's ``sampler``.

Tolerances: float64 losses, gradients and causal weights 1e-10 relative,
plus 1e-14 absolute: the periodic embedding makes both periodic conditions
hold by construction, so their losses (~1e-30) and gradients are rounding
noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, poisson_2d, rel_err, tree_like
from neuralpde_tpu.ops import sampling as jsampling
from neuralpde_tpu_torch import accuracy

F64 = torch.float64
POINTS, BCS_POINTS, SLABS = 64, 16, 4


def _jax_allen_cahn(eps, tree):
    """bench.py's `accuracy_dense_full` problem in the JAX package, at a
    small size (hidden width 8, two hidden layers)."""
    x, t = jpkg.symbols("x t")
    u = jpkg.DepVar("u")
    dx = jpkg.Differential(x)
    system = jpkg.PDESystem(
        jpkg.Eq(jpkg.Differential(t)(u(x, t)),
                1e-4 * (dx ** 2)(u(x, t)) + 5.0 * (u(x, t) - u(x, t) ** 3)),
        [jpkg.Eq(u(x, 0.0), x ** 2 * jpkg.cos(np.pi * x)),
         jpkg.Eq(u(-1.0, t), u(1.0, t)),
         jpkg.Eq(dx(u(-1.0, t)), dx(u(1.0, t)))],
        [jpkg.Domain(x, jpkg.Interval(-1, 1)),
         jpkg.Domain(t, jpkg.Interval(0, 1))], [x, t], [u(x, t)])
    net = jpkg.Chain(jpkg.PeriodicEmbedding(2, axis=0, period=2.0, n_modes=10),
                     *jpkg.mlp([21, 8, 8, 1]).layers)
    strategy = jpkg.CausalTraining(POINTS, t, bcs_points=BCS_POINTS,
                                   n_slabs=SLABS, causal_eps=eps)
    prob = jpkg.discretize(system, jpkg.PhysicsInformedNN(
        net, strategy, derivative="jet", dtype=jnp.float64,
        init_params=tree if tree is not None else None,
        adaptive_loss=jpkg.NonAdaptiveLoss(bc_loss_weights=[100.0, 1.0, 1.0])))
    return prob, strategy, net


def _close(got, want) -> bool:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return bool(np.max(np.abs(got - want))
                <= 1e-10 * np.max(np.abs(want)) + 1e-14)


def _pair(eps=10.0):
    _, _, jnet = _jax_allen_cahn(eps, None)
    tree = tree_like(jnet.init(jax.random.key(0)), np.random.default_rng(3))
    jprob, jstrategy, _ = _jax_allen_cahn(eps, tree)
    tprob, tstrategy = accuracy.dense_allen_cahn_problem(
        eps, points=POINTS, bcs_points=BCS_POINTS, n_slabs=SLABS, hidden=8,
        depth=2, dtype=F64, device="cpu",
        init_params=tpkg.params_from_jax(tree))
    return jprob, jstrategy, tprob, tstrategy


def _jax_points(pinnrep, strategy, i, key):
    """The uniform points the JAX strategy draws for loss i (PDE first)."""
    args = (pinnrep.pde_args + pinnrep.bc_args)[i]
    n = strategy.points if i == 0 else strategy.bcs_points
    lb, ub = jpkg.get_bounds(pinnrep.domains, [args], n, jnp.float64)[0]
    return np.asarray(jsampling.uniform_random(key, n, lb, ub,
                                               dtype=jnp.float64))


def _feed(tstrategy, points):
    def sampler(n, lb, ub, generator):
        assert n == points.shape[1]
        return torch.tensor(points)

    tstrategy.sampler = sampler


@pytest.mark.parametrize("i", range(4), ids=["pde", "ic", "periodic",
                                             "periodic_dx"])
def test_causal_losses_and_gradients_match_jax(i):
    jprob, jstrategy, tprob, tstrategy = _pair()
    key = jax.random.key(20 + i)
    jfn = (jprob.pinnrep.loss_functions.pde_loss_functions
           + jprob.pinnrep.loss_functions.bc_loss_functions)[i]
    want, jgrad = jax.value_and_grad(jfn)(jprob.init_params, key)
    _feed(tstrategy, _jax_points(jprob.pinnrep, jstrategy, i, key))
    theta = {k: v.clone().requires_grad_(True)
             for k, v in tprob.init_params.items()}
    tfn = (tprob.pinnrep.loss_functions.pde_loss_functions
           + tprob.pinnrep.loss_functions.bc_loss_functions)[i]
    got = tfn(theta, None)
    grads = torch.autograd.grad(got, list(theta.values()),
                                materialize_grads=True)
    assert _close(float(got.detach()), float(want))
    jgrad = tpkg.params_from_jax(jax.tree.map(np.asarray, jgrad))
    for (k, _), g in zip(theta.items(), grads):
        assert _close(g.numpy(), jgrad[k].numpy()), k


def test_causal_weights_match_jax_and_do_not_increase():
    jprob, jstrategy, tprob, tstrategy = _pair(eps=100.0)
    key = jax.random.key(5)
    want = np.asarray(jstrategy.causal_weights(jprob.init_params, key)[0])
    _feed(tstrategy, _jax_points(jprob.pinnrep, jstrategy, 0, key))
    got = tstrategy.causal_weights(tprob.init_params)[0].numpy()
    assert got.shape == (SLABS,) and got[0] == 1.0
    assert rel_err(got, want) < 1e-10
    assert np.all(np.diff(got) <= 0)


def test_causal_slabs_stratify_time():
    """Slab s of the sample lies in the s-th time interval, slab-major."""
    _, _, tprob, tstrategy = _pair()
    pinnrep = tprob.pinnrep
    lb, ub = tpkg.get_bounds(pinnrep.domains, pinnrep.pde_args, POINTS,
                             F64)[0]
    residual = pinnrep.loss_functions.datafree_pde_loss_functions[0]
    cords = []
    slabs = tstrategy._slab_losses(
        lambda c, th: cords.append(c) or residual(c, th), lb, ub, 1, None)
    slabs(tprob.init_params, torch.Generator().manual_seed(0))
    t = cords[0][1].reshape(SLABS, POINTS // SLABS)
    edges = lb[1] + (ub[1] - lb[1]) * torch.arange(SLABS + 1,
                                                   dtype=F64) / SLABS
    for s in range(SLABS):
        assert bool(((t[s] >= edges[s]) & (t[s] <= edges[s + 1])).all())


def test_equation_without_time_falls_back_to_plain_sampling():
    tree = mlp_params(np.random.default_rng(1), [2, 8, 1])
    jstrategy = jpkg.CausalTraining(POINTS, "t", n_slabs=SLABS)
    jprob = jpkg.discretize(poisson_2d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp([2, 8, 1]), jstrategy, init_params=tree, derivative="jet",
        dtype=jnp.float64))
    tstrategy = tpkg.CausalTraining(POINTS, "t", n_slabs=SLABS)
    tprob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([2, 8, 1], dtype=F64), tstrategy,
        init_params=tpkg.params_from_jax(tree), derivative="jet", dtype=F64,
        device="cpu"))
    key = jax.random.key(2)
    want = float(jprob.pinnrep.loss_functions.pde_loss_functions[0](
        jprob.init_params, key))
    _feed(tstrategy, _jax_points(jprob.pinnrep, jstrategy, 0, key))
    got = float(tprob.pinnrep.loss_functions.pde_loss_functions[0](
        tprob.init_params, None))
    assert rel_err(got, want) < 1e-10
    with pytest.raises(ValueError, match="discretized problem"):
        tstrategy.causal_weights(tprob.init_params)
    with pytest.raises(ValueError, match="multiple of n_slabs"):
        tpkg.CausalTraining(65, "t", n_slabs=SLABS)


def test_dense_recipe_runs_end_to_end_on_the_cpu(tmp_path):
    """`dense_allen_cahn` at a cut budget: its documented layout, finite
    rel L2 against the spectral reference; stopped in its second stage and
    run again from its checkpoints, it gives the stages of a run that never
    stopped."""
    kw = dict(device="cpu", inner_steps=2, points=POINTS,
              bcs_points=BCS_POINTS, n_slabs=SLABS, hidden=8, depth=2)
    out = accuracy.dense_allen_cahn((4, 4, 4), **kw)
    assert [s["eps"] for s in out["per_stage"]] == [
        e for e, _ in accuracy.DENSE_AC_STAGES]
    assert out["rel_l2"] == out["per_stage"][-1]["rel_l2"]
    for s in out["per_stage"]:
        assert s["iters"] == 4 and np.isfinite(s["rel_l2"])
        assert 0.0 <= s["last_weight"] <= 1.0
    d = str(tmp_path / "ckpt")
    stopped = accuracy.dense_allen_cahn((4, 2), checkpoint_dir=d,
                                        checkpoint_every=2, **kw)
    assert [s["iters"] for s in stopped["per_stage"]] == [4, 2]
    resumed = accuracy.dense_allen_cahn((4, 4, 4), checkpoint_dir=d,
                                        checkpoint_every=2, **kw)
    assert [s["rel_l2"] for s in resumed["per_stage"]] == [
        s["rel_l2"] for s in out["per_stage"]]
    assert resumed["per_stage"][0]["loss"] is None


def test_dense_recipe_cli_rejects_checkpoint_without_dense():
    with pytest.raises(SystemExit):
        accuracy.main(["--checkpoint", "somewhere"])
