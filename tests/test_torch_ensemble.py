"""Parity of the port's deep ensembles with solo solves and with the JAX
package: `parallel/ensemble.py` (`solve_ensemble`: member m against a solo
`solve` from member m's parameters, with and without an adaptive loss;
per-member losses and parameters against the JAX ensemble started from
the same stacked parameters; the history cap, checkpoint resume, the
callback and abstol, `mesh=`) and `solve_pino_pde_ensemble` (member m
against a solo `solve_pino_pde`; `best`, `predict`, `mean_and_std`).

Initial parameters are normal draws from `numpy.random.default_rng(seed)`
handed in through ``member_init``; the problems are deterministic
(`GridTraining`), so the members' trajectories do not depend on random
streams.  Tolerances (float64): member against solo 1e-10 (the same
operations on the same values); against the JAX ensemble (optax's Adam,
XLA's arithmetic) 1e-8 after 20 steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, poisson_1d, rel_err
from neuralpde_tpu_torch import accuracy

F64 = torch.float64
SIZES = [1, 12, 1]


@pytest.fixture(autouse=True)
def float64_default():
    before = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    yield
    torch.set_default_dtype(before)


def _prob(strategy=None, **kw):
    return tpkg.discretize(poisson_1d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp(SIZES), strategy or tpkg.GridTraining(0.1), dtype=F64,
        device="cpu", **kw))


def _trees(n, seed=0):
    rng = np.random.default_rng(seed)
    return [mlp_params(rng, SIZES) for _ in range(n)]


def _member_init(trees):
    """``member_init`` handing out ``trees`` in member order."""
    flats = iter([{f"depvar.{k}": v for k, v in
                   tpkg.params_from_jax(t, dtype=F64).items()} for t in trees])
    return lambda generator: next(flats)


@pytest.mark.parametrize("adaptive", [False, True], ids=["plain", "gradscale"])
def test_member_matches_a_solo_solve(adaptive):
    kw = ({"adaptive_loss": tpkg.GradientScaleAdaptiveLoss(5)} if adaptive
          else {})
    prob = _prob(**kw)
    trees = _trees(3)
    res = tpkg.solve_ensemble(prob, tpkg.adam(1e-2), maxiters=20,
                              n_ensemble=3, inner_steps=10,
                              member_init=_member_init(trees))
    assert res.n_ensemble == 3 and res.losses.shape == (3,)
    for m in range(3):
        init = {f"depvar.{k}": v for k, v in
                tpkg.params_from_jax(trees[m], dtype=F64).items()}
        solo = tpkg.solve(prob.with_params(init), tpkg.adam(1e-2),
                          maxiters=20, inner_steps=10)
        for k, v in solo.u.items():
            assert rel_err(res.member(m)[k], v) < 1e-10, (m, k)
        assert abs(float(res.losses[m]) - solo.objective) <= \
            1e-10 * abs(solo.objective)
    assert res.best_index == int(torch.argmin(res.losses))


def test_members_match_the_jax_ensemble_from_the_same_parameters():
    trees = _trees(3, seed=1)
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *trees)
    key = jax.random.key(7)
    keys = jax.random.key_data(jax.vmap(
        lambda m: jax.random.fold_in(key, m))(jnp.arange(3)))

    def jinit(k):
        m = jnp.argmax(jnp.all(keys == jax.random.key_data(k), axis=1))
        return {"depvar": jax.tree.map(lambda s: s[m], stacked)}

    jprob = jpkg.discretize(poisson_1d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp(SIZES), jpkg.GridTraining(0.1), dtype=jnp.float64))
    jres = jpkg.solve_ensemble(jprob, optax.adam(1e-2), maxiters=20,
                               n_ensemble=3, inner_steps=10, key=key,
                               member_init=jinit)
    res = tpkg.solve_ensemble(_prob(), tpkg.adam(1e-2), maxiters=20,
                              n_ensemble=3, inner_steps=10,
                              member_init=_member_init(trees))
    assert rel_err(res.losses, np.asarray(jres.losses)) < 1e-8
    want = tpkg.params_from_jax(jax.tree.map(np.asarray, jres.members),
                                dtype=F64)
    for k, v in res.members.items():
        assert rel_err(v, want[k]) < 1e-8, k
    assert [it for it, _ in res.history] == [it for it, _ in jres.history]


def test_stochastic_members_draw_their_own_points():
    """Members with the same parameters see different points (each draws
    after the members before it), so their losses differ."""
    trees = _trees(1) * 3
    res = tpkg.solve_ensemble(_prob(tpkg.StochasticTraining(16)),
                              tpkg.adam(1e-3), maxiters=1, n_ensemble=3,
                              member_init=_member_init(trees))
    losses = res.losses.tolist()
    assert len(set(losses)) == 3


def _history(cap, maxiters):
    res = tpkg.solve_ensemble(_prob(), tpkg.adam(1e-3), maxiters=maxiters,
                              n_ensemble=2, history_cap=cap,
                              member_init=_member_init(_trees(2)))
    return [it for it, _ in res.history]


def _jax_history(cap, maxiters):
    """`parallel/ensemble.py:248-249`'s decimation of the iterations."""
    history = []
    for it in range(1, maxiters + 1):
        history.append(it)
        if len(history) > cap:
            history = history[::2]
    return history


def test_history_cap_keeps_the_newest_pair():
    # an even cap: the JAX package's decimation, entry for entry
    assert _history(4, 11) == _jax_history(4, 11)
    # an odd cap: the JAX package drops the newest pair; the port keeps it
    got, jax_rule = _history(3, 8), _jax_history(3, 8)
    assert got[-1] == 8 and jax_rule[-1] != 8
    assert len(got) <= 3


def test_checkpoint_resume_equals_a_straight_run(tmp_path):
    kw = dict(n_ensemble=2, inner_steps=5)
    trees = _trees(2, seed=2)
    prob = _prob(adaptive_loss=tpkg.GradientScaleAdaptiveLoss(5))
    straight = tpkg.solve_ensemble(prob, tpkg.adam(1e-2), maxiters=20,
                                   member_init=_member_init(trees), **kw)
    path = str(tmp_path / "ens")
    tpkg.solve_ensemble(prob, tpkg.adam(1e-2), maxiters=10,
                        checkpoint_path=path, checkpoint_every=5,
                        member_init=_member_init(trees), **kw)
    resumed = tpkg.solve_ensemble(prob, tpkg.adam(1e-2), maxiters=20,
                                  checkpoint_path=path,
                                  member_init=_member_init(trees), **kw)
    assert resumed.iterations == 20
    for k, v in straight.members.items():
        assert torch.equal(resumed.members[k], v), k
    assert torch.equal(resumed.losses, straight.losses)
    # a finished run restores its losses rather than the initial infinities
    again = tpkg.solve_ensemble(prob, tpkg.adam(1e-2), maxiters=20,
                                checkpoint_path=path,
                                member_init=_member_init(trees), **kw)
    assert torch.equal(again.losses, straight.losses)


def test_callback_abstol_and_refusals():
    seen = []
    res = tpkg.solve_ensemble(
        _prob(), tpkg.adam(1e-2), maxiters=50, n_ensemble=2, inner_steps=5,
        member_init=_member_init(_trees(2)),
        callback=lambda it, losses: seen.append((it, losses.shape)) or it >= 10)
    assert seen == [(5, (2,)), (10, (2,))] and res.iterations == 10
    res = tpkg.solve_ensemble(_prob(), tpkg.adam(1e-2), maxiters=500,
                              n_ensemble=2, inner_steps=5, abstol=1.0,
                              member_init=_member_init(_trees(2)))
    assert res.iterations < 500 and float(res.losses.min()) < 1.0
    with pytest.raises(TypeError, match="Mesh"):
        tpkg.solve_ensemble(_prob(), mesh=object())
    with pytest.raises(ValueError, match="L-BFGS"):
        tpkg.solve_ensemble(_prob(), lambda ps: torch.optim.LBFGS(list(ps)),
                            maxiters=1, n_ensemble=2)
    bare = tpkg.solvers.ode._SimpleProblem(lambda th, g: 0.0, {})
    with pytest.raises(ValueError, match="member_init"):
        tpkg.solve_ensemble(bare)


def test_default_members_differ_and_predict_spreads():
    res = tpkg.solve_ensemble(_prob(), tpkg.adam(1e-2), maxiters=10,
                              n_ensemble=3)
    a, b = (res.member(i)["depvar.layer_0.weight"] for i in (0, 1))
    assert not torch.equal(a, b)
    cord = torch.linspace(0, 1, 11)[None]
    preds = res.predict(cord)
    assert preds.shape == (3, 1, 11)
    mean, std = res.mean_and_std(cord)
    assert mean.shape == std.shape == (1, 11)
    np.testing.assert_allclose(std.numpy(), preds.numpy().std(axis=0),
                               rtol=1e-12)


# ------------------------------------------------------- PINOPDE ensembles

def _heat_alg(**kw):
    return tpkg.PINOPDE(chain=tpkg.FNO2D(1, width=4, modes=3, depth=2),
                        opt=tpkg.adam(3e-3), bounds=[(0.05, 0.5)],
                        number_of_parameters=3,
                        strategy=tpkg.GridTraining(1 / 8), **kw)


def test_pino_pde_ensemble_member_matches_a_solo_solve():
    system, alg = accuracy.heat_family_system(), _heat_alg()
    ens = tpkg.solve_pino_pde_ensemble(system, alg, n_ensemble=2,
                                       maxiters=20, inner_steps=10, seed=3,
                                       device="cpu")
    gen = torch.Generator().manual_seed(3)
    for m in range(2):
        alg.chain.reset_parameters(gen)
        init = {k: v.detach().clone()
                for k, v in alg.chain.named_parameters()}
        solo = tpkg.solve_pino_pde(system, dataclasses.replace(
            alg, init_params=init), maxiters=20, inner_steps=10,
            device="cpu")
        member = ens.member_solution(m)
        assert rel_err(member.u, solo.u) < 1e-10
        assert abs(float(ens.losses[m]) - solo.original.objective) <= \
            1e-10 * solo.original.objective
    best = ens.best
    assert best.u.shape == (9, 9, 3)
    assert ens.predict().shape == (2, 9, 9, 3)
    g = np.linspace(0, 1, 17)
    mean, std = ens.mean_and_std(p=np.array([[0.1, 0.2]]), grids=[g, g])
    assert mean.shape == std.shape == (17, 17, 2)
    preds = ens.predict(p=np.array([[0.1, 0.2]]), grids=[g, g]).numpy()
    np.testing.assert_allclose(std.numpy(), preds.std(axis=0), rtol=1e-12)
    with pytest.raises(TypeError, match="Mesh"):
        tpkg.solve_pino_pde_ensemble(system, alg, mesh=object(),
                                     device="cpu")
    with pytest.raises(ValueError, match="init_params"):
        tpkg.solve_pino_pde_ensemble(system, dataclasses.replace(
            alg, init_params={}), device="cpu")
