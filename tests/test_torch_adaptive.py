"""The port's adaptive losses (`neuralpde_tpu_torch.adaptive`) against
`neuralpde_tpu.adaptive`, and `solve` with each deterministic scheme against
the JAX package's `solve`.

Each `reweight` gets the same losses, component gradients and (fresh)
state on both sides for five calls: float64, rtol 1e-12.  ReLoBRaLo's
Bernoulli draw is forced to each outcome (beta 1 and 0), since the two
packages draw different numbers.  A whole `solve` of 20 Adam steps on
`GridTraining` with reweighting every 5 steps: final loss and parameters
to rtol 1e-8 (Adam amplifies rounding in small gradients); ReLoBRaLo is
left out because its draws differ.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, poisson_2d, rel_err
from neuralpde_tpu_torch.adaptive import adam_update

F64 = torch.float64
SHAPES = [(8, 2), (8, 1), (1, 8), (1, 1)]
SCHEMES = {
    "GradientScaleAdaptiveLoss": {},
    "MiniMaxAdaptiveLoss": {},
    "SoftAdaptAdaptiveLoss": {"smoothing": 0.3},
    "InverseDirichletAdaptiveLoss": {},
}


def _inputs(rng, n_pde, n_bc):
    """Positive losses and per-equation gradients, as numpy."""
    losses = (rng.uniform(0.1, 2.0, n_pde), rng.uniform(0.01, 1.0, n_bc))
    grads = tuple([[rng.normal(scale=s, size=shape) for shape in SHAPES]
                   for s in rng.uniform(0.1, 3.0, n)]
                  for n in (n_pde, n_bc))
    return losses, grads


def _compare_states(tstate, jstate):
    for k in ("pde_weights", "bc_weights"):
        assert rel_err(tstate[k].numpy(), np.asarray(jstate[k])) < 1e-12, k


@pytest.mark.parametrize("name,options", [
    *SCHEMES.items(),
    ("ReLoBRaLoAdaptiveLoss", {"beta": 1.0}),
    ("ReLoBRaLoAdaptiveLoss", {"beta": 0.0, "smoothing": 0.5})],
    ids=[*SCHEMES, "ReLoBRaLo_previous", "ReLoBRaLo_initial"])
def test_reweight_matches_jax_over_five_calls(name, options):
    n_pde, n_bc = 2, 3
    jada = getattr(jpkg, name)(reweight_every=1, **options)
    tada = getattr(tpkg, name)(reweight_every=1, **options)
    jstate = jada.init_state(n_pde, n_bc, jnp.float64)
    tstate = tada.init_state(n_pde, n_bc, F64, "cpu")
    rng = np.random.default_rng(3)
    for call in range(5):
        (pde, bc), (gp, gb) = _inputs(rng, n_pde, n_bc)
        jcomp = ([{f"p{i}": jnp.asarray(a) for i, a in enumerate(g)} for g in gp],
                 [{f"p{i}": jnp.asarray(a) for i, a in enumerate(g)} for g in gb])
        tcomp = ([[torch.tensor(a) for a in g] for g in gp],
                 [[torch.tensor(a) for a in g] for g in gb])
        jstate = jada.reweight(jstate, None, jnp.asarray(pde), jnp.asarray(bc),
                               jcomp, jax.random.key(call))
        tstate = tada.reweight(tstate, None, torch.tensor(pde),
                               torch.tensor(bc), tcomp,
                               torch.Generator().manual_seed(call))
        _compare_states(tstate, jstate)
        if "initialized" in tstate:
            assert bool(tstate["initialized"]) == bool(jstate["initialized"])


def test_minimax_inner_adam_matches_optax():
    rng = np.random.default_rng(8)
    opt = optax.adam(0.05)
    params = jnp.asarray(rng.normal(size=4))
    state = opt.init(params)
    w = torch.tensor(np.asarray(params))
    mu, nu = torch.zeros(4, dtype=F64), torch.zeros(4, dtype=F64)
    count = torch.zeros((), dtype=torch.int32)
    for _ in range(6):
        g = rng.normal(size=4)
        updates, state = opt.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        update, mu, nu, count = adam_update(torch.tensor(g), mu, nu, count,
                                            0.05)
        w = w + update
        assert rel_err(w.numpy(), np.asarray(params)) < 1e-12
    assert int(count) == 6


def _problems(jada, tada, seed=0):
    sizes = [2, 8, 8, 1]
    tree = mlp_params(np.random.default_rng(seed), sizes)
    jprob = jpkg.discretize(poisson_2d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp(sizes), jpkg.GridTraining(0.25), init_params=tree,
        derivative="jet", dtype=jnp.float64, adaptive_loss=jada))
    tprob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp(sizes, dtype=F64), tpkg.GridTraining(0.25),
        init_params=tpkg.params_from_jax(tree), derivative="jet", dtype=F64,
        adaptive_loss=tada, device="cpu"))
    return jprob, tprob


@pytest.mark.parametrize("name", list(SCHEMES))
def test_solve_with_each_deterministic_scheme_matches_jax(name):
    jprob, tprob = _problems(getattr(jpkg, name)(5, **SCHEMES[name]),
                             getattr(tpkg, name)(5, **SCHEMES[name]))
    jres = jpkg.solve(jprob, optax.adam(1e-2), maxiters=20, inner_steps=10)
    tres = tpkg.solve(tprob, tpkg.adam(1e-2), maxiters=20, inner_steps=10)
    assert rel_err(tres.objective, jres.objective) < 1e-8
    want = tpkg.params_from_jax(jax.tree.map(np.asarray, jres.u))
    for k, v in tres.u.items():
        assert rel_err(v.numpy(), want[k].numpy()) < 1e-8, k
    for k in ("pde_weights", "bc_weights"):
        assert rel_err(tres.aux["adaptive_state"][k].numpy(),
                       np.asarray(jres.aux["adaptive_state"][k])) < 1e-8, k


def test_relobralo_trains_and_keeps_its_weights_normalized():
    _, tprob = _problems(None, tpkg.ReLoBRaLoAdaptiveLoss(5))
    res = tpkg.solve(tprob, tpkg.adam(1e-2), maxiters=20)
    ada = res.aux["adaptive_state"]
    total = float(ada["pde_weights"].sum() + ada["bc_weights"].sum())
    assert bool(ada["initialized"]) and abs(total - 5.0) < 1e-12
    assert res.history[-1] < res.history[0]


def test_weight_count_and_state_device():
    with pytest.raises(ValueError, match="expected 4 weights"):
        tpkg.GradientScaleAdaptiveLoss(5, bc_loss_weights=[1.0, 2.0]).init_state(
            1, 4, F64, "cpu")
    state = tpkg.MiniMaxAdaptiveLoss(5).init_state(1, 4, F64, "cpu")
    assert sorted(state) == sorted(
        ["pde_weights", "bc_weights", "additional_weights", "pde_mu", "pde_nu",
         "pde_count", "bc_mu", "bc_nu", "bc_count"])
    assert all(v.device.type == "cpu" for v in state.values())


@pytest.mark.parametrize("name", [
    "NonAdaptiveLoss", "GradientScaleAdaptiveLoss", "MiniMaxAdaptiveLoss",
    "SoftAdaptAdaptiveLoss", "ReLoBRaLoAdaptiveLoss",
    "InverseDirichletAdaptiveLoss"])
def test_state_defaults_to_the_card(name):
    """No scheme puts its state on the CPU unless asked."""
    init_state = getattr(tpkg, name).init_state
    assert inspect.signature(init_state).parameters["device"].default == "cuda"
