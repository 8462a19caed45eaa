"""`neuralpde_tpu_torch.parallel.distributed` in two processes on the CPU,
mirroring tests/test_distributed.py: `initialize_distributed` (gloo,
through a file store), `global_batch_mesh` over both processes and one
sharded training step of a `GridTraining` Poisson problem.  Both processes
report the same loss before and after one Adam step, equal to the JAX
package's single-process values on the same parameters (1e-10 relative in
float64); `per_process_batch` splits a batch and refuses one that does not
divide."""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import neuralpde_tpu as jpkg
from _torch_parity import mlp_params, rel_err
from neuralpde_tpu_torch.parallel.distributed import per_process_batch
from test_torch_mesh import LR, Ranks


def _system(pkg):
    x, y = pkg.symbols("x y")
    u = pkg.DepVar("u")
    eq = pkg.Eq((pkg.Differential(x) ** 2)(u(x, y))
                + (pkg.Differential(y) ** 2)(u(x, y)),
                -pkg.sin(np.pi * x) * pkg.sin(np.pi * y))
    return pkg.PDESystem(
        eq, [pkg.Eq(u(0.0, y), 0.0), pkg.Eq(u(1.0, y), 0.0)],
        [pkg.Domain(x, pkg.Interval(0, 1)), pkg.Domain(y, pkg.Interval(0, 1))],
        [x, y], [u(x, y)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tree = mlp_params(np.random.default_rng(40), [2, 8, 1])
    r = Ranks("distributed", 2, {"tree": tree},
              str(tmp_path_factory.mktemp("dist")))
    r.tree = tree
    yield r
    for p in r.procs:
        if p.poll() is None:
            p.kill()


def test_per_process_batch_without_a_group():
    assert per_process_batch(64) == 64


def test_two_process_sharded_train_step(ranks):
    tree = jax.tree.map(jnp.asarray, ranks.tree)
    # dx = 1/3: 16 interior points and 4 a boundary, which split over 2
    prob = jpkg.discretize(_system(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp([2, 8, 1]), jpkg.GridTraining(1.0 / 3.0), init_params=tree,
        dtype=jnp.float64))
    lstate = {"key": jax.random.key(0), "adaptive":
              prob.pinnrep.adaloss.init_state(1, 2, jnp.float64)}

    def loss(th):
        return prob.loss(th, lstate)[0]

    l0, g = jax.value_and_grad(loss)(prob.init_params)
    opt = optax.adam(LR)
    upd, _ = opt.update(g, opt.init(prob.init_params), prob.init_params)
    l1 = loss(optax.apply_updates(prob.init_params, upd))
    res = ranks.results()
    a, b = (r["step"] for r in res)
    assert a["loss0"] == b["loss0"] and a["loss1"] == b["loss1"]
    assert a["loss1"] < a["loss0"]
    assert rel_err(a["loss0"], float(l0)) < 1e-10
    assert rel_err(a["loss1"], float(l1)) < 1e-10


def test_global_batch_mesh_and_per_process_batch(ranks):
    for r in ranks.results():
        assert r["size"] == 2 and r["batch"] == 32
        assert "not divisible by 2" in r["refused"]
