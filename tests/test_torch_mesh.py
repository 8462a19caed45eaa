"""The port's mesh (`neuralpde_tpu_torch.parallel.mesh`) on 4 gloo ranks
against the JAX package on its 4-device virtual CPU mesh, mirroring
tests/test_parallel.py, tests/test_round4_fixes.py (shard_batch),
tests/test_separable.py (TestMesh, TestMeshCausal) and
tests/test_bayesian_parallel.py (chains over the mesh).

The port runs in 4 worker processes (`_torch_mesh_worker.py`, one process
a device, joined through a file store), started once for the file: every
check below reads their results.  Parameters are `numpy.random` draws in
the JAX layout and the random strategies' points are the JAX package's
draws, handed to the workers as numpy arrays; the JAX references run in
this process, under `use_mesh(make_mesh(4))` / `make_mesh_2d(2, 2)`,
while the workers run.

Tolerances: 1e-10 relative in float64 (losses, gradients relative to the
largest), 1e-6 in float32; 1e-8 for parameters after one Adam step in
float64, as tests/test_torch_pino.py holds them.  The ensemble
and the chains over the mesh are held to the port's run without one: bit
for bit for the ensemble, whose step holds no collective, and for the
"hmc" chains, whose noise each rank draws whole.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, poisson_2d, rel_err, tree_like
from neuralpde_tpu.ops import sampling as jsampling
from neuralpde_tpu.parallel.mesh import (
    make_mesh as jmake_mesh, make_mesh_2d as jmake_mesh_2d,
    shard_batch as jshard_batch, shard_params_tp as jshard_params_tp,
    use_mesh as juse_mesh,
)
from neuralpde_tpu.solvers import pino_pde as jpde
from neuralpde_tpu.symbolic import expr as JE
from neuralpde_tpu_torch.parallel import mesh as tmesh

W = 4
LR = 1e-2
KEY = 5
WORKER = os.path.join(os.path.dirname(__file__), "_torch_mesh_worker.py")
# strategy cases, each on every rank; "-f32" runs in float32
STRATEGY_CASES = ("grid", "grid-f32", "gridodd", "stochastic", "quadrature",
                  "weak", "causal", "separable", "separablecausal")
# cases held to the port's own run without a mesh (the JAX package draws
# their points by its own RNG inside the loss)
PORT_ONLY = ("rad", "quasi")
JVP_KINDS = ("weak", "separable", "separablecausal")


def _jdtype(name):
    return jnp.float32 if name.endswith("-f32") else jnp.float64


def _tol(name):
    return 1e-6 if name.endswith("-f32") else 1e-10


def _jstrategy(name):
    kind = name.split("-")[0]
    return {
        "grid": lambda: jpkg.GridTraining(1 / 15),
        "gridodd": lambda: jpkg.GridTraining(0.1),
        "stochastic": lambda: jpkg.StochasticTraining(256, bcs_points=9,
                                                      microbatch=32),
        "quadrature": lambda: jpkg.QuadratureTraining(order=4, panels=2),
        "weak": lambda: jpkg.WeakTraining(elements=4, n_test=8, ibp=1),
        "causal": lambda: jpkg.CausalTraining(64, "y", bcs_points=8,
                                              n_slabs=4, causal_eps=2.0),
        "separable": lambda: jpkg.SeparableTraining(dx=1 / 63),
        "separablecausal": lambda: jpkg.SeparableTraining(
            dx=1 / 63, causal="t", causal_eps=5.0),
    }[kind]()


def _jsystem(kind):
    if kind == "separable":
        x, y = jpkg.symbols("x y")
        u = jpkg.DepVar("u")
        eq = jpkg.Eq((jpkg.Differential(x) ** 2)(u(x, y))
                     + (jpkg.Differential(y) ** 2)(u(x, y)),
                     -jpkg.sin(np.pi * x) * jpkg.sin(np.pi * y))
        return jpkg.PDESystem(
            eq, [jpkg.Eq(u(0.0, y), 0.0), jpkg.Eq(u(1.0, y), 0.0)],
            [jpkg.Domain(x, jpkg.Interval(0, 1)),
             jpkg.Domain(y, jpkg.Interval(0, 1))], [x, y], [u(x, y)])
    if kind == "separablecausal":
        x, t = jpkg.symbols("x t")
        u = jpkg.DepVar("u")
        eq = jpkg.Eq(jpkg.Differential(t)(u(t, x)),
                     0.1 * (jpkg.Differential(x) ** 2)(u(t, x)))
        return jpkg.PDESystem(
            eq, [jpkg.Eq(u(0.0, x), jpkg.sin(np.pi * x))],
            [jpkg.Domain(x, jpkg.Interval(0, 1)),
             jpkg.Domain(t, jpkg.Interval(0, 1))], [x, t], [u(t, x)])
    return poisson_2d(jpkg)


def _jproblem(name, tree):
    kind = name.split("-")[0]
    net = (jpkg.separable_mlp(2, (16,), 8) if kind.startswith("separable")
           else jpkg.mlp([2, 8, 1]))
    dtype = _jdtype(name)
    tree = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    return jpkg.discretize(_jsystem(kind), jpkg.PhysicsInformedNN(
        net, _jstrategy(name), init_params=tree, dtype=dtype,
        derivative="jvp" if kind in JVP_KINDS else "jet"))


def _tree(name, seed):
    kind = name.split("-")[0]
    rng = np.random.default_rng(seed)
    if kind.startswith("separable"):
        shapes = jax.eval_shape(jpkg.separable_mlp(2, (16,), 8).init,
                                jax.random.key(0))
        return tree_like(shapes, rng, 0.5)
    return mlp_params(rng, [2, 8, 1])


def _jax_points(prob, n_pts, n_bc, bc_bound_points, dtype):
    """The points the JAX package's full loss draws with key KEY: one
    array an equation, PDEs then BCs (the order the port's sampler is
    asked in)."""
    rep = prob.pinnrep
    key = jax.random.key(KEY)
    n_pde, n_b = len(rep.pde_args), len(rep.bc_args)
    keys = (list(jax.random.split(jax.random.fold_in(key, 0), max(n_pde, 1)))
            [:n_pde] + list(jax.random.split(jax.random.fold_in(key, 1),
                                             max(n_b, 1)))[:n_b])
    out = []
    for i, (args, k) in enumerate(zip(rep.pde_args + rep.bc_args, keys)):
        pde = i < n_pde
        lb, ub = jpkg.get_bounds(rep.domains, [args],
                                 n_pts if pde else bc_bound_points, dtype)[0]
        out.append(np.asarray(jsampling.uniform_random(
            k, n_pts if pde else n_bc, lb, ub, dtype=dtype)))
    return out


def _strategy_inputs(name, seed):
    tree = _tree(name, seed)
    case = {"tree": tree, "points": None, "plain": name in PORT_ONLY}
    kind = name.split("-")[0]
    if kind in ("stochastic", "causal"):
        prob = _jproblem(name, tree)
        s = prob.pinnrep.strategy
        bound = s.points if kind == "stochastic" else s.bcs_points
        case["points"] = _jax_points(prob, s.points, s.bcs_points, bound,
                                     _jdtype(name))
    return case


# ---------------------------------------------------------------------------
# PINO heat family (the JAX tests' test_pino_pde_family_axis_sharding and
# test_pino_pde_causal_mesh_parity, at 2 members a rank)
# ---------------------------------------------------------------------------

def _pino_alg(pkg, kind, tree, samples):
    E = JE
    x, t = E.Sym("x"), E.Sym("t")
    nu, u, f0 = E.Param("nu"), E.DepVar("u"), E.DepVar("f0")
    eq = E.Eq(E.Deriv(u(x, t), (t,)), nu * E.Deriv(u(x, t), (x, x)))
    doms = [pkg.Domain(x, pkg.Interval(0, 1)), pkg.Domain(t, pkg.Interval(0, 1))]
    tree = jax.tree.map(jnp.asarray, tree)
    if kind == "plain":
        sysd = pkg.PDESystem(eq, [E.Eq(u(x, E.Num(0.0)), f0(x))], doms,
                             ivs=[x, t], dvs=[u(x, t)], ps=[nu])
        alg = pkg.PINOPDE(chain=pkg.FNO2D(2, width=8, modes=4, depth=2),
                          opt=optax.adam(LR), bounds=[(0.05, 0.3)],
                          number_of_parameters=2 * W,
                          input_functions={f0(x): lambda k, g, n: samples},
                          strategy=pkg.GridTraining(0.25), init_params=tree)
    else:
        sysd = pkg.PDESystem(eq, [E.Eq(u(x, E.Num(0.0)),
                                       pkg.sin(np.pi * x))], doms,
                             ivs=[x, t], dvs=[u(x, t)], ps=[nu])
        alg = pkg.PINOPDE(chain=pkg.FNO2D(1, width=8, modes=4, depth=2),
                          opt=optax.adam(LR), bounds=[(0.05, 0.3)],
                          number_of_parameters=2 * W, causal_eps=3.0,
                          strategy=pkg.GridTraining(0.25), init_params=tree)
    return sysd, alg


def _pino_inputs(kind, seed):
    rng = np.random.default_rng(seed)
    chain = jpkg.FNO2D(2 if kind == "plain" else 1, width=8, modes=4, depth=2)
    tree = tree_like(jax.eval_shape(chain.init, jax.random.key(0)), rng, 0.3)
    samples = (rng.normal(size=(5, 2 * W)) if kind == "plain" else None)
    return {"tree": tree, "samples": samples}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

class Ranks:
    """The worker processes of one mode, started at construction; their
    results on first use."""

    def __init__(self, mode, world, inputs, tmp):
        store = os.path.join(tmp, "store")
        path = os.path.join(tmp, "inputs.pkl")
        with open(path, "wb") as f:
            pickle.dump(inputs, f)
        root = os.path.dirname(os.path.dirname(os.path.abspath(WORKER)))
        env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
               "HOME": os.environ.get("HOME", tmp),
               "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
        self.tmp, self.world = tmp, world
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, mode, str(r), str(world), store, path,
             tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
            for r in range(world)]
        self._results = None

    def results(self):
        if self._results is None:
            logs = [p.communicate(timeout=600)[0].decode() for p in self.procs]
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-4000:]
            self._results = []
            for r in range(self.world):
                with open(os.path.join(self.tmp, f"rank{r}.pkl"), "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = {"strategies": {n: _strategy_inputs(n, i) for i, n in
                             enumerate(STRATEGY_CASES + PORT_ONLY)},
              "pino": {k: _pino_inputs(k, 20 + i)
                       for i, k in enumerate(("plain", "causal"))}}
    rng = np.random.default_rng(30)
    inputs["tp_tree"] = mlp_params(rng, [2, 8, 8, 1])
    inputs["tp_wide_tree"] = mlp_params(rng, [2, 8, 8, 2])
    inputs["tp_x"] = np.linspace(0.0, 1.0, 128).reshape(2, 64)
    tp_prob = _tp_problem(inputs["tp_tree"])
    inputs["tp_points"] = _jax_points(tp_prob, 32, 4, 32, jnp.float64)
    r = Ranks("mesh", W, inputs, str(tmp_path_factory.mktemp("mesh")))
    r.inputs = inputs
    yield r
    for p in r.procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(W)


def _tp_problem(tree):
    return jpkg.discretize(poisson_2d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp([2, 8, 8, 1]), jpkg.StochasticTraining(32, bcs_points=4),
        init_params=jax.tree.map(jnp.asarray, tree), derivative="jet",
        dtype=jnp.float64))


def _flat(tree, prefix="depvar"):
    return {k: np.asarray(v) for k, v in tpkg.params_from_jax(
        {prefix: jax.tree.map(np.asarray, tree)}).items()}


def _check_step(got, want, tol):
    """A rank's one-step result against the JAX package's."""
    assert rel_err(got["loss0"], want["loss0"]) < tol
    scale = max(np.max(np.abs(v)) for v in want["grads"].values())
    for k, g in want["grads"].items():
        assert np.max(np.abs(got["grads"][k] - g)) / scale < tol, k
    # Adam's first step divides the gradient by its own magnitude, which
    # lifts the relative error of a near-zero component (test_torch_pino's
    # bound for parameters after Adam steps)
    ptol = max(tol, 1e-8)
    for k, p in want["params"].items():
        assert rel_err(got["params"][k], p) < ptol, k
    assert rel_err(got["loss1"], want["loss1"]) < tol


def _jax_step(loss_fn, theta):
    """Loss, gradient, parameters after one optax Adam step and the loss
    there, of a JAX loss ``loss_fn(theta)`` (flat numpy, port names)."""
    vg = jax.jit(jax.value_and_grad(loss_fn))
    l0, g = vg(theta)
    opt = optax.adam(LR)
    upd, _ = opt.update(g, opt.init(theta), theta)
    theta1 = optax.apply_updates(theta, upd)
    l1, _ = vg(theta1)
    return {"loss0": float(l0), "loss1": float(l1),
            "grads": _flat(g["depvar"]), "params": _flat(theta1["depvar"])}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def test_a_mesh_needs_a_process_group_and_a_mesh():
    """In this process no group is initialized; `use_mesh` and the
    ``mesh=`` drivers take a `Mesh` only."""
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmesh.make_mesh(device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        with tmesh.use_mesh(object()):
            pass
    assert tmesh.get_mesh() is None
    x = torch.zeros((2, 8))
    assert tmesh.shard_batch(x) is x           # no mesh: no-op


def test_the_port_has_every_module_and_the_top_level_mesh_names():
    """After slice 10 every module of the JAX package has its counterpart,
    and the six top-level names of `neuralpde_tpu/__init__.py:40-42`."""
    from pathlib import Path

    jroot = Path(jpkg.__file__).parent
    troot = Path(tpkg.__file__).parent
    missing = [str(p.relative_to(jroot)) for p in jroot.rglob("*.py")
               if not (troot / p.relative_to(jroot)).exists()]
    assert missing == []
    for name in ("make_mesh", "make_mesh_2d", "replicate_params",
                 "shard_batch", "shard_params_tp", "use_mesh"):
        assert getattr(tpkg, name) is getattr(tmesh, name)


def test_mesh_layout(ranks):
    res = ranks.results()
    for r, out in enumerate(res):
        assert out["shape"] == {"data": W} and out["coords"] == {"data": r}
        assert "requested 8 devices" in out["too_many"]
        # rank 0's parameters everywhere
        np.testing.assert_array_equal(out["replicated"], np.zeros(2))
        assert out["tp"]["coords"] == {"data": r // 2, "model": r % 2}


def test_shard_batch_slices_match_jax(ranks, jmesh):
    x = np.arange(128, dtype=np.float64).reshape(2, 64)
    with juse_mesh(jmesh):
        xs = jshard_batch(jnp.asarray(x))
    shards = sorted(xs.addressable_shards, key=lambda s: s.device.id)
    res = ranks.results()
    for r in range(W):
        np.testing.assert_array_equal(res[r]["slice"],
                                      np.asarray(shards[r].data))
        np.testing.assert_array_equal(res[r]["nodes"],
                                      np.arange(64)[16 * r:16 * (r + 1)])
        assert res[r]["indivisible_kept"]


@pytest.mark.parametrize("name", STRATEGY_CASES)
def test_strategy_loss_and_adam_step_match_jax(ranks, jmesh, name):
    """One training step under the mesh: the summed loss, the summed
    gradient, the parameters after Adam and the loss there, on every rank,
    against the JAX package's under its mesh.  "gridodd" (121 and 11
    points) and the stochastic case's 9 boundary points do not divide by
    4: those terms are computed whole and counted once."""
    case = ranks.inputs["strategies"][name]
    with juse_mesh(jmesh):
        prob = _jproblem(name, case["tree"])
        rep = prob.pinnrep
        lstate = {"key": jax.random.key(KEY), "adaptive":
                  rep.adaloss.init_state(len(rep.pde_args),
                                         len(rep.bc_args), _jdtype(name))}
        want = _jax_step(lambda th: prob.loss(th, lstate)[0],
                         prob.init_params)
    for out in ranks.results():
        _check_step(out["strategies"][name], want, _tol(name))


@pytest.mark.parametrize("name", PORT_ONLY)
def test_resampled_strategies_match_the_run_without_a_mesh(ranks, name):
    """ResidualAdaptiveTraining and QuasiRandomTraining: every rank draws
    the global candidates or design from the same generator, so the mesh
    run is the run without one."""
    for out in ranks.results():
        _check_step(out["strategies"][name], out["plain"][name], 1e-10)


@pytest.mark.parametrize("kind", ["plain", "causal"])
def test_pino_family_axis_matches_jax(ranks, jmesh, kind):
    """The PINOPDE family axis over the mesh (2 members a rank), with the
    causal slice weights from the global family."""
    case = ranks.inputs["pino"][kind]
    sysd, alg = _pino_alg(jpkg, kind, case["tree"], case["samples"])
    with juse_mesh(jmesh):
        b = jpde._build(sysd, alg)
        want = _jax_step(lambda th: b.total_loss(th, jax.random.key(0)),
                         {"depvar": jax.tree.map(jnp.asarray, case["tree"])})
    for out in ranks.results():
        _check_step(out["pino"][kind], want, 1e-10)


def test_tensor_parallel_forward_matches_jax(ranks):
    """mlp([2, 8, 8, 1]) on a (data 2, model 2) mesh: layer 0 column- and
    layer 1 row-parallel, the output layer replicated."""
    tree = jax.tree.map(jnp.asarray, ranks.inputs["tp_tree"])
    x = jnp.asarray(ranks.inputs["tp_x"])
    net = jpkg.mlp([2, 8, 8, 1])
    mesh2 = jmake_mesh_2d(2, 2)
    with juse_mesh(mesh2):
        want = np.asarray(jax.jit(net.apply)(jshard_params_tp(tree, mesh2),
                                             jshard_batch(x)))
    np.testing.assert_allclose(want, np.asarray(net.apply(tree, x)),
                               rtol=1e-12)
    for out in ranks.results():
        tp = out["tp"]
        assert tp["places"]["layer_0.weight"] == ("model", 0)
        assert tp["places"]["layer_0.bias"] == ("model", 0)
        assert tp["places"]["layer_1.weight"] == ("model", 1)
        assert tp["places"]["layer_1.bias"] == (None, None)
        assert tp["places"]["layer_2.weight"] == (None, None)
        assert rel_err(tp["forward"], want) < 1e-12


def _local(v, place, m):
    """Model rank m's slice of a full array under a `Placement`."""
    axis, dim = place
    if axis is None:
        return v
    n = v.shape[dim] // 2
    return np.take(v, range(m * n, (m + 1) * n), axis=dim)


def test_tensor_parallel_gathers_a_split_output_and_its_gradient(ranks):
    """mlp([2, 8, 8, 2]): layer 2, column-parallel, takes an input that
    carries a gradient (its cotangents summed over the model axis) and
    leaves a split output that is gathered; forward and the gradient of
    sum(out^2) against the JAX package's."""
    tree = jax.tree.map(jnp.asarray, ranks.inputs["tp_wide_tree"])
    x = jnp.asarray(ranks.inputs["tp_x"])
    net = jpkg.mlp([2, 8, 8, 2])
    want = np.asarray(net.apply(tree, x))
    g = _flat(jax.grad(lambda p: jnp.sum(net.apply(p, x) ** 2))(tree), "n")
    for out in ranks.results():
        wide, m = out["tp"]["wide"], out["tp"]["coords"]["model"]
        assert wide["places"]["layer_2.weight"] == ("model", 0)
        assert rel_err(wide["forward"], want) < 1e-12
        scale = max(np.max(np.abs(v)) for v in g.values())
        for k, v in wide["grads"].items():
            ref = _local(g["n." + k], wide["places"][k], m)
            assert np.max(np.abs(v - ref)) / scale < 1e-12, k


def test_tensor_parallel_dp_loss_matches_jax(ranks):
    """The full jet loss and one Adam step under data + tensor parallelism:
    each rank's gradient and parameters are its slices of the JAX
    package's."""
    tree = ranks.inputs["tp_tree"]
    mesh2 = jmake_mesh_2d(2, 2)
    with juse_mesh(mesh2):
        prob = _tp_problem(tree)
        lstate = {"key": jax.random.key(KEY), "adaptive":
                  prob.pinnrep.adaloss.init_state(1, 4, jnp.float64)}
        theta = {"depvar": jshard_params_tp(prob.init_params["depvar"],
                                            mesh2)}
        want = _jax_step(lambda th: prob.loss(th, lstate)[0], theta)
    for out in ranks.results():
        tp = out["tp"]
        m = tp["coords"]["model"]
        local = {part: {k: _local(v, tp["places"][k[len("depvar."):]], m)
                        for k, v in want[part].items()}
                 for part in ("grads", "params")}
        _check_step(tp["step"], {**want, **local}, 1e-10)


def test_solve_reweighting_by_component_gradients_under_the_mesh(ranks):
    """Four `solve` steps with GradientScaleAdaptiveLoss reweighting every
    step: the per-equation gradients are summed over the mesh, so weights
    and parameters are those of the run without a mesh; each rank keeps
    its own checkpoint directory."""
    for out in ranks.results():
        sharded, plain = out["reweighting"]
        assert sharded["checkpoints"] == [f"rank{r}" for r in range(W)]
        assert rel_err(sharded["weights"], plain["weights"]) < 1e-10
        assert not np.allclose(plain["weights"], 1.0)
        for k, v in plain["params"].items():
            assert rel_err(sharded["params"][k], v) < 1e-10, k
        assert rel_err(sharded["loss"], plain["loss"]) < 1e-10


def test_ensemble_over_mesh_matches_unsharded(ranks):
    """8 members, 2 a rank: every rank returns all members, bit-equal to
    the run without a mesh; a member count that does not divide raises."""
    for out in ranks.results():
        ens = out["ensembles"]
        for k, v in ens["plain"].items():
            np.testing.assert_array_equal(ens["sharded"][k], v)
        np.testing.assert_array_equal(*ens["losses"])
        np.testing.assert_array_equal(*ens["history"])
        assert "multiple of the mesh size" in ens["refused"]


@pytest.mark.parametrize("kernel", ["hmc", "nuts"])
def test_chains_over_mesh(ranks, kernel):
    """"hmc": 8 chains, 2 a rank, equal to the run without a mesh.
    "nuts": 4 chains, one a rank; the first rank's chain continues no
    other, so it is chain 0 of the run without a mesh."""
    for out in ranks.results():
        sharded, plain = out["chains"][kernel]
        assert sharded.shape == plain.shape
        assert np.all(np.isfinite(sharded))
        if kernel == "hmc":
            np.testing.assert_array_equal(sharded, plain)
        else:
            np.testing.assert_array_equal(sharded[0], plain[0])
