"""One rank of the port's multi-process tests (tests/test_torch_mesh.py,
tests/test_torch_distributed.py), on the CPU with gloo.

    python _torch_mesh_worker.py MODE RANK WORLD STORE INPUTS OUT_DIR

joins a process group of WORLD ranks through the file store STORE
(`initialize_distributed(f"file://{STORE}", ...)`), runs every check of
MODE ("mesh" or "distributed") on the parameters and points in the pickle
INPUTS (the JAX package's, as numpy arrays), and writes its results to
OUT_DIR/rank<RANK>.pkl.  It imports `torch` and the port, never JAX.
"""

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

F64 = torch.float64
LR = 1e-2
# the kinds of case that take the "jvp" engine, as the JAX tests they
# mirror do; the others take "jet" (the JAX side takes the same)
JVP_KINDS = ("weak", "separable", "separablecausal")


class Feed:
    """A strategy sampler that returns the given point arrays in turn (a
    full loss asks for its equations' points in order: PDEs, then BCs)."""

    def __init__(self, arrays, dtype):
        self.arrays = [torch.as_tensor(a, dtype=dtype) for a in arrays]
        self.i = 0

    def __call__(self, n, lb, ub, generator):
        out = self.arrays[self.i % len(self.arrays)]
        self.i += 1
        assert out.shape[1] == n, (out.shape, n)
        return out


def _np(t):
    return t.detach().cpu().numpy()


def strategy(tpkg, name, n_slabs=4):
    """The port's strategy of a case of test_torch_mesh.STRATEGY_CASES."""
    kind = name.split("-")[0]
    if kind == "grid":
        return tpkg.GridTraining(1 / 15)
    if kind == "gridodd":
        return tpkg.GridTraining(0.1)
    if kind == "stochastic":
        return tpkg.StochasticTraining(256, bcs_points=9, microbatch=32)
    if kind == "quadrature":
        return tpkg.QuadratureTraining(order=4, panels=2)
    if kind == "weak":
        return tpkg.WeakTraining(elements=4, n_test=8, ibp=1)
    if kind == "causal":
        return tpkg.CausalTraining(64, "y", bcs_points=8, n_slabs=n_slabs,
                                   causal_eps=2.0)
    if kind == "separable":
        return tpkg.SeparableTraining(dx=1 / 63)
    if kind == "separablecausal":
        return tpkg.SeparableTraining(dx=1 / 63, causal="t", causal_eps=5.0)
    if kind == "rad":
        return tpkg.ResidualAdaptiveTraining(64, candidates=128,
                                             bcs_points=8)
    if kind == "quasi":
        return tpkg.QuasiRandomTraining(64, bcs_points=8)
    raise ValueError(name)


def problem(tpkg, name, tree, dtype):
    """The 2-D problem of a case, on the CPU."""
    from _torch_parity import poisson_2d

    kind = name.split("-")[0]
    if kind.startswith("separable"):
        x, y = tpkg.symbols("x y")
        t = tpkg.symbols("t")
        u = tpkg.DepVar("u")
        if kind == "separable":
            eq = tpkg.Eq((tpkg.Differential(x) ** 2)(u(x, y))
                         + (tpkg.Differential(y) ** 2)(u(x, y)),
                         -tpkg.sin(np.pi * x) * tpkg.sin(np.pi * y))
            system = tpkg.PDESystem(
                eq, [tpkg.Eq(u(0.0, y), 0.0), tpkg.Eq(u(1.0, y), 0.0)],
                [tpkg.Domain(x, tpkg.Interval(0, 1)),
                 tpkg.Domain(y, tpkg.Interval(0, 1))], [x, y], [u(x, y)])
        else:
            eq = tpkg.Eq(tpkg.Differential(t)(u(t, x)),
                         0.1 * (tpkg.Differential(x) ** 2)(u(t, x)))
            system = tpkg.PDESystem(
                eq, [tpkg.Eq(u(0.0, x), tpkg.sin(np.pi * x))],
                [tpkg.Domain(x, tpkg.Interval(0, 1)),
                 tpkg.Domain(t, tpkg.Interval(0, 1))], [x, t], [u(t, x)])
        net = tpkg.separable_mlp(2, (16,), 8, dtype=dtype)
    else:
        system = poisson_2d(tpkg)
        net = tpkg.mlp([2, 8, 1], dtype=dtype)
    return tpkg.discretize(system, tpkg.PhysicsInformedNN(
        net, strategy(tpkg, name), derivative="jvp" if kind in JVP_KINDS else "jet", dtype=dtype,
        device="cpu", init_params=tpkg.params_from_jax(tree, dtype=dtype)))


def one_step(tpkg, loss, params, generator, n_pde=0, n_bc=0, dtype=F64,
             adaloss=None):
    """One Adam step of `make_step` under the ambient mesh -> loss, the
    summed gradients and the parameters after it, and the loss after it
    (its shares summed)."""
    from neuralpde_tpu_torch.parallel.mesh import get_mesh, sum_over_data

    step = tpkg.make_step(loss, tpkg.adam(LR), mesh_shares=True)
    ada = (adaloss or tpkg.NonAdaptiveLoss()).init_state(n_pde, n_bc, dtype,
                                                          "cpu")
    theta, opt, ada, _ = step.init(params, ada)
    loss0, aux = step.run(theta, opt, ada, generator, False)
    grads = {k: _np(v.grad) for k, v in theta.items()}
    with torch.no_grad():
        share, _ = loss(theta, {"generator": generator, "adaptive": ada})
    loss1 = sum_over_data(share) if get_mesh() is not None else share
    return {"loss0": float(loss0), "loss1": float(loss1), "grads": grads,
            "params": {k: _np(v) for k, v in theta.items()},
            "aux": {k: _np(v) for k, v in aux.items()}}


def run_strategy(tpkg, name, case, dtype):
    prob = problem(tpkg, name, case["tree"], dtype)
    if case.get("points") is not None:
        prob.pinnrep.strategy.sampler = Feed(case["points"], dtype)
    lf = prob.pinnrep.loss_functions
    return one_step(tpkg, prob.loss, prob.init_params,
                    torch.Generator().manual_seed(3),
                    len(lf.pde_loss_functions), len(lf.bc_loss_functions),
                    dtype)


def pino(tpkg, case):
    """The PINOPDE heat family of a case (init_params and, for "plain", the
    input-function samples from the JAX package)."""
    from neuralpde_tpu_torch.solvers import pino_pde as tpde
    from neuralpde_tpu_torch.solvers.ode import _SimpleProblem
    from neuralpde_tpu_torch.symbolic import expr as E

    x, t = E.Sym("x"), E.Sym("t")
    nu, u, f0 = E.Param("nu"), E.DepVar("u"), E.DepVar("f0")
    eq = E.Eq(E.Deriv(u(x, t), (t,)), nu * E.Deriv(u(x, t), (x, x)))
    doms = [tpkg.Domain(x, tpkg.Interval(0, 1)),
            tpkg.Domain(t, tpkg.Interval(0, 1))]
    params = tpkg.params_from_jax(case["tree"], dtype=F64)
    if case["samples"] is not None:
        samples = case["samples"]
        sysd = tpkg.PDESystem(eq, [E.Eq(u(x, E.Num(0.0)), f0(x))], doms,
                              ivs=[x, t], dvs=[u(x, t)], ps=[nu])
        alg = tpkg.PINOPDE(
            chain=tpkg.FNO2D(2, width=8, modes=4, depth=2), opt=tpkg.adam(LR),
            bounds=[(0.05, 0.3)], number_of_parameters=8,
            input_functions={f0(x): lambda gen, grids, n: samples},
            strategy=tpkg.GridTraining(0.25), init_params=params)
    else:
        sysd = tpkg.PDESystem(eq, [E.Eq(u(x, E.Num(0.0)),
                                        tpkg.sin(np.pi * x))], doms,
                              ivs=[x, t], dvs=[u(x, t)], ps=[nu])
        alg = tpkg.PINOPDE(
            chain=tpkg.FNO2D(1, width=8, modes=4, depth=2), opt=tpkg.adam(LR),
            bounds=[(0.05, 0.3)], number_of_parameters=8, causal_eps=3.0,
            strategy=tpkg.GridTraining(0.25), init_params=params)
    b = tpde._build(sysd, alg, device="cpu")
    prob = _SimpleProblem(b.total_loss, b.theta0, mesh_shares=True)
    return one_step(tpkg, prob.loss, prob.init_params, torch.Generator())


def tensor_parallel(tpkg, M, inputs, mesh2):
    tree = inputs["tp_tree"]
    full = tpkg.params_from_jax(tree, dtype=F64)
    net = tpkg.mlp([2, 8, 8, 1], dtype=F64)
    local, places = M.shard_params_tp(full, mesh2)
    out = {"places": {k: (p.axis, p.dim) for k, p in places.items()},
           "coords": dict(mesh2.coords)}
    with M.use_mesh(mesh2):
        out["forward"] = _np(tpkg.Phi(net)(torch.as_tensor(inputs["tp_x"]),
                                           local))
        # mlp([2, 8, 8, 2]): layer 2 is column-parallel on an input that
        # carries a gradient, and its split output is gathered
        wide = tpkg.params_from_jax(inputs["tp_wide_tree"], dtype=F64)
        wlocal, wplaces = M.shard_params_tp(wide, mesh2)
        wlocal = {k: v.clone().requires_grad_(True)
                  for k, v in wlocal.items()}
        y = tpkg.Phi(tpkg.mlp([2, 8, 8, 2], dtype=F64))(
            torch.as_tensor(inputs["tp_x"]), wlocal)
        grads = torch.autograd.grad(torch.sum(y ** 2), list(wlocal.values()))
        out["wide"] = {"forward": _np(y),
                       "places": {k: (p.axis, p.dim)
                                  for k, p in wplaces.items()},
                       "grads": {k: _np(g) for k, g in zip(wlocal, grads)}}
    # dp+tp: the full loss and one Adam step on the Poisson problem
    from _torch_parity import poisson_2d

    with M.use_mesh(mesh2):
        prob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
            tpkg.mlp([2, 8, 8, 1], dtype=F64),
            tpkg.StochasticTraining(32, bcs_points=4), derivative="jet",
            dtype=F64, device="cpu",
            init_params=tpkg.params_from_jax(tree, dtype=F64)))
        prob.pinnrep.strategy.sampler = Feed(inputs["tp_points"], F64)
        tp_theta, _ = M.shard_params_tp(prob.init_params, mesh2)
        out["step"] = one_step(tpkg, prob.loss, tp_theta,
                               torch.Generator().manual_seed(0), 1, 4)
    return out


def reweighting(tpkg, M, mesh, out_dir):
    """`solve` with GradientScaleAdaptiveLoss (per-equation gradients,
    summed over the mesh) reweighting every step, under the mesh (with a
    checkpoint directory) and without it."""
    from _torch_parity import poisson_2d

    def run(m, checkpoint_dir=None):
        prob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
            tpkg.mlp([2, 8, 1], dtype=F64), tpkg.GridTraining(1 / 15),
            derivative="jet", dtype=F64, device="cpu",
            adaptive_loss=tpkg.GradientScaleAdaptiveLoss(1)))
        with M.use_mesh(m) if m is not None else M.no_mesh():
            res = tpkg.solve(prob, tpkg.adam(LR), maxiters=4,
                             checkpoint_dir=checkpoint_dir)
        return {"params": {k: _np(v) for k, v in res.u.items()},
                "weights": _np(res.aux["adaptive_state"]["bc_weights"]),
                "loss": res.objective}

    ckpt = os.path.join(out_dir, "checkpoint")
    sharded = run(mesh, ckpt)
    dist.barrier()
    sharded["checkpoints"] = sorted(os.listdir(ckpt))
    return sharded, run(None)


def ensembles(tpkg, M, mesh):
    from _torch_parity import poisson_2d

    prob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([2, 8, 1], dtype=F64), tpkg.GridTraining(0.25),
        derivative="jet", dtype=F64, device="cpu"))

    def run(m):
        return tpkg.solve_ensemble(prob, tpkg.adam(LR), maxiters=10,
                                   n_ensemble=8, inner_steps=5, mesh=m)

    sharded, plain = run(mesh), run(None)
    try:
        tpkg.solve_ensemble(prob, tpkg.adam(LR), maxiters=5, n_ensemble=6,
                            mesh=mesh)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"sharded": {k: _np(v) for k, v in sharded.members.items()},
            "plain": {k: _np(v) for k, v in plain.members.items()},
            "losses": (_np(sharded.losses), _np(plain.losses)),
            "history": (sharded.history[-1][1], plain.history[-1][1]),
            "refused": refused}


def chains(mesh):
    from neuralpde_tpu_torch.bayesian import hmc

    def ld(q):
        return -0.5 * torch.sum((q - 0.5) ** 2)

    out = {}
    for kernel, n, draws in (("hmc", 8, 40), ("nuts", 4, 15)):
        q0s = 0.1 * torch.arange(n, dtype=F64)[:, None] * torch.ones(3)

        def run(m):
            return _np(hmc.sample_chains(
                ld, q0s, torch.Generator().manual_seed(7), draws,
                kernel=kernel, n_leapfrog=10, max_depth=4, mesh=m))

        out[kernel] = (run(mesh), run(None))
    return out


def mesh_mode(tpkg, inputs, rank, out_dir):
    from neuralpde_tpu_torch.parallel import mesh as M

    mesh = M.make_mesh(device="cpu")
    res = {"shape": dict(mesh.shape), "coords": dict(mesh.coords)}
    x = torch.arange(128, dtype=F64).reshape(2, 64)
    y = torch.zeros((2, 63))
    nodes = torch.arange(64, dtype=F64)
    with M.use_mesh(mesh):
        res["slice"] = _np(M.shard_batch(x))
        odd = nodes[:63]
        res["indivisible_kept"] = (M.shard_batch(y) is y
                                   and M.shard_axis_nodes(odd) is odd)
        res["nodes"] = _np(M.shard_axis_nodes(nodes))
    res["replicated"] = _np(M.replicate_params(
        {"w": torch.full((2,), float(rank))}, mesh)["w"])
    try:
        M.make_mesh(8, device="cpu")
        res["too_many"] = ""
    except ValueError as e:
        res["too_many"] = str(e)

    res["strategies"] = {}
    res["plain"] = {}
    for name, case in inputs["strategies"].items():
        dtype = torch.float32 if name.endswith("-f32") else F64
        with M.use_mesh(mesh):
            res["strategies"][name] = run_strategy(tpkg, name, case, dtype)
        if case.get("plain"):
            res["plain"][name] = run_strategy(tpkg, name, case, dtype)
    res["pino"] = {}
    for name, case in inputs["pino"].items():
        with M.use_mesh(mesh):
            res["pino"][name] = pino(tpkg, case)
    mesh2 = M.make_mesh_2d(2, 2, device="cpu")
    res["tp"] = tensor_parallel(tpkg, M, inputs, mesh2)
    res["reweighting"] = reweighting(tpkg, M, mesh, out_dir)
    res["ensembles"] = ensembles(tpkg, M, mesh)
    res["chains"] = chains(mesh)
    return res


def distributed_mode(tpkg, inputs, rank, out_dir):
    from neuralpde_tpu_torch.parallel.distributed import (
        global_batch_mesh, per_process_batch,
    )
    from neuralpde_tpu_torch.parallel.mesh import use_mesh

    mesh = global_batch_mesh(device="cpu")
    res = {"batch": per_process_batch(64), "size": mesh.size}
    try:
        per_process_batch(63)
        res["refused"] = ""
    except ValueError as e:
        res["refused"] = str(e)
    x, y = tpkg.symbols("x y")
    u = tpkg.DepVar("u")
    eq = tpkg.Eq((tpkg.Differential(x) ** 2)(u(x, y))
                 + (tpkg.Differential(y) ** 2)(u(x, y)),
                 -tpkg.sin(np.pi * x) * tpkg.sin(np.pi * y))
    system = tpkg.PDESystem(
        eq, [tpkg.Eq(u(0.0, y), 0.0), tpkg.Eq(u(1.0, y), 0.0)],
        [tpkg.Domain(x, tpkg.Interval(0, 1)),
         tpkg.Domain(y, tpkg.Interval(0, 1))], [x, y], [u(x, y)])
    with use_mesh(mesh):
        prob = tpkg.discretize(system, tpkg.PhysicsInformedNN(
            tpkg.mlp([2, 8, 1], dtype=F64), tpkg.GridTraining(1 / 3),
            dtype=F64, device="cpu",
            init_params=tpkg.params_from_jax(inputs["tree"], dtype=F64)))
        res["step"] = one_step(tpkg, prob.loss, prob.init_params,
                               torch.Generator(), 1, 2)
    return res


def main():
    mode, rank, world, store, inputs, out_dir = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    torch.set_default_dtype(F64)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import neuralpde_tpu_torch as tpkg
    from neuralpde_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )

    initialize_distributed(f"file://{store}", world, rank, device="cpu")
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    run = mesh_mode if mode == "mesh" else distributed_mode
    try:
        res = run(tpkg, data, rank, out_dir)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main()
