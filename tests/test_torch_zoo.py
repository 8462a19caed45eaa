"""Parity of the port's trial-function zoo with the JAX package: `FBPINN`
(flat, multilevel), `KANLayer`/`kan`, `DGM`, and the module adapter against
the same weights in an `mlp`; the list round-trip of `params_from_jax` /
`params_to_numpy` and the flat-vector order; `get_loss_function`.

The same parameters (`numpy.random.default_rng(seed)`, crossing through
`params_from_jax`) and the same points go through both packages.

Tolerances, relative to the largest |value|: float64 1e-10, float32 1e-5
for values and 1e-4 for derivatives (a derivative amplifies the rounding of
the value it differentiates: the FBPINN's windows divide by a sum of squared
cosines under 1/h^2 = 28, a degree-4 Chebyshev expansion's second
derivative carries k^4; 1.6e-5 was seen for the KAN).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch import nn

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, poisson_1d, poisson_2d, rel_err, tree_like
from neuralpde_tpu_torch.nn.core import TrialFunction

F64, F32 = torch.float64, torch.float32
JDT = {F64: jnp.float64, F32: jnp.float32}
TOL = {F64: 1e-10, F32: 1e-5}


def _nets(name):
    """(JAX net, port's net factory, points (dim, N)) for a zoo member."""
    rng = np.random.default_rng(7)
    if name == "fbpinn_flat":
        # the last points lie on window edges (|s| = 1): 0.125 +- 0.1875
        xs = np.concatenate([rng.uniform(0, 1, (1, 14)),
                             [[0.3125, 0.6875, 0.5]]], axis=1)
        kw = dict(subdivisions=4, hidden=(8,))
        return (jpkg.FBPINN([(0, 1)], **kw),
                lambda dt: tpkg.FBPINN([(0, 1)], dtype=dt, **kw), xs)
    if name == "fbpinn_multilevel":
        xs = np.stack([rng.uniform(0, 1, 17), rng.uniform(-1, 1, 17)])
        kw = dict(levels=[1, (3, 2)], hidden=(6,), overlap=0.7)
        bounds = [(0, 1), (-1, 1)]
        return (jpkg.FBPINN(bounds, **kw),
                lambda dt: tpkg.FBPINN(bounds, dtype=dt, **kw), xs)
    if name == "kan":
        return (jpkg.kan([2, 6, 5, 1], degree=4),
                lambda dt: tpkg.kan([2, 6, 5, 1], degree=4, dtype=dt),
                rng.uniform(-1, 1, (2, 19)))
    if name == "dgm":
        return (jpkg.DGM(2, 1, 10, 2),
                lambda dt: tpkg.DGM(2, 1, 10, 2, dtype=dt),
                rng.uniform(-1, 1, (2, 19)))
    if name == "dgm_sigmoid":
        return (jpkg.DGM(2, 1, 8, 1, jpkg.nn.sigmoid, jpkg.nn.tanh),
                lambda dt: tpkg.DGM(2, 1, 8, 1, tpkg.nn.sigmoid,
                                    tpkg.nn.tanh, dtype=dt),
                rng.uniform(-1, 1, (2, 19)))
    raise KeyError(name)


ZOO = ["fbpinn_flat", "fbpinn_multilevel", "kan", "dgm", "dgm_sigmoid"]


def _pair(name, dtype, seed=0):
    jnet, make, xs = _nets(name)
    tree = tree_like(jnet.init(jax.random.key(0)),
                     np.random.default_rng(seed), 0.6)
    jtree = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), tree)
    tnet = make(dtype)
    params = tpkg.params_from_jax(tree, dtype=dtype)
    return jnet, jtree, tnet, params, xs


def _jax_second(jnet, jtree, xs, vi, dtype):
    """First and second derivative along axis ``vi`` by nested `jax.jvp`."""
    e = np.zeros(xs.shape[0])
    e[vi] = 1.0
    e = jnp.asarray(e, JDT[dtype])

    def f(p):
        return jnet.apply(jtree, p[:, None])[0, 0]

    def d1(p):
        return jax.jvp(f, (p,), (e,))[1]

    d1s, d2s = jax.vmap(lambda p: jax.jvp(d1, (p,), (e,)))(
        jnp.asarray(xs.T, JDT[dtype]))
    return np.asarray(d1s), np.asarray(d2s)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_names_forward_and_derivatives(name, dtype):
    """Parameter names are the JAX tree's paths; forward, first and second
    derivatives agree, the second in "jvp" and in "jet" mode."""
    jnet, jtree, tnet, params, xs = _pair(name, dtype)
    assert set(params) == set(dict(tnet.named_parameters()))
    for k, p in tnet.named_parameters():
        assert tuple(p.shape) == tuple(params[k].shape), k
    assert tnet.has_taylor_rule
    u = TrialFunction(tnet, params)
    x = torch.as_tensor(xs, dtype=dtype)
    tol = TOL[dtype]
    assert rel_err(u(x), jnet.apply(jtree, jnp.asarray(xs, JDT[dtype]))) < tol
    tol2 = 1e-4 if dtype == F32 else tol       # see the module note
    for vi in range(xs.shape[0]):
        want1, want2 = _jax_second(jnet, jtree, xs, vi, dtype)
        got1 = tpkg.DerivativeEngine("jvp")(u, x, (vi,), xs.shape[0])[0]
        assert rel_err(got1, want1) < tol2
        for mode in ("jvp", "jet"):
            got2 = tpkg.DerivativeEngine(mode)(u, x, (vi, vi), xs.shape[0])[0]
            assert rel_err(got2, want2) < tol2, (mode, vi)


@pytest.mark.parametrize("name", ZOO)
def test_zoo_taylor_rule_against_nested_jvp(name):
    """Orders 2 and 3 of the Taylor rule against nested jvp (float64, 1e-10),
    and the parameter gradient of a second derivative through both."""
    _, _, tnet, params, xs = _pair(name, F64, seed=1)
    x = torch.as_tensor(xs, dtype=F64)
    dim = xs.shape[0]
    theta = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    for order in (2, 3):
        for vi in range(dim):
            grads = []
            for derive in (
                    lambda u: tpkg.jet_derivative(u, x, vi, order),
                    lambda u: tpkg.jvp_derivative(u, x, (vi,) * order, dim)):
                out = derive(TrialFunction(tnet, theta))
                # a last layer's bias does not reach a derivative
                grads.append((out.detach(), torch.autograd.grad(
                    (out * out).sum(), list(theta.values()),
                    allow_unused=True)))
            (jet, g_jet), (nested, g_nested) = grads
            assert rel_err(jet, nested) < 1e-10, (order, vi)
            for a, b in zip(g_jet, g_nested):
                assert (a is None) == (b is None)
                if a is not None:
                    assert rel_err(a, b) < 1e-9, (order, vi)


@pytest.mark.parametrize("mode,dtype", [("jvp", F64), ("jet", F64),
                                        ("jet", F32)],
                         ids=["jvp-f64", "jet-f64", "jet-f32"])
@pytest.mark.parametrize("name", ["fbpinn_multilevel", "kan", "dgm"])
def test_zoo_pinn_loss_and_gradient(name, mode, dtype):
    """Loss and parameter gradient of the 2-D Poisson problem on a grid,
    through `discretize`, against the JAX package (the flat gradient
    vectors line up entry for entry)."""
    jnet, jtree, tnet, params, _ = _pair(name, dtype, seed=2)
    if name == "fbpinn_multilevel":       # the problem lives on [0, 1]^2
        kw = dict(levels=[1, 2], hidden=(6,))
        jnet = jpkg.FBPINN([(0, 1)] * 2, **kw)
        tnet = tpkg.FBPINN([(0, 1)] * 2, dtype=dtype, **kw)
        tree = tree_like(jnet.init(jax.random.key(0)),
                         np.random.default_rng(3), 0.6)
        jtree = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), tree)
        params = tpkg.params_from_jax(tree, dtype=dtype)
    # `jax.experimental.jet` has no rule for the windows' product over axes
    # (reduce_prod), so the FBPINN's reference is the JAX "jvp" engine
    jmode = "jvp" if name.startswith("fbpinn") else mode
    jprob = jpkg.discretize(poisson_2d(jpkg), jpkg.PhysicsInformedNN(
        jnet, jpkg.GridTraining(0.125), init_params=jtree, derivative=jmode,
        dtype=JDT[dtype]))
    lstate = {"key": jax.random.key(0),
              "adaptive": jprob.pinnrep.adaloss.init_state(1, 4, JDT[dtype])}
    want, jgrad = jax.value_and_grad(
        lambda th: jprob.loss(th, lstate)[0])(jprob.init_params)
    tprob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tnet, tpkg.GridTraining(0.125), init_params=params, derivative=mode,
        dtype=dtype, device="cpu"))
    theta = {k: v.clone().requires_grad_(True)
             for k, v in tprob.init_params.items()}
    ada = tprob.pinnrep.adaloss.init_state(1, 4, dtype, "cpu")
    got, _ = tprob.loss(theta, {"generator": None, "adaptive": ada})
    got.backward()
    grad = tpkg.parameters_to_vector({k: v.grad for k, v in theta.items()})[0]
    tol = 1e-4 if dtype == F32 else TOL[dtype]  # a loss of second derivatives
    assert rel_err(got.detach(), want) < tol
    assert rel_err(grad, ravel_pytree(jgrad)[0]) < 10 * tol


def test_fbpinn_windows_partition_of_unity_and_edges():
    """Windows sum to 1 per level and are exactly 0 outside their support;
    at a window's edge the Taylor rule and nested jvp give the same second
    derivative, without a jump across it (the C^2 property)."""
    net = tpkg.FBPINN([(0, 1), (-1, 1)], levels=[1, 2, 4], hidden=(8,),
                      dtype=F64)
    assert net.n_levels == 3 and net.n_subdomains == 1 + 4 + 16
    x = torch.stack([torch.linspace(0.02, 0.98, 29, dtype=F64),
                     torch.linspace(-0.96, 0.96, 29, dtype=F64)])
    for level in range(3):
        w = net._windows(x, level)
        assert rel_err(w.sum(dim=0), np.ones(29)) < 1e-12
        assert float(w.min()) >= 0.0

    flat = tpkg.FBPINN([(0, 1)], subdivisions=4, hidden=(8,), dtype=F64)
    flat.reset_parameters(torch.Generator().manual_seed(1))
    w = flat._windows(torch.tensor([[0.3125, 0.32, 0.9]], dtype=F64))
    assert float(w[0, 0]) == 0.0 and float(w[0, 1]) == 0.0   # edge, outside
    u = TrialFunction(flat, dict(flat.named_parameters()))
    # the support edge of subdomain 0: center 0.125 + half-width 0.1875
    xs = torch.linspace(0.3120, 0.3130, 201, dtype=F64)[None, :]
    with torch.no_grad():
        jet = tpkg.jet_derivative(u, xs, 0, 2)[0]
        nested = tpkg.jvp_derivative(u, xs, (0, 0), 1)[0]
    assert rel_err(jet, nested) < 1e-10
    assert float(jet.diff().abs().max()) < 1e-2


def test_fbpinn_validation_and_init():
    with pytest.raises(ValueError, match="overlap"):
        tpkg.FBPINN([(0, 1)], overlap=0.0)
    with pytest.raises(ValueError, match="lo < hi"):
        tpkg.FBPINN([(1, 0)])
    with pytest.raises(ValueError, match="subdivisions"):
        tpkg.FBPINN([(0, 1)], subdivisions=0)
    with pytest.raises(ValueError, match="not both"):
        tpkg.FBPINN([(0, 1)], subdivisions=4, levels=[1, 2])
    with pytest.raises(ValueError, match="non-empty"):
        tpkg.FBPINN([(0, 1)], levels=[])
    with pytest.raises(ValueError, match="degree"):
        tpkg.KANLayer(2, 3, degree=0)
    # every local net is drawn like mlp's layers: glorot weights, zero bias
    net = tpkg.FBPINN([(0, 1)] * 2, subdivisions=(3, 2), hidden=(8,))
    net.reset_parameters(torch.Generator().manual_seed(0))
    w = net.nets.layer_0.weight
    assert tuple(w.shape) == (6, 8, 2)
    assert float(w.abs().max()) <= np.sqrt(6.0 / 10) and float(w.std()) > 0.2
    assert float(net.nets.layer_0.bias.abs().max()) == 0.0
    again = w.clone()
    net.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(net.nets.layer_0.weight, again)


def test_fbpinn_geometry_is_made_once_per_device():
    """Centers and half-widths become tensors in `prepare` only (the
    constructor's call, `discretize`'s): evaluations reuse them and copy
    nothing from the host, and a dtype that was not prepared raises."""
    net = tpkg.FBPINN([(0, 1)], levels=[2, 3], hidden=(4,), dtype=F32)
    x = torch.rand((1, 5))
    params = dict(net.named_parameters())
    kept = {k: list(v) for k, v in net._geometry.items()}
    assert [k[0] for k in kept] == [F32] and len(kept[F32, x.device]) == 2
    TrialFunction(net, params)(x)
    assert all(net._geometry[k][l] is v[l] for k, v in kept.items()
               for l in range(2))
    with pytest.raises(RuntimeError, match="prepare"):
        net(x.to(F64))
    tpkg.Transformed(net, lambda c, o: c * o).prepare(F64, "cpu")
    assert net._level_geometry(1, x.to(F64))[0].dtype == F64


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_adapter_matches_mlp_with_the_same_weights(dtype):
    """A wrapped `nn.Sequential` of Linear and Tanh layers against `mlp`
    holding the same weights: values, and a second derivative in "jet"
    mode (nested jvp for the adapter, which has no Taylor rule)."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        rng = np.random.default_rng(4)
        tree = mlp_params(rng, [2, 7, 6, 1])
        wrapped = tpkg.TorchModuleAdapter(nn.Sequential(
            nn.Linear(2, 7), nn.Tanh(), nn.Linear(7, 6), nn.Tanh(),
            nn.Linear(6, 1)).to(torch.float32), in_dim=2, out_dim=1)
    finally:
        torch.set_default_dtype(before)
    assert not wrapped.has_taylor_rule
    assert (wrapped.in_dim, wrapped.out_dim) == (2, 1)
    # floating parameters were cast to the default float of the moment
    assert {p.dtype for p in wrapped.parameters()} == {dtype}
    assert sorted(dict(wrapped.named_parameters())) == [
        "0.bias", "0.weight", "2.bias", "2.weight", "4.bias", "4.weight"]
    ours = tpkg.params_from_jax(tree, dtype=dtype)
    theirs = {}
    for i in range(3):
        theirs[f"{2 * i}.weight"] = ours[f"layer_{i}.weight"]
        theirs[f"{2 * i}.bias"] = ours[f"layer_{i}.bias"][:, 0]
    net = tpkg.mlp([2, 7, 6, 1], dtype=dtype)
    x = torch.as_tensor(rng.uniform(0, 1, (2, 11)), dtype=dtype)
    u_mlp, u_wrapped = TrialFunction(net, ours), TrialFunction(wrapped, theirs)
    tol = TOL[dtype]
    assert rel_err(u_wrapped(x), u_mlp(x)) < tol
    engine = tpkg.DerivativeEngine("jet")
    assert rel_err(engine(u_wrapped, x, (1, 1), 2),
                   engine(u_mlp, x, (1, 1), 2)) < 10 * tol
    # it trains through the pipeline
    prob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        wrapped, tpkg.GridTraining(0.25), dtype=dtype, device="cpu", seed=3))
    again = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        wrapped, tpkg.GridTraining(0.25), dtype=dtype, device="cpu", seed=3))
    assert all(torch.equal(prob.init_params[k], again.init_params[k])
               for k in prob.init_params)          # the seed decides the draw
    res = tpkg.solve(prob, tpkg.adam(1e-2), maxiters=20, inner_steps=5)
    assert res.objective < res.history[0]


def test_params_round_trip_with_lists_and_flat_order():
    """`params_from_jax` takes the multilevel FBPINN's list of level
    stacks, `params_to_numpy` gives the list back, and the flat vector is
    `ravel_pytree`'s for DGM's mixed-case keys and for a list of more than
    ten levels."""
    rng = np.random.default_rng(5)
    tnet = tpkg.FBPINN([(0, 1)], levels=list(range(1, 13)), hidden=(3,))
    # the JAX tree of such a net: {"nets": [stack_0, ..., stack_11]}
    tree = {"nets": [
        {f"layer_{i}": {"weight": rng.normal(size=(j, o, n)),
                        "bias": rng.normal(size=(j, o, 1))}
         for i, (n, o) in enumerate([(1, 3), (3, 1)])}
        for j in range(1, 13)]}
    params = tpkg.params_from_jax(tree, dtype=F64)
    assert "nets.10.layer_0.weight" in params
    assert set(params) == set(dict(tnet.named_parameters()))
    for k, p in tnet.named_parameters():
        assert tuple(p.shape) == tuple(params[k].shape), k
    back = tpkg.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    vec, unravel = tpkg.parameters_to_vector(params)
    np.testing.assert_array_equal(
        vec.numpy(), np.asarray(ravel_pytree(jax.tree.map(jnp.asarray,
                                                          tree))[0]))
    again = unravel(vec)
    assert all(torch.equal(again[k], params[k]) for k in params)

    dgm = tree_like(jpkg.DGM(2, 1, 5, 2).init(jax.random.key(0)), rng)
    dgm = {"depvar": dgm, "p": rng.normal(size=(2,))}
    vec, _ = tpkg.parameters_to_vector(tpkg.params_from_jax(dgm, dtype=F64))
    np.testing.assert_array_equal(
        vec.numpy(), np.asarray(ravel_pytree(jax.tree.map(jnp.asarray,
                                                          dgm))[0]))


def test_gauss_newton_residual_vector_on_multilevel_fbpinn():
    """||r(theta)||^2 == loss on a multilevel FBPINN, and r itself against
    the JAX package's vector."""
    def system(pkg):
        x = pkg.symbols("x")
        u = pkg.DepVar("u")
        return pkg.PDESystem(
            [pkg.Eq(pkg.Differential(x)(u(x)), pkg.cos(4 * np.pi * x))],
            [pkg.Eq(u(0.0), 0.0)], [pkg.Domain(x, pkg.Interval(0, 1))],
            ivs=[x], dvs=[u(x)])

    kw = dict(levels=[1, 3], hidden=(6,))
    jnet = jpkg.FBPINN([(0, 1)], **kw)
    tree = tree_like(jnet.init(jax.random.key(0)), np.random.default_rng(6))
    jprob = jpkg.discretize(system(jpkg), jpkg.PhysicsInformedNN(
        jnet, jpkg.GridTraining(0.05), init_params=tree, dtype=jnp.float64))
    want = jpkg.build_residual_vector(jprob.pinnrep)(jprob.init_params)
    tprob = tpkg.discretize(system(tpkg), tpkg.PhysicsInformedNN(
        tpkg.FBPINN([(0, 1)], dtype=F64, **kw), tpkg.GridTraining(0.05),
        init_params=tpkg.params_from_jax(tree), dtype=F64, device="cpu"))
    r = tpkg.build_residual_vector(tprob.pinnrep)(tprob.init_params)
    assert rel_err(r, want) < 1e-10
    ada = tprob.pinnrep.adaloss.init_state(1, 1, F64, "cpu")
    loss, _ = tprob.loss(tprob.init_params, {"generator": None,
                                             "adaptive": ada})
    assert rel_err((r * r).sum(), loss) < 1e-12


def test_deep_galerkin_is_a_discretizer_with_a_dgm():
    disc = tpkg.DeepGalerkin(2, 1, 6, 2, tpkg.nn.tanh, tpkg.nn.tanh,
                             tpkg.nn.identity, tpkg.GridTraining(0.25),
                             device="cpu", derivative="jet")
    assert isinstance(disc, tpkg.PhysicsInformedNN)
    assert isinstance(disc.chain, tpkg.DGM) and disc.chain.has_taylor_rule
    names = dict(disc.chain.named_parameters())
    assert {"input.weight", "lstm_0.Uz", "lstm_1.bh", "output.bias"} <= set(names)
    assert tuple(names["lstm_0.bz"].shape) == (6, 1)
    # an activation without a rule leaves the engine on nested jvp
    assert not tpkg.DGM(2, 1, 4, 1, tpkg.nn.tanh, tpkg.nn.tanh,
                        lambda z: z).has_taylor_rule
    prob = tpkg.discretize(poisson_2d(tpkg), disc)
    res = tpkg.solve(prob, tpkg.adam(1e-2), maxiters=30, inner_steps=10)
    assert np.isfinite(res.objective) and res.objective < res.history[0]


@pytest.mark.parametrize("strategy", ["default", "override"])
def test_get_loss_function(strategy):
    """The per-strategy loss of one residual is the pipeline's own PDE
    loss, and equals the JAX package's on the same parameters."""
    tree = mlp_params(np.random.default_rng(8), [1, 6, 1])
    jrep = jpkg.symbolic_discretize(poisson_1d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp([1, 6, 1]), jpkg.GridTraining(0.1), init_params=tree,
        dtype=jnp.float64))
    trep = tpkg.symbolic_discretize(poisson_1d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 6, 1]), tpkg.GridTraining(0.1),
        init_params=tpkg.params_from_jax(tree), dtype=F64, device="cpu"))
    jres = jrep.loss_functions.datafree_pde_loss_functions[0]
    tres = trep.loss_functions.datafree_pde_loss_functions[0]
    if strategy == "default":
        jf = jpkg.get_loss_function(jrep, jres)
        tf = tpkg.get_loss_function(trep, tres)
        own = trep.loss_functions.pde_loss_functions[0]
        assert rel_err(tf(trep.flat_init_params, None),
                       own(trep.flat_init_params, None)) < 1e-14
    else:
        jf = jpkg.get_loss_function(jrep, jres, strategy=jpkg.GridTraining(
            0.05))
        tf = tpkg.get_loss_function(trep, tres, strategy=tpkg.GridTraining(
            0.05))
    got = tf(trep.flat_init_params, None)
    assert got.device.type == "cpu" and got.dtype == F64
    assert rel_err(got, jf(jrep.flat_init_params, jax.random.key(0))) < 1e-10
