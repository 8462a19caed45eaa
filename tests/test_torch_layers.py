"""The port's wrapper and embedding layers against the JAX package:
`Transformed`, `SkipConnection`, `FourierFeatures`, `PeriodicEmbedding`,
`mlp(fourier_features=)`, and `SeparableNet` trees of them.

Forward values and Taylor series (orders 1 to 4, random input series) are
compared with `jax.experimental.jet` on the same parameters and inputs.
Tolerances: float64 1e-10 relative (only summation order differs), float32
1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import jet
from torch.func import functional_call

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import rel_err, tree_like
from neuralpde_tpu_torch.utils.convert import params_from_jax, params_to_numpy

RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _hard(c, o):
    return c[0:1] * (1 - c[0:1]) * c[1:2] * o + c[1:2] ** 2


def _merge(o, x):
    return o * x[0:1] + o


def _periodic_chain(pkg, dtype):
    kw = {} if pkg is jpkg else {"dtype": dtype}
    return pkg.Chain(pkg.PeriodicEmbedding(2, axis=0, period=2.0, n_modes=3),
                     *pkg.mlp([7, 8, 8, 2], **kw).layers)


NETS = {
    "transformed": lambda pkg, kw: pkg.Transformed(
        pkg.mlp([2, 8, 8, 3], **kw), _hard),
    "skip": lambda pkg, kw: pkg.SkipConnection(
        pkg.mlp([2, 8, 2], **kw), _merge),
    "fourier": lambda pkg, kw: pkg.mlp([2, 8, 8, 1], fourier_features=5,
                                       fourier_sigma=1.5, **kw),
    "fourier_layer": lambda pkg, kw: pkg.FourierFeatures(2, 4, 0.7, **kw),
    "periodic": None,
    "transformed_of_dense": lambda pkg, kw: pkg.Transformed(
        pkg.Dense(2, 3, pkg.nn.core.tanh, **kw), _hard),
    # a torch function inside the transform (lifted by nested jvp) and a
    # division by a series
    "transformed_function": lambda pkg, kw: pkg.Transformed(
        pkg.mlp([2, 8, 2], **kw),
        lambda c, o: pkg.nn.core.sin(c[0:1]) * o / (2 + c[1:2] ** 2)),
}


def _pair(name, dtype, seed=0):
    """The same layer in both packages, with numpy-drawn parameters."""
    tkw = {"dtype": dtype}
    if name == "periodic":
        jnet, tnet = _periodic_chain(jpkg, dtype), _periodic_chain(tpkg, dtype)
    else:
        jnet, tnet = NETS[name](jpkg, {}), NETS[name](tpkg, tkw)
    rng = np.random.default_rng(seed)
    tree = tree_like(jnet.init(jax.random.key(0)), rng, scale=0.7)
    return jnet, tnet, tree, rng


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_matches_jax(name, dtype):
    jnet, tnet, tree, rng = _pair(name, dtype)
    x = rng.uniform(-1, 1, (2, 13))
    want = jnet.apply(jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), tree),
                      jnp.asarray(x, JDT[dtype]))
    got = functional_call(tnet, params_from_jax(tree, dtype=dtype),
                          (torch.tensor(x, dtype=dtype),))
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    assert rel_err(got.detach().numpy(), np.asarray(want)) < RTOL[dtype]


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(NETS))
def test_taylor_series_match_jax_jet(name, order):
    jnet, tnet, tree, rng = _pair(name, torch.float64, seed=order)
    assert tnet.has_taylor_rule
    x = rng.uniform(-1, 1, (2, 11))
    series = [rng.normal(size=(2, 11)) for _ in range(order)]
    jparams = jax.tree.map(jnp.asarray, tree)
    want0, want = jet.jet(lambda c: jnet.apply(jparams, c), (jnp.asarray(x),),
                          ([jnp.asarray(s) for s in series],))
    got0, got = tpkg.nn.TrialFunction(tnet, params_from_jax(tree)).taylor(
        torch.tensor(x), [torch.tensor(s) for s in series])
    assert rel_err(got0.detach().numpy(), np.asarray(want0)) < 1e-10
    assert len(got) == order
    for k in range(order):
        assert rel_err(got[k].detach().numpy(), np.asarray(want[k])) < 1e-10, k


def _separable_pair():
    hard = lambda c, o: c * (1 - c) * o          # noqa: E731

    def build(pkg, kw):
        return pkg.SeparableNet([
            pkg.Transformed(pkg.mlp([1, 6, 4], **kw), hard),
            pkg.Chain(pkg.PeriodicEmbedding(1, axis=0, period=2.0, n_modes=2),
                      *pkg.mlp([4, 6, 4], **kw).layers),
            pkg.mlp([1, 6, 4], fourier_features=3, **kw)])

    return build(jpkg, {}), build(tpkg, {"dtype": torch.float64})


def test_parameter_names_and_round_trip_of_nested_trees():
    """A SeparableNet of Transformed / PeriodicEmbedding / Fourier chains:
    the port's parameter names are the JAX tree's paths (no extra level for
    a wrapper), and the tree survives params_from_jax -> params_to_numpy."""
    jnet, tnet = _separable_pair()
    tree = tree_like(jnet.init(jax.random.key(1)), np.random.default_rng(5))
    paths = {".".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
    names = dict(tnet.named_parameters())
    assert set(names) == paths
    assert "axis_0.layer_0.weight" in names and "axis_2.layer_0.B" in names
    params = params_from_jax({"depvar": tree}, dtype=torch.float64)
    back = params_to_numpy(params)
    flat_in = jax.tree_util.tree_flatten_with_path({"depvar": tree})[0]
    flat_out = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_in] == [p for p, _ in flat_out]
    for (_, a), (_, b) in zip(flat_in, flat_out):
        np.testing.assert_array_equal(a, b)
    for k, v in names.items():
        assert tuple(v.shape) == params["depvar." + k].shape


def test_wrappers_share_the_wrapped_parameters():
    base = tpkg.mlp([1, 4, 2])
    net = tpkg.Transformed(base, lambda c, o: c * o)
    assert net.base is base and net.in_dim == 1 and net.out_dim == 2
    assert dict(net.named_parameters()) == dict(base.named_parameters())
    net.reset_parameters(torch.Generator().manual_seed(3))
    assert float(base.layer_0.weight.detach().abs().sum()) > 0
    x = torch.linspace(0, 1, 5)[None, :]
    zeros = {k: torch.zeros_like(v) for k, v in net.named_parameters()}
    torch.testing.assert_close(functional_call(net, zeros, (x,)),
                               torch.zeros(2, 5))


def test_fourier_embedding_is_fixed():
    net = tpkg.mlp([2, 8, 1], fourier_features=3)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in net.named_parameters()}
    out = functional_call(net, params, (torch.rand(2, 7),))
    out.sum().backward()
    assert params["layer_0.B"].grad is None
    assert params["layer_1.weight"].grad is not None
    assert [type(l).__name__ for l in net.layers] == ["FourierFeatures",
                                                      "Dense", "Dense"]
