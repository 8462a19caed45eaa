"""Parity of the port's nn layers and parameter exchange with the JAX package.

Tolerances: float64 forward passes agree to 1e-10 relative (the only
difference is the matmul's summation order); float32 to 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from _torch_parity import mlp_params, rel_err
from neuralpde_tpu.nn import core as jcore
from neuralpde_tpu_torch.nn import core as tcore
from neuralpde_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from neuralpde_tpu_torch.utils.pytree import (
    parameters_to_vector, vector_to_parameters,
)

RTOL = {torch.float64: 1e-10, torch.float32: 1e-5}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}

ACTIVATIONS = ["tanh", "sigmoid", "relu", "gelu", "swish", "softplus", "sin"]


def _forward_pair(sizes, dtype, activation="tanh", seed=0, n=33):
    rng = np.random.default_rng(seed)
    tree = mlp_params(rng, sizes)
    x = rng.uniform(-3, 3, (sizes[0], n))
    jnet = jcore.mlp(sizes, getattr(jcore, activation))
    want = jnet.apply(jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), tree),
                      jnp.asarray(x, JDT[dtype]))
    tnet = tcore.mlp(sizes, getattr(tcore, activation), dtype=dtype)
    params = params_from_jax(tree, dtype=dtype)
    got = torch.func.functional_call(tnet, params, (torch.tensor(x, dtype=dtype),))
    return got, np.asarray(want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mlp_forward_matches_jax(dtype):
    got, want = _forward_pair([2, 16, 16, 1], dtype)
    assert got.dtype == dtype and got.shape == (1, 33)
    assert rel_err(got.detach().numpy(), want) < RTOL[dtype]


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_activation_matches_jax(activation):
    got, want = _forward_pair([2, 8, 1], torch.float64, activation, seed=3)
    assert rel_err(got.detach().numpy(), want) < RTOL[torch.float64]


def test_parameter_names_match_jax_paths():
    tnet = tcore.mlp([2, 16, 16, 1])
    jparams = jcore.mlp([2, 16, 16, 1]).init(jax.random.key(0))
    paths = {".".join(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert {n for n, _ in tnet.named_parameters()} == paths
    for name, p in tnet.named_parameters():
        leaf = jparams
        for part in name.split("."):
            leaf = leaf[part]
        assert tuple(p.shape) == leaf.shape


def test_params_round_trip():
    rng = np.random.default_rng(1)
    tree = {"depvar": mlp_params(rng, [2, 16, 16, 1]), "p": rng.normal(size=3)}
    params = params_from_jax(tree, dtype=torch.float64)
    assert "depvar.layer_1.weight" in params and "p" in params
    back = params_to_numpy(params)
    flat_in = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_out = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_in] == [p for p, _ in flat_out]
    for (_, a), (_, b) in zip(flat_in, flat_out):
        np.testing.assert_array_equal(a, b)


def test_parameters_to_vector_matches_ravel_pytree():
    rng = np.random.default_rng(2)
    tree = {"depvar": mlp_params(rng, [2, 8, 8, 1]), "p": rng.normal(size=2)}
    params = params_from_jax(tree, dtype=torch.float64)
    vec, unravel = parameters_to_vector(params)
    want, _ = ravel_pytree(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_array_equal(vec.numpy(), np.asarray(want))
    again = vector_to_parameters(vec * 2, params)
    for k in params:
        torch.testing.assert_close(again[k], params[k] * 2, rtol=0, atol=0)
    assert unravel(vec).keys() == params.keys()


def test_reset_parameters_is_seeded():
    net_a, net_b = tcore.mlp([2, 16, 1]), tcore.mlp([2, 16, 1])
    net_a.reset_parameters(torch.Generator().manual_seed(7))
    net_b.reset_parameters(torch.Generator().manual_seed(7))
    for (_, a), (_, b) in zip(net_a.named_parameters(), net_b.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    w = net_a.layer_0.weight.detach()
    assert float(w.abs().max()) <= np.sqrt(6.0 / 18)
    assert float(net_a.layer_0.bias.detach().abs().max()) == 0.0


def test_eltype_adaptor_and_tree_helpers_match_jax():
    """`EltypeAdaptor` leaf by leaf on nested dicts and lists (float32,
    float64, complex and integer leaves), `recursive_eltype` (the widest
    inexact dtype), `tree_size` and `finfo_eps`, against the JAX package."""
    import neuralpde_tpu as jpkg
    import neuralpde_tpu_torch as tpkg

    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 3)), rng.normal(size=4)
    c, i = rng.normal(size=2) + 1j * rng.normal(size=2), np.arange(3)
    jtree = {"a": jnp.asarray(a, jnp.float32),
             "b": [jnp.asarray(b, jnp.float64), {"i": jnp.asarray(i, jnp.int32)}]}
    ttree = {"a": torch.tensor(a, dtype=torch.float32),
             "b": [torch.tensor(b, dtype=torch.float64),
                   {"i": torch.tensor(i, dtype=torch.int32)}]}
    assert tpkg.recursive_eltype(ttree) == torch.float64
    assert jpkg.recursive_eltype(jtree) == jnp.float64
    jc = {**jtree, "c": jnp.asarray(c, jnp.complex64)}
    tc = {**ttree, "c": torch.tensor(c, dtype=torch.complex64)}
    assert str(jpkg.recursive_eltype(jc)) == "complex128"
    assert tpkg.recursive_eltype(tc) == torch.complex128
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        jout, tout = jpkg.EltypeAdaptor(jd)(jtree), tpkg.EltypeAdaptor(td)(ttree)
        assert tout["a"].dtype == tout["b"][0].dtype == td
        assert tout["b"][1]["i"].dtype == torch.int32     # ints untouched
        np.testing.assert_array_equal(tout["a"].numpy(), np.asarray(jout["a"]))
        np.testing.assert_array_equal(tout["b"][0].numpy(),
                                      np.asarray(jout["b"][0]))
    assert tpkg.tree_size(ttree) == jpkg.utils.pytree.tree_size(jtree) == 13
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        assert tpkg.finfo_eps(td) == jpkg.config.finfo_eps(jd)
