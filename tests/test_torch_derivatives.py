"""Parity of the port's derivative engines and Taylor rules with the JAX
package, and the tanh_jet2 kernel's plain version and backward.

Tolerances:
* jvp and jet in float64: 1e-10 relative to the largest |value|; the two
  frameworks differ only in summation order.
* jvp and jet in float32: 1e-4 relative (second derivatives).
* fd in float64: each stencil divides differences of network values by
  step^order, so a value that differs by a few ulp between the frameworks
  moves the result by up to ``64 eps max|u| / step^order`` (step from
  `fd_step`); that is the bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import jet

from _torch_parity import mlp_params, rel_err
from neuralpde_tpu.nn import core as jcore
from neuralpde_tpu.ops.derivatives import DerivativeEngine as JaxEngine
from neuralpde_tpu_torch.kernels import tanh_jet as tj
from neuralpde_tpu_torch.nn import core as tcore
from neuralpde_tpu_torch.ops.derivatives import DerivativeEngine, fd_step
from neuralpde_tpu_torch.utils.convert import params_from_jax

PARTIALS = [(0,), (1,), (0, 0), (1, 1), (0, 1), (1, 1, 1), (0, 0, 1),
            (0, 0, 0, 0), (0, 1, 0, 1)]
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _pair(dtype, sizes=(2, 16, 16, 1), activation="tanh", seed=0, n=17):
    rng = np.random.default_rng(seed)
    tree = mlp_params(rng, list(sizes))
    x = rng.uniform(0, 1, (sizes[0], n))
    jp = jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]), tree)
    jnet = jcore.mlp(list(sizes), getattr(jcore, activation))
    tnet = tcore.mlp(list(sizes), getattr(tcore, activation), dtype=dtype)
    u_jax = lambda c: jnet.apply(jp, c)
    u_torch = tcore.TrialFunction(tnet, params_from_jax(tree, dtype=dtype))
    return (u_jax, jnp.asarray(x, JDT[dtype])), (u_torch,
                                                  torch.tensor(x, dtype=dtype))


@pytest.mark.parametrize("partial", PARTIALS, ids=str)
@pytest.mark.parametrize("mode", ["jvp", "jet", "fd"])
def test_engine_matches_jax_f64(mode, partial):
    (uj, xj), (ut, xt) = _pair(torch.float64)
    want = np.asarray(JaxEngine(mode)(uj, xj, list(partial), 2))
    got = DerivativeEngine(mode)(ut, xt, list(partial), 2).detach().numpy()
    assert got.shape == want.shape == (1, 17)
    if mode == "fd":
        u_max = float(np.max(np.abs(np.asarray(uj(xj)))))
        step = fd_step(torch.float64, len(partial))
        atol = 64 * np.finfo(np.float64).eps * u_max / step ** len(partial)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        assert rel_err(got, want) < 1e-10


@pytest.mark.parametrize("mode", ["jvp", "jet"])
@pytest.mark.parametrize("partial", [(0, 0), (1, 1), (0, 1)], ids=str)
def test_engine_matches_jax_f32(mode, partial):
    (uj, xj), (ut, xt) = _pair(torch.float32)
    want = np.asarray(JaxEngine(mode)(uj, xj, list(partial), 2))
    got = DerivativeEngine(mode)(ut, xt, list(partial), 2)
    assert got.dtype == torch.float32
    assert rel_err(got.detach().numpy(), want) < 1e-4


@pytest.mark.parametrize("order", [1, 2, 3, 4])
@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "sin", "gelu",
                                        "swish"])
def test_taylor_rules_match_jax_jet(activation, order):
    """A whole Chain's Taylor pass against jax.experimental.jet, every output
    coefficient, including the plain recurrences (orders other than 2)."""
    (uj, xj), (ut, xt) = _pair(torch.float64, activation=activation, seed=5)
    rng = np.random.default_rng(order)
    series = [rng.normal(size=xt.shape) for _ in range(order)]
    want_primal, want = jet.jet(uj, (xj,), ([jnp.asarray(s) for s in series],))
    got_primal, got = ut.taylor(xt, [torch.tensor(s) for s in series])
    assert rel_err(got_primal.detach().numpy(), want_primal) < 1e-10
    for k in range(order):
        assert rel_err(got[k].detach().numpy(), want[k]) < 1e-10


@pytest.mark.parametrize("partial", [(0,), (0, 0), (0, 1), (1, 1, 1),
                                     (0, 0, 1, 1)], ids=str)
@pytest.mark.parametrize("activation", ["relu", "softplus"])
def test_taylor_rules_of_relu_and_softplus_match_jax_jvp(activation, partial):
    """relu and softplus have Taylor rules in the port; the JAX package's
    jet raises on them, so its nested jvp is the reference."""
    (uj, xj), (ut, xt) = _pair(torch.float64, activation=activation, seed=3)
    assert ut.has_taylor_rule
    want = np.asarray(JaxEngine("jvp")(uj, xj, list(partial), 2))
    got = DerivativeEngine("jet")(ut, xt, list(partial), 2).detach().numpy()
    assert rel_err(got, want) < 1e-10


def test_module_without_taylor_rule_takes_nested_jvp():
    """An activation with no Taylor rule (here a lambda around softplus):
    jet mode differentiates the net by nested jvp, a static choice, and
    gives the JAX package's exact value."""
    rng = np.random.default_rng(2)
    tree = mlp_params(rng, [2, 16, 16, 1])
    x = rng.uniform(0, 1, (2, 17))
    jnet = jcore.mlp([2, 16, 16, 1], lambda z: jcore.softplus(z))
    tnet = tcore.mlp([2, 16, 16, 1], lambda z: tcore.softplus(z),
                     dtype=torch.float64)
    ut = tcore.TrialFunction(tnet, params_from_jax(tree, dtype=torch.float64))
    assert not ut.has_taylor_rule
    want = np.asarray(JaxEngine("jvp")(
        lambda c: jnet.apply(jax.tree.map(jnp.asarray, tree), c),
        jnp.asarray(x), [0, 0], 2))
    got = DerivativeEngine("jet")(ut, torch.tensor(x), [0, 0], 2)
    assert rel_err(got.detach().numpy(), want) < 1e-10


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown derivative mode"):
        DerivativeEngine("spectral")


def _jet_inputs(shape=(5, 7), seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    z, z1, z2 = (rng.normal(scale=2.0, size=shape) for _ in range(3))
    return [torch.tensor(a, dtype=dtype) for a in (z, z1, z2)], (z, z1, z2)


def test_tanh_jet2_reference_matches_jax_jet():
    (z, z1, z2), (nz, nz1, nz2) = _jet_inputs()
    a, (w1, w2) = jet.jet(jnp.tanh, (jnp.asarray(nz),),
                          ((jnp.asarray(nz1), jnp.asarray(nz2)),))
    got = tj.tanh_jet2_reference(z, z1, z2)
    for g, w in zip(got, (a, w1, w2)):
        assert rel_err(g.numpy(), w) < 1e-12


def test_tanh_jet2_backward_reference_matches_jax_vjp():
    (z, z1, z2), (nz, nz1, nz2) = _jet_inputs(seed=1)
    rng = np.random.default_rng(9)
    cot = [rng.normal(size=nz.shape) for _ in range(3)]

    def f(a, b, c):
        p, (s1, s2) = jet.jet(jnp.tanh, (a,), ((b, c),))
        return p, s1, s2

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (nz, nz1, nz2)))
    want = vjp(tuple(jnp.asarray(c) for c in cot))
    got = tj.tanh_jet2_backward_reference(
        z, z1, z2, *(torch.tensor(c) for c in cot))
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), w) < 1e-12


def test_tanh_jet2_gradcheck_f64():
    (z, z1, z2), _ = _jet_inputs(shape=(3, 4), seed=2)
    inputs = tuple(t.requires_grad_(True) for t in (z, z1, z2))
    assert torch.autograd.gradcheck(tj.tanh_jet2, inputs)


def test_tanh_jet2_cpu_takes_plain_version_without_launching():
    (z, z1, z2), _ = _jet_inputs()
    before = tj.tanh_jet2.launches
    got = tj.tanh_jet2(z, z1, z2)
    for g, w in zip(got, tj.tanh_jet2_reference(z, z1, z2)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert tj.tanh_jet2.launches == before


def test_tanh_jet2_other_device_raises():
    z = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tj.tanh_jet2(z, z, z)


def test_tanh_jet2_kernel_rejects_cpu_operands():
    """The launch wrapper itself never takes the plain path."""
    (z, z1, z2), _ = _jet_inputs()
    with pytest.raises(ValueError, match="not CUDA"):
        tj.tanh_jet2_forward_cuda(z, z1, z2)
