"""The `tanh_jet2` rule under `torch.func` transforms and higher-order
autograd, on the CPU in float64.

The probe residual is ``r(θ) = d²u/dx²`` of ``mlp([2, 8, 8, 1])`` by Taylor
mode (`jet_derivative`, which runs `TanhJet2`); the nested-jvp engine gives
the same function by another route and is the reference.

Tolerances: transforms of r agree to 1e-10 relative, second-order
gradients to 1e-9 (both routes only reorder float64 sums); the rule's
Jacobian-vector product agrees with JAX's `jet` rule to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import jet
from torch.func import jvp, vjp, vmap

from _torch_parity import mlp_params, rel_err
from neuralpde_tpu_torch.kernels import tanh_jet as tj
from neuralpde_tpu_torch.nn.core import TrialFunction, mlp
from neuralpde_tpu_torch.ops.derivatives import jet_derivative, jvp_derivative
from neuralpde_tpu_torch.utils.convert import params_from_jax

F64 = torch.float64


def _probe(seed=0, n=17):
    rng = np.random.default_rng(seed)
    net = mlp([2, 8, 8, 1], dtype=F64)
    theta = params_from_jax(mlp_params(rng, [2, 8, 8, 1]), dtype=F64)
    x = torch.tensor(rng.uniform(-1, 1, (2, n)), dtype=F64)

    def r_jet(th):
        return jet_derivative(TrialFunction(net, th), x, 0, 2)

    def r_jvp(th):
        return jvp_derivative(TrialFunction(net, th), x, [0, 0], 2)

    return rng, theta, r_jet, r_jvp


def _like(rng, theta, batch=()):
    return {k: torch.tensor(rng.normal(size=batch + tuple(v.shape)), dtype=F64)
            for k, v in theta.items()}


def _assert_trees_close(got, want, tol):
    for k in want:
        assert rel_err(got[k].detach().numpy(), want[k].detach().numpy()) < tol, k


@pytest.mark.parametrize("transform", ["jvp", "vjp", "vmap"])
def test_transforms_of_the_jet_residual_match_the_jvp_engine(transform):
    rng, theta, r_jet, r_jvp = _probe()
    if transform == "jvp":
        v = _like(rng, theta)
        got = jvp(r_jet, (theta,), (v,))[1]
        want = jvp(r_jvp, (theta,), (v,))[1]
        assert rel_err(got.numpy(), want.numpy()) < 1e-10
        return
    if transform == "vjp":
        u = torch.tensor(rng.normal(size=(1, 17)), dtype=F64)
        _assert_trees_close(vjp(r_jet, theta)[1](u)[0],
                            vjp(r_jvp, theta)[1](u)[0], 1e-10)
        return
    # a batch of 4 Jacobian-vector products and of 3 vector-Jacobian
    # products, as Gauss-Newton's preconditioner vmaps its probes
    vs = _like(rng, theta, (4,))
    got = vmap(lambda v: jvp(r_jet, (theta,), (v,))[1])(vs)
    want = vmap(lambda v: jvp(r_jvp, (theta,), (v,))[1])(vs)
    assert got.shape == (4, 1, 17)
    assert rel_err(got.numpy(), want.numpy()) < 1e-10
    us = torch.tensor(rng.normal(size=(3, 1, 17)), dtype=F64)
    _assert_trees_close(vmap(vjp(r_jet, theta)[1])(us)[0],
                        vmap(vjp(r_jvp, theta)[1])(us)[0], 1e-10)


def test_second_order_gradient_matches_the_jvp_engine():
    """∇_θ Σ(∂r/∂θ)² with create_graph: the jet route differentiates the
    rule's backward, the jvp route plain ops."""
    _, theta, r_jet, r_jvp = _probe(seed=1)

    def second(r_fn):
        th = {k: v.clone().requires_grad_(True) for k, v in theta.items()}
        params = list(th.values())
        grads = torch.autograd.grad(r_fn(th).sum(), params, create_graph=True,
                                    allow_unused=True, materialize_grads=True)
        total = sum((g ** 2).sum() for g in grads)
        return dict(zip(th, torch.autograd.grad(
            total, params, allow_unused=True, materialize_grads=True)))

    got, want = second(r_jet), second(r_jvp)
    for k in theta:
        w = want[k].numpy()
        assert np.max(np.abs(got[k].numpy() - w)) <= 1e-9 * max(
            np.max(np.abs(w)), 1.0), k
    assert np.max(np.abs(want["layer_2.weight"].numpy())) > 1.0


def _rule_inputs(n_in, seed=2, shape=(3, 5)):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(scale=1.5, size=shape), dtype=F64,
                         requires_grad=True) for _ in range(n_in)]


@pytest.mark.parametrize("fn, n_in", [(tj.tanh_jet2, 3),
                                      (tj.TanhJet2Backward.apply, 6),
                                      (tj.TanhJet2Jvp.apply, 6)],
                         ids=["tanh_jet2", "backward", "jvp"])
def test_gradcheck_forward_ad_and_batched(fn, n_in):
    inputs = _rule_inputs(n_in)
    assert torch.autograd.gradcheck(fn, inputs, check_forward_ad=True,
                                    check_batched_grad=True,
                                    check_batched_forward_grad=True)
    assert torch.autograd.gradgradcheck(fn, inputs, check_fwd_over_rev=True,
                                        check_rev_over_rev=True)


def test_jvp_reference_matches_jax_jet_rule():
    rng = np.random.default_rng(3)
    z, z1, z2, tz, tz1, tz2 = (rng.normal(scale=1.5, size=(4, 9))
                               for _ in range(6))

    def rule(z, z1, z2):
        a, (a1, a2) = jet.jet(jnp.tanh, (z,), ((z1, z2),))
        return a, a1, a2

    _, want = jax.jvp(rule, (z, z1, z2), (tz, tz1, tz2))
    got = tj.tanh_jet2_jvp_reference(
        *(torch.tensor(a, dtype=F64) for a in (z, z1, z2, tz, tz1, tz2)))
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), np.asarray(w)) < 1e-12


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    tj.reset_launch_counts()
    z = _rule_inputs(3, seed=4)
    out = tj.tanh_jet2(*z)
    torch.autograd.grad(sum(o.sum() for o in out), z)
    jvp(lambda a: tj.tanh_jet2(a, z[1].detach(), z[2].detach())[2],
        (z[0].detach(),), (torch.ones_like(z[0]),))
    assert tj.launch_counts() == {"tanh_jet2_forward": 0,
                                  "tanh_jet2_backward": 0,
                                  "tanh_jet2_jvp": 0}
    assert tj.tanh_jet2.launches == 0
