"""Parity of the port's quadrature rules with `neuralpde_tpu.ops.quadrature`.

The static rules are numpy on both sides and must agree to 1e-12 (they are
the same arithmetic); the three tensor functions (`integrate_box`,
`integrate_parametric_1d`, `rule_tensors`) and the two host-side h-adaptive
routines are held to the JAX package's values in float64 to 1e-12, on
integrands made from `numpy.random.default_rng(seed)`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralpde_tpu.ops import quadrature as jq
from neuralpde_tpu_torch.ops import quadrature as tq

TOL = 1e-12


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("order", [1, 2, 7, 20])
def test_gauss_legendre_matches_jax(order):
    for got, want in zip(tq.gauss_legendre(order), jq.gauss_legendre(order)):
        _close(got, want)


@pytest.mark.parametrize("order,panels", [(3, 1), (8, 4), (20, 2)])
def test_composite_rule_matches_jax(order, panels):
    for got, want in zip(tq.composite_gl_unit(order, panels),
                         jq.composite_gl_unit(order, panels)):
        _close(got, want)
    assert abs(tq.composite_gl_unit(order, panels)[1].sum() - 1.0) < TOL


@pytest.mark.parametrize("dim,order,panels", [(1, 5, 2), (2, 4, 3), (3, 3, 1)])
def test_tensor_rules_match_jax(dim, order, panels):
    for got, want in zip(tq.tensor_rule_unit(dim, order, panels),
                         jq.tensor_rule_unit(dim, order, panels)):
        _close(got, want)
    rng = np.random.default_rng(dim)
    lb = rng.uniform(-1, 0, dim)
    ub = lb + rng.uniform(0.5, 2, dim)
    for got, want in zip(tq.tensor_rule_box(lb, ub, order, panels),
                         jq.tensor_rule_box(lb, ub, order, panels)):
        _close(got, want)


def test_rule_tensors_are_cached_per_dtype_and_hold_the_rule():
    a = tq.rule_tensors(2, 4, 2, torch.float64, "cpu")
    assert tq.rule_tensors(2, 4, 2, torch.float64, torch.device("cpu"))[0] is a[0]
    b = tq.rule_tensors(2, 4, 2, torch.float32, "cpu")
    assert b[0].dtype == torch.float32 and a[0].dtype == torch.float64
    nodes, weights = tq.tensor_rule_unit(2, 4, 2)
    _close(a[0].numpy(), nodes)
    _close(a[1].numpy(), weights)


def _poly(rng, dim, out):
    """A smooth vector integrand of (dim, Q) points from random
    coefficients, in numpy, jax and torch."""
    c = rng.normal(size=(out, dim))
    k = rng.uniform(0.5, 3.0, size=(out, dim))

    def make(xp, sin, stack, total):
        def f(x):
            return stack([total(stack([c[o, d] * sin(k[o, d] * x[d])
                                       for d in range(dim)]))
                          for o in range(out)])
        return f

    return (make(jnp, jnp.sin, jnp.stack, lambda a: jnp.sum(a, axis=0)),
            make(torch, torch.sin, torch.stack, lambda a: torch.sum(a, dim=0)),
            make(np, np.sin, np.stack, lambda a: np.sum(a, axis=0)))


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_integrate_box_matches_jax(dim):
    rng = np.random.default_rng(10 + dim)
    fj, ft, _ = _poly(rng, dim, 2)
    lb, ub = rng.uniform(-1, 0, dim), rng.uniform(0.5, 2, dim)
    want = jq.integrate_box(fj, lb, ub, order=6, panels=2, dtype=jnp.float64)
    got = tq.integrate_box(ft, lb, ub, order=6, panels=2, dtype=torch.float64,
                           device="cpu")
    assert got.shape == (2,) and got.dtype == torch.float64
    _close(got.numpy(), want)


def test_integrate_parametric_1d_matches_jax():
    rng = np.random.default_rng(20)
    lb, ub = rng.uniform(-1, 0, 9), rng.uniform(0.2, 2, 9)
    c = rng.normal(size=3)

    def f(xp):
        return lambda n: xp.stack([ci * xp.cos((i + 1) * n)
                                   for i, ci in enumerate(c)])

    want = jq.integrate_parametric_1d(f(jnp), jnp.asarray(lb), jnp.asarray(ub),
                                      order=7, panels=3)
    got = tq.integrate_parametric_1d(f(torch), torch.tensor(lb),
                                     torch.tensor(ub), order=7, panels=3)
    assert got.shape == (3, 9)
    _close(got.numpy(), want)
    exact = np.stack([ci / (i + 1) * (np.sin((i + 1) * ub) - np.sin((i + 1) * lb))
                      for i, ci in enumerate(c)])
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-10)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "vector"])
def test_adaptive_quad_1d_matches_jax(vector):
    """The same bisections, so the same value and error estimate; the port
    also takes an integrand that returns tensors."""
    def f(x):
        return np.stack([np.sin(40 * x), np.cos(7 * x)]) if vector \
            else np.sin(40.0 * x)

    kw = dict(reltol=1e-10, abstol=1e-10, maxiters=1000)
    want, want_err = jq.adaptive_quad_1d(f, 0.0, 1.0, **kw)
    got, got_err = tq.adaptive_quad_1d(f, 0.0, 1.0, **kw)
    _close(got, want)
    assert got_err == want_err
    from_tensor, _ = tq.adaptive_quad_1d(
        lambda x: torch.as_tensor(f(x)), 0.0, 1.0, **kw)
    _close(from_tensor, want)
    assert abs(np.ravel(got)[0] - (1 - np.cos(40.0)) / 40.0) < 1e-8


def test_adaptive_quad_1d_honours_its_budget():
    evals = []

    def f(x):
        evals.append(len(x))
        return np.sin(400.0 * x)

    tq.adaptive_quad_1d(f, 0.0, 1.0, reltol=1e-14, abstol=1e-14, maxiters=9)
    assert len(evals) <= 2 * 9 + 2


def test_adaptive_quad_nd_matches_jax():
    def f(n):
        return np.exp(-50.0 * ((n[0] - 0.5) ** 2 + (n[1] - 0.5) ** 2))

    kw = dict(reltol=1e-9, abstol=1e-12, maxiters=600)
    want, want_err = jq.adaptive_quad_nd(f, [0.0, 0.0], [1.0, 1.0], **kw)
    got, got_err = tq.adaptive_quad_nd(f, [0.0, 0.0], [1.0, 1.0], **kw)
    _close(got, want)
    assert got_err == want_err
