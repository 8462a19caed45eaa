"""Parity of the port's operator building blocks with the JAX package:
`nn/fno.py` (`SpectralConv1D/2D/3D` at sizes where the mode clipping
bites, odd and even grids, on random weights, so the mixed spectra are not
Hermitian; `FNO1D/2D/3D` with parameter columns and function-valued
inputs), `nn/deeponet.py`, `compile/fieldgrid.py` (`grid_diff`,
`grid_diff_spectral`, `build_field_residual` on the JAX tests' cases), the
`GaussianRandomField` on the JAX package's white noise, and the held-out
Navier-Stokes initial conditions the port keeps as a file.

Parameters are normal draws from `numpy.random.default_rng(seed)` in the
JAX package's tree layout and cross through `params_from_jax`; the spectral
weights are the two real leaves ``w_re``/``w_im`` a block on both sides.

Tolerances (float64): forward 1e-10 and parameter gradients 1e-9 relative
to the largest entry; finite and spectral differences 1e-12; the GRF from
the same white noise 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import rel_err, tree_like
from neuralpde_tpu.compile import fieldgrid as jfg
from neuralpde_tpu.symbolic import expr as JE
from neuralpde_tpu_torch.compile import fieldgrid as tfg
from neuralpde_tpu_torch.symbolic import expr as TE

F64 = torch.float64
PI = float(np.pi)


def _params(jmodule, seed):
    """Normal draws (std 0.3) in ``jmodule``'s tree layout, as numpy."""
    template = jax.eval_shape(jmodule.init, jax.random.key(0))
    return tree_like(template, np.random.default_rng(seed), scale=0.3)


def _jax_value_and_grad(jmodule, tree, x, cot):
    """One compiled program: the output and the gradient of <output, cot>."""
    def both(p):
        y, pullback = jax.vjp(lambda q: jmodule.apply(q, x), p)
        return y, pullback(cot)[0]

    y, g = jax.jit(both)(jax.tree.map(jnp.asarray, tree))
    return np.asarray(y), tpkg.params_from_jax(jax.tree.map(np.asarray, g),
                                               dtype=F64)


def _check(jmodule, tmodule, tree, jx, tx, seed=1):
    """Forward 1e-10 and every parameter gradient 1e-9 against JAX, each
    relative to its largest entry (the gradients: to the largest entry of
    any, since a weight block the input's spectrum misses has a gradient of
    rounding noise in both packages)."""
    params = {k: v.requires_grad_(True)
              for k, v in tpkg.params_from_jax(tree, dtype=F64).items()}
    y = functional_call(tmodule, params, (tx,), strict=True)
    cot = np.random.default_rng(seed).normal(size=tuple(y.shape))
    want, jgrad = _jax_value_and_grad(jmodule, tree, jx, jnp.asarray(cot))
    assert y.shape == want.shape
    assert rel_err(y.detach(), want) < 1e-10
    grads = torch.autograd.grad((y * torch.as_tensor(cot)).sum(),
                                list(params.values()))
    assert sorted(params) == sorted(jgrad)
    scale = max(float(v.abs().max()) for v in jgrad.values())
    for k, g in zip(params, grads):
        assert float((g - jgrad[k]).abs().max()) < 1e-9 * scale, k


def _field(rng, shape):
    x = rng.normal(size=shape)
    return jnp.asarray(x), torch.as_tensor(x)


# ------------------------------------------------------- spectral layers

@pytest.mark.parametrize("shape,modes", [((3, 16, 7), 64), ((2, 9, 3), 3)],
                         ids=["even-clipped", "odd"])
def test_spectral_conv1d_matches_jax(shape, modes):
    jm = jpkg.SpectralConv1D(shape[0], 4, modes)
    tm = tpkg.SpectralConv1D(shape[0], 4, modes)
    jx, tx = _field(np.random.default_rng(0), shape)
    _check(jm, tm, _params(jm, 1), jx, tx)


@pytest.mark.parametrize("shape,modes", [((3, 12, 10, 2), 64),
                                         ((2, 9, 7, 3), (3, 2))],
                         ids=["even-clipped", "odd"])
def test_spectral_conv2d_matches_jax(shape, modes):
    jm = jpkg.SpectralConv2D(shape[0], 3, modes)
    tm = tpkg.SpectralConv2D(shape[0], 3, modes)
    jx, tx = _field(np.random.default_rng(0), shape)
    _check(jm, tm, _params(jm, 2), jx, tx)


@pytest.mark.parametrize("shape,modes", [((2, 8, 6, 10, 2), 32),
                                         ((1, 7, 9, 5, 2), (2, 3, 2))],
                         ids=["even-clipped", "odd"])
def test_spectral_conv3d_matches_jax(shape, modes):
    jm = jpkg.SpectralConv3D(shape[0], 2, modes)
    tm = tpkg.SpectralConv3D(shape[0], 2, modes)
    jx, tx = _field(np.random.default_rng(0), shape)
    _check(jm, tm, _params(jm, 3), jx, tx)


def test_spectral_weights_are_two_real_leaves_a_block():
    """Adam keeps its moments per real component (optax's rule on the JAX
    package's real leaves), so no parameter is complex."""
    names = dict(tpkg.SpectralConv3D(2, 2, 3).named_parameters())
    assert sorted(names) == sorted(f"w{b}_{c}" for b in range(4)
                                   for c in ("re", "im"))
    net = tpkg.FNO2D(1, width=4, modes=2, depth=1)
    assert not any(p.is_complex() for p in net.parameters())
    jtree = jax.eval_shape(jpkg.FNO2D(1, width=4, modes=2, depth=1).init,
                           jax.random.key(0))
    assert sorted(dict(net.named_parameters())) == sorted(
        tpkg.params_from_jax(jax.tree.map(lambda a: np.zeros(a.shape),
                                          jtree)))


# ----------------------------------------------------------- FNO, DeepONet

def test_fno1d_matches_jax_on_columns_and_fields():
    rng = np.random.default_rng(4)
    jm, tm = jpkg.FNO1D(2, 8, 4, 2), tpkg.FNO1D(2, 8, 4, 2)
    t = np.linspace(0, 1, 17)[None]
    p = rng.normal(size=(2, 5))
    tree = _params(jm, 5)
    _check(jm, tm, tree, (jnp.asarray(p), jnp.asarray(t)),
           (torch.as_tensor(p), torch.as_tensor(t)))
    jm3, tm3 = (jpkg.FNO1D(2, 8, 4, 2, out_channels=3),
                tpkg.FNO1D(2, 8, 4, 2, out_channels=3))
    field = rng.normal(size=(2, 17, 4))
    _check(jm3, tm3, _params(jm3, 6), (jnp.asarray(field), jnp.asarray(t)),
           (torch.as_tensor(field), torch.as_tensor(t)))


def test_fno2d_matches_jax_with_a_function_valued_input():
    rng = np.random.default_rng(7)
    jm = jpkg.FNO2D(2, width=6, modes=(3, 2), depth=2, out_channels=2)
    tm = tpkg.FNO2D(2, width=6, modes=(3, 2), depth=2, out_channels=2)
    gx, gt = np.linspace(0, 1, 9), np.linspace(0, 0.5, 6)
    field = rng.normal(size=(2, 9, 6, 3))
    _check(jm, tm, _params(jm, 8),
           (jnp.asarray(field), (jnp.asarray(gx), jnp.asarray(gt))),
           (torch.as_tensor(field), (torch.as_tensor(gx),
                                     torch.as_tensor(gt))))


def test_fno3d_matches_jax():
    rng = np.random.default_rng(9)
    jm = jpkg.FNO3D(1, width=6, modes=(3, 3, 2), depth=2)
    tm = tpkg.FNO3D(1, width=6, modes=(3, 3, 2), depth=2)
    gs = [np.linspace(0, 1, 8), np.linspace(0, 1, 7), np.linspace(0, 1, 6)]
    p = rng.normal(size=(1, 8, 7, 6, 2))
    _check(jm, tm, _params(jm, 10), (jnp.asarray(p), tuple(map(jnp.asarray,
                                                               gs))),
           (torch.as_tensor(p), tuple(map(torch.as_tensor, gs))))


def test_deeponets_match_jax():
    rng = np.random.default_rng(11)
    t = np.linspace(0, 1, 7)[None]
    p = rng.normal(size=(1, 5))
    jm = jpkg.DeepONet(jpkg.mlp([1, 8, 8]), jpkg.mlp([1, 8, 8]))
    tm = tpkg.DeepONet(tpkg.mlp([1, 8, 8]), tpkg.mlp([1, 8, 8]))
    _check(jm, tm, _params(jm, 12), (jnp.asarray(p), jnp.asarray(t)),
           (torch.as_tensor(p), torch.as_tensor(t)))
    kw = dict(latent=8, branch_sizes=(8,), trunk_sizes=(8,), out_channels=2)
    jm, tm = jpkg.DeepONetPDE(2, 2, **kw), tpkg.DeepONetPDE(2, 2, **kw)
    p2 = rng.normal(size=(2, 4))
    gx, gt = np.linspace(0, 1, 6), np.linspace(0, 1, 5)
    _check(jm, tm, _params(jm, 13),
           (jnp.asarray(p2), (jnp.asarray(gx), jnp.asarray(gt))),
           (torch.as_tensor(p2), (torch.as_tensor(gx), torch.as_tensor(gt))))


def test_deeponet_pde_head_scale_and_layout_errors():
    torch.manual_seed(0)
    net = tpkg.DeepONetPDE(1, 2, latent=400)
    assert abs(float(net.head.std()) - 1 / 20) < 0.01     # 1/sqrt(latent)
    assert float(net.bias.abs().max()) == 0.0
    with pytest.raises(ValueError, match="scalar parameter channel"):
        tpkg.DeepONetPDE(0, 2)
    with pytest.raises(ValueError, match="FNO backbone"):
        net((torch.ones(1, 3, 2), (torch.ones(3), torch.ones(2))))
    with pytest.raises(ValueError, match="in_channels"):
        tpkg.FNO1D(2, 8, 4, 2)((torch.ones(2), torch.ones(1, 5)))
    with pytest.raises(ValueError, match="ndim"):
        tpkg.FNO3D(2, 8, 3, 2)((torch.ones(2), [torch.ones(4)] * 3))


# ------------------------------------------------------- field-grid lowering

@pytest.mark.parametrize("n", [9, 10])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_grid_diff_matches_jax(n, order):
    u = np.random.default_rng(order).normal(size=(4, n, 3))
    want = np.asarray(jfg.grid_diff(jnp.asarray(u), 0.125, 1, order))
    got = tfg.grid_diff(torch.as_tensor(u), 0.125, 1, order)
    assert rel_err(got, want) < 1e-12


@pytest.mark.parametrize("n", [17, 18])
@pytest.mark.parametrize("order", [1, 2])
def test_grid_diff_spectral_matches_jax(n, order):
    u = np.random.default_rng(order).normal(size=(3, n, 2))
    want = np.asarray(jfg.grid_diff_spectral(jnp.asarray(u), 2.0, 1, order))
    got = tfg.grid_diff_spectral(torch.as_tensor(u), 2.0, 1, order)
    assert rel_err(got, want) < 1e-12


def _contexts(spectral=frozenset()):
    grids = [np.linspace(0.0, 1.0, 9), np.linspace(0.0, 2.0, 7)]
    kw = dict(iv_names=["x", "t"], dict_depvar_input={"u": ["x", "t"]},
              eq_params=["nu"], spectral_axes=spectral)
    return (jfg.FieldGridContext(grids=[jnp.asarray(g) for g in grids], **kw),
            tfg.FieldGridContext(grids=[torch.as_tensor(g) for g in grids],
                                 **kw))


def _equations(E):
    """The JAX tests' lowering cases (tests/test_pino_pde.py:67-148, 748),
    written in either package's expression nodes."""
    x, t, z = E.Sym("x"), E.Sym("t"), E.Sym("z")
    nu, u = E.Param("nu"), E.DepVar("u")
    return {
        "interior": E.Eq(E.Deriv(u(x, t), (t,)),
                         nu * E.Deriv(u(x, t), (x, x))),
        "bc-slice": E.Eq(u(E.Num(0.0), t), E.sin(E.Num(PI) * t)),
        "bc-derivative": E.Eq(E.Deriv(u(E.Num(1.0), t), (x,)), E.Num(0.0)),
        "nongrid-derivative": E.Eq(E.Deriv(u(x, t), (z,)), E.Num(0.0)),
        "spectral": E.Eq(E.Deriv(u(x, t), (x, x)) + x * t * u(x, t),
                         E.Num(-(2 * PI) ** 2) * nu * u(x, t)),
    }


@pytest.mark.parametrize("name", list(_equations(JE)))
def test_build_field_residual_matches_jax(name):
    spectral = frozenset({"x"}) if name == "spectral" else frozenset()
    jctx, tctx = _contexts(spectral)
    rng = np.random.default_rng(3)
    field, p = rng.normal(size=(9, 7, 3)), rng.uniform(0.5, 2, (1, 3))
    want = np.asarray(jfg.build_field_residual(_equations(JE)[name], jctx)(
        {"u": jnp.asarray(field)}, jnp.asarray(p)))
    got = tfg.build_field_residual(_equations(TE)[name], tctx)(
        {"u": torch.as_tensor(field)}, torch.as_tensor(p))
    assert tuple(got.shape) == want.shape
    assert float(np.max(np.abs(got.numpy() - want))) <= 1e-12 * max(
        1.0, float(np.max(np.abs(want))))


def test_field_lowering_errors_match_jax():
    _, tctx = _contexts()
    x, t, u = TE.Sym("x"), TE.Sym("t"), TE.DepVar("u")
    zero = {"u": torch.zeros(9, 7, 1)}, torch.zeros(1, 1)
    with pytest.raises(ValueError, match="not a grid node"):
        tfg.build_field_residual(TE.Eq(u(TE.Num(0.31), t), TE.Num(0.0)),
                                 tctx)(*zero)
    with pytest.raises(ValueError, match="canonical"):
        tfg.build_field_residual(TE.Eq(u(t, x), TE.Num(0.0)), tctx)(*zero)
    with pytest.raises(NotImplementedError, match="integral"):
        tfg.build_field_residual(TE.Eq(TE.Integral(x, 0.0, 1.0)(u(x, t)),
                                       TE.Num(0.0)), tctx)(*zero)
    with pytest.raises(ValueError, match="spectral_axes"):
        tfg.FieldGridContext(iv_names=["x"], grids=[torch.ones(3)],
                             dict_depvar_input={"u": ["x"]}, eq_params=[],
                             spectral_axes=frozenset({"zz"}))
    with pytest.raises(ValueError, match="grid nodes"):
        tfg.grid_diff(torch.ones(2, 1), 0.5, 0, 1)


def test_spectral_factors_are_made_when_the_residual_is_built():
    """A step reads the wavenumber factors; it makes none."""
    _, tctx = _contexts(frozenset({"x"}))
    tfg.build_field_residual(_equations(TE)["spectral"], tctx)
    factor = tctx._factors[(0, 2)]
    assert factor.dtype == F64 and not factor.is_complex()
    res = tfg.build_field_residual(_equations(TE)["spectral"], tctx)
    res({"u": torch.zeros(9, 7, 1, dtype=F64)}, torch.ones(1, 1, dtype=F64))
    assert tctx._factors[(0, 2)] is factor and len(tctx._factors) == 1


# -------------------------------------------------------------------- GRF

@pytest.mark.parametrize("nodes", [(33,), (17, 12)], ids=["1d", "2d"])
def test_gaussian_random_field_matches_jax_on_its_white_noise(nodes):
    grids = [np.linspace(0.0, 1.0 + a, n) for a, n in enumerate(nodes)]
    key = jax.random.key(5)
    jgrf = jpkg.GaussianRandomField(length_scale=0.2, variance=2.0, mean=0.5)
    want = np.asarray(jgrf(key, [jnp.asarray(g) for g in grids], 6))
    white = jax.random.normal(key, (*(n - 1 for n in nodes), 6), jnp.float64)
    tgrf = tpkg.GaussianRandomField(length_scale=0.2, variance=2.0, mean=0.5)
    got = tgrf.transform(torch.as_tensor(np.asarray(white)), grids)
    assert rel_err(got, want) < 1e-12
    # the population std over the values drawn (ddof 0), wrap nodes aside,
    # up to the 1e-12 guard in the normalization; ddof 1 would miss by
    # sqrt(n / (n - 1)) - 1 > 1e-4
    inner = got[tuple(slice(0, -1) for _ in nodes)]
    assert abs(float(torch.std(inner, correction=0)) - 2.0 ** 0.5) < 1e-10
    drawn = tgrf(torch.Generator().manual_seed(0), grids, 4)
    assert tuple(drawn.shape) == (*nodes, 4)
    assert torch.equal(drawn[0], drawn[-1])


def test_held_out_ns_ics_equal_the_jax_redraw():
    """The 8 held-out initial vorticities kept in the port
    (`accuracy.ns_eval_ics`) are the evaluation protocol's draw
    (scripts/measure_ns_operator_tpu.py:77-85): the example's zero-mean GRF,
    key 4242, 65 nodes an axis, drawn with x64 off."""
    from neuralpde_tpu_torch import accuracy

    kept = accuracy.ns_eval_ics()
    assert kept.shape == (65, 65, 8) and kept.dtype == np.float32
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        grf = jpkg.GaussianRandomField(length_scale=0.25, variance=9.0)
        g65 = jnp.linspace(0.0, 1.0, 65)
        f = grf(jax.random.key(4242), [g65, g65], 8)
        redraw = np.asarray(f - jnp.mean(f[:-1, :-1, :], axis=(0, 1)))
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert redraw.dtype == np.float32
    np.testing.assert_array_equal(kept, redraw)
