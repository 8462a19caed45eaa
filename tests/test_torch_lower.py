"""Parity of the port's lowering with `neuralpde_tpu.compile.lower`: the 2-D
Poisson residual and its four boundary residuals, evaluated at the same
points with the same parameters through both packages' contexts.

Tolerances: float64 1e-10 relative to the largest |value| (summation order
is the only difference); float32 1e-4 for the PDE residual (second
derivatives) and 1e-5 for the boundary residuals (values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, poisson_2d, rel_err
from neuralpde_tpu.compile import lower as jlower
from neuralpde_tpu.nn import core as jcore
from neuralpde_tpu_torch.compile import lower as tlower
from neuralpde_tpu_torch.nn import core as tcore

JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
SIZES = [2, 16, 16, 1]


def _contexts(mode, dtype, seed=0):
    """Both packages' lowering contexts for u(x, y) = mlp(SIZES), and the
    same parameters for each."""
    tree = mlp_params(np.random.default_rng(seed), SIZES)
    common = dict(depvars=["u"], indvars=["x", "y"],
                  dict_depvar_input={"u": ["x", "y"]}, multioutput=False)
    jctx = jlower.LoweringContext(
        phis=[jpkg.Phi(jcore.mlp(SIZES)).apply],
        derivative=jpkg.DerivativeEngine(mode), **common)
    tctx = tlower.LoweringContext(
        modules=[tcore.mlp(SIZES, dtype=dtype)],
        derivative=tpkg.DerivativeEngine(mode), **common)
    jtheta = {"depvar": jax.tree.map(lambda a: jnp.asarray(a, JDT[dtype]),
                                     tree)}
    ttheta = tpkg.params_from_jax({"depvar": tree}, dtype=dtype)
    return (jctx, jtheta), (tctx, ttheta)


def _cord(args, n, rng):
    """Collocation matrix for a get_argument layout: uniform rows for the
    symbols, the constant itself for a number."""
    return np.stack([rng.uniform(0, 1, n) if isinstance(a, (jpkg.Sym, tpkg.Sym))
                     else np.full(n, float(a)) for a in args])


def _residual_pair(jeq, teq, jctx, tctx, default_p=None):
    jargs = jpkg.get_argument(jeq, ["u"])
    targs = tpkg.get_argument(teq, ["u"])
    assert [repr(a) for a in jargs] == [repr(a) for a in targs]
    jres = jpkg.build_residual_function(
        jeq, [a if isinstance(a, jpkg.Sym) else None for a in jargs], jctx,
        default_p)
    tres = tpkg.build_residual_function(
        teq, [a if isinstance(a, tpkg.Sym) else None for a in targs], tctx,
        default_p)
    return jres, tres, jargs


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("mode", ["jvp", "jet"])
@pytest.mark.parametrize("which", ["pde", "bc0", "bc1", "bc2", "bc3"])
def test_poisson_residuals_match_jax(which, mode, dtype):
    (jctx, jtheta), (tctx, ttheta) = _contexts(mode, dtype)
    jsys, tsys = poisson_2d(jpkg), poisson_2d(tpkg)
    i = 0 if which == "pde" else int(which[-1])
    jeq = (jsys.eqs if which == "pde" else jsys.bcs)[i]
    teq = (tsys.eqs if which == "pde" else tsys.bcs)[i]
    jres, tres, args = _residual_pair(jeq, teq, jctx, tctx)
    cord = _cord(args, 41, np.random.default_rng(3))
    want = np.asarray(jres(jnp.asarray(cord, JDT[dtype]), jtheta))
    got = tres(torch.tensor(cord, dtype=dtype), ttheta)
    assert got.shape == (41,) and got.dtype == dtype
    tol = 1e-10 if dtype == torch.float64 else (1e-4 if which == "pde" else 1e-5)
    assert rel_err(got.detach().numpy(), want) < tol


def test_residual_with_default_parameter_matches_jax():
    """A PDE parameter with a default value is closed over, as in the JAX
    package: u_xx + a u = f with a = 2.5."""
    (jctx, jtheta), (tctx, ttheta) = _contexts("jvp", torch.float64)
    eqs = []
    for pkg, ctx in ((jpkg, jctx), (tpkg, tctx)):
        x, y = pkg.symbols("x y")
        u, a = pkg.DepVar("u"), pkg.parameters("a")
        ctx.eq_params = ["a"]
        eqs.append(pkg.Eq((pkg.Differential(x) ** 2)(u(x, y)) + a * u(x, y),
                          pkg.cos(x * y)))
    jres, tres, args = _residual_pair(*eqs, jctx, tctx, np.array([2.5]))
    cord = _cord(args, 23, np.random.default_rng(4))
    want = np.asarray(jres(jnp.asarray(cord), jtheta))
    got = tres(torch.tensor(cord), ttheta).detach().numpy()
    assert rel_err(got, want) < 1e-10


def test_float32_constants_stay_float32():
    """Constant call arguments, a derivative in a variable the network does
    not take, and numeric literals all take the parameters' dtype."""
    _, (tctx, ttheta) = _contexts("jet", torch.float32)
    x, y, t = tpkg.symbols("x y t")
    u = tpkg.DepVar("u")
    eq = tpkg.Eq(tpkg.Differential(t)(u(0.0, y)) + u(0.5, y) * 2.0, 1.0)
    res = tpkg.build_residual_function(eq, [None, y], tctx)
    cord = torch.stack([torch.zeros(9), torch.linspace(0, 1, 9)])
    out = res(cord.to(torch.float32), ttheta)
    assert out.dtype == torch.float32 and out.shape == (9,)
    want = tcore.TrialFunction(tctx.modules[0], tlower.depvar_params(ttheta))(
        torch.stack([torch.full((9,), 0.5), cord[1]]))[0] * 2.0 - 1.0
    torch.testing.assert_close(out, want)


def test_integral_terms_wait_for_a_later_slice():
    """They waited for the quadrature slice; now an integral term lowers,
    to the JAX package's values (tests/test_torch_integrals.py has the
    other forms)."""
    (jctx, jtheta), (tctx, ttheta) = _contexts("jvp", torch.float64)
    eqs = []
    for pkg in (jpkg, tpkg):
        x, y, s = pkg.symbols("x y s")
        u = pkg.DepVar("u")
        eqs.append(pkg.Eq(x * u(x, y), pkg.Integral(s, 0.0, 1.0)(u(s, y))))
    jres, tres, args = _residual_pair(*eqs, jctx, tctx)
    cord = _cord(args, 17, np.random.default_rng(5))
    want = np.asarray(jres(jnp.asarray(cord), jtheta))
    got = tres(torch.tensor(cord), ttheta).detach().numpy()
    assert rel_err(got, want) < 1e-10


def test_get_argument_and_variables_match_jax():
    jsys, tsys = poisson_2d(jpkg), poisson_2d(tpkg)
    for jeq, teq in zip(jsys.eqs + jsys.bcs, tsys.eqs + tsys.bcs):
        assert ([repr(a) for a in jpkg.get_argument(jeq, ["u"])]
                == [repr(a) for a in tpkg.get_argument(teq, ["u"])])
        assert ([a.name for a in jpkg.get_variables(jeq, ["u"])]
                == [a.name for a in tpkg.get_variables(teq, ["u"])])


def test_free_symbols_match_jax():
    from neuralpde_tpu.compile.lower import free_symbols as jfree

    jsys, tsys = poisson_2d(jpkg), poisson_2d(tpkg)
    for jeq, teq in zip(jsys.eqs + jsys.bcs, tsys.eqs + tsys.bcs):
        assert ([s.name for s in jfree(jeq)]
                == [s.name for s in tpkg.free_symbols(teq)])
