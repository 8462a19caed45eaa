"""`neuralpde_tpu_torch.utils.export` against the JAX package's
`utils.export`, mirroring the four export tests of tests/test_utils.py:
a round trip through a file (rtol 1e-12 in float64 against the JAX
package's ``phi``), a dynamic batch (at 5 and 17, and at 8, the hidden
width), the matmul precision recorded and applied, and a PINOPDE operator
against the JAX package's exported one (rtol 1e-5), with a family count
equal to a grid size.  A saved artifact runs in a fresh process that
imports only `torch`."""

import os
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
from _torch_parity import mlp_params, tree_like
from neuralpde_tpu.compile.discretize import Phi as JPhi
from neuralpde_tpu.utils import export as jexport
from neuralpde_tpu_torch.utils.export import (
    export_phi, export_pino_pde, load_exported, save_exported,
)

F64 = torch.float64


def _phi_pair(seed=0):
    tree = mlp_params(np.random.default_rng(seed), [2, 8, 1])
    tparams = tpkg.params_from_jax(tree, dtype=F64)
    return (JPhi(jpkg.mlp([2, 8, 1])), jax.tree.map(jnp.asarray, tree),
            tpkg.Phi(tpkg.mlp([2, 8, 1], dtype=F64)), tparams)


def test_export_roundtrip_through_a_file_matches_jax(tmp_path):
    jphi, jparams, tphi, tparams = _phi_pair()
    cord = np.random.default_rng(1).uniform(size=(2, 16))
    want = np.asarray(jphi(jnp.asarray(cord), jparams))
    blob, call = export_phi(tphi, tparams, 2, batch=16, dtype=F64)
    assert isinstance(blob, bytes) and len(blob) > 0
    np.testing.assert_allclose(call(torch.as_tensor(cord)).numpy(), want,
                               rtol=1e-12)
    path = str(tmp_path / "sol.pt2")
    save_exported(path, blob)
    serve = load_exported(path)
    np.testing.assert_allclose(serve(torch.as_tensor(cord)).numpy(), want,
                               rtol=1e-12)
    # a process that imports torch only (not the port) runs the artifact
    np.save(tmp_path / "cord.npy", cord)
    code = (
        "import sys, numpy as np, torch\n"
        "extra = {'matmul_precision': ''}\n"
        f"ep = torch.export.load({path!r}, extra_files=extra)\n"
        "assert extra['matmul_precision'] == 'highest'\n"
        f"c = torch.as_tensor(np.load({str(tmp_path / 'cord.npy')!r}))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, ep.module()(c).numpy())\n"
        "assert 'neuralpde_tpu_torch' not in sys.modules\n")
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), want,
                               rtol=1e-12)


@pytest.mark.parametrize("n", [5, 8, 17])
def test_export_dynamic_batch_matches_jax(n):
    """5 and 17 as in the JAX test, and 8, the hidden width (a size of the
    model must not pin the dynamic dimension)."""
    jphi, jparams, tphi, tparams = _phi_pair(2)
    _, jcall = jexport.export_phi(jphi, jparams, 2, batch=None,
                                  dtype=jnp.float64)
    _, call = export_phi(tphi, tparams, 2, batch=None, dtype=F64)
    cord = np.random.default_rng(n).uniform(size=(2, n))
    got = call(torch.as_tensor(cord)).numpy()
    assert got.shape == (1, n)
    np.testing.assert_allclose(got, np.asarray(jcall(jnp.asarray(cord))),
                               rtol=1e-12)


def test_export_records_and_applies_matmul_precision(tmp_path, monkeypatch):
    """The artifact records ``matmul_precision`` ("highest" by default,
    none with None), and the call runs the program with TF32 off under
    "highest" and under the caller's flag with None, restoring it after."""
    _, _, tphi, tparams = _phi_pair(3)
    params32 = {k: v.float() for k, v in tparams.items()}
    blob, _ = export_phi(tphi, params32, 2, batch=4)
    blob0, _ = export_phi(tphi, params32, 2, batch=4, matmul_precision=None)
    flags = torch.backends.cuda.matmul
    seen = []
    real = torch.export.load

    def spying_load(f, extra_files=None):
        program = real(f, extra_files=extra_files)

        class Spied:
            def module(self):
                inner = program.module()

                def run(*inputs):
                    seen.append(flags.allow_tf32)
                    return inner(*inputs)

                return run

        return Spied()

    monkeypatch.setattr(torch.export, "load", spying_load)
    before = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        path = str(tmp_path / "p.pt2")
        save_exported(path, blob)
        call = load_exported(path)
        assert call.matmul_precision == "highest"
        assert call(torch.ones((2, 4))).shape == (1, 4)
        assert flags.allow_tf32 is True
        save_exported(path, blob0)
        call0 = load_exported(path)
        assert call0.matmul_precision is None
        call0(torch.ones((2, 4)))
    finally:
        flags.allow_tf32 = before
    assert seen == [False, True]


def _heat(pkg, opt):
    from neuralpde_tpu.symbolic import expr as E

    x, t = E.Sym("x"), E.Sym("t")
    nu, u, f0 = E.Param("nu"), E.DepVar("u"), E.DepVar("f0")
    eq = E.Eq(E.Deriv(u(x, t), (t,)), nu * E.Deriv(u(x, t), (x, x)))
    return pkg.PDESystem(eq, [E.Eq(u(x, E.Num(0.0)), f0(x))],
                         [pkg.Domain(x, pkg.Interval(0, 1)),
                          pkg.Domain(t, pkg.Interval(0, 1))],
                         ivs=[x, t], dvs=[u(x, t)], ps=[nu]), f0(x)


@pytest.mark.parametrize("n_family", [2, 5])
def test_export_pino_pde_operator_matches_jax(n_family):
    """The JAX test's heat operator (FNO2D, width 8, 5 x 5 grid) from the
    same parameters, exported by both packages with a dynamic family
    dimension and called on the same inputs; 5 is the grid size."""
    chain = jpkg.FNO2D(2, width=8, modes=4, depth=2)
    tree = tree_like(jax.eval_shape(chain.init, jax.random.key(0)),
                     np.random.default_rng(7), 0.3)
    rng = np.random.default_rng(8)
    samples = rng.normal(size=(5, 4))
    jsys, jf0 = _heat(jpkg, None)
    jalg = jpkg.PINOPDE(chain=chain, opt=optax.adam(1e-3),
                        bounds=[(0.05, 0.3)], number_of_parameters=4,
                        input_functions={jf0: lambda k, g, n: samples},
                        strategy=jpkg.GridTraining(0.25),
                        init_params=jax.tree.map(jnp.asarray, tree))
    jsol = jpkg.solve_pino_pde(jsys, jalg, maxiters=0, inner_steps=1)
    _, jcall = jexport.export_pino_pde(jsol, dtype=jnp.float64)

    before = torch.get_default_dtype()
    torch.set_default_dtype(F64)
    try:
        from neuralpde_tpu_torch.symbolic import expr as TE

        x, t = TE.Sym("x"), TE.Sym("t")
        nu, u, f0 = TE.Param("nu"), TE.DepVar("u"), TE.DepVar("f0")
        eq = TE.Eq(TE.Deriv(u(x, t), (t,)), nu * TE.Deriv(u(x, t), (x, x)))
        tsys = tpkg.PDESystem(eq, [TE.Eq(u(x, TE.Num(0.0)), f0(x))],
                              [tpkg.Domain(x, tpkg.Interval(0, 1)),
                               tpkg.Domain(t, tpkg.Interval(0, 1))],
                              ivs=[x, t], dvs=[u(x, t)], ps=[nu])
        talg = tpkg.PINOPDE(
            chain=tpkg.FNO2D(2, width=8, modes=4, depth=2),
            opt=tpkg.adam(1e-3), bounds=[(0.05, 0.3)],
            number_of_parameters=4,
            input_functions={f0(x): lambda g, grids, n: samples},
            strategy=tpkg.GridTraining(0.25),
            init_params=tpkg.params_from_jax(tree, dtype=F64))
        tsol = tpkg.solve_pino_pde(tsys, talg, maxiters=0, device="cpu")
        _, call = export_pino_pde(tsol, dtype=F64)
        p = rng.uniform(0.05, 0.3, size=(1, n_family))
        ic = rng.normal(size=(5, n_family))
        got = call(torch.as_tensor(p), torch.as_tensor(ic)).numpy()
        want = tsol(p=torch.as_tensor(p),
                    input_values={"f0": torch.as_tensor(ic)}).numpy()
    finally:
        torch.set_default_dtype(before)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        got, np.asarray(jcall(jnp.asarray(p), jnp.asarray(ic))),
        rtol=1e-5, atol=1e-6)
