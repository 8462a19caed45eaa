"""The port's whole slice against the JAX package: `discretize` of the 2-D
Poisson problem, its loss and gradient, Adam steps through `make_step`,
training with `solve`, and the package's independence from JAX.

Tolerances (float64): loss and gradients 1e-10 relative; parameters and
losses after Adam steps 1e-8 relative (Adam divides by sqrt(v) + eps, which
amplifies rounding differences in small gradients).
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neuralpde_tpu as jpkg
import neuralpde_tpu_torch as tpkg
from _torch_parity import mlp_params, poisson_1d, poisson_2d, rel_err
from neuralpde_tpu.train import make_step as jax_make_step

PORT = Path(tpkg.__file__).resolve().parent


def _problems(system, sizes, strategy, derivative, seed=0):
    tree = mlp_params(np.random.default_rng(seed), sizes)
    jprob = jpkg.discretize(system(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp(sizes), strategy(jpkg), init_params=tree,
        derivative=derivative, dtype=jnp.float64))
    tprob = tpkg.discretize(system(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp(sizes, dtype=torch.float64), strategy(tpkg),
        init_params=tpkg.params_from_jax(tree), derivative=derivative,
        dtype=torch.float64, device="cpu"))
    return jprob, tprob


def _grid(pkg):
    return pkg.GridTraining(0.1)


def _ada(prob):
    dtype = prob.pinnrep.dtype
    on = ("cpu",) if isinstance(dtype, torch.dtype) else ()   # the port's
    return prob.pinnrep.adaloss.init_state(1, 4, dtype, *on)


@pytest.mark.parametrize("derivative", ["jvp", "jet"])
def test_poisson_loss_and_gradient_match_jax(derivative):
    jprob, tprob = _problems(poisson_2d, [2, 8, 8, 1], _grid, derivative)
    (jloss, jaux), jgrad = jax.value_and_grad(jprob.loss, has_aux=True)(
        jprob.init_params, {"key": jax.random.key(0), "adaptive": _ada(jprob)})
    theta = {k: v.clone().requires_grad_(True)
             for k, v in tprob.init_params.items()}
    loss, aux = tprob.loss(theta, {"generator": torch.Generator(),
                                   "adaptive": _ada(tprob)})
    loss.backward()
    assert rel_err(float(loss.detach()), float(jloss)) < 1e-10
    for name in ("pde_losses", "bc_losses"):
        assert rel_err(aux[name].detach().numpy(), jaux[name]) < 1e-10
    want = tpkg.params_from_jax(jax.tree.map(np.asarray, jgrad))
    assert want.keys() == theta.keys()
    for k, v in theta.items():
        assert rel_err(v.grad.numpy(), want[k].numpy()) < 1e-10, k


@pytest.mark.parametrize("derivative", ["jvp", "jet"])
def test_adam_steps_match_optax(derivative):
    jprob, tprob = _problems(poisson_2d, [2, 8, 8, 1], _grid, derivative)
    jlf, tlf = jprob.pinnrep.loss_functions, tprob.pinnrep.loss_functions
    opt = optax.adam(1e-3)
    jstep = jax.jit(jax_make_step(jprob.loss, opt, jprob.pinnrep.adaloss,
                                  jlf.pde_loss_functions,
                                  jlf.bc_loss_functions))
    jcarry = (jprob.init_params, opt.init(jprob.init_params), _ada(jprob),
              jnp.asarray(0, jnp.int32))
    tstep = tpkg.make_step(tprob.loss, tpkg.adam(1e-3), tprob.pinnrep.adaloss,
                           tlf.pde_loss_functions, tlf.bc_loss_functions)
    tcarry = tstep.init(tprob.init_params, _ada(tprob))
    generator = torch.Generator()
    for _ in range(5):
        jcarry, (jloss, _) = jstep(jcarry, jax.random.key(0))
        tcarry, (tloss, _) = tstep(tcarry, generator)
        assert rel_err(float(tloss), float(jloss)) < 1e-8
    want = tpkg.params_from_jax(jax.tree.map(np.asarray, jcarry[0]))
    for k, v in tcarry[0].items():
        assert rel_err(v.detach().numpy(), want[k].numpy()) < 1e-8, k
    assert tcarry[3] == 5


def _max_error(phi_eval, xs):
    return float(np.max(np.abs(phi_eval(xs) - np.sin(np.pi * xs))))


def test_solve_1d_poisson_reaches_the_jax_error_band():
    """The verify flow: u'' = -pi^2 sin(pi x), u(0) = u(1) = 0, trained by
    each package's `solve` from the same start; both land in one band."""
    jprob, tprob = _problems(poisson_1d, [1, 16, 1],
                             lambda pkg: pkg.GridTraining(0.05), "jet", seed=4)
    jres = jpkg.solve(jprob, optax.adam(2e-2), maxiters=300)
    tres = tpkg.solve(tprob, tpkg.adam(2e-2), maxiters=300)
    xs = np.linspace(0, 1, 101)[None, :]
    jerr = _max_error(lambda c: np.asarray(
        jprob.pinnrep.phi(jnp.asarray(c), jres.u["depvar"])), xs)
    terr = _max_error(lambda c: tprob.pinnrep.phi(
        torch.tensor(c), tpkg.depvar_params(tres.u)).numpy(), xs)
    assert tres.iterations == 300 and len(tres.history) == 300
    assert jerr < 0.05 and terr < 0.05
    assert abs(terr - jerr) < 0.1 * jerr
    assert rel_err(tres.objective, jres.objective) < 1e-3


def test_solve_stops_on_callback_abstol_and_divergence():
    _, tprob = _problems(poisson_1d, [1, 8, 1],
                         lambda pkg: pkg.GridTraining(0.1), "jet")
    seen = []
    res = tpkg.solve(tprob, maxiters=50,
                     callback=lambda it, loss, aux: seen.append(it) or it == 3)
    assert res.iterations == 3 and seen == [1, 2, 3]
    res = tpkg.solve(tprob, maxiters=50, abstol=1e9)
    assert res.iterations == 1
    bad = tpkg.discretize(poisson_1d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([1, 8, 1], dtype=torch.float64), tpkg.GridTraining(0.1),
        dtype=torch.float64,
        additional_loss=lambda phi, theta, p: torch.tensor(float("nan")),
        device="cpu"))
    with pytest.warns(UserWarning, match="diverged"):
        res = tpkg.solve(bad, maxiters=50)
    assert res.iterations == 1 and not np.isfinite(res.objective)


def test_default_initial_parameters_are_seeded():
    def init(seed):
        return tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
            tpkg.mlp([2, 8, 1]), tpkg.GridTraining(0.2),
            seed=seed, device="cpu")).init_params

    a, b, c = init(1), init(1), init(2)
    assert sorted(a) == ["depvar.layer_0.bias", "depvar.layer_0.weight",
                         "depvar.layer_1.bias", "depvar.layer_1.weight"]
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["depvar.layer_0.weight"],
                           c["depvar.layer_0.weight"])


def test_not_yet_ported_options_raise():
    """Integral terms are ported: a problem with one builds and takes a step
    on the dense and on the factorized path.  So is Gauss-Newton on the weak
    form: a `WeakTraining` problem gives a residual vector, and a strategy
    that Gauss-Newton does not know is refused by name."""
    x, s = tpkg.symbols("x s")
    u = tpkg.DepVar("u")
    system = tpkg.PDESystem(
        tpkg.Eq(u(x), tpkg.Integral(s, 0.0, 1.0)(u(s))), [],
        [tpkg.Domain(x, tpkg.Interval(0, 1))], [x], [u(x)])
    for chain, strategy in ((tpkg.mlp([1, 8, 1]), tpkg.GridTraining(0.2)),
                            (tpkg.separable_mlp(1, (8,), 4),
                             tpkg.SeparableTraining(dx=0.2))):
        prob = tpkg.discretize(system, tpkg.PhysicsInformedNN(
            chain, strategy, device="cpu"))
        assert np.isfinite(tpkg.solve(prob, maxiters=1).objective)

    weak = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([2, 8, 1]), tpkg.WeakTraining(elements=2, n_test=3),
        device="cpu"))
    r = tpkg.build_residual_vector(weak.pinnrep)(weak.init_params)
    assert r.ndim == 1 and bool(torch.isfinite(r).all())

    class Unknown(tpkg.TrainingStrategy):
        pass

    prob.pinnrep.strategy = Unknown()
    with pytest.raises(TypeError, match="deterministic strategy"):
        tpkg.build_residual_vector(prob.pinnrep)


def test_import_leaves_jax_out():
    code = ("import sys, neuralpde_tpu_torch; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'neuralpde_tpu')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=PORT.parent, timeout=120)


def test_no_module_of_the_port_imports_jax():
    scripts = sorted((PORT.parent / "scripts").glob("torch_*.py"))
    assert len(scripts) >= 10, scripts    # the twins and the port's tools
    for path in [*PORT.rglob("*.py"), PORT.parent / "chip_smoke.py",
                 PORT.parent / "bench_torch.py", *scripts]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "optax", "neuralpde_tpu"), (path, name)


def _defined_names(path: Path) -> set:
    """Public names a module defines at top level (what ``import *`` of a
    module without ``__all__`` takes, less the names it imports)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


def test_every_jax_subpackage_name_resolves_in_the_port():
    """Each name a JAX subpackage's ``__init__.py`` exports (read by AST,
    no JAX import) is an attribute of the port's subpackage, as
    ``from neuralpde_tpu_torch.compile import discretize`` needs."""
    import importlib

    jax_root = PORT.parent / "neuralpde_tpu"
    exempt = {"FlaxAdapter", "HaikuAdapter"}      # TorchModuleAdapter instead
    missing, seen = [], 0
    for init in sorted(jax_root.glob("*/__init__.py")):
        sub = init.parent.name
        port = importlib.import_module(f"neuralpde_tpu_torch.{sub}")
        for node in ast.parse(init.read_text()).body:
            if not isinstance(node, ast.ImportFrom):
                continue
            names = [a.asname or a.name for a in node.names]
            if names == ["*"]:
                names = _defined_names(init.parent / f"{node.module}.py")
            for name in set(names) - exempt:
                seen += 1
                if not hasattr(port, name):
                    missing.append(f"{sub}.{name}")
    assert seen > 100 and not missing, missing

def test_loss_weights_match_jax():
    """NonAdaptiveLoss's fixed weights scale each loss as in the JAX
    package; a wrong count of weights raises."""
    tree = mlp_params(np.random.default_rng(6), [2, 8, 1])
    weights = dict(pde_loss_weights=3.0, bc_loss_weights=[1.0, 2.0, 0.5, 4.0])
    jprob = jpkg.discretize(poisson_2d(jpkg), jpkg.PhysicsInformedNN(
        jpkg.mlp([2, 8, 1]), jpkg.GridTraining(0.2), init_params=tree,
        adaptive_loss=jpkg.NonAdaptiveLoss(**weights), dtype=jnp.float64))
    tprob = tpkg.discretize(poisson_2d(tpkg), tpkg.PhysicsInformedNN(
        tpkg.mlp([2, 8, 1], dtype=torch.float64), tpkg.GridTraining(0.2),
        init_params=tpkg.params_from_jax(tree),
        adaptive_loss=tpkg.NonAdaptiveLoss(**weights), dtype=torch.float64,
        device="cpu"))
    want, jaux = jprob.loss(jprob.init_params, {"key": jax.random.key(0),
                                                "adaptive": _ada(jprob)})
    got, aux = tprob.loss(tprob.init_params, {"generator": None,
                                              "adaptive": _ada(tprob)})
    assert rel_err(float(got), float(want)) < 1e-10
    assert rel_err(aux["weighted_bc_losses"].numpy(),
                   jaux["weighted_bc_losses"]) < 1e-10
    with pytest.raises(ValueError, match="expected 4 weights"):
        tpkg.NonAdaptiveLoss(bc_loss_weights=[1.0, 2.0]).init_state(
            1, 4, torch.float64, "cpu")


def test_matmul_precision_sets_and_restores_tf32():
    flags = torch.backends.cuda.matmul
    before = flags.allow_tf32
    with tpkg.matmul_precision("high"):
        assert flags.allow_tf32
        with tpkg.matmul_precision("highest"):
            assert not flags.allow_tf32
        assert flags.allow_tf32
    assert flags.allow_tf32 == before
    with pytest.raises(ValueError, match="unknown matmul_precision"):
        with tpkg.matmul_precision("bf16"):
            pass


def test_enable_x64_switches_the_default_dtype():
    before = torch.get_default_dtype()
    try:
        tpkg.enable_x64()
        assert tpkg.default_float() == torch.float64
        assert tpkg.mlp([2, 4, 1]).layer_0.weight.dtype == torch.float64
        tpkg.enable_x64(False)
        assert tpkg.default_float() == torch.float32
    finally:
        torch.set_default_dtype(before)


def allen_cahn(pkg):
    """u_t = 1e-4 u_xx + 5 (u - u^3) on [-1, 1] x [0, 1], u(x, 0) =
    x^2 cos(pi x), u(-1, t) = u(1, t)."""
    x, t = pkg.symbols("x t")
    u = pkg.DepVar("u")
    eq = pkg.Eq(pkg.Differential(t)(u(x, t)),
                1e-4 * (pkg.Differential(x) ** 2)(u(x, t))
                + 5.0 * (u(x, t) - u(x, t) ** 3))
    bcs = [pkg.Eq(u(x, 0.0), x ** 2 * pkg.cos(np.pi * x)),
           pkg.Eq(u(-1.0, t), u(1.0, t))]
    return pkg.PDESystem(eq, bcs, [pkg.Domain(x, pkg.Interval(-1, 1)),
                                   pkg.Domain(t, pkg.Interval(0, 1))],
                         [x, t], [u(x, t)])


def poisson_2d_pde_only(pkg):
    """`poisson_2d` without boundary conditions (bcs=[])."""
    system = poisson_2d(pkg)
    return pkg.PDESystem(system.eqs, [], system.domains, system.ivs,
                         system.dvs)


@pytest.mark.parametrize("derivative", ["jvp", "jet"])
@pytest.mark.parametrize("system, n_bc", [(allen_cahn, 2),
                                          (poisson_2d_pde_only, 0)],
                         ids=["allen_cahn", "poisson_pde_only"])
def test_probe_problems_match_jax(system, n_bc, derivative):
    """Dense Allen-Cahn (an initial and a periodic condition) and a PDE-only
    Poisson problem: loss, per-equation losses and gradient, float64."""
    sizes = [2, 8, 8, 1]
    jprob, tprob = _problems(system, sizes, lambda pkg: pkg.GridTraining(0.25),
                             derivative, seed=7)
    jada = jprob.pinnrep.adaloss.init_state(1, n_bc, jnp.float64)
    (jloss, jaux), jgrad = jax.value_and_grad(jprob.loss, has_aux=True)(
        jprob.init_params, {"key": jax.random.key(0), "adaptive": jada})
    theta = {k: v.clone().requires_grad_(True)
             for k, v in tprob.init_params.items()}
    loss, aux = tprob.loss(theta, {
        "generator": None,
        "adaptive": tprob.pinnrep.adaloss.init_state(1, n_bc, torch.float64,
                                                   "cpu")})
    loss.backward()
    assert rel_err(float(loss.detach()), float(jloss)) < 1e-10
    for name in ("pde_losses", "bc_losses"):
        if n_bc or name == "pde_losses":
            assert rel_err(aux[name].detach().numpy(), jaux[name]) < 1e-10
    want = tpkg.params_from_jax(jax.tree.map(np.asarray, jgrad))
    for k, v in theta.items():
        # no bc: the output bias does not reach u_xx + u_yy (JAX: zeros)
        got = torch.zeros_like(v) if v.grad is None else v.grad
        assert np.max(np.abs(got.numpy() - want[k].numpy())) <= 1e-10 * max(
            np.max(np.abs(want[k].numpy())), 1e-300), k


def test_solve_inner_steps_runs_blocks():
    """inner_steps=k: k steps per block; history, callback and the
    iteration count move once per block, on the block's last loss; the
    parameters are those of inner_steps=1; whole blocks run, as in JAX."""
    jprob, tprob = _problems(poisson_1d, [1, 8, 1],
                             lambda pkg: pkg.GridTraining(0.1), "jet", seed=2)
    seen = []
    blocked = tpkg.solve(tprob, tpkg.adam(1e-2), maxiters=12, inner_steps=4,
                         callback=lambda it, loss, aux: seen.append(
                             (it, loss)) and False)
    single = tpkg.solve(tprob, tpkg.adam(1e-2), maxiters=12)
    assert blocked.iterations == 12 and len(blocked.history) == 3
    assert [it for it, _ in seen] == [4, 8, 12]
    assert blocked.history == [single.history[i] for i in (3, 7, 11)]
    assert [loss for _, loss in seen] == blocked.history
    for k, v in single.u.items():
        torch.testing.assert_close(blocked.u[k], v, rtol=0, atol=0)
    ragged = tpkg.solve(tprob, tpkg.adam(1e-2), maxiters=10, inner_steps=4)
    jragged = jpkg.solve(jprob, optax.adam(1e-2), maxiters=10, inner_steps=4)
    assert ragged.iterations == jragged.iterations == 12
    assert len(ragged.history) == len(jragged.history) == 3
    stopped = tpkg.solve(tprob, maxiters=40, inner_steps=5, abstol=1e9)
    assert stopped.iterations == 5 and len(stopped.history) == 1
